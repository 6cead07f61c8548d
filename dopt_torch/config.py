"""Typed, frozen experiment configuration for the PyTorch port.

Every field of ``dopt.config``'s ``DataConfig``, ``ModelConfig``,
``OptimizerConfig``, ``FederatedConfig``, ``GossipConfig`` and
``ExperimentConfig``, with the same names and defaults, so a preset, a
dopt config or a ``--set`` override means the same thing in both
packages.  ``PopulationConfig`` is dopt's client population
(``dopt_torch.population``); ``SeqLMConfig`` is its sequence-parallel
language model (``dopt_torch.engine.seqlm.SeqLMTrainer``), which the
gossip and federated trainers refuse by naming that trainer.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection + partitioning (reference ``get_dataset`` args)."""

    dataset: str = "mnist"   # mnist | fmnist | cifar10 | cifar100 | a9a | synthetic
    iid: bool = True
    shards: int = 2          # non-IID shards per user
    num_users: int = 8
    data_dir: str | None = None   # directory with raw files; None -> synthetic
    synthetic_train_size: int = 2048
    synthetic_test_size: int = 512
    plan_impl: str = "numpy"  # "native": the C++ planner (dopt_torch.native)
    local_holdout: float = 0.0
    # Fraction of each worker's shard held out as local validation (the
    # reference's train_val_test split: val_size = max(int(L·f), 1));
    # training runs on the rest, and every local epoch evaluates the
    # worker's val split into ``trainer.client_history``.
    holdout_mode: str = "deterministic"
    # deterministic — val = the FIRST val_size indices of the shard (P1);
    # random        — a seeded per-worker draw without replacement (P2).


@dataclass(frozen=True)
class ModelConfig:
    """Model zoo selection (reference ``args.model`` string dispatch)."""

    model: str = "model1"
    # model1 | model3 | mlp | logistic | resnet18 | transformer (the
    # SeqLMTrainer's TransformerLM, built from the seqlm section)
    stage_sizes: tuple[int, ...] | None = None
    # resnet18 only: residual blocks a stage; None = (2, 2, 2, 2).
    faithful: bool = True
    # faithful=True reproduces the reference's Softmax-head +
    # CrossEntropyLoss double-softmax; False uses the corrected logits
    # head (and post-conv ReLUs).
    num_classes: int = 10
    input_shape: tuple[int, ...] = (28, 28, 1)   # NHWC, as in dopt
    param_dtype: str = "float32"     # storage: float32 | bfloat16
    compute_dtype: str = "float32"   # forward/backward: float32 | bfloat16
    stacked_impl: str = "auto"
    # "auto": the worker-stacked grouped-conv forward; "vmap": dopt's
    # oracle-parity mode, the worker's model vmapped over the workers
    # (dopt_torch.models.zoo.vmap_forward).


@dataclass(frozen=True)
class OptimizerConfig:
    """Local SGD settings (torch momentum semantics)."""

    optimizer: str = "sgd"
    lr: float = 0.01
    momentum: float = 0.5
    weight_decay: float = 0.0
    # ℓ2 coefficient added to the local loss (λ‖θ‖²/2 as a loss term).
    rho: float = 0.1   # FedProx proximal weight / FedADMM penalty
    clip_norm: float = 0.0
    # > 0: clip each worker's gradient to this global ℓ2 norm after the
    # algorithm's edit, before the update (dopt's order).
    fused_update: bool = False
    # True sends every step's momentum-SGD update through the
    # hand-written CUDA kernel (dopt_torch.ops.fused_sgd_momentum).


@dataclass(frozen=True)
class FederatedConfig:
    """Server-coordinated path (reference P1 ``servers.py``)."""

    algorithm: str = "fedavg"   # fedavg | fedprox | fedadmm | scaffold
    frac: float = 0.1           # fraction of users sampled per round
    rounds: int = 20
    local_ep: int = 10
    local_bs: int = 50
    compact: bool | None = None
    # Train only the m sampled lanes ([m, ...] gather → local update →
    # scatter back) instead of all W lanes with the unsampled results
    # masked away.  None = auto (on when frac < 1 and the fused epilogue
    # is off).
    block_rounds: int = 1
    # > 1 runs that many rounds a block: each round replays a CUDA graph
    # of the round body, with one device→host fetch a block
    # (dopt_torch.engine.graphs); on the CPU the same block loop runs
    # the body eagerly.
    comm_dtype: str | None = None
    # Wire narrowing of the masked-mean reduce (bfloat16|float16|float32):
    # the f32 partial sum is narrowed once; forces the full width.
    staleness_max: int = 0
    # > 0: late updates (drop-policy stragglers, delayed uplinks) are
    # buffered and admitted d rounds later at weight staleness_decay**d.
    staleness_decay: float = 0.5
    update_sharding: str = "off"
    # "scatter": the masked mean runs over flat buckets as a
    # reduce-scatter, a shard divide and an all-gather
    # (masked_average_scatter).
    update_bucket_mb: float = 4.0
    # Per-worker payload bound of one flat bucket of the scatter path and
    # the fused epilogue.
    fused_update: str = "off"
    # "off" | "on".  "on" carries theta as the [W, ...] broadcast slab in
    # a flat bucket store and runs each round's masked mean + theta
    # update as ONE CUDA kernel pass per bucket,
    # θ'_b = M(mask)·disp + θ_b (kernel 2 with lr = −1);
    # fedavg/fedprox, full width only.
    prefetch: str = "off"
    # "off" | "on".  "on" builds the next block's batch plans and stages
    # them on the device on a background thread while the current block
    # runs (dopt_torch.data.prefetch); blocked runs only.
    diagnostics: str = "off"    # "on" arrives with the telemetry slice


@dataclass(frozen=True)
class GossipConfig:
    """Serverless gossip/consensus path (reference P2 ``simulators.py``)."""

    algorithm: str = "dsgd"     # dsgd | nocons | centralized | fedlcon | gossip | choco
    topology: str = "circle"    # circle | star | complete | dynamic | random
    #                           # | torus | hierarchical | one_peer_exp
    mode: str = "stochastic"    # stochastic | double_stochastic | metropolis | uniform | ones
    rounds: int = 10
    local_ep: int = 4
    local_bs: int = 128
    eps: int = 1                # fedlcon's consensus sweeps a round
    eval_mode: str = "full"
    # full — every worker evaluates the whole test split; sharded — each
    # evaluates its round-robin 1/W shard (the in-training metric only).
    mixing: str = "sync"
    comm_impl: str = "auto"
    # auto | dense | shift: "shift" mixes by the schedule's circulant
    # diagonals (dopt_torch.parallel.collectives.mix_shifts); "auto"
    # takes it only where a wire makes it win, so never on one GPU.
    block_rounds: int = 1
    # > 1: blocks of that many rounds, as FederatedConfig.block_rounds.
    faithful_bugs: bool = False   # fedlcon: one sweep, the reference's bug
    self_weight: bool = False   # reference mixing has a zero diagonal
    hier_groups: int = 2
    hier_period: int = 4
    # choco (algorithm="choco"): consensus step γ, the compressor
    # (topk|randk|qsgd|none), its ratio (qsgd: levels = ratio·256 unless
    # qsgd_levels), and comm_dtype, the consensus wire's dtype.
    choco_gamma: float = 1.0
    compression: str = "topk"
    compression_ratio: float = 1.0
    qsgd_levels: int = 0
    comm_dtype: str | None = None
    correction: str = "none"    # "push_sum": ratio consensus (link path)
    update_sharding: str = "off"
    # "scatter": the consensus mix runs over flat buckets as a
    # reduce-scatter of f32 partial contractions (mix_update_scatter).
    update_bucket_mb: float = 4.0
    # Per-worker payload bound of one flat bucket of the scatter path and
    # the fused epilogue
    # (dopt_torch.parallel.collectives.make_update_shard_spec).
    fused_update: str = "off"
    # "off" | "on".  "on" carries (post-mix params q, displacement
    # fbuf) and runs the round epilogue q_t = W·q_{t-1} − fbuf_{t-1} as
    # one CUDA kernel pass per flat bucket — the D-PSGD ordering of
    # dopt's GossipConfig.fused_update.
    prefetch: str = "off"       # "off" | "on", as FederatedConfig.prefetch
    diagnostics: str = "off"    # "on" arrives with the telemetry slice
    dropout: float = 0.0        # dopt's deprecated alias of faults.crash


@dataclass(frozen=True)
class FaultConfig:
    """Deterministic fault injection (``dopt_torch.faults.FaultPlan``).

    The reference assumes every simulated worker is alive and instant
    (SURVEY §5); real decentralized systems treat crashes, stragglers
    and partitions as the steady state.  All draws are keyed by
    (seed, round) — stateless — so the same config replays the same
    fault trace, per-round and blocked execution inject identical
    faults, and a killed-and-resumed run sees exactly the faults a
    continuous run would.  Every injected fault lands in the run's
    fault ledger (``History.faults``)."""

    crash: float = 0.0
    # Per-round per-worker crash probability.  A crashed worker is down
    # for the round: it skips consensus and local training (gossip) or
    # contributes nothing to the server aggregate (federated) and
    # rejoins next round with stale-but-valid state.
    straggle: float = 0.0
    # Per-round per-worker straggler probability (crashes win ties).
    straggle_frac: float = 0.5
    # Fraction of its local work a straggler finishes before the round
    # deadline: epochs under the holdout's epoch loop, SGD steps on the
    # flat path (ceil(frac * total), so frac > 0 always does some work).
    straggler_policy: str = "partial"
    # Federated only: 'partial' aggregates the straggler's truncated
    # update; 'drop' removes it from the round (FedAvg-paper server
    # deadline) — combine with over_select so the aggregate still
    # averages ~m clients.  Gossip has no server deadline and always
    # applies 'partial'.
    over_select: float = 0.0
    # Federated: sample ceil(m·(1+over_select)) clients, keep the first
    # m survivors after crashes/deadline drops (surplus is released and
    # ledgered) — the FedAvg-paper over-selection pattern.
    partition: float = 0.0
    # Per-round probability a network partition STARTS; while active,
    # the fleet is split into partition_groups random groups.  Gossip:
    # cross-group mixing edges are cut (matrix repaired as data,
    # ``repair_for_partition``).  Federated: only group 0 can reach the
    # server; other groups are unreachable for the span.
    partition_span: int = 2     # rounds a partition lasts once started
    partition_groups: int = 2   # number of sides of the cut
    corrupt: float = 0.0
    # Per-round per-worker probability the worker LIES: its contributed
    # update (federated) / the state it broadcasts to neighbors (gossip)
    # is replaced by a corrupted value before aggregation — the
    # Byzantine threat model, vs. crash's fail-stop model.  Crashes win
    # ties (a down worker sends nothing).  Injection happens INSIDE the
    # jitted round functions (``dopt_torch.faults.corrupt_update``) from the
    # same stateless per-round streams, so corrupted runs stay
    # bit-reproducible, blocked-execution-exact and resume-exact.
    corrupt_mode: str = "nan"
    # What the lie looks like: 'nan' | 'inf' (non-finite poison),
    # 'scale' (norm blow-up by corrupt_scale), 'signflip' (update
    # negated through the reference point), 'stale' (replay of the
    # worker's previous update; federated engine only — gossip carries
    # no per-worker previous-send state).
    corrupt_scale: float = 100.0   # blow-up factor for mode='scale'
    corrupt_max: int = 0
    # Cap on corrupted workers per round (0 = no cap).  The cap keeps
    # the LOWEST-INDEXED workers among the round's draws, so
    # ``corrupt=1.0, corrupt_max=f`` pins workers 0..f-1 as PERSISTENT
    # adversaries — the classic fixed-f Byzantine setting robust
    # aggregators state their breakdown points against.
    msg_drop: float = 0.0
    # Per-round per-DIRECTED-EDGE message-loss probability (the lossy-
    # link model).  Each direction of each link draws independently, so
    # loss is asymmetric in general — which is exactly what makes the
    # row-renormalised effective mixing matrix non-doubly-stochastic
    # and plain gossip converge to a biased average (the push-sum
    # correction, ``GossipConfig.correction="push_sum"``, recovers the
    # true mean).  Gossip: the edge is cut for the round and the
    # surviving weights repaired as data.  Federated: the probability a
    # sampled client's UPLINK to the server loses the round's update
    # (the client keeps its local state; the server sees a failure).
    msg_delay: float = 0.0
    # Per-round per-directed-edge message-DELAY probability.  A delayed
    # gossip edge delivers the sender's state d rounds late (d drawn
    # uniformly in 1..msg_delay_max), so the receiver mixes against a
    # stale value — the bounded-staleness asynchronous-gossip model.
    # The staleness buffer is engine state, carried through blocked
    # execution and checkpoints.  Federated: a sampled client's uplink
    # update arrives d rounds late; with
    # ``FederatedConfig.staleness_max`` > 0 it is buffered and admitted
    # with decay weighting, otherwise it is lost like a drop.
    msg_delay_max: int = 2
    # Maximum delay D in rounds (the staleness bound; buffer depth is
    # compiled from it, so keep it small).
    churn: float = 0.0
    # Per-round per-worker probability an elastic-membership LEAVE event
    # starts: the worker departs the fleet for ``churn_span`` rounds and
    # then rejoins (the join event) with its stale state.  While away
    # the mixing matrix is repaired around it (identity row — same
    # healing as a crash) / it is excluded from federated sampling, and
    # its data shard is deterministically reassigned to the next alive
    # worker (``dopt_torch.data.partition.reassign_shards``) so the departed
    # data keeps being trained on.  Draws are stateless per round like
    # every other fault kind.
    churn_span: int = 4         # rounds a departed worker stays away
    seed: int | None = None     # fault-stream seed; None = experiment seed


@dataclass(frozen=True)
class RobustConfig:
    """Byzantine-robust aggregation & quarantine (``dopt_torch.robust``).

    The defense side of the threat model: ``FaultConfig.corrupt``
    injects lies, this config decides what the aggregation layer does
    about them.  ``None`` (or all defaults) keeps the exact masked-mean
    programs — clean runs stay bit-identical."""

    aggregator: str = "mean"
    # Federated server aggregation over the round's surviving updates:
    # 'mean' (the reference masked average, breakdown point 0),
    # 'trimmed_mean' (coordinate-wise, tolerates < trim_frac·n liars),
    # 'median' (coordinate-wise, breakdown 1/2), 'krum' / 'multi_krum'
    # (distance-based selection, tolerates f with n > 2f + 2).
    # All are jittable pure functions of (stacked updates, mask).
    trim_frac: float = 0.1
    # trimmed_mean: fraction trimmed from EACH end per coordinate
    # (k = floor(trim_frac · n_alive), clamped so >= 1 value survives).
    krum_f: int = 1
    # krum/multi_krum: assumed number of Byzantine workers f; each
    # worker is scored by its n_alive − f − 2 closest neighbors.
    multi_krum_m: int = 0
    # multi_krum: average the m best-scored workers (0 = auto:
    # n_alive − krum_f).  krum is multi_krum with m = 1.
    clip_radius: float = 0.0
    # Norm clip (0 = off).  Federated: worker updates are clipped to an
    # L2 ball of this radius around theta before aggregation.  Gossip:
    # the clipped-gossip rule — each worker clips every neighbor
    # DEVIATION ``x_j − x_i`` to this radius before applying the mixing
    # weights, so one liar moves any honest worker at most
    # W_ij·clip_radius per round (composes with partition/crash repair,
    # which act on the matrix itself).
    quarantine_after: int = 0
    # Detection/quarantine layer (0 = off): a worker whose update is
    # screened (non-finite, or majority-clipped in gossip) this many
    # rounds IN A ROW is quarantined — masked out via the engines'
    # existing alive/participation machinery and recorded in the fault
    # ledger — then readmitted after ``quarantine_rounds``.
    quarantine_rounds: int = 8  # backoff length before readmission


@dataclass(frozen=True)
class CommConfig:
    """The per-bucket wire schedule of ``update_sharding="scatter"``
    (dopt's ``CommConfig``), shared by both engines: which wire format
    each flat bucket speaks.  ``make_codec_plan`` maps a byte budget
    onto formats — the big buckets compress hardest (packed int8, or
    nibble-packed int4, with per-chunk scales and error feedback), the
    small ones stay exact — and ``link_byte_budget`` derives that budget
    from the lossy-link fault model.  ``None`` on ExperimentConfig keeps
    every path as it was."""

    codec: str = "none"
    # "none" | "qsgd": the per-bucket stochastic int8/int4 codec
    # (dopt_torch.ops.compression.qint_encode).  The gossip engine
    # carries the error-feedback residual ("comm_residual" in
    # checkpoints); draws are per (round, bucket, global lane), so codec
    # runs repeat, block and resume bit for bit.
    wire_dtype: str | None = None
    # Narrowing for the buckets the codec does not cover (the whole wire
    # with codec="none"): None | "bfloat16" | "float16".
    byte_budget_mb: float = 0.0
    # Per-lane per-round wire budget in MiB.  0: every bucket of at
    # least min_codec_bytes gets the codec at int8.  > 0: buckets
    # escalate largest first (base -> q8 -> q4) until the plan fits.
    min_codec_bytes: int = 4096
    # Buckets whose per-lane f32 payload is below this keep the base
    # wire format.
    chunk: int = 1024
    # Elements per f32 scale of the integer codec; even (int4 packs two
    # levels a byte).
    error_feedback: str = "on"
    # "on" | "off": carry each bucket's quantization residual into the
    # next round's encode; "off" drops it.

    def __post_init__(self) -> None:
        if self.codec not in ("none", "qsgd"):
            raise ValueError(
                f"unknown comm codec {self.codec!r}; one of none|qsgd")
        if self.wire_dtype not in (None, "bfloat16", "float16"):
            raise ValueError(
                f"unknown comm wire_dtype {self.wire_dtype!r}; one of "
                "bfloat16|float16 (or None for the leaf dtype)")
        if self.byte_budget_mb < 0:
            raise ValueError(
                f"comm byte_budget_mb must be >= 0, got "
                f"{self.byte_budget_mb}")
        if self.min_codec_bytes < 0:
            raise ValueError(
                f"comm min_codec_bytes must be >= 0, got "
                f"{self.min_codec_bytes}")
        if self.chunk <= 0 or self.chunk % 2:
            raise ValueError(
                f"comm chunk must be a positive even count, got "
                f"{self.chunk}")
        if self.error_feedback not in ("on", "off"):
            raise ValueError(
                f"unknown comm error_feedback {self.error_feedback!r}; "
                "one of on|off")


@dataclass(frozen=True)
class PopulationConfig:
    """The client population (``dopt_torch.population``): each round a
    seeded, stateless sampler draws ``cohort`` clients from the eligible
    ones among ``clients`` host-side records, the cohort trains in
    ceil(cohort / lanes) waves of fixed-width lanes (validity as data),
    per-lane f32 partial sums accumulate across the waves and one
    bucketed reduce forms the aggregate.  Per-client state (shard,
    participation, staleness, screen streaks, quarantine) is keyed by
    client id.  ``None`` on ExperimentConfig keeps every path as it
    was."""

    clients: int = 1000
    # Population size P: the client records the registry holds.
    cohort: int = 64
    # Clients sampled a round (M); fewer when fewer are eligible — the
    # cohort size is data (lane validity), never a shape.
    seed: int | None = None
    # Cohort-sampler seed; None = the experiment seed.  Draws are keyed
    # by (seed, round) alone.
    lanes: int | None = None
    # Lane width of a wave; None = data.num_users (one lane a shard).


@dataclass(frozen=True)
class SeqLMConfig:
    """Sequence-parallel language-model training (``SeqLMTrainer``):
    a decoder-only TransformerLM on dopt's synthetic Markov corpus, the
    sequence axis split over the ranks, attention as a ring (KV blocks
    rotating rank to rank) or Ulysses (all-to-all head resharding) —
    exact, not approximate."""

    steps: int = 60
    batch: int = 8
    seq_len: int = 512       # divisible by the rank count
    vocab: int = 64
    dim: int = 128
    depth: int = 2
    heads: int = 4
    attn: str = "ring"       # ring | ulysses | dense (one rank)
    kv_chunk: int = 0
    # ring only: each ring block's KV in chunks of this size (flash-
    # style), so a rank's score memory is O(block·kv_chunk) instead of
    # O(block²).  0 = the whole block at once; must divide
    # seq_len / ranks.
    log_every: int = 10


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level experiment description (the notebook form cell, typed)."""

    name: str = "experiment"
    seed: int = 2022
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    gossip: GossipConfig | None = None
    federated: FederatedConfig | None = None
    faults: FaultConfig | None = None
    # Fault injection (crash, straggle, partition, corrupt, link faults,
    # churn), in both engines.
    robust: RobustConfig | None = None
    # Clipped gossip and quarantine (gossip); the robust aggregators,
    # clip_radius and quarantine (federated).
    comm: CommConfig | None = None
    # The scatter path's per-bucket wire schedule (codec, wire dtype,
    # byte budget); needs update_sharding="scatter".
    population: PopulationConfig | None = None
    # The client population: cohorts sampled from a client registry
    # (federated: the wave loop; gossip: the cohort→lane binding).
    seqlm: SeqLMConfig | None = None
    # The sequence-parallel LM (SeqLMTrainer); the gossip and federated
    # trainers refuse it.
    backend: str = "jax"
    # dopt's engine switch: "jax" is dopt's engine, which the port takes
    # to mean its own; "torch" (dopt's sequential CPU oracle) is refused.
    mesh_devices: int | None = None
    mesh_hosts: int | None = None
    # Ranks the worker axis spreads over, and dopt's hybrid host axis
    # (dopt_torch.parallel.engine_group): None takes the launched
    # torch.distributed world (one rank without one), 1 one GPU; more
    # must equal the world, which must divide the workers.

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    @property
    def num_users(self) -> int:
        return self.data.num_users


def from_reference_args(args: Mapping[str, Any]) -> ExperimentConfig:
    """An ``ExperimentConfig`` from a reference-style flat args dict,
    dopt's mapping: the notebooks' key names (num_users, local_ep,
    local_bs, lr, momentum, model, dataset, iid, shards, rho, seed,
    topology, mode, frac, rounds, eps), so published experiment
    dictionaries replay verbatim.  A usable ``topology`` (or
    ``paradigm="gossip"``) makes a gossip config, anything else a
    federated one; keys whose value is None take the default."""
    def _get(key: str, default):
        v = args.get(key)
        return default if v is None else v

    model_name = str(_get("model", "")).lower()
    dataset = str(_get("dataset", "mnist")).lower()
    num_classes = 10
    if dataset in ("cifar", "cifar10"):
        dataset = "cifar10"
        input_shape: tuple[int, ...] = (32, 32, 3)
        default_model = "model3"
    elif dataset == "cifar100":
        input_shape = (32, 32, 3)
        default_model = "model3"
        num_classes = 100
    elif dataset == "a9a":
        input_shape = (123,)   # LIBSVM a9a: 123 binary features, 2 classes
        default_model = "logistic"
        num_classes = 2
    elif dataset == "synthetic":
        input_shape = tuple(_get("input_shape", (28, 28, 1)))
        default_model = "mlp"
    else:
        input_shape = (28, 28, 1)
        default_model = "model1"
    if model_name in ("", "none"):
        model_name = default_model
    if args.get("unequal"):
        raise ValueError(
            "unequal splits are not supported (the reference has none; "
            "both its partitioner families produce equal-size shards)")
    data = DataConfig(dataset=dataset, iid=bool(_get("iid", True)),
                      shards=int(_get("shards", 2)),
                      num_users=int(_get("num_users", 8)),
                      data_dir=args.get("data_dir"))
    model = ModelConfig(model=model_name, num_classes=num_classes,
                        input_shape=input_shape,
                        faithful=bool(_get("faithful", True)))
    optim = OptimizerConfig(lr=float(_get("lr", 0.01)),
                            momentum=float(_get("momentum", 0.5)),
                            rho=float(_get("rho", 0.1)),
                            optimizer=str(_get("optimizer", "sgd")))
    federated = gossip = None
    # Reference form cells carry unused keys with value None: route on a
    # usable topology value, not on the key's presence.
    if args.get("topology") or str(_get("paradigm", "")) == "gossip":
        gossip = GossipConfig(algorithm=str(_get("algorithm", "dsgd")),
                              topology=str(_get("topology", "circle")),
                              mode=str(_get("mode", "stochastic")),
                              rounds=int(_get("rounds", 10)),
                              local_ep=int(_get("local_ep", 4)),
                              local_bs=int(_get("local_bs", 128)),
                              eps=int(_get("eps", 1)))
    else:
        federated = FederatedConfig(algorithm=str(_get("algorithm", "fedavg")),
                                    frac=float(_get("frac", 0.1)),
                                    rounds=int(_get("rounds", 20)),
                                    local_ep=int(_get("local_ep", 10)),
                                    local_bs=int(_get("local_bs", 50)))
    return ExperimentConfig(name=str(args.get("name", "experiment")),
                            seed=int(args.get("seed", 2022)), data=data,
                            model=model, optim=optim, federated=federated,
                            gossip=gossip)


def exp_details(cfg: ExperimentConfig) -> str:
    """Human-readable config dump, dopt's character for character (the
    reference's ``exp_details``): the name, seed and backend, then every
    field of each section that is set."""
    lines = [f"Experiment: {cfg.name}", f"  seed      : {cfg.seed}",
             f"  backend   : {cfg.backend}"]
    for section in ("data", "model", "optim", "federated", "gossip", "faults",
                    "robust", "population", "comm"):
        sub = getattr(cfg, section)
        if sub is None:
            continue
        lines.append(f"  [{section}]")
        for f in dataclasses.fields(sub):
            lines.append(f"    {f.name:12s}: {getattr(sub, f.name)}")
    return "\n".join(lines)
