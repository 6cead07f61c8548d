"""Server-coordinated federated training: the port's
``FederatedTrainer``.

Counterpart of dopt/engine/federated.py (the reference's project 1):
FedAvg, FedProx, FedADMM and SCAFFOLD with partial participation, the
fleet as one ``[W, ...]`` stacked state.  Each round samples
m = max(int(frac·W), 1) clients from dopt's seeded stream, trains them
from the global model theta for ``local_ep`` epochs, screens out lanes
whose update is not finite, and re-forms theta as the mean of the
survivors.  Unsampled clients keep their stale params and momentum, as
the reference's lifetime client optimizers do.

Three execution paths, same math up to float summation order:

* full width — all W lanes train (the unsampled ones from their own
  params) and a 0/1 mask discards what the aggregate must not see;
* compact (auto when frac < 1) — only the m sampled lanes are gathered
  into ``[m, ...]`` tensors, trained and scattered back;
* fused epilogue (``federated.fused_update="on"``, fedavg/fedprox, full
  width) — theta lives as the ``[W, ...]`` broadcast slab in a flat
  bucket store, and the masked mean plus the theta update are ONE pass
  of CUDA kernel 2 per bucket: θ'_b = M(mask)·disp + θ_b, with the
  displacement store as kernel 2's ``p`` and the slab as its ``buf`` at
  lr = −1; the new slab is then copied back into the slab store (one
  store copy a round, instead of swapping the two stores' roles: a
  captured round must find every state at the address it was captured
  with, and one graph then serves every round).

``federated.comm_dtype`` narrows the masked-mean reduce's wire: the f32
partial sum is rounded once to that dtype (``masked_average``), as
dopt's one-device mesh does.  It forces the full-width path (the
compact mean has no cross-worker collective to narrow) and refuses an
explicit ``compact=True``, the fused epilogue, the robust aggregators
and the staleness buffer, in dopt's words.

``federated.update_sharding="scatter"`` runs the masked mean over flat
buckets (``masked_average_scatter``: the f32 masked partial sum, a
reduce-scatter over the flat axis, the divide on the shard, one
all-gather — on one GPU no collective is issued), at the full width;
``comm.wire_dtype`` (``cfg.comm``, codec "none" only) narrows its
partial sums.  It refuses the robust aggregators, the staleness buffer,
``compact=True`` and the fused epilogue, in dopt's words.

Across ranks (``mesh_devices``; ``dopt_torch.parallel.engine_group``)
each rank holds and trains its L = W/R lanes of the params, momentum,
duals or controls and the staleness buffer; theta, SCAFFOLD's server
control and the device counters are replicated; every host draw is
dopt's whole ``[W]`` draw of which the rank takes its rows.  The screen's
flags, the eval metrics and the local losses are all-gathered, the
masked mean sums the ranks' partial sums in rank order, and the robust
aggregators, the staleness sum and the diagnostics read the gathered
updates, so theta and the History are the same on every rank.  The
full width runs (compact sampling is off across ranks, as in dopt), the
fused epilogue is refused in dopt's words, and a block's rounds run
eagerly.  Population mode trains each rank's lanes of every wave and
reduces over the same ranks.

History rows are P1's: round, test_acc, test_loss (the global model on
the test set, P1's summed loss), train_loss, train_acc (every client's
own model on its own train split), local_loss (the survivors' mean
training loss).  Each round makes one device→host fetch.

A round is a host *stage* (the client sample — drawn on the caller's
thread, in round order — the batch plan, the mask and selection and
their upload) and a device *body* (local phase, screen, aggregation,
evals) that writes every carried state in place and its metrics into a
static slot.  ``federated.block_rounds`` > 1 runs blocks of rounds as
CUDA-graph replays of the body with one fetch a block
(``dopt_torch.engine.graphs``; eagerly on the CPU), bit-identical to the
per-round run, and ``federated.prefetch="on"`` builds the next block
while the current one runs (``dopt_torch.data.prefetch``).
``save``/``restore`` and ``run(checkpoint_every=, checkpoint_path=)``
checkpoint the whole state, the client-sampling stream included, as
``GossipTrainer``'s do.

The fault model (dopt/engine/federated.py:126-300, :922-1215,
:1269-1397, :1526-1840, :2055-2414), from ``cfg.faults``
(``dopt_torch.faults.FaultPlan``) and ``cfg.robust``:

* participation — each round's sample passes dopt's host elif-chain
  (quarantine > churn > crash > partition, where only group 0 reaches
  the server > ``drop``-policy straggler > uplink drop > uplink delay >
  survivor) in draw order; with ``over_select`` the server draws
  ceil(m·(1+over_select)) clients, keeps the first m survivors and
  releases the rest.  A fault-free round is the sorted draw, so the
  sampling stream is dopt's and the fault-free port's byte for byte;
* ``partial`` stragglers — a ``[W]`` step budget gates the local steps
  (kernel 1's gated launch on the fused path);
* corrupt — the liars' updates (and, for fedadmm/scaffold, their
  companion state) are rewritten around theta (``corrupt_update`` with
  ``ref``/``prev``: nan, inf, scale, signflip, stale) before the
  non-finite screen, which runs on every round;
* defenses — ``robust.clip_radius`` clips each lane's deviation from
  theta (``clip_to_ball``), ``robust.aggregator`` replaces the masked
  mean (trimmed mean, median, Krum, multi-Krum), and
  ``robust.quarantine_after`` benches a client after that many
  screened participations for ``quarantine_rounds``;
* staleness (``federated.staleness_max`` > 0) — deadline-dropped
  stragglers and delayed uplinks train anyway, their update is captured
  into the ``[W, ...]`` buffer ``stale_p`` and admitted d rounds later at
  weight ``staleness_decay``^d.

Telemetry and ``federated.diagnostics="on"`` as ``GossipTrainer``'s:
the bundle after each round's fetch, the six gauges (the sixth the lane
dispersion mean_i ||p_i − theta||) computed inside the round.

Population mode (``cfg.population``, dopt :296-385, :1398-1500,
:1841-2063): the clients are a host registry of P records
(``dopt_torch.population.ClientRegistry``), not the lanes.  Each round
samples a cohort from the eligible clients (stateless per (seed,
round)), runs dopt's client-keyed participation chain
(``_cohort_participation``), binds the survivors onto ceil(cohort /
lanes) waves of ``population.lanes`` lanes, and trains the waves in
order from theta with zero momentum (kernel 1 every step); each lane's
f32 partial sum accumulates across the waves, the screened and padding
lanes zeroed first, and one bucketed reduce (``masked_average_scatter``
with the cohort weight as denominator) forms theta.  ``frac`` and
``block`` do not apply; ``prefetch="on"`` stages the next round's draw
and plans.  History rows gain dopt's ``cohort`` and ``population``
columns (train_loss/train_acc are the cohort's local means), and the
registry rides in the checkpoint (``population_registry``).

The compact path pads the survivors to the static m lanes with a
validity mask (``_fixed_width_sel``), so every faulted compact round has
one shape.  Blocked runs with quarantine or staleness run the *chaos*
round: participation is decided on the device from the pre-drawn
candidates and the stateless fault vectors, the streak, sentence and
admission counters are device state, and after the block's fetch the
host replays the same integer rule for the ledger (``history.faults``,
dopt's rows in dopt's order) and checks the device counters against its
mirrors round by round.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from dopt_torch.config import ExperimentConfig
from dopt_torch.data import (PrefetchStager, make_batch_plan, ready,
                             stacked_eval_batches, upload)
from dopt_torch.convert import port_layout
from dopt_torch.engine.gossip import (DTYPES, check_checkpoint_args,
                                      checkpoint_meta, initial_params,
                                      load_device_data, rank_state,
                                      refuse_fused_across_ranks,
                                      refuse_membership_population,
                                      resolve_device, restore_meta,
                                      save_rank_checkpoint, serve_rounds,
                                      steps_per_round, validate_common)
from dopt_torch.engine.graphs import RoundGraphs, run_blocked
from dopt_torch.engine.local import (local_steps, stacked_eval_gathered,
                                     stacked_evaluate)
from dopt_torch.faults import (FaultPlan, churn_ledger_rows, corrupt_update,
                               validate_fault_config)
from dopt_torch.models.zoo import deterministic, full_f32, stacked_forward
from dopt_torch.obs import consensus_distance
from dopt_torch.obs.events import DIAG_GAUGES, finite_diag_gauges
from dopt_torch.ops.fused_update import fused_mix_update
from dopt_torch.optim import (admm_dual_ascent, grad_edit, rounded,
                              scaffold_control_update, scaffold_scale)
from dopt_torch.parallel.collectives import (alloc_flat, broadcast_to_workers,
                                             flat_views, lane_sum,
                                             make_update_shard_spec,
                                             masked_average,
                                             masked_average_scatter,
                                             mean_weight_matrix, where_mask,
                                             wire_dtype)
from dopt_torch.parallel.mesh import (engine_group, gather_workers,
                                      launched_world, make_worker_group,
                                      shard_worker_tree)
from dopt_torch.population import (ClientRegistry, population_gauges,
                                   restore_registry,
                                   validate_population_config)
from dopt_torch.robust import (clip_to_ball, finite_lane_mask,
                               global_norm_f32, lane_sq_norms,
                               make_aggregator, masked_mean,
                               validate_robust_config)
from dopt_torch.utils.checkpoint import (copy_into, load_checkpoint,
                                         meta_expect)
from dopt_torch.utils.metrics import History
from dopt_torch.utils.prng import host_rng
from dopt_torch.utils.profiling import (CompileWatcher, PhaseTimers,
                                        emit_device_resource)

_LOCAL_ALGORITHM = {"fedavg": "sgd", "fedprox": "fedprox",
                    "fedadmm": "fedadmm", "scaffold": "scaffold"}


def produces_late(cfg: ExperimentConfig) -> bool:
    """Whether the fault config makes late updates (``drop``-policy
    stragglers or uplink delays) for the staleness buffer to capture."""
    fc = cfg.faults
    return fc is not None and ((fc.straggle > 0
                                and fc.straggler_policy == "drop")
                               or fc.msg_delay > 0)


def validate_federated(cfg: ExperimentConfig) -> None:
    """Refuse every configuration the federated engine does not run, and
    make dopt's own refusals
    (dopt/engine/federated.py:126-300, :551-600, :1783-1792) in dopt's
    words: a robust aggregator, staleness or compact sampling with
    ``comm_dtype``, staleness with a stateful algorithm or a robust
    aggregator, compact sampling with staleness, and the fused epilogue
    with companion state, compact sampling, a robust aggregator,
    ``clip_radius``, corrupt faults, staleness or ``comm_dtype``."""
    f = cfg.federated
    if f is None:
        raise ValueError("cfg.federated must be set for FederatedTrainer")
    validate_common(cfg)
    if f.algorithm not in _LOCAL_ALGORITHM:
        raise ValueError(f"unknown federated algorithm {f.algorithm!r}")
    if f.update_sharding not in ("off", "scatter"):
        raise ValueError(f"unknown update_sharding {f.update_sharding!r}; "
                         "one of off|scatter")
    for knob in ("prefetch", "diagnostics", "fused_update"):
        if getattr(f, knob) not in ("off", "on"):
            raise ValueError(f"unknown {knob} {getattr(f, knob)!r}; one of "
                             "off|on")
    fc, rc = cfg.faults, cfg.robust
    if fc is not None:
        validate_fault_config(fc)
    if rc is not None:
        validate_robust_config(rc)
    aggregator = rc.aggregator if rc is not None else "mean"
    clip_radius = rc.clip_radius if rc is not None else 0.0
    has_corrupt = fc is not None and fc.corrupt > 0
    if aggregator != "mean" and f.comm_dtype:
        raise ValueError(
            "comm_dtype wire compression only applies to the masked-"
            f"mean reduce; aggregator={aggregator!r} is a full-"
            "precision robust statistic — drop one of the two")
    if f.update_sharding == "scatter":
        if aggregator != "mean":
            raise ValueError(
                "update_sharding='scatter' shards the masked-MEAN "
                f"reduce; aggregator={aggregator!r} is a full-"
                "precision robust statistic over whole updates — "
                "drop one of the two")
        if f.staleness_max > 0:
            raise ValueError(
                "update_sharding='scatter' does not compose with "
                "staleness-aware aggregation (its decay-weighted "
                "sum runs on the unsharded tree) — drop one of "
                "the two")
        if f.compact:
            raise ValueError(
                "update_sharding='scatter' is a full-width sharded "
                "reduce; FederatedConfig.compact gathers m lanes "
                "and has no cross-worker collective to shard — "
                "drop one of the two")
    comm = cfg.comm
    if comm is not None:
        if f.update_sharding != "scatter":
            raise ValueError(
                "the comm substrate schedule (ExperimentConfig.comm) "
                "speaks the flat-bucket wire of "
                "update_sharding='scatter'; set "
                "federated.update_sharding='scatter' to arm it "
                f"(got update_sharding={f.update_sharding!r})")
        if comm.codec != "none":
            raise ValueError(
                f"comm.codec={comm.codec!r} needs a stable "
                "per-lane error-feedback residual across rounds; "
                "the federated round re-binds sampled clients onto "
                "lanes, so run the codec on the gossip engine and "
                "use comm.wire_dtype for federated wire narrowing")
        if f.comm_dtype and comm.wire_dtype:
            raise ValueError(
                f"federated.comm_dtype={f.comm_dtype!r} and "
                f"comm.wire_dtype={comm.wire_dtype!r} both name "
                "a wire dtype; set exactly one (comm.wire_dtype is "
                "the substrate-schedule spelling of the same knob)")
    if f.staleness_max < 0:
        raise ValueError("FederatedConfig.staleness_max must be >= 0")
    if not 0.0 < f.staleness_decay <= 1.0:
        raise ValueError(
            f"FederatedConfig.staleness_decay={f.staleness_decay} "
            "must be in (0, 1]")
    if f.staleness_max > 0:
        if f.algorithm not in ("fedavg", "fedprox"):
            raise ValueError(
                "staleness-aware aggregation needs a stateless-"
                "client algorithm (fedavg|fedprox): SCAFFOLD/ADMM "
                "companion state has no late-admission semantics")
        if aggregator != "mean":
            raise ValueError(
                "staleness-aware aggregation is a weighted mean; "
                f"it does not compose with aggregator="
                f"{aggregator!r} (selection/trimming have no "
                "decayed-weight form here) — drop one of the two")
        if f.comm_dtype:
            raise ValueError(
                "comm_dtype wire compression only applies to the "
                "masked-mean reduce; the staleness-weighted "
                "aggregate runs its own full-precision sum — drop "
                "one of the two")
    wire_dtype(f.comm_dtype)
    if f.fused_update == "on":
        if f.algorithm not in ("fedavg", "fedprox"):
            raise ValueError(
                "fused_update='on' fuses the masked-mean contraction "
                f"with the theta update; algorithm {f.algorithm!r} "
                "carries companion state (SCAFFOLD controls / ADMM "
                "duals) through the aggregate, which the fused "
                "epilogue does not yet speak (fedavg|fedprox)")
        if aggregator != "mean":
            raise ValueError(
                "fused_update='on' only applies to the masked-mean "
                f"reduce; aggregator={aggregator!r} is a full-"
                "precision robust contraction with no mixing-matrix "
                "form — drop one of the two")
        if clip_radius > 0:
            raise ValueError(
                "fused_update='on' does not compose with "
                "RobustConfig.clip_radius (the ball projection "
                "applies per lane BETWEEN the local step and the "
                "mean, so the displacement contraction would skip "
                "it) — drop one of the two")
        if has_corrupt:
            raise ValueError(
                "fused_update='on' does not compose with corrupt "
                "faults (the Byzantine injection rewrites lane "
                "updates between the local step and the aggregate; "
                "the robust defenses that make that meaningful are "
                "unfused) — drop one of the two")
        if f.staleness_max > 0:
            raise ValueError(
                "fused_update='on' does not compose with staleness-"
                "aware aggregation (the admit-weighted sum over the "
                "late buffer is not a masked mean) — drop one of "
                "the two")
        if f.update_sharding == "scatter":
            raise ValueError(
                "update_sharding='scatter' already restructures the "
                "aggregation hot path; fused_update='on' is the "
                "single-device fusion of the same epilogue — drop "
                "one of the two")
        if f.comm_dtype:
            raise ValueError(
                "comm_dtype wire compression only applies to the "
                "plain masked-average collective; the fused "
                "epilogue contracts at f32 in one HBM pass — drop "
                "one of the two")
        if f.compact:
            raise ValueError(
                "FederatedConfig.compact=True is incompatible with "
                "fused_update='on': the fused epilogue contracts "
                "the full [W, ...] slab (compact's gathered-lane "
                "mean has no fixed-width contraction) — drop one "
                "of the two")
    if f.staleness_max > 0 and produces_late(cfg) and f.compact:
        raise ValueError(
            "FederatedConfig.compact=True is incompatible with "
            "staleness-aware aggregation (captured lanes train "
            "outside the sampled set) — drop one of the two")
    if f.comm_dtype and f.compact:
        # dopt refuses it at its first round; the compact path's mean
        # has no cross-worker collective to narrow.
        raise ValueError(
            "FederatedConfig.compact=True is incompatible with "
            "comm_dtype (the compact path has no cross-worker "
            "collective to compress)")
    if cfg.population is not None:
        validate_population_federated(cfg)


def validate_population_federated(cfg: ExperimentConfig) -> None:
    """dopt's refusals of population mode (dopt/engine/federated.py:
    309-385, :412-428, :604-608), in dopt's words and order: a stateful
    algorithm, the holdout, compact sampling, staleness, ``comm_dtype``,
    scatter, a robust aggregator, a host axis, stale lies, lanes that
    do not fold onto the ranks, diagnostics, prefetch with the client
    quarantine and the fused epilogue."""
    f, rc, pop = cfg.federated, cfg.robust, cfg.population
    validate_population_config(pop)
    aggregator = rc.aggregator if rc is not None else "mean"
    has_corrupt = cfg.faults is not None and cfg.faults.corrupt > 0
    if f.algorithm not in ("fedavg", "fedprox"):
        raise ValueError(
            "population mode needs a stateless-client algorithm "
            f"(fedavg|fedprox): {f.algorithm!r} carries "
            "per-client companion state no registry row can hold")
    if cfg.data.local_holdout > 0:
        raise ValueError(
            "population mode is incompatible with the local "
            "train/val holdout (per-epoch client history needs "
            "persistent per-client state) — drop one of the two")
    if f.compact:
        raise ValueError(
            "FederatedConfig.compact=True is incompatible with "
            "population mode (the wave loop IS the compact "
            "execution: fixed-width lanes, validity as data)")
    if f.staleness_max > 0:
        raise ValueError(
            "population mode does not compose with staleness-"
            "aware aggregation (the one-slot-per-WORKER buffer "
            "has no per-client form) — drop one of the two")
    if f.comm_dtype:
        raise ValueError(
            "population mode's hierarchical reduce is its own "
            "wire path; comm_dtype applies to the plain masked-"
            "mean reduce only — drop one of the two")
    if f.update_sharding == "scatter":
        raise ValueError(
            "population mode always aggregates via the bucketed "
            "scatter flat-tree path; keep update_sharding='off' "
            "(the knob only retargets the lane engines)")
    if aggregator != "mean":
        raise ValueError(
            "population mode streams per-wave partial SUMS; "
            f"aggregator={aggregator!r} needs every update "
            "materialised at once — drop one of the two")
    if cfg.mesh_hosts:
        raise ValueError(
            "population mode runs its reduce over a flat 1-D "
            "worker mesh; hybrid (hosts × ici) meshes are not "
            "supported")
    if has_corrupt and cfg.faults.corrupt_mode == "stale":
        raise ValueError(
            "corrupt_mode='stale' replays the worker's previous "
            "update; population clients are stateless (no "
            "previous update exists) — use nan|inf|scale|"
            "signflip")
    w = cfg.data.num_users
    lanes = int(pop.lanes or w)
    size = 1 if cfg.mesh_devices == 1 else launched_world()
    if lanes % size or w % size:
        raise ValueError(
            f"population lanes={lanes} and data.num_users={w} "
            f"must both divide the {size}-device mesh")
    if f.diagnostics == "on":
        raise ValueError(
            "diagnostics='on' does not compose with population mode "
            "(wave clients are stateless — there is no lane-carried "
            "momentum/params for the convergence diagnostics to "
            "measure) — drop one of the two")
    if f.prefetch == "on" and rc is not None and rc.quarantine_after > 0:
        raise ValueError(
            "prefetch='on' does not compose with population-mode "
            "client quarantine: round t+1's cohort eligibility "
            "depends on round t's screen feedback, which only "
            "exists after the fetch — drop one of the two")
    if f.fused_update == "on":
        raise ValueError(
            "fused_update='on' does not compose with population "
            "mode (waves accumulate into an f32 lane "
            "accumulator, not a masked mean over the carried "
            "slab) — drop one of the two")


def round_diag(p_lanes: dict[str, torch.Tensor],
               p_start: dict[str, torch.Tensor],
               m_new: dict[str, torch.Tensor],
               theta_new: dict[str, torch.Tensor],
               p_fleet: dict[str, torch.Tensor], losses: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """The round's [6] f32 diagnostics on the device (dopt's federated
    ``round_diag``, federated.py:827-870): the L2 norm of the
    aggregating lanes' displacement from their round-start load
    (``mask``: a screened lane reverts to its stale params, a compact
    padding lane is out), of the carried momentum and of the new global
    model; the aggregating lanes' train-loss mean and max − min spread
    (lanes with a non-finite loss left out); and the fleet dispersion
    mean_i ||p_i − theta|| over every carried lane.  ``p_start`` may
    lack the lane axis (the compact round starts every lane at
    theta)."""
    upd = (lane_sq_norms({k: p_lanes[k].float() - p_start[k].float()
                          for k in p_lanes}) * mask).sum().sqrt()
    lane = losses.mean(1).float()
    okl = mask * torch.isfinite(lane)
    on = okl > 0
    lmean = torch.where(on, lane, 0.0).sum() / okl.sum().clamp_min(1.0)
    spread = torch.where(okl.sum() > 0,
                         torch.where(on, lane, -math.inf).max()
                         - torch.where(on, lane, math.inf).min(), 0.0)
    sq = None
    for k in sorted(p_fleet):
        x = p_fleet[k].float()
        d = (x - theta_new[k].float()[None]).reshape(x.shape[0], -1)
        s = (d * d).sum(1)
        sq = s if sq is None else sq + s
    return torch.stack([upd, global_norm_f32(m_new),
                        global_norm_f32(theta_new), lmean, spread,
                        sq.sqrt().mean()])


def _lanes(tree: dict[str, torch.Tensor], m: int) -> dict[str, torch.Tensor]:
    """m fresh contiguous copies of a single model, as ``[m, ...]``."""
    return {k: x.repeat(m, *([1] * x.dim())) for k, x in tree.items()}


def _pad_lanes(x: torch.Tensor, w: int) -> torch.Tensor:
    """``x`` ([m, ...]) zero-padded along its lane axis to w lanes."""
    if x.shape[0] == w:
        return x
    return torch.cat([x, x.new_zeros((w - x.shape[0],) + x.shape[1:])])


class FederatedTrainer:
    """FedAvg / FedProx / FedADMM / SCAFFOLD over ``cfg.data.num_users``
    clients, under dopt's fault model, on one device or over the ranks
    of a ``torch.distributed`` group (``mesh_devices``).

    ``device`` defaults to CUDA and raises where there is none; pass
    ``device="cpu"`` to run on the CPU (the kernels' plain versions).
    ``init_params`` takes one worker's dopt params tree (numpy leaves) so
    a run can start at dopt's exact init.  ``eval_train=False`` skips the
    per-client train-split eval (the History's train_loss/train_acc are
    then 0).  SCAFFOLD's client controls are a ``[W, ...]`` state like
    the ADMM duals (``self.duals``); its server control is
    ``self.c_global``; sampled SCAFFOLD clients start from a fresh zero
    momentum and refresh their control with the step size
    lr/(1 − momentum) over the steps they executed.  Takes
    ``model.compute_dtype``, ``model.param_dtype`` and
    ``optim.clip_norm`` as ``GossipTrainer`` does; with bf16 storage
    theta, the slab, the displacement store, momentum, duals, controls
    and the staleness buffer are all bf16.  On CUDA ``run`` and the
    evals run in full f32 and in the deterministic mode, as
    ``GossipTrainer``'s do.
    """

    engine_kind = "federated"

    def __init__(self, cfg: ExperimentConfig, *, device=None,
                 init_params=None, eval_train: bool = True,
                 membership=None):
        refuse_membership_population(cfg, membership)
        validate_federated(cfg)
        self.device = dev = resolve_device(device)
        f = cfg.federated
        self.cfg = cfg
        self.eval_train = eval_train
        self.round = 0
        self.history = History(cfg.name)
        # Per-epoch per-client rows, filled when the holdout is on: P1's
        # Client.history {global_round, epoch, train_loss, train_acc,
        # val_acc, val_loss (summed flavour)} plus a worker column, for
        # the round's surviving sampled clients only.
        self.client_history = History(cfg.name + "-clients")
        w = self.num_workers = cfg.data.num_users
        # Telemetry (``dopt_torch.obs.attach``) and the serve-mode hooks
        # (``dopt_torch.serve``), as GossipTrainer's.
        self.timers = PhaseTimers()
        self.telemetry = None
        self._suppress_run_summary = False
        self.checkpoint_writer = True
        self._membership = membership
        self._diag = f.diagnostics == "on"
        self._diag_keys = DIAG_GAUGES + ("lane_dispersion",)
        self._compile_watch = CompileWatcher()
        self._last_step_total = 0.0

        # The worker axis over ranks (dopt's make_worker_mesh): this rank
        # holds lanes [lane0, lane0 + L) of the W clients; theta and the
        # server state are replicated, every host draw is dopt's whole
        # [W] draw, of which the rank takes its rows.
        self.group = engine_group(w, cfg.mesh_devices, cfg.mesh_hosts)
        self.lanes = lanes = self.group.lanes
        if f.fused_update == "on":
            refuse_fused_across_ranks(self.group)
        load_device_data(self, cfg, dev, local_bs=f.local_bs,
                         group=self.group)
        self.steps_per_round = steps_per_round(self._train_matrix,
                                               f.local_bs, f.local_ep)
        ti, tw = stacked_eval_batches(self._train_matrix,
                                      batch_size=max(f.local_bs, 256))
        ti, tw = shard_worker_tree((ti, tw), self.group)
        self._train_eval = (
            torch.from_numpy(np.ascontiguousarray(ti, np.int64)).to(dev),
            torch.from_numpy(np.ascontiguousarray(tw)).to(dev))

        p0 = {k: v.to(dev) for k, v in initial_params(cfg,
                                                      init_params).items()}
        self.param_count = sum(v.numel() for v in p0.values())
        self.params = {k: v.requires_grad_(True)
                       for k, v in _lanes(p0, lanes).items()}
        zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
        self.momentum = _lanes(zeros, lanes)
        self.duals = (_lanes(zeros, lanes)
                      if f.algorithm in ("fedadmm", "scaffold") else None)
        self.c_global = zeros if f.algorithm == "scaffold" else None
        self._setup_faults(zeros)
        # The scatter path's flat bucket plan; comm.wire_dtype narrows
        # its reduce.
        self._setup_population(p0)
        if f.update_sharding == "scatter" and not self.group.flat:
            raise ValueError(
                "update_sharding='scatter' needs a flat 1-D worker "
                f"mesh (got {self.group.shape}); hybrid (hosts × "
                "ici) meshes keep the dense path")
        self.scatter_spec = (make_update_shard_spec(
            self.momentum, fold=self.group.size,
            bucket_bytes=int(f.update_bucket_mb * (1 << 20)))
            if f.update_sharding == "scatter" else None)
        if cfg.comm is not None and cfg.comm.wire_dtype:
            self._comm_dtype = wire_dtype(cfg.comm.wire_dtype)

        self._fused_on = f.fused_update == "on"
        self.fused_spec = None
        if self._fused_on:
            self.fused_spec = make_update_shard_spec(
                self.momentum,
                bucket_bytes=int(f.update_bucket_mb * (1 << 20)))
            self._theta_flat = alloc_flat(w, self.fused_spec, dev)
            self._disp_flat = alloc_flat(w, self.fused_spec, dev)
            for k, v in flat_views(self._theta_flat, self.fused_spec).items():
                v.copy_(p0[k])
            self.theta = None
        else:
            self.theta = p0
        self._sample_rng = host_rng(cfg.seed, 314159)
        # The local phase's scalars, rounded to the storage dtype once
        # here: lr and μ (the unfused update), rho (the edits) and
        # SCAFFOLD's refresh factor 1/(K·lr_eff).
        o = cfg.optim
        lr_eff = o.lr / max(1.0 - o.momentum, 1e-8)
        for x in (o.lr, o.momentum, o.rho,
                  scaffold_scale(lr_eff, self.steps_per_round)):
            rounded(float(x), DTYPES[cfg.model.param_dtype])
        # The round's packed metrics: local loss, test acc, test loss,
        # train loss, train acc, the [W] screened flags, then (staleness)
        # the [W] screened-on-admission flags, (holdout) the [4, W, E]
        # epoch rows of the lanes, (quarantine or staleness) the chaos
        # round's device counters and, last, the [6] diagnostics block
        # (``diagnostics="on"``).
        width = (5 + w + (w if self._has_stale else 0)
                 + (4 * w * f.local_ep if self._val is not None else 0)
                 + len(self._counters()) * w
                 + (len(self._diag_keys) if self._diag else 0))
        self._slot = torch.zeros(width, device=dev)
        # Across ranks the block's rounds run eagerly (see graphs.py).
        self.graphs = RoundGraphs(self._body, self._slot,
                                  eager=self.group.wire)

    def _setup_faults(self, zeros: dict[str, torch.Tensor]) -> None:
        """The fault plan, the robust layer and its host mirrors, the
        staleness schedule, and their device state: the ``[W, ...]``
        staleness buffer and the chaos round's counters (streak and
        sentence, and under staleness the admission round and weight),
        all written in place."""
        cfg, f, w, dev = self.cfg, self.cfg.federated, self.num_workers, \
            self.device
        self.faults = FaultPlan(w, cfg.faults, seed=cfg.seed,
                                membership=self._membership)
        fc = cfg.faults
        self._may_straggle = (self.faults.may_straggle
                              and fc.straggler_policy == "partial")
        self._has_corrupt = self.faults.has_corrupt
        rc = cfg.robust
        aggregator = rc.aggregator if rc is not None else "mean"
        self._clip = rc.clip_radius if rc is not None else 0.0
        self._agg_robust = (make_aggregator(
            aggregator, trim_frac=rc.trim_frac, krum_f=rc.krum_f,
            multi_krum_m=rc.multi_krum_m) if aggregator != "mean" else None)
        # Population mode's quarantine is the registry's, keyed by
        # client; the lane-keyed one stays off.
        self._quarantine_on = bool(rc is not None and rc.quarantine_after > 0
                                   and cfg.population is None)
        self._quarantine_after = rc.quarantine_after if rc else 0
        self._quarantine_rounds = rc.quarantine_rounds if rc else 0
        self._screen_streak = np.zeros(w, np.int64)
        self._quarantine_until = np.zeros(w, np.int64)
        self._staleness_max = f.staleness_max
        self._staleness_decay = f.staleness_decay
        self._has_stale = f.staleness_max > 0 and produces_late(cfg)
        self._comm_dtype = wire_dtype(f.comm_dtype)
        self._stale_admit_round = np.zeros(w, np.int64)
        self._stale_weight = np.zeros(w, np.float64)
        self._stale_origin = np.zeros(w, np.int64)
        # Straggler budgets count epochs under the holdout's epoch loop
        # and SGD steps otherwise (dopt :662-665).
        self._straggle_units = (f.local_ep if self._val is not None
                                else self.steps_per_round)
        self._chaos = self._quarantine_on or self._has_stale
        self._stale_p = ({k: torch.zeros((self.lanes,) + v.shape,
                                         dtype=v.dtype, device=dev)
                          for k, v in zeros.items()}
                         if self._has_stale else None)
        if self._chaos:
            self._dev_streak = torch.zeros(w, dtype=torch.int32, device=dev)
            self._dev_until = torch.zeros(w, dtype=torch.int32, device=dev)
        if self._has_stale:
            self._dev_admit = torch.zeros(w, dtype=torch.int32, device=dev)
            self._dev_weight = torch.zeros(w, device=dev)
            # f32(f64 decay**d) per d: the value the host admission gives
            # through np.float32(self._stale_weight[i]).
            self._decay_pow = torch.tensor(
                [np.float32(float(f.staleness_decay) ** d)
                 for d in range(max(self._staleness_max, 1) + 1)],
                dtype=torch.float32, device=dev)

    def _setup_population(self, p0: dict[str, torch.Tensor]) -> None:
        """Population mode (dopt :296-385, :502-515): the client registry
        with its client-keyed fault plan and quarantine, the wave width
        (``population.lanes``, default ``num_users``), the reduce's
        worker group and the flat bucket plan of the f32 ``[lanes, ...]``
        accumulator — the weighted sums accumulate at full precision
        whatever ``param_dtype`` is."""
        cfg, f = self.cfg, self.cfg.federated
        self._registry = None
        pop = cfg.population
        if pop is None:
            return
        lanes = int(pop.lanes or self.num_workers)
        self._registry = ClientRegistry(
            pop, num_shards=self.num_workers, seed=cfg.seed,
            faults=cfg.faults, robust=cfg.robust, lanes=lanes)
        # Across ranks each rank trains its contiguous lanes of every
        # wave, and the reduce runs over the same ranks.
        self._pop_group = make_worker_group(lanes, self.group.group,
                                            meter=self.group.meter)
        self._pop_spec = make_update_shard_spec(
            {k: torch.zeros((lanes,) + v.shape, dtype=torch.float32,
                            device="meta") for k, v in p0.items()},
            fold=self._pop_group.size,
            bucket_bytes=int(f.update_bucket_mb * (1 << 20)))

    def _counters(self) -> list[torch.Tensor]:
        """The chaos round's device counters, in packing order."""
        if not self._chaos:
            return []
        out = [self._dev_streak, self._dev_until]
        if self._has_stale:
            out += [self._dev_admit, self._dev_weight]
        return out

    def _host_counters(self) -> list[np.ndarray]:
        """The host mirrors of ``_counters``, as the device holds them."""
        out = [self._screen_streak.astype(np.int32),
               self._quarantine_until.astype(np.int32)]
        if self._has_stale:
            out += [self._stale_admit_round.astype(np.int32),
                    self._stale_weight.astype(np.float32)]
        return out

    def _block_start(self) -> None:
        """Before a block's rounds run: the device counters take the host
        mirrors (a per-round run or a restore moves only the mirrors)."""
        for d, h in zip(self._counters(), self._host_counters()):
            d.copy_(torch.from_numpy(h))

    # -- sampling and path choice ---------------------------------------
    def _sampled_count(self) -> int:
        return max(int(self.cfg.federated.frac * self.num_workers), 1)

    def _sample_indices(self) -> np.ndarray:
        """m = max(int(frac·W), 1) clients without replacement, sorted —
        dopt's draw from dopt's stream (a fault-free round's sample)."""
        m = self._sampled_count()
        chosen = self._sample_rng.choice(self.num_workers, m, replace=False)
        return np.sort(chosen).astype(np.int32)

    def _draw_count(self) -> int:
        """Clients drawn a round: m, or ceil(m·(1+over_select)) capped at
        W when faults are on and the server over-selects."""
        m = self._sampled_count()
        c = self.faults.cfg
        if self.faults.active and c.over_select > 0.0:
            return min(int(np.ceil(m * (1.0 + c.over_select))),
                       self.num_workers)
        return m

    def _use_compact(self) -> bool:
        # comm_dtype forces the full width: its narrowing acts on the
        # masked-mean reduce, which the compact path does not run; so
        # does the scatter path, a full-width reduce.
        if (self._fused_on or self._has_stale or self._comm_dtype is not None
                or self.scatter_spec is not None):
            return False
        if self.group.size > 1:
            # dopt's mesh rule: across ranks the lanes are parallel
            # hardware, so the full width runs.
            if self.cfg.federated.compact:
                raise ValueError(
                    "FederatedConfig.compact=True requires a single-device "
                    f"mesh (have {self.group.size} devices)")
            return False
        if self._sampled_count() >= self.num_workers:
            return False
        compact = self.cfg.federated.compact
        return True if compact is None else compact

    def _theta(self) -> dict[str, torch.Tensor]:
        """The single global model (row 0 of the slab when fused)."""
        if self._fused_on:
            return {k: v[0] for k, v in
                    flat_views(self._theta_flat, self.fused_spec).items()}
        return self.theta

    def _forward(self, params: dict[str, torch.Tensor]):
        mc = self.cfg.model
        name, faithful = mc.model.lower(), mc.faithful
        dtype = DTYPES[mc.compute_dtype]
        return lambda x: stacked_forward(name, params, x, faithful=faithful,
                                         dtype=dtype)

    # -- host participation (dopt :1526-1840) ---------------------------
    def _participation_static(self, t: int) -> dict:
        """Round t's participation inputs that no quarantine or staleness
        state touches: the candidate draw in draw order (the sampling
        stream's one step) and the round's stateless fault vectors.  No
        row is written: a chaos block draws these at staging and replays
        ``_round_participation(t, chosen=...)`` after its fetch."""
        w = self.num_workers
        chosen = self._sample_rng.choice(
            w, self._draw_count(), replace=False).astype(np.int32)
        rf = self.faults.for_round(t)
        up_drop, up_delay = self.faults.uplink_for_round(t)
        unreach = (np.zeros(w, bool) if rf.partition is None
                   else rf.partition != 0)
        late_d = (self.faults.straggler_lateness(t, self._staleness_max)
                  if self._has_stale else np.zeros(w, np.int32))
        corrupt = (rf.corrupt if self._has_corrupt and rf.corrupt is not None
                   else np.zeros(w, bool))
        return dict(
            chosen=chosen,
            away=self.faults.away_for_round(t).astype(np.float32),
            crashed=rf.crashed.astype(np.float32),
            unreach=unreach.astype(np.float32),
            straggler=rf.straggler.astype(np.float32),
            up_drop=up_drop.astype(np.float32),
            up_delay=up_delay.astype(np.int32),
            late_d=late_d.astype(np.int32),
            limits=FaultPlan.limits_for(rf, self._straggle_units),
            corrupt=corrupt.astype(np.float32))

    def _round_participation(self, t: int, chosen: np.ndarray | None = None
                             ) -> tuple:
        """Sample round t's clients and apply its faults (dopt's
        ``_round_participation``): returns (survivors, sorted; [W]
        straggler work limits; [W] corrupt mask; the round's ledger rows;
        [W] capture mask; [W] admission weights).  A round with no fault
        is the sorted draw.  With faults the chain quarantine > churn >
        crash > partition > ``drop`` straggler > uplink drop > uplink
        delay > survivor runs over the candidates in DRAW order, the
        first m survivors stay and the surplus is released (sorting
        first would release the highest ids).  Under staleness, late
        stragglers and delayed uplinks are captured and admitted d rounds
        later.  ``chosen`` is the chaos block's pre-drawn candidate list,
        which the replay must not draw again."""
        rows: list[dict] = []
        w = self.num_workers
        capture = np.zeros(w, np.float32)
        admit_w = np.zeros(w, np.float32)
        if self._quarantine_on:
            expired = ((self._quarantine_until != 0)
                       & (t >= self._quarantine_until))
            for i in np.nonzero(expired)[0]:
                rows.append({"round": int(t), "worker": int(i),
                             "kind": "quarantine", "action": "readmitted"})
                self._quarantine_until[i] = 0
                self._screen_streak[i] = 0
        if self._has_stale:
            # Admissions due this round, unless their sender was
            # quarantined meanwhile.
            due = (self._stale_admit_round == t) & (self._stale_weight > 0)
            for i in np.nonzero(due)[0]:
                if self._quarantine_on and t < self._quarantine_until[i]:
                    rows.append({"round": int(t), "worker": int(i),
                                 "kind": "staleness",
                                 "action": "dropped_quarantined"})
                else:
                    admit_w[i] = np.float32(self._stale_weight[i])
                    d = int(t - self._stale_origin[i])
                    rows.append({"round": int(t), "worker": int(i),
                                 "kind": "staleness",
                                 "action": f"admitted_after_{d}_rounds"})
                self._stale_admit_round[i] = 0
                self._stale_weight[i] = 0.0
        away = self.faults.away_for_round(t)
        if self.faults.has_churn:
            rows.extend(churn_ledger_rows(self.faults, t, away))
        m = self._sampled_count()
        n_draw = self._draw_count()
        if chosen is None:
            chosen = self._sample_rng.choice(
                w, n_draw, replace=False).astype(np.int32)
        rf = self.faults.for_round(t)
        limits = FaultPlan.limits_for(rf, self._straggle_units)
        cmask = np.zeros(w, np.float32)
        up_drop, up_delay = self.faults.uplink_for_round(t)
        quarantined_now = (self._quarantine_on
                           and bool((self._quarantine_until > t).any()))
        if (not rf.any_fault and n_draw == m and not quarantined_now
                and not away.any() and not up_drop.any()
                and not up_delay.any() and not admit_w.any()):
            return np.sort(chosen), limits, cmask, rows, capture, admit_w
        c = self.faults.cfg
        drop_policy = c is not None and c.straggler_policy == "drop"
        late_d = (self.faults.straggler_lateness(t, self._staleness_max)
                  if self._has_stale else None)
        survivors: list[int] = []
        captured: list[int] = []

        def _capture(i: int, d: int) -> None:
            d = min(int(d), self._staleness_max)
            if self._stale_admit_round[i] > t:
                rows.append({"round": int(t), "worker": i,
                             "kind": "staleness",
                             "action": "pending_overwritten"})
            capture[i] = 1.0
            captured.append(i)
            self._stale_admit_round[i] = t + d
            self._stale_weight[i] = float(self._staleness_decay) ** d
            self._stale_origin[i] = t

        for i in chosen:
            i = int(i)
            if quarantined_now and t < self._quarantine_until[i]:
                rows.append({"round": int(t), "worker": i,
                             "kind": "quarantine",
                             "action": "excluded_while_quarantined"})
            elif away[i]:
                rows.append({"round": int(t), "worker": i, "kind": "churn",
                             "action": "excluded_while_away"})
            elif rf.crashed[i]:
                rows.append({"round": int(t), "worker": i, "kind": "crash",
                             "action": "dropped_from_round"})
            elif rf.partition is not None and rf.partition[i] != 0:
                # Only group 0 reaches the server for the span.
                rows.append({
                    "round": int(t), "worker": i, "kind": "partition",
                    "action": f"unreachable_in_group_{int(rf.partition[i])}"})
            elif rf.straggler[i] and drop_policy:
                if self._has_stale:
                    # The straggler finishes its whole local work and its
                    # update arrives d rounds late.
                    d = min(int(late_d[i]), self._staleness_max)
                    rows.append({
                        "round": int(t), "worker": i, "kind": "straggler",
                        "action": f"deadline_buffered_arriving_{t + d}"})
                    _capture(i, d)
                else:
                    rows.append({
                        "round": int(t), "worker": i, "kind": "straggler",
                        "action": (f"deadline_dropped_after_"
                                   f"{int(limits[i])}_of_"
                                   f"{self._straggle_units}")})
            elif up_drop[i]:
                rows.append({"round": int(t), "worker": i,
                             "kind": "msg_drop", "action": "uplink_dropped"})
            elif up_delay[i] > 0:
                d = int(up_delay[i])
                if self._has_stale and d <= self._staleness_max:
                    rows.append({"round": int(t), "worker": i,
                                 "kind": "msg_delay",
                                 "action": f"uplink_buffered_delay_{d}"})
                    _capture(i, d)
                else:
                    rows.append({"round": int(t), "worker": i,
                                 "kind": "msg_delay",
                                 "action": f"uplink_dropped_stale_{d}"})
            else:
                survivors.append(i)
        for i in survivors[m:]:
            rows.append({"round": int(t), "worker": i, "kind": "overselect",
                         "action": "released_surplus"})
        survivors = np.sort(np.asarray(survivors[:m], np.int32))
        if self._may_straggle:
            for i in survivors:
                if rf.straggler[i]:
                    rows.append({
                        "round": int(t), "worker": int(i),
                        "kind": "straggler",
                        "action": (f"truncated_to_{int(limits[i])}"
                                   f"_of_{self._straggle_units}")})
        if self._has_corrupt and rf.corrupt is not None:
            mode = self.cfg.faults.corrupt_mode
            # A liar lies on the late channel too.
            for i in sorted(set(survivors.tolist()) | set(captured)):
                if rf.corrupt[i]:
                    cmask[i] = 1.0
                    rows.append({"round": int(t), "worker": int(i),
                                 "kind": "corrupt",
                                 "action": f"injected_{mode}"})
        return survivors, limits, cmask, rows, capture, admit_w

    def _apply_screen_feedback(self, t: int, workers, flags,
                               rows: list) -> None:
        """Fold the round's non-finite-screen flags (aligned with
        ``workers``, the surviving sampled clients) into the ledger and
        the quarantine streaks: K consecutive screened participations
        bench the client for ``quarantine_rounds``; one clean
        participation resets the streak."""
        for j, wid in enumerate(np.asarray(workers).reshape(-1)):
            wid = int(wid)
            if float(flags[j]) > 0.5:
                self._screen_streak[wid] += 1
                rows.append({"round": int(t), "worker": wid,
                             "kind": "corrupt",
                             "action": "screened_nonfinite"})
                if (self._quarantine_on and self._screen_streak[wid]
                        >= self._quarantine_after):
                    until = int(t) + 1 + self._quarantine_rounds
                    self._quarantine_until[wid] = until
                    self._screen_streak[wid] = 0
                    rows.append({"round": int(t), "worker": wid,
                                 "kind": "quarantine",
                                 "action": f"quarantined_until_{until}"})
            else:
                self._screen_streak[wid] = 0

    def _fixed_width_sel(self, sel: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        """The survivors padded to the static m lanes: survivors first,
        then the lowest worker ids not selected, with a 0/1 validity
        prefix.  Padding lanes train and are discarded, so every faulted
        compact round has one shape."""
        w, m = self.num_workers, self._sampled_count()
        pad = np.setdiff1d(np.arange(w, dtype=np.int32), sel)[:m - len(sel)]
        valid = np.zeros(m, np.float32)
        valid[:len(sel)] = 1.0
        return np.concatenate([sel, pad]).astype(np.int32), valid

    # -- one round: host inputs -----------------------------------------
    def _limit_steps(self, limits: np.ndarray) -> np.ndarray:
        """Straggler budgets as the local phase's int32 SGD-step limits
        (the holdout's epoch budgets times the steps an epoch)."""
        f = self.cfg.federated
        per = self.steps_per_round // f.local_ep if self._val is not None \
            else 1
        return (limits.astype(np.int64) * per).astype(np.int32)

    def _plan(self, t: int, workers=None) -> dict[str, np.ndarray]:
        """Round t's batch plan (of ``workers`` only, if given); under
        churn a departed client's shard goes to its adopter."""
        cfg, f = self.cfg, self.cfg.federated
        plan = make_batch_plan(
            self.faults.plan_matrix_for(t, self._train_matrix),
            batch_size=f.local_bs, local_ep=f.local_ep, seed=cfg.seed,
            round_idx=t, workers=workers, impl=cfg.data.plan_impl)
        # Every rank plans the whole fleet and takes its lanes' rows (the
        # compact path, whose plan is of ``workers``, runs one rank).
        return shard_worker_tree({"idx": plan.idx.astype(np.int64),
                                  "bw": plan.weight}, self.group)

    def _round_inputs(self, t: int, part: tuple
                      ) -> tuple[str, dict[str, np.ndarray]]:
        """Round t's device inputs from its participation ``part`` (pure):
        the kind of round — "compact" (the survivors, padded to m lanes
        under faults, with their plans, limits and corrupt mask) or
        "full" (the [W] mask, and under staleness the load, admission
        and capture vectors) — and its arrays."""
        sel, limits, cmask, _, cap, admit = part
        compact = self._use_compact()
        lanes, valid = (self._fixed_width_sel(sel)
                        if compact and self.faults.active else (sel, None))
        use_c = compact and len(lanes) > 0
        out = self._plan(t, lanes if use_c else None)
        if use_c:
            out["sel"] = lanes.astype(np.int64)
            if valid is not None:
                out["valid"] = valid
            pick = lanes
        else:
            mask = np.zeros(self.num_workers, np.float32)
            mask[sel] = 1.0
            out["mask"] = mask
            if self._has_stale:
                out.update(load=np.clip(mask + cap, 0.0, 1.0),
                           admit=admit.astype(np.float32), capture=cap)
            pick = slice(None)
        if self._may_straggle:
            out["limit"] = shard_worker_tree(self._limit_steps(limits[pick]),
                                             self.group)
        if self._has_corrupt:
            out["cmask"] = cmask[pick].astype(np.float32)
        return ("compact" if use_c else "full"), out

    def _chaos_inputs(self, t: int, stat: dict) -> dict[str, np.ndarray]:
        """A chaos round's device inputs (pure): the full-width plan, the
        round index, the candidates in draw order and the stateless
        fault vectors."""
        out = self._plan(t)
        out["t"] = np.array([t], np.int32)
        out["chosen"] = stat["chosen"].astype(np.int64)
        for k in ("away", "crashed", "unreach", "straggler", "up_drop",
                  "up_delay", "late_d"):
            out[k] = stat[k]
        if self._may_straggle:
            out["limit"] = shard_worker_tree(
                self._limit_steps(stat["limits"]), self.group)
        if self._has_corrupt:
            out["craw"] = stat["corrupt"]
        return out

    # -- one round: the device body -------------------------------------
    def _local(self, theta, params, moms, duals, idx, bw, val, limit=None):
        """The algorithm's local phase on however many lanes ``params``
        carries, in place, gated by the straggler ``limit``; returns
        (losses, accs, em, the lanes' new companion state or None)."""
        cfg, f = self.cfg, self.cfg.federated
        algo = f.algorithm
        edit = grad_edit(
            _LOCAL_ALGORITHM[algo], rho=cfg.optim.rho,
            theta=self.c_global if algo == "scaffold" else theta,
            alpha=duals)
        losses, accs, em = local_steps(
            self._forward(params), params, moms, idx, bw, self._train_x,
            self._train_y, self._sample_shape, lr=cfg.optim.lr,
            momentum=cfg.optim.momentum, fused=cfg.optim.fused_update,
            edit=edit, l2=cfg.optim.weight_decay,
            clip_norm=cfg.optim.clip_norm, local_ep=f.local_ep, val=val,
            limit=limit)
        with torch.no_grad():
            if algo == "fedadmm":
                new = admm_dual_ascent(duals, params, theta, cfg.optim.rho)
            elif algo == "scaffold":
                # A straggler refreshes with the steps it executed.
                lr_eff = cfg.optim.lr / max(1.0 - cfg.optim.momentum, 1e-8)
                steps = bw.shape[1]
                new = scaffold_control_update(
                    duals, self.c_global, theta, params, lr=lr_eff,
                    num_steps=(steps if limit is None
                               else torch.clamp_max(limit, steps)))
            else:
                new = None
        return losses, accs, em, new

    def _corrupt(self, p_t, sub_new, cmask, theta, prev_p, prev_d):
        """The liars' lies (dopt :942-958): their updates rewritten around
        theta and, for fedadmm/scaffold, their companion state too."""
        fc = self.cfg.faults
        p_t = corrupt_update(p_t, cmask, fc.corrupt_mode, fc.corrupt_scale,
                             ref=theta, prev=prev_p)
        if sub_new is not None:
            sub_new = corrupt_update(sub_new, cmask, fc.corrupt_mode,
                                     fc.corrupt_scale, prev=prev_d)
        return p_t, sub_new

    def _full_round(self, inp: dict[str, torch.Tensor], mask: torch.Tensor,
                    load=None, cmask=None, admit=None, capture=None):
        """All W lanes train (dopt's ``round_fn``); the mask keeps what
        the aggregate sees.  Under staleness the ``load`` lanes (the
        sampled and the captured late senders) start from theta, the
        admitted buffer lanes join the weighted sum and the captured
        lanes' updates land in the buffer.  The masks are the global
        ``[W]`` vectors; across ranks each rank trains its lanes, the
        screen's flags are gathered, the masked mean reduces the ranks'
        partial sums and the robust aggregators, the staleness sum and
        the diagnostics read the gathered updates.  Returns (local loss,
        [W] screened flags, [W] screened-on-admission flags or None,
        epoch rows, diagnostics)."""
        w, gr = self.num_workers, self.group
        scaffold = self.cfg.federated.algorithm == "scaffold"
        theta = self._theta()
        theta_b = (flat_views(self._theta_flat, self.fused_spec)
                   if self._fused_on else broadcast_to_workers(theta, w, gr))
        with torch.no_grad():
            prev_p = {k: v.detach().clone() for k, v in self.params.items()}
            start = where_mask(
                shard_worker_tree(mask if load is None else load, gr),
                theta_b, prev_p)
            for k, p in self.params.items():
                p.copy_(start[k])
            prev_m = {k: v.clone() for k, v in self.momentum.items()}
        # SCAFFOLD keeps no momentum across rounds: a fresh zero buffer.
        moms = ({k: torch.zeros_like(v) for k, v in prev_m.items()}
                if scaffold else self.momentum)
        losses, accs, em, sub_new = self._local(theta, self.params, moms,
                                                self.duals, inp["idx"],
                                                inp["bw"], self._val,
                                                inp.get("limit"))
        stale_scr = None
        with torch.no_grad():
            p_t = self.params
            if cmask is not None:
                p_t, sub_new = self._corrupt(
                    p_t, sub_new, shard_worker_tree(cmask, gr), theta,
                    prev_p, self.duals)
            # The non-finite screen, always on.
            fin = gather_workers(finite_lane_mask(p_t), gr, "screen")
            agg = mask * fin
            agg_l = shard_worker_tree(agg, gr)
            # Every carried state is written in place (RoundGraphs).
            if sub_new is not None:
                new_duals = where_mask(agg_l, sub_new, self.duals)
                if scaffold:
                    inc = lane_sum({k: new_duals[k] - self.duals[k]
                                    for k in self.c_global}, gr)
                    for k, c in self.c_global.items():
                        c.copy_(c + inc[k] / w)
                for k, d in self.duals.items():
                    d.copy_(new_duals[k])
            if self._fused_on:
                # θ'_b = M(agg)·disp + θ_b in one kernel-2 pass a bucket.
                # disp is zeroed where the mask is off (a screened lane's
                # NaN would poison the contraction through 0·NaN); an
                # all-dead round has M = 0 and passes θ_b through.
                disp = flat_views(self._disp_flat, self.fused_spec)
                for k, d in disp.items():
                    torch.sub(p_t[k], theta_b[k], out=d)
                    d.masked_fill_(agg.reshape((w,) + (1,) * (d.dim() - 1))
                                   == 0, 0.0)
                fused_mix_update(self._disp_flat, self._theta_flat,
                                 mean_weight_matrix(agg), self.fused_spec,
                                 lr=-1.0)
                self._theta_flat.copy_(self._disp_flat)
            new_p = where_mask(agg_l, p_t, prev_p)
            if not self._fused_on:
                agg_in = (clip_to_ball(new_p, theta, self._clip)
                          if self._clip > 0 else new_p)
                if self._has_stale:
                    avg, alive, stale_scr = self._stale_sum(
                        gather_workers(agg_in, gr, "stale"), agg, theta,
                        admit)
                    new_stale = where_mask(shard_worker_tree(capture, gr), p_t,
                                           self._stale_p)
                    for k, s in self._stale_p.items():
                        s.copy_(new_stale[k])
                elif self.scatter_spec is not None:
                    avg = masked_average_scatter(
                        agg_in, agg, gr, self.scatter_spec,
                        comm_dtype=self._comm_dtype)
                    alive = agg.sum() > 0
                else:
                    avg = (masked_average(agg_in, agg, self._comm_dtype, gr)
                           if self._agg_robust is None
                           else self._agg_robust(
                               gather_workers(agg_in, gr, "robust"), agg))
                    alive = agg.sum() > 0
                # A round with no survivor keeps theta.
                for k, v in theta.items():
                    v.copy_(torch.where(alive, avg[k], v))
            for k, p in self.params.items():
                p.copy_(new_p[k])
            if not scaffold:
                new_m = where_mask(agg_l, self.momentum, prev_m)
                for k, m in self.momentum.items():
                    m.copy_(new_m[k])
            lane_loss = gather_workers(losses.mean(1), gr, "metrics")
            lane_loss = torch.where(torch.isfinite(lane_loss), lane_loss, 0.0)
            local_loss = (lane_loss * agg).sum() / agg.sum().clamp_min(1.0)
            # From the carried state: the lanes' displacement from their
            # round-start load, the momentum, the new theta, the fleet
            # (gathered across ranks).
            diag = None
            if self._diag:
                fleet = gather_workers(new_p, gr, "diag")
                diag = round_diag(fleet, gather_workers(start, gr, "diag"),
                                  gather_workers(self.momentum, gr, "diag"),
                                  self._theta(), fleet,
                                  gather_workers(em["train_loss"] if em
                                                 else losses, gr, "diag"),
                                  agg)
        return local_loss, mask * (1.0 - fin), stale_scr, em, diag

    def _stale_sum(self, agg_in, agg, theta, admit):
        """The staleness-weighted aggregate (dopt :980-1017) over the
        whole fleet's ``[W, ...]`` updates: the fresh survivors at weight
        1 and the admitted buffer lanes at their decay weights, one
        normalised sum.  Buffer lanes that went non-finite enter at
        weight 0 and are zeroed first (0·NaN would poison the sum); the
        total weight is guarded only at zero.  Returns (aggregate,
        whether any weight, screened-on-admission)."""
        stale_p = gather_workers(self._stale_p, self.group, "stale")
        fin_s = finite_lane_mask(stale_p)
        aw = admit * fin_s
        stale_z = where_mask(fin_s, stale_p,
                             {k: torch.zeros_like(v)
                              for k, v in stale_p.items()})
        agg_stale = (clip_to_ball(stale_z, theta, self._clip)
                     if self._clip > 0 else stale_z)
        tot_w = agg.sum() + aw.sum()
        denom = torch.where(tot_w > 0, tot_w, torch.ones_like(tot_w))
        avg = {}
        for k, x in agg_in.items():
            mm = agg.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
            ss = aw.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
            avg[k] = (((x * mm).sum(0) + (agg_stale[k] * ss).sum(0))
                      / denom.to(x.dtype))
        return avg, tot_w > 0, (admit > 0).float() * (1.0 - fin_s)

    def _compact_round(self, inp: dict[str, torch.Tensor]):
        """Only the sampled lanes train: gather → local → scatter (dopt's
        ``compact_round_fn``).  Under faults the lanes are the survivors
        padded to m, and ``valid`` folds into the screen, so a padding
        lane is excluded and scatters its own state back."""
        w = self.num_workers
        scaffold = self.cfg.federated.algorithm == "scaffold"
        sel_t = inp["sel"]
        m = len(sel_t)
        theta = self.theta
        with torch.no_grad():
            lanes = {k: v.requires_grad_(True)
                     for k, v in _lanes(theta, m).items()}
            prev_p = {k: v.detach()[sel_t] for k, v in self.params.items()}
            prev_m = {k: v[sel_t] for k, v in self.momentum.items()}
            moms = {k: (torch.zeros_like(v) if scaffold else v.clone())
                    for k, v in prev_m.items()}
            duals = (None if self.duals is None else
                     {k: v[sel_t] for k, v in self.duals.items()})
        val = (None if self._val is None
               else tuple(a[sel_t] for a in self._val))
        losses, accs, em, sub_new = self._local(theta, lanes, moms, duals,
                                                inp["idx"], inp["bw"], val,
                                                inp.get("limit"))
        with torch.no_grad():
            p_t = lanes
            if "cmask" in inp:
                p_t, sub_new = self._corrupt(p_t, sub_new, inp["cmask"],
                                             theta, prev_p, duals)
            fin = finite_lane_mask(p_t)
            if "valid" in inp:
                fin = fin * inp["valid"]
            all_fin = fin.min() >= 1.0
            if sub_new is not None:
                kept = where_mask(fin, sub_new, duals)
                for k, d in self.duals.items():
                    d.index_copy_(0, sel_t, kept[k])
                if scaffold:
                    for k, c in self.c_global.items():
                        c.copy_(c + (kept[k] - duals[k]).sum(0) / w)
            p_keep = where_mask(fin, p_t, prev_p)
            for k, p in self.params.items():
                p.index_copy_(0, sel_t, p_keep[k])
            if not scaffold:
                m_keep = where_mask(fin, moms, prev_m)
                for k, mo in self.momentum.items():
                    mo.index_copy_(0, sel_t, m_keep[k])
            agg_in = (clip_to_ball(p_keep, theta, self._clip)
                      if self._clip > 0 else p_keep)
            # Every lane started at this round's theta, which is
            # overwritten below.
            theta0 = ({k: v.clone() for k, v in theta.items()}
                      if self._diag else None)
            if self._agg_robust is None:
                masked = masked_mean(agg_in, fin)
                new = {k: torch.where(all_fin, x.mean(0), masked[k])
                       for k, x in agg_in.items()}
            else:
                new = self._agg_robust(agg_in, fin)
            any_fin = fin.sum() > 0
            for k, v in theta.items():
                v.copy_(torch.where(any_fin, new[k], v))
            lane_loss = losses.mean(1)
            lane_loss = torch.where(torch.isfinite(lane_loss), lane_loss, 0.0)
            local_loss = torch.where(
                all_fin, losses.mean(),
                (lane_loss * fin).sum() / fin.sum().clamp_min(1.0))
            diag = (round_diag(p_keep, theta0, self.momentum, theta,
                               self.params,
                               em["train_loss"] if em else losses, fin)
                    if self._diag else None)
            em = {k: _pad_lanes(v, w) for k, v in em.items()}
        return local_loss, _pad_lanes(1.0 - fin, w), None, em, diag

    def _device_participation(self, inp: dict[str, torch.Tensor],
                              quar: torch.Tensor):
        """The host elif-chain as device math over the candidates in draw
        order (dopt's ``device_participation``): the first m survivors
        (rank = running count of survivors ≤ m) form the [W] mask; under
        staleness the captured late senders form the [W] capture mask
        with their lateness.  The [W]-wide masks are one-hot sums over
        the distinct candidates (no scatter)."""
        f = self.cfg.faults
        w = self.num_workers
        ch = inp["chosen"]
        n = ch.shape[0]
        at = {k: inp[k][ch] for k in ("away", "crashed", "unreach",
                                      "straggler", "up_drop", "up_delay")}
        excl = (quar[ch] | (at["away"] > 0) | (at["crashed"] > 0)
                | (at["unreach"] > 0))
        sg = (at["straggler"] > 0) & ~excl
        strag = (sg if f is not None and f.straggler_policy == "drop"
                 else torch.zeros_like(sg))
        after = excl | strag
        ud = at["up_drop"] > 0
        dl = at["up_delay"]
        dl_c = (dl > 0) & ~after & ~ud
        ok = ~(after | (ud & ~after) | dl_c)
        idx = torch.arange(n, device=ch.device)
        rank = ((idx[None, :] <= idx[:, None]) & ok[None, :]).sum(1)
        onehot = ch[None, :] == torch.arange(w, device=ch.device)[:, None]
        mask = (onehot & (ok & (rank <= self._sampled_count()))[None, :]
                ).any(1).float()
        if not self._has_stale:
            return mask, None, None
        s_max = self._staleness_max
        cap_c = strag | (dl_c & (dl <= s_max))
        d_c = torch.where(strag, torch.clamp_max(inp["late_d"][ch], s_max),
                          torch.clamp_max(dl, s_max))
        cap = (onehot & cap_c[None, :]).any(1).float()
        d_vec = (onehot * torch.where(cap_c, d_c, torch.zeros_like(d_c)
                                      )[None, :]).sum(1).to(torch.int32)
        return mask, cap, d_vec

    def _chaos_round(self, inp: dict[str, torch.Tensor]):
        """A blocked round under quarantine or staleness (dopt's
        ``chaos_block_fn`` body): expired sentences readmitted and due
        admissions taken on the device counters, participation decided
        on the device, the round, then the screen's streak and sentence
        rule — every counter written in place."""
        t = inp["t"]
        stk, unt = self._dev_streak, self._dev_until
        expired = (unt != 0) & (t >= unt)
        unt.copy_(torch.where(expired, torch.zeros_like(unt), unt))
        stk.copy_(torch.where(expired, torch.zeros_like(stk), stk))
        quar = unt > t
        admit = load = None
        if self._has_stale:
            sta, stw = self._dev_admit, self._dev_weight
            due = (sta == t) & (stw > 0)
            admit = torch.where(due & ~quar, stw, torch.zeros_like(stw))
            sta.copy_(torch.where(due, torch.zeros_like(sta), sta))
            stw.copy_(torch.where(due, torch.zeros_like(stw), stw))
        mask, cap, d_vec = self._device_participation(inp, quar)
        playing = mask
        if self._has_stale:
            captured = cap > 0
            sta.copy_(torch.where(captured, t + d_vec, sta))
            stw.copy_(torch.where(captured, self._decay_pow[d_vec.long()],
                                  stw))
            load = playing = torch.clamp(mask + cap, 0.0, 1.0)
        cmask = inp["craw"] * playing if self._has_corrupt else None
        out = self._full_round(inp, mask, load=load, cmask=cmask,
                               admit=admit, capture=cap)
        part = mask > 0
        flagged = part & (out[1] > 0.5)
        stk2 = torch.where(flagged, stk + 1,
                           torch.where(part, torch.zeros_like(stk), stk))
        if self._quarantine_on:
            trigger = flagged & (stk2 >= self._quarantine_after)
            unt.copy_(torch.where(
                trigger, (t + 1 + self._quarantine_rounds).to(unt.dtype),
                unt))
            stk2 = torch.where(trigger, torch.zeros_like(stk2), stk2)
        stk.copy_(stk2)
        return out

    def _body(self, inp: dict[str, torch.Tensor], kind: str) -> None:
        """The round on the device — a "full", "compact" or "chaos"
        round, then the evals — with its metrics in the slot."""
        if kind == "chaos":
            out = self._chaos_round(inp)
        elif kind == "compact":
            out = self._compact_round(inp)
        else:
            out = self._full_round(
                inp, inp["mask"], load=inp.get("load"),
                cmask=inp.get("cmask"), admit=inp.get("admit"),
                capture=inp.get("capture"))
        local_loss, screened, stale_scr, em, diag = out
        # Across ranks every rank packs the same slot from the gathered
        # lanes' rows.
        em = gather_workers(em, self.group, "metrics")
        ev = self._global_eval()
        parts = [local_loss, ev["acc"], ev["loss_sum"]]
        if self.eval_train:
            tm = gather_workers(stacked_eval_gathered(
                self._forward(self.params), *self._train_eval, self._train_x,
                self._train_y, self._sample_shape), self.group, "metrics")
            parts += [tm["loss_mean"].mean(), tm["acc"].mean()]
        else:
            parts += [local_loss.new_zeros(())] * 2
        parts.append(screened)
        if self._has_stale:
            parts.append(torch.zeros_like(screened) if stale_scr is None
                         else stale_scr)
        if em:
            parts += [em[k] for k in ("train_loss", "train_acc", "val_acc",
                                      "val_loss_sum")]
        # The counters are the chaos round's; other rounds leave zeros.
        parts += [c if kind == "chaos" else torch.zeros_like(c)
                  for c in self._counters()]
        if diag is not None:
            parts.append(diag)
        with torch.no_grad():
            torch.cat([p.reshape(-1).float() for p in parts], out=self._slot)

    # -- one round: the rows ---------------------------------------------
    def _record(self, t: int, kind: str, sel: np.ndarray, rows: list,
                      vals: np.ndarray) -> None:
        """After round t's fetch, in dopt's order: the screened flags into
        the ledger and the quarantine mirrors, the buffer lanes screened
        on admission, the rows into ``history.faults``, the History row
        and the client rows; after a chaos round the device counters
        must equal the host mirrors."""
        f, w = self.cfg.federated, self.num_workers
        ll, acc, loss_sum, t_loss, t_acc = (float(v) for v in vals[:5])
        lanes = slice(0, len(sel)) if kind == "compact" else sel
        self._apply_screen_feedback(t, sel, vals[5:5 + w][lanes], rows)
        off = 5 + w
        if self._has_stale:
            for i in np.nonzero(vals[off:off + w] > 0.5)[0]:
                rows.append({"round": int(t), "worker": int(i),
                             "kind": "staleness",
                             "action": "screened_nonfinite_on_admission"})
            off += w
        self.history.faults.extend(rows)
        self.history.append(round=t, test_acc=acc, test_loss=loss_sum,
                            train_loss=t_loss, train_acc=t_acc,
                            local_loss=ll)
        if self._val is not None:
            e = f.local_ep
            tl, ta, va, vl = vals[off:off + 4 * w * e].reshape(4, w, e)[
                :, lanes]
            for j, wid in enumerate(sel):
                for k in range(e):
                    self.client_history.append(
                        global_round=t, epoch=k, worker=int(wid),
                        train_loss=float(tl[j, k]), train_acc=float(ta[j, k]),
                        val_acc=float(va[j, k]), val_loss=float(vl[j, k]))
        n_diag = len(self._diag_keys) if self._diag else 0
        end = len(vals) - n_diag
        if kind == "chaos":
            dev = vals[end - len(self._counters()) * w:end].reshape(-1, w)
            for d, h in zip(dev, self._host_counters()):
                if not np.array_equal(d.astype(h.dtype), h):
                    raise RuntimeError("fused-chaos host replay diverged "
                                       "from the device counters")
        self._round_telemetry(t, rows, vals[end:] if n_diag else None)

    # -- blocks: the stateful draw, the pure build, the rows -----------
    def _draw_block(self, ts: list[int]) -> dict:
        """The block's stateful host draws, on the caller's thread in
        block order: each round's participation (its ledger rows
        included), or under quarantine or staleness only the candidates
        and the stateless fault vectors (the participation is replayed
        after the fetch)."""
        if self._chaos:
            return {"ts": ts, "kinds": ["chaos"] * len(ts),
                    "stats": [self._participation_static(t) for t in ts]}
        return {"ts": ts, "parts": [self._round_participation(t)
                                    for t in ts]}

    def _build_block(self, meta: dict) -> dict:
        """The block's plans and device inputs, stacked and uploaded:
        pure, so the prefetch stager may run it on its background
        thread."""
        if self._chaos:
            rounds = [self._chaos_inputs(t, s)
                      for t, s in zip(meta["ts"], meta["stats"])]
        else:
            built = [self._round_inputs(t, p)
                     for t, p in zip(meta["ts"], meta["parts"])]
            meta["kinds"] = [k for k, _ in built]
            rounds = [r for _, r in built]
        meta["dev"] = upload({k: np.stack([r[k] for r in rounds])
                              for k in rounds[0]}, self.device)
        return meta

    def _record_block(self, meta: dict, vals: np.ndarray) -> None:
        for j, (t, kind) in enumerate(zip(meta["ts"], meta["kinds"])):
            part = (self._round_participation(
                t, chosen=meta["stats"][j]["chosen"])
                if kind == "chaos" else meta["parts"][j])
            self._record(t, kind, part[0], part[3], vals[j])
            self.round += 1
        emit_device_resource(self, meta["ts"][-1], "chaos_block_fn"
                             if self._chaos else "block_fn")

    # -- population mode (dopt :1398-1500, :1841-2063) -----------------
    def _cohort_participation(self, t: int) -> tuple:
        """Sample round t's cohort from the population and apply its
        client-keyed faults (dopt's ``_cohort_participation``): returns
        (the binding, the ``[K, lanes]`` straggler limits, the ``[K,
        lanes]`` corrupt mask, the ledger rows).  Quarantine and churn
        exclude clients at sampling (eligibility); then over the draw, in
        draw order, crash > partition > ``drop`` straggler > uplink drop
        > uplink delay (a delayed uplink is dropped: no staleness
        buffer); the first m survivors stay and the surplus is released;
        the ``cohort`` row goes in after the readmission and churn rows,
        before the draw's rows; then the truncated stragglers and the
        injected lies, in client order.  Stateless per (seed, round)
        except the readmissions; participation is committed after the
        round's fetch."""
        reg = self._registry
        rows = reg.begin_round(t)
        away = reg.faults.away_for_round(t)
        if reg.faults.has_churn:
            rows.extend(reg.churn_ledger_rows(t, away))
        eligible = ~(reg.quarantine_until > t) & ~away
        c = reg.faults.cfg
        m = reg.cohort_size
        n_draw = m
        if reg.faults.active and c.over_select > 0.0:
            n_draw = int(np.ceil(m * (1.0 + c.over_select)))
        cohort = reg.sample_cohort(t, n_draw=n_draw, eligible=eligible)
        binding_row_at = len(rows)
        rf = reg.faults.for_round(t)
        limits_p = FaultPlan.limits_for(rf, self._straggle_units)
        up_drop, up_delay = reg.faults.uplink_for_round(t)
        drop_policy = c is not None and c.straggler_policy == "drop"
        survivors: list[int] = []
        for i in cohort:
            i = int(i)
            if rf.crashed[i]:
                rows.append({"round": int(t), "worker": i, "kind": "crash",
                             "action": "dropped_from_round"})
            elif rf.partition is not None and rf.partition[i] != 0:
                rows.append({
                    "round": int(t), "worker": i, "kind": "partition",
                    "action": f"unreachable_in_group_{int(rf.partition[i])}"})
            elif rf.straggler[i] and drop_policy:
                rows.append({
                    "round": int(t), "worker": i, "kind": "straggler",
                    "action": (f"deadline_dropped_after_{int(limits_p[i])}"
                               f"_of_{self._straggle_units}")})
            elif up_drop[i]:
                rows.append({"round": int(t), "worker": i,
                             "kind": "msg_drop", "action": "uplink_dropped"})
            elif up_delay[i] > 0:
                rows.append({"round": int(t), "worker": i,
                             "kind": "msg_delay",
                             "action": f"uplink_dropped_stale_"
                                       f"{int(up_delay[i])}"})
            else:
                survivors.append(i)
        for i in survivors[m:]:
            rows.append({"round": int(t), "worker": i, "kind": "overselect",
                         "action": "released_surplus"})
        survivors_a = np.asarray(survivors[:m], np.int64)
        binding = reg.bind(t, cohort, survivors_a)
        rows.insert(binding_row_at, binding.ledger_row(reg.clients))
        if self._may_straggle:
            for i in np.sort(survivors_a):
                if rf.straggler[i]:
                    rows.append({
                        "round": int(t), "worker": int(i),
                        "kind": "straggler",
                        "action": (f"truncated_to_{int(limits_p[i])}"
                                   f"_of_{self._straggle_units}")})
        limits = limits_p[binding.lane_ids]
        cmask = np.zeros((binding.waves, binding.lanes), np.float32)
        if self._has_corrupt and rf.corrupt is not None:
            cmask = (rf.corrupt[binding.lane_ids].astype(np.float32)
                     * binding.valid)
            mode = self.cfg.faults.corrupt_mode
            for i in np.sort(survivors_a):
                if rf.corrupt[i]:
                    rows.append({"round": int(t), "worker": int(i),
                                 "kind": "corrupt",
                                 "action": f"injected_{mode}"})
        return binding, limits, cmask, rows

    def _draw_pop_round(self, t: int) -> dict:
        """The stateful half of a population round's staging (the
        participation chain, which reads and writes the registry): on
        the caller's thread, in round order."""
        binding, limits, cmask, rows = self._cohort_participation(t)
        return {"t": t, "binding": binding, "rows": rows, "cmask": cmask,
                "lim": limits}

    def _build_pop_round(self, meta: dict) -> dict:
        """The pure half: the K wave plans, keyed by client id and
        gathering each client's shard (``rows=shard_of[ids]``), and the
        round's device inputs, uploaded (safe on the stager's thread)."""
        cfg, f, reg = self.cfg, self.cfg.federated, self._registry
        t, binding = meta["t"], meta["binding"]
        pm = reg.plan_matrix_for(t, self._train_matrix)
        plans = [make_batch_plan(
            pm, batch_size=f.local_bs, local_ep=f.local_ep, seed=cfg.seed,
            round_idx=t, impl=cfg.data.plan_impl,
            workers=binding.lane_ids[k],
            rows=reg.shard_of[binding.lane_ids[k]])
            for k in range(binding.waves)]
        host = {"idx": np.stack([p.idx for p in plans]).astype(np.int64),
                "bw": np.stack([p.weight for p in plans]),
                "valid": binding.valid}
        if self._may_straggle:
            host["limit"] = self._limit_steps(meta["lim"])
        if self._has_corrupt:
            host["cmask"] = meta["cmask"]
        # Every rank plans the whole cohort and takes its lanes of each
        # wave (``valid`` stays whole: the reduce's weights are global).
        gp = self._pop_group
        host = {k: (np.ascontiguousarray(v[:, gp.lane0:gp.lane0 + gp.lanes])
                    if gp.wire and k != "valid" else v)
                for k, v in host.items()}
        meta["dev"] = upload(host, self.device)
        return meta

    def _pop_round(self, inp: dict[str, torch.Tensor]) -> torch.Tensor:
        """One population round on the device (dopt's ``pop_round_fn``):
        for each wave in order, theta into every lane with zero momentum,
        the local phase (kernel 1 with ``optim.fused_update``), the
        client-keyed lies, the screen times the validity mask, the ball
        clip, then the screened and padding lanes ZEROED before the add
        (a 0-weighted NaN still poisons a sum) into the per-lane f32
        accumulator; then one bucketed reduce over the lanes with the
        cohort weight as denominator (theta passes an empty round
        through) and the global eval.  Returns the packed metrics:
        [local loss, test acc, test loss, the cohort's train loss and
        accuracy, the ``[K·lanes]`` screened flags]."""
        reg, dev, fc = self._registry, self.device, self.cfg.faults
        gp = self._pop_group
        lanes, mine = reg.lanes, gp.lanes
        theta = self.theta
        acc = {k: torch.zeros((mine,) + v.shape, dtype=torch.float32,
                              device=dev) for k, v in theta.items()}
        acc_w = torch.zeros(lanes, device=dev)
        lsum = torch.zeros((), device=dev)
        asum = torch.zeros((), device=dev)
        screened = []
        for k in range(reg.waves):
            with torch.no_grad():
                start = {n: v.requires_grad_(True)
                         for n, v in _lanes(theta, mine).items()}
                moms = {n: torch.zeros_like(v) for n, v in start.items()}
            losses, accs, _, _ = self._local(
                theta, start, moms, None, inp["idx"][k], inp["bw"][k], None,
                inp["limit"][k] if "limit" in inp else None)
            with torch.no_grad():
                p_t = {n: v.detach() for n, v in start.items()}
                if "cmask" in inp:
                    p_t = corrupt_update(p_t, inp["cmask"][k], fc.corrupt_mode,
                                         fc.corrupt_scale, ref=theta,
                                         prev=broadcast_to_workers(theta,
                                                                   mine))
                # The wave's screen and lane metrics over every rank's
                # lanes (gathered), so each rank weighs the whole wave.
                fin_raw, lane_loss, lane_acc = gather_workers(
                    (finite_lane_mask(p_t), losses.mean(1), accs.mean(1)),
                    gp, "metrics")
                fin = fin_raw * inp["valid"][k]
                agg_in = (clip_to_ball(p_t, theta, self._clip)
                          if self._clip > 0 else p_t)
                zed = where_mask(shard_worker_tree(fin, gp), agg_in,
                                 {n: torch.zeros_like(v)
                                  for n, v in agg_in.items()})
                for n, a in acc.items():
                    a.add_(zed[n].float())
                acc_w += fin
                lane_loss = torch.where(torch.isfinite(lane_loss), lane_loss,
                                        0.0)
                lane_acc = torch.where(torch.isfinite(lane_acc), lane_acc, 0.0)
                lsum = lsum + (lane_loss * fin).sum()
                asum = asum + (lane_acc * fin).sum()
                screened.append(inp["valid"][k] * (1.0 - fin_raw))
        with torch.no_grad():
            tot = acc_w.sum()
            avg = masked_average_scatter(
                acc, torch.ones(lanes, device=dev), gp,
                self._pop_spec, denom=torch.where(tot > 0, tot, 1.0))
            for n, v in theta.items():
                v.copy_(torch.where(tot > 0, avg[n].to(v.dtype), v))
            cnt = tot.clamp_min(1.0)
            ev = self._global_eval()
            parts = [lsum / cnt, ev["acc"], ev["loss_sum"], lsum / cnt,
                     asum / cnt, torch.stack(screened)]
            return torch.cat([x.reshape(-1).float() for x in parts])

    def _record_pop(self, t: int, payload: dict, vals: np.ndarray) -> None:
        """After round t's fetch — the commit: participation and the
        screen feedback into the registry, the rows into the ledger, the
        History row with dopt's ``cohort`` and ``population`` columns,
        the telemetry."""
        reg = self._registry
        binding, rows = payload["binding"], payload["rows"]
        ll, acc, loss_sum, t_loss, t_acc = (float(v) for v in vals[:5])
        n = len(binding.survivors)
        reg.record_participation(t, binding.survivors)
        # The survivors hold the first n wave-major slots; the padding
        # lanes' flags are discarded.
        reg.apply_screen_feedback(t, binding.survivors, vals[5:][:n], rows)
        self.history.faults.extend(rows)
        self.history.append(round=t, test_acc=acc, test_loss=loss_sum,
                            train_loss=t_loss, train_acc=t_acc,
                            local_loss=ll, cohort=n, population=reg.clients)
        self._round_telemetry(t, rows)

    def _run_population(self, rounds: int, checkpoint_every: int,
                        checkpoint_path) -> None:
        """Population rounds, one at a time (dopt's ``_run_population``):
        each is one device body and one fetch.  With ``prefetch="on"``
        the loop runs dispatch → stage-next → fetch: round t+1's cohort
        is drawn here and its plans built on the stager's thread while
        round t runs; staging never crosses a scheduled checkpoint."""
        stager = (PrefetchStager() if self.cfg.federated.prefetch == "on"
                  else None)
        try:
            for r in range(rounds):
                t = self.round
                payload = stager.take(t) if stager is not None else None
                if payload is None:
                    with self.timers.phase("host_batch_plan"):
                        payload = self._build_pop_round(
                            self._draw_pop_round(t))
                with self.timers.phase("round_step"):
                    packed = self._pop_round(ready(*payload["dev"]))
                    ckpt_next = (checkpoint_every
                                 and (t + 1) % checkpoint_every == 0)
                    if stager is not None and r + 1 < rounds \
                            and not ckpt_next:
                        with self.timers.phase("host_batch_plan"):
                            meta = self._draw_pop_round(t + 1)
                        stager.stage(t + 1, self._build_pop_round, meta)
                    # ONE device→host fetch per round.
                    vals = packed.cpu().numpy()
                self._record_pop(t, payload, vals)
                self.round += 1
                if checkpoint_every and self.round % checkpoint_every == 0:
                    self.save(checkpoint_path)
        finally:
            if stager is not None:
                stager.discard()

    def run(self, rounds: int | None = None, block: int | None = None,
            checkpoint_every: int = 0, checkpoint_path=None) -> History:
        """Train ``rounds`` rounds (default ``cfg.federated.rounds``) at
        client fraction ``cfg.federated.frac``, in blocks of ``block``
        (default ``cfg.federated.block_rounds``; the last block may be
        shorter); ``self.round`` and the sampling stream persist across
        calls.  Compact sampling with the quarantine runs per-round
        whatever ``block`` says, as dopt's does (its gather depends on
        the quarantine state).  ``checkpoint_every``/``checkpoint_path``
        as ``GossipTrainer.run``: a killed run resumes bit for bit, the
        client sample included.  Population mode runs its rounds one at
        a time through the wave loop, whatever ``frac`` and ``block``
        say, as dopt's does."""
        f = self.cfg.federated
        rounds = f.rounds if rounds is None else rounds
        block = f.block_rounds if block is None else block
        check_checkpoint_args(checkpoint_every, checkpoint_path)
        t0 = time.perf_counter()
        with full_f32(self.device), deterministic(self.device):
            if self._registry is not None:
                # frac and block are the lane engines' knobs: the cohort
                # comes from the registry, a round at a time.
                self._run_population(rounds, checkpoint_every,
                                     checkpoint_path)
            elif block > 1 and not (self._quarantine_on
                                    and self._use_compact()):
                run_blocked(self, rounds, block, prefetch=f.prefetch == "on",
                            checkpoint_every=checkpoint_every,
                            checkpoint_path=checkpoint_path)
            else:
                for _ in range(rounds):
                    t = self.round
                    with self.timers.phase("host_batch_plan"):
                        part = self._round_participation(t)
                        kind, host = self._round_inputs(t, part)
                        inp = {k: torch.from_numpy(v).to(self.device)
                               for k, v in host.items()}
                    with self.timers.phase("round_step"):
                        self._body(inp, kind)
                        # ONE device→host fetch per round.
                        vals = self._slot.cpu().numpy()
                    self._record(t, kind, part[0], part[3], vals)
                    emit_device_resource(
                        self, t, "compact_fn" if kind == "compact"
                        else "round_fn")
                    self.round += 1
                    if checkpoint_every and self.round % checkpoint_every == 0:
                        self.save(checkpoint_path)
        self.total_time = time.perf_counter() - t0
        self._run_summary_telemetry()
        return self.history

    # -- telemetry (dopt_torch.obs) -------------------------------------
    def _round_telemetry(self, t: int, frows: list, diag=None) -> None:
        """Round t's bundle (dopt :2655-2696): the fault-ledger rows, the
        host-mirror gauges (quarantine, the staleness schedule) and the
        fetched diagnostics as gauges, then the History row as the
        ``round`` event, at the same point of the per-round, blocked and
        chaos-blocked loops.  No-op without telemetry."""
        tele = self.telemetry
        if tele is None:
            return
        quarantined = int((self._quarantine_until > t).sum())
        gauges = {"quarantine_active": float(quarantined),
                  "screen_streak_max": float(self._screen_streak.max()),
                  "participating_lanes": float(self.num_workers
                                               - quarantined)}
        if diag is not None:
            gauges.update(finite_diag_gauges(self._diag_keys, diag))
        if self._has_stale:
            gauges["stale_pending"] = float((self._stale_weight > 0).sum())
            gauges["stale_weight_total"] = float(self._stale_weight.sum())
        if self._registry is not None:
            population_gauges(self._registry, t, gauges)
        tele.emit_round_bundle(t, engine=self.engine_kind,
                               metrics=self.history.rows[-1], faults=frows,
                               gauges=gauges)

    def _consensus_value(self) -> float | None:
        """Mean over clients of ||p_i − theta||, or None on round 0 or for
        a diverged fleet (dopt :2704-2722)."""
        if self.round == 0:
            return None
        cd = consensus_distance(gather_workers(self.params, self.group),
                                self._theta())
        return cd if math.isfinite(cd) else None

    def _run_summary_telemetry(self) -> None:
        """The end-of-``run()`` consensus-distance gauge, suppressed
        under ``diagnostics="on"`` (its ``lane_dispersion`` gauge is the
        same meter every round)."""
        tele = self.telemetry
        if tele is None or self._diag or self._suppress_run_summary:
            return
        cd = self._consensus_value()
        if cd is not None:
            tele.emit("gauge", round=self.round - 1,
                      name="consensus_distance", value=cd,
                      engine=self.engine_kind)

    def run_served(self, controller) -> str:
        """Resident serve-mode entry (``dopt_torch.serve``; dopt
        :2506-2525), ``GossipTrainer.run_served``'s contract: the
        controller's boundary before every round, ``"run"`` | ``"drain"``
        | ``"restart"`` | ``"rebuild"``, the summary gauge once, at the
        drain."""
        return serve_rounds(self, controller)

    # -- checkpoint -----------------------------------------------------
    def save(self, path) -> None:
        """Checkpoint theta, the stacked params, momentum (not for
        SCAFFOLD, whose momentum is round-local), the duals or controls,
        SCAFFOLD's server control and the staleness buffer ``stale_p``,
        with dopt's meta keys (the fault ledger, the quarantine mirrors,
        the admission schedule) and the client-sampling stream's state —
        without it a resumed run would replay round 0's sample.  The
        fused slab's rows are one model, so theta is written as row 0:
        fused and unfused checkpoints are interchangeable, as in dopt."""
        algo = self.cfg.federated.algorithm
        arrays = {"theta": self._theta(), "params": self.params,
                  "duals": self.duals, "c_global": self.c_global}
        if algo != "scaffold":
            arrays["momentum"] = self.momentum
        if self._has_stale:
            arrays["stale_p"] = self._stale_p
        meta = checkpoint_meta(self, algo)
        meta.update(stale_admit_round=self._stale_admit_round.tolist(),
                    stale_weight=self._stale_weight.tolist(),
                    stale_origin=self._stale_origin.tolist(),
                    sample_rng_state=self._sample_rng.bit_generator.state)
        if self._registry is not None:
            # Everything but the stateless draws: with the round index,
            # all a population run needs to resume bit for bit.
            meta["population_registry"] = self._registry.state_dict()
        with self.timers.phase("checkpoint"):
            save_rank_checkpoint(self.group, path, arrays, meta,
                                 replicated=("theta", "c_global"),
                                 write=self.checkpoint_writer)
        if self.telemetry is not None:
            # After the atomic save landed, with the consensus snapshot.
            ev = {"round": int(self.round)}
            cd = self._consensus_value()
            if cd is not None:
                ev["consensus_distance"] = cd
            self.telemetry.emit("checkpoint", **ev)

    def restore(self, path) -> None:
        """Resume from a checkpoint written by ``save`` (same config), or
        by dopt's ``FederatedTrainer.save`` in its npz layout.  Every
        carried tensor is written in place (the fused slab's every row
        from the saved theta), so captured graphs stay valid."""
        arrays, meta = load_checkpoint(path)
        # Every rank reads the whole file and keeps its lanes' rows.
        arrays = rank_state(self.group, arrays,
                            replicated=("theta", "c_global"))
        algo = self.cfg.federated.algorithm
        if meta.get("algorithm") != algo:
            raise ValueError(
                f"checkpoint is for algorithm {meta.get('algorithm')!r}, "
                f"trainer runs {algo!r}")
        if self.duals is not None and "duals" not in arrays:
            raise ValueError(
                f"{algo} trainer requires its worker-stacked companion "
                "state ('duals') in the checkpoint")
        if self.c_global is not None and "c_global" not in arrays:
            raise ValueError(
                "scaffold trainer requires the server control variate "
                "('c_global') in the checkpoint")
        if self._has_stale and "stale_p" not in arrays:
            raise ValueError(
                "staleness-aware trainer requires its late-update "
                "buffer ('stale_p') in the checkpoint")
        shape = self.cfg.model.input_shape
        tree = {k: port_layout(v, input_shape=shape)
                for k, v in arrays.items()}
        if self._fused_on:
            rows = flat_views(self._theta_flat, self.fused_spec)
            copy_into({k: v[0] for k, v in rows.items()}, tree["theta"],
                      what="theta")
            with torch.no_grad():
                self._theta_flat[1:].copy_(
                    self._theta_flat[:1].expand_as(self._theta_flat[1:]))
        else:
            copy_into(self.theta, tree["theta"], what="theta")
        copy_into(self.params, tree["params"], what="params")
        if "momentum" in tree:
            copy_into(self.momentum, tree["momentum"], what="momentum")
        if self.duals is not None:
            copy_into(self.duals, tree["duals"], what="duals")
        if self.c_global is not None:
            copy_into(self.c_global, tree["c_global"], what="c_global")
        restore_meta(self, meta)
        w = self.num_workers
        self._screen_streak = np.asarray(meta.get("screen_streak", [0] * w),
                                         np.int64)
        self._quarantine_until = np.asarray(
            meta.get("quarantine_until", [0] * w), np.int64)
        if self._has_stale:
            copy_into(self._stale_p, tree["stale_p"], what="stale_p")
            self._stale_admit_round = np.asarray(
                meta.get("stale_admit_round", [0] * w), np.int64)
            self._stale_weight = np.asarray(
                meta.get("stale_weight", [0.0] * w), np.float64)
            self._stale_origin = np.asarray(
                meta.get("stale_origin", [0] * w), np.int64)
        self._block_start()
        if meta.get("sample_rng_state"):
            self._sample_rng.bit_generator.state = meta["sample_rng_state"]
        if self._registry is not None:
            meta_expect(meta, what="population checkpoint", algorithm=algo)
            restore_registry(self._registry, meta)

    # -- state ----------------------------------------------------------
    def _global_eval(self) -> dict[str, torch.Tensor]:
        """dopt's ``make_evaluator`` on theta: the stacked forward with
        W = 1 over the test stack, as [1] device tensors."""
        theta = {k: v[None] for k, v in self._theta().items()}
        return stacked_evaluate(self._forward(theta), 1, *self._eval)

    def evaluate_global(self) -> dict[str, float]:
        """The global model on the test set: acc, loss_sum (P1's
        flavour), loss_mean (P2's) and count."""
        with full_f32(self.device), deterministic(self.device):
            out = self._global_eval()
        return {k: float(v[0]) for k, v in out.items()}

    def global_params(self) -> dict[str, np.ndarray]:
        """Host copy of theta in the port's layout (f32 arrays)
        (``dopt_torch.convert.params_to_jax`` gives dopt's)."""
        return {k: v.detach().float().cpu().numpy()
                for k, v in self._theta().items()}

    def worker_params(self) -> dict[str, np.ndarray]:
        """Host copy of every client's parameters ([W, ...] f32 arrays,
        exact for bf16 storage); across ranks the lanes are gathered, so
        every rank must call it."""
        return {k: v.detach().float().cpu().numpy()
                for k, v in gather_workers(self.params, self.group).items()}
