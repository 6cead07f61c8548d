"""Synchronous gossip: the port's ``GossipTrainer``.

Counterpart of dopt/engine/gossip.py: N workers as one ``[W, ...]``
stacked state, each round consensus → eval → local epochs (the
reference's order), with the reference's batch plans and History rows,
and its local train/val holdout (``data.local_holdout``: per-epoch
local-val rows in ``client_history``).  The data setup, the shared
refusals and the init here serve the federated engine too.

The reference study's algorithms (``gossip.algorithm``), as dopt runs
them:

* ``dsgd`` — one consensus sweep with the schedule's
  ``matrices[round % len]``, then the local epochs;
* ``nocons`` — the local epochs only, no mixing;
* ``centralized`` — one worker on the whole IID training set, one local
  epoch a round: the config is rewritten to ``num_users=1``,
  ``iid=True``, ``local_ep=1``, ``algorithm="nocons"`` (``self.cfg``
  holds the rewritten config, as dopt's does);
* ``fedlcon`` — ``gossip.eps`` consensus sweeps a round, each reading
  the previous sweep's output (``faithful_bugs=True`` runs one sweep,
  the reference's effective behaviour);
* ``gossip`` — pairwise gossip: each round's matrix is a random perfect
  matching drawn from a stateful host stream
  (``host_rng(seed, 60551)``), on the main thread in round order, and
  carried through checkpoints;
* ``choco`` — CHOCO-SGD (Koloskova et al. 2019): each worker sends
  q = Q(x − x̂) (``gossip.compression``: topk, randk, qsgd or none,
  ``dopt_torch.ops.compression``), the public copy ``x_hat`` advances by
  q, and x += γ·(W x̂ − x̂).  The round's key is ``fold_in(key(seed ^
  0x0C0C0), t)`` with t on the device, so a captured round replays
  with the next round's draws; the draws are dopt's ``jax.random``
  bits (``dopt_torch.utils.prng``) over each tensor in dopt's layout.
  A dead lane sends nothing under faults: its x̂ freezes.

``gossip.comm_dtype`` narrows every consensus sweep's wire (dsgd,
fedlcon's sweeps, matchings, choco's x̂ mix, async's neighbour term) to
that dtype, contracting the f32 matrix in f32 (``mix_dense``).

``gossip.mixing="async"`` (dsgd) is dopt's staleness-1 mixing: each
worker's own term reads its current params, its neighbours' terms the
previous round's entry state, x_i ← W_ii·x_i(t) + Σ_{j≠i} W_ij·x_j(t−1),
with the previous state a carried buffer (``async_prev``, round −1's the
shared init) written in place and checkpointed.  The one-peer
exponential schedule (``topology="one_peer_exp"``) mixes on the dense
path unless ``comm_impl="shift"`` asks for the shift path.

The worker axis over ranks (``mesh_devices``, ``mesh_hosts``; dopt's
multi-device mesh): ``dopt_torch.parallel.engine_group`` gives the
trainer its ``WorkerGroup`` — one rank with no wire unless the caller
launched a ``torch.distributed`` group.  Each rank holds lanes [lane0,
lane0 + L) of every per-lane state and trains them (kernel 1 per rank);
every host draw (matrix, faults, batch plan, cohort) is dopt's whole
``[W]`` draw, of which the rank takes its rows; the consensus mixes
through the collectives below, and what reads every lane — the robust
layer's pairwise screen, choco's compressor draws, the diagnostics and
the round's metrics — reads the all-gathered fleet, so the History is
the same on every rank.  ``worker_params``, ``evaluate``, ``save`` and
the telemetry's consensus gauge are collectives there.  Across ranks a
block's rounds run eagerly and the fused epilogue is refused, as dopt
refuses it on a multi-device mesh.

The consensus wire (dopt :599-800):

* ``gossip.comm_impl="shift"`` mixes by the schedule's circulant
  diagonals (``mix_shifts``; the round's ``[k, n]`` coefficient table is
  device data); ``"auto"`` takes the shift path only where dopt's rule
  says it wins: a wire, a sparse shift set and fewer shipped lanes than
  the dense all-gather (never on one rank, nor on a hybrid layout).
* ``gossip.update_sharding="scatter"`` mixes flat buckets as f32 partial
  contractions and a reduce-scatter (``mix_update_scatter``): W and the
  sum stay f32 whatever the storage dtype.
* ``cfg.comm`` (``CommConfig``, scatter only) schedules each bucket's
  wire: ``wire_dtype`` narrowing, or with ``codec="qsgd"`` the q8/q4
  integer codec with error feedback (``mix_codec_gather``).  The
  residual is one ``[W, Fb]`` f32 buffer a bucket, written in place and
  checkpointed as ``comm_residual``; the draws key on (round, bucket,
  global lane) from ``key(seed ^ 0xC0DEC)``, with the round as device
  data, so a captured round replays with the next round's draws.

Population mode (``cfg.population``, dopt :280-331, :2165-2189) binds a
client cohort onto the lanes: each round ``num_users`` clients are
sampled from the registry (``dopt_torch.population``) and lane i trains
client c_i's shard under c_i's batch stream; the round's ``cohort`` row
goes to the ledger and the participation to the registry at plan time,
in round order (``_plan_inputs``; blocked runs bind in ``_draw_block``),
so blocked ≡ per-round.  dopt's refusals hold (faults, the robust layer,
the holdout, diagnostics, prefetch, the codec, async, the fused
epilogue).

``gossip.eval_mode="sharded"`` evaluates each worker on its round-robin
1/W shard of the test set during training (``evaluate`` stays the full
test set, as dopt's).

Two orderings, as in dopt:

* ``gossip.fused_update="off"`` — mix the carried params, evaluate,
  train: x ← local(W·x).
* ``gossip.fused_update="on"`` — the carry is (post-mix q, displacement
  fbuf) in flat ``[W, padded]`` bucket stores; each round opens with ONE
  CUDA kernel pass per bucket, q_t = W·q_{t-1} − fbuf_{t-1} (round 0
  contracts a zero fbuf), evaluates and trains from q_t, and leaves
  fbuf_t = q_t − p'_t.  The worker's endpoint is q − fbuf (the D-PSGD
  update ordering, a documented variant of the default trajectory).

With ``optim.fused_update=True`` every SGD step's update is one launch
of the fused momentum-SGD kernel.

A round is a host *stage* (the mixing matrix, the batch plan, their
upload) and a device *body* (consensus → eval on flagged rounds → local
epochs → fbuf) that writes the round's metrics into a static slot.
Per-round runs (``block <= 1``) stage, run the body eagerly and fetch
the slot once a round.  Blocked runs (``gossip.block_rounds`` or
``run(block=k)``, k > 1) stage k rounds at once, run each round as a
CUDA-graph replay over static buffers (``dopt_torch.engine.graphs``;
eagerly on the CPU) and fetch once a block, bit-identical to the
per-round run; ``gossip.prefetch="on"`` builds the next block while the
current one runs (``dopt_torch.data.prefetch``).  ``eval_every`` skips
the test-set eval on rounds t with t % eval_every != 0; their History
rows lack ``avg_test_acc``/``avg_test_loss``, as in dopt.

``save``/``restore`` and ``run(checkpoint_every=K, checkpoint_path=P)``
checkpoint the whole state in dopt's npz layout
(``dopt_torch.utils.checkpoint``; blocked runs at block boundaries): a
run killed at any point and resumed from its latest checkpoint is the
continuous run bit for bit, and a dopt npz checkpoint restores too.

The fault model (dopt/engine/gossip.py:268-489, :1167-1645, :2010-2212),
from ``cfg.faults`` (``dopt_torch.faults.FaultPlan``; ``gossip.dropout``
is dopt's deprecated alias of ``faults.crash``) and ``cfg.robust``:

* crash and churn — a down worker's mixing row is repaired to identity
  (``repair_for_dropout``), its lane trains and is discarded (its
  params and momentum keep their values), the round's train metric
  averages the alive workers only; churn also hands a departed
  worker's shard to its adopter (``reassign_shards``);
* straggle — a ``[W]`` step budget on the device gates the local steps
  (kernel 1's gated launch on the fused path);
* partition — cross-group edges cut from the matrix;
* corrupt — Byzantine sends (``corrupt_update``: nan, inf, scale,
  signflip) mixed undefended (``byzantine_mix``) or through clipped
  gossip (``robust.clip_radius``, ``clipped_gossip_mix``), whose
  screened flags feed the quarantine (``robust.quarantine_after``);
  on the dense path the quarantine's streak and sentence counters live
  on the device and the host replays the same integer rule for the
  ledger (dopt's fused quarantine);
* lossy links — ``msg_drop``/``msg_delay`` and ``correction="push_sum"``
  route consensus through the ``[D+1, n, n]`` per-staleness stack
  (``split_by_delay``) against the buffered history (``_link_buf``)
  or, under push-sum, the in-flight packets and their mass
  (``_link_buf_mass``), with each worker's mass in ``_mass``: the
  carried params are then the numerators and ``worker_params`` the
  de-biased estimates.

Telemetry (``dopt_torch.obs.attach``) streams each round's fault rows,
gauges and History row after the round's fetch, at the same point of
the per-round and the blocked loops; ``gossip.diagnostics="on"`` adds
six gauges computed on the device inside the round (``round_diag``),
packed last into the round's metric vector.

Every draw is host numpy, stateless per (seed, kind, round), so the
fault ledger (``history.faults``: one row per round, worker, kind and
action, in dopt's order) is dopt's bit for bit, and per-round, blocked
and resumed runs write the same rows.

``model.compute_dtype="bfloat16"`` runs the forward and backward in bf16
at dopt's cast points; ``model.param_dtype="bfloat16"`` stores the
params, momentum and the fused carry in bf16 (both kernels then run
their bf16 instantiations); ``optim.clip_norm > 0`` clips each worker's
gradient to that global norm after the algorithm's edit.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings

import numpy as np
import torch

from dopt_torch.config import (CommConfig, ExperimentConfig, FaultConfig,
                               PopulationConfig, RobustConfig)
from dopt_torch.convert import dopt_flat_order, params_from_jax, port_layout
from dopt_torch.data import (eval_batches, load_dataset, make_batch_plan,
                             partition, sharded_eval_batches, upload)
from dopt_torch.engine.graphs import RoundGraphs, run_blocked
from dopt_torch.engine.local import (local_steps, prepare_holdout,
                                     stacked_eval_gathered, stacked_evaluate,
                                     validate_optimizer)
from dopt_torch.faults import (FaultPlan, churn_ledger_rows, corrupt_update,
                               validate_fault_config)
from dopt_torch.models.zoo import (COMPUTE_DTYPES, MODELS, STACKED,
                                   StackedModel, deterministic, full_f32,
                                   init_worker_params, param_shapes,
                                   stacked_forward)
from dopt_torch.obs import consensus_distance
from dopt_torch.obs.events import DIAG_GAUGES, finite_diag_gauges
from dopt_torch.ops.compression import device_order, make_compressor
from dopt_torch.ops.fused_update import fused_mix_update
from dopt_torch.optim import rounded
from dopt_torch.parallel.collectives import (alloc_flat, buckets_to_stacked,
                                             flat_views, make_codec_plan,
                                             make_update_shard_spec,
                                             mix_codec_gather, mix_dense,
                                             mix_shifts, mix_update_scatter,
                                             shift_comm_lanes,
                                             stacked_to_buckets, where_mask,
                                             wire_dtype)
from dopt_torch.parallel.mesh import (engine_group, gather_workers,
                                      shard_worker_tree)
from dopt_torch.population import (ClientRegistry, population_gauges,
                                   restore_registry,
                                   validate_population_config)
from dopt_torch.robust import (byzantine_mix, clipped_gossip_mix,
                               finite_lane_mask, lane_sq_norms,
                               validate_robust_config)
# random_matching_matrix is also this module's name for it, at dopt's path
# (dopt.engine.gossip.random_matching_matrix).
from dopt_torch.topology import (build_mixing_matrices, coeffs_for_matrix,
                                 push_sum_link_matrix, random_matching_matrix,
                                 repair_for_dropout, repair_for_dropout_torch,
                                 repair_for_link_drop, repair_for_partition,
                                 schedule_shift_decomposition, split_by_delay)
from dopt_torch.utils.checkpoint import (copy_into, load_checkpoint,
                                         rank_state, save_rank_checkpoint)
from dopt_torch.utils.metrics import History
from dopt_torch.utils.prng import fold_in, host_rng, jax_key
from dopt_torch.utils.profiling import (CompileWatcher, PhaseTimers,
                                        emit_device_resource)

# The dtypes ``model.compute_dtype`` and ``model.param_dtype`` take.
DTYPES = COMPUTE_DTYPES
ALGORITHMS = ("dsgd", "nocons", "centralized", "fedlcon", "gossip", "choco")
# The algorithms that mix with a topology's schedule (gossip draws a
# matching each round; nocons does not mix).
SCHEDULED = ("dsgd", "fedlcon", "choco")


def resolve_device(device=None) -> torch.device:
    """The port runs on the GPU unless the caller names the CPU; a CUDA
    request on a machine without one raises instead of running on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU — pass "
            "device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def validate_common(cfg: ExperimentConfig) -> None:
    """Refusals shared by both engines."""
    d, m = cfg.data, cfg.model
    for section, cls in (("faults", FaultConfig), ("robust", RobustConfig),
                         ("comm", CommConfig),
                         ("population", PopulationConfig)):
        sec = getattr(cfg, section)
        if sec is not None and not isinstance(sec, cls):
            raise ValueError(f"cfg.{section} must be a dopt_torch.config."
                             f"{cls.__name__}, got {type(sec).__name__}")
    if cfg.seqlm is not None:
        raise ValueError("cfg.seqlm is set: the sequence-parallel LM trains "
                         "with dopt_torch.engine.SeqLMTrainer, not the "
                         "gossip or federated engines")
    # dopt's engines run whatever ``backend`` says: the knob picks the
    # trainer in ``build_trainer`` (``dopt_torch.run``).
    if cfg.backend not in ("jax", "torch"):
        raise ValueError(
            f"unknown backend {cfg.backend!r}; 'jax' (TPU/mesh engines) or "
            "'torch' (the sequential reference oracle)")
    for knob in ("mesh_devices", "mesh_hosts"):
        v = getattr(cfg, knob)
        if v is not None and (not isinstance(v, int) or v < 1):
            raise ValueError(f"{knob}={v!r} must be a positive int or None")
    if m.stacked_impl not in ("auto", "vmap"):
        raise ValueError(
            f"unknown stacked_impl {m.stacked_impl!r}; one of auto|vmap")
    if d.plan_impl not in ("numpy", "native"):
        raise ValueError(f"unknown plan_impl {d.plan_impl!r}; one of "
                         "numpy|native (the C++ native planner)")
    if m.model.lower() == "transformer":
        raise ValueError("model 'transformer' is the sequence-parallel LM: "
                         "it trains with dopt_torch.engine.SeqLMTrainer "
                         "(cfg.seqlm), not the gossip or federated engines")
    if m.model.lower() not in STACKED:
        raise ValueError(f"unknown model {m.model!r}; one of "
                         f"{sorted(MODELS)}")
    if m.stage_sizes is not None and m.model.lower() != "resnet18":
        raise ValueError("stage_sizes applies to resnet18 only")
    for knob in ("compute_dtype", "param_dtype"):
        if getattr(m, knob) not in DTYPES:
            raise ValueError(f"unknown model.{knob} {getattr(m, knob)!r}; "
                             f"one of {'|'.join(DTYPES)}")
    validate_optimizer(cfg)


def validate_slice(cfg: ExperimentConfig) -> None:
    """Refuse every configuration the gossip engine does not run."""
    g = cfg.gossip
    if cfg.federated is not None:
        raise ValueError("cfg.federated is set: the federated engine is "
                         "FederatedTrainer, not GossipTrainer")
    if g is None:
        raise ValueError("cfg.gossip must be set for GossipTrainer")
    validate_common(cfg)
    if g.algorithm not in ALGORITHMS:
        raise ValueError(f"unknown gossip algorithm {g.algorithm!r}; one of "
                         f"{'|'.join(ALGORITHMS)}")
    if g.eval_mode not in ("full", "sharded"):
        raise ValueError(f"unknown eval_mode {g.eval_mode!r}; one of "
                         "full|sharded")
    if g.diagnostics not in ("off", "on"):
        raise ValueError(f"unknown diagnostics {g.diagnostics!r}; one of "
                         "off|on")
    if g.mixing not in ("sync", "async"):
        raise ValueError(f"unknown gossip mixing {g.mixing!r}; one of "
                         "sync|async")
    if g.prefetch not in ("off", "on"):
        raise ValueError(f"unknown prefetch {g.prefetch!r}; one of off|on")
    validate_fault_model(cfg)
    wire_dtype(g.comm_dtype)
    validate_wire(cfg)
    if cfg.population is not None:
        validate_population_gossip(cfg)
    if g.fused_update not in ("off", "on"):
        raise ValueError(f"unknown fused_update {g.fused_update!r}; "
                         "one of off|on")
    if g.correction not in ("none", "push_sum"):
        raise ValueError(f"unknown gossip correction {g.correction!r}; "
                         "one of none|push_sum")
    if g.fused_update == "on" and g.algorithm not in ("dsgd", "gossip"):
        raise ValueError(
            "fused_update='on' fuses the single dense consensus sweep with "
            f"the update; algorithm {g.algorithm!r} has no such sweep to "
            "fuse (dsgd|gossip: fedlcon's eps sweeps re-enter the matrix, "
            "choco exchanges compressed deltas, nocons/centralized never "
            "mix)")


def validate_population_gossip(cfg: ExperimentConfig) -> None:
    """dopt's refusals of the gossip engine's population binding
    (dopt/engine/gossip.py:292-375, :643-648, :841-845, :914-918), in
    dopt's words: a cohort other than the fleet, another lane width,
    faults or dropout, the robust layer, the holdout, diagnostics,
    prefetch, the bucket codec, async mixing and the fused epilogue."""
    g, pop, w = cfg.gossip, cfg.population, cfg.data.num_users
    validate_population_config(pop)
    if pop.cohort != w:
        raise ValueError(
            f"gossip population mode trains every lane every "
            f"round: set cohort == data.num_users "
            f"(cohort={pop.cohort}, num_users={w}); wave-looped "
            "cohorts are a federated-engine feature")
    if pop.lanes not in (None, w):
        raise ValueError(
            f"gossip population mode binds onto the fixed "
            f"{w}-lane fleet; lanes={pop.lanes} is a federated-"
            "engine knob")
    if FaultPlan(w, cfg.faults, seed=cfg.seed).active or g.dropout > 0:
        raise ValueError(
            "gossip population mode does not compose with fault "
            "injection (gossip fault identity is lane-keyed; a "
            "per-round client rebinding would silently change "
            "what 'worker i' means) — use the federated engine "
            "for client-keyed faults")
    if cfg.robust is not None and (cfg.robust.clip_radius > 0
                                   or cfg.robust.quarantine_after > 0):
        raise ValueError(
            "gossip population mode does not compose with the "
            "robust layer (screen/quarantine identity is lane-"
            "keyed, and its ledger rows would interleave "
            "differently under blocked execution) — the "
            "federated engine is the client-keyed path")
    if cfg.data.local_holdout > 0:
        raise ValueError(
            "gossip population mode is incompatible with the "
            "local holdout (per-epoch client rows are lane-"
            "keyed) — drop one of the two")
    if g.diagnostics == "on":
        raise ValueError(
            "diagnostics='on' does not compose with population mode "
            "(lanes rebind to a different client cohort every round, "
            "so round-over-round lane diagnostics would mix cohort "
            "resampling noise with actual contraction) — drop one of "
            "the two")
    if g.prefetch == "on":
        raise ValueError(
            "prefetch='on' does not compose with gossip population "
            "mode (the cohort binding mutates the registry and "
            "appends its ledger row at plan time, which a staged "
            "build must not do) — the federated engine is the "
            "prefetch-eligible population path")
    if cfg.comm is not None and cfg.comm.codec != "none":
        raise ValueError(
            "comm.codec with population mode would hand lane "
            "i's quantization residual to a different client "
            "after a cohort rebinding; run the codec on the "
            "classic worker==lane engines (population=None)")
    if g.mixing == "async":
        raise ValueError(
            "mixing='async' does not compose with population "
            "mode (a stale neighbor read would cross a cohort "
            "rebinding — lane i's previous-round state belongs "
            "to a different client) — drop one of the two")
    if g.fused_update == "on":
        raise ValueError(
            "fused_update='on' does not compose with population "
            "mode (the displacement buffer is lane state; a "
            "per-round client rebinding would hand lane i's "
            "displacement to a different client) — drop one of "
            "the two")


def validate_wire(cfg: ExperimentConfig) -> None:
    """dopt's refusals of the bucket wire, the shift path and the scatter
    path (its gossip.py:607-669, :723-757, :834-840, :896-906), in
    dopt's words; the robust and link refusals of ``comm_impl="shift"``
    are ``validate_fault_model``'s."""
    g, comm = cfg.gossip, cfg.comm
    codec_on = comm is not None and comm.codec != "none"
    if comm is not None:
        if g.update_sharding != "scatter":
            raise ValueError(
                "the comm substrate schedule (ExperimentConfig.comm) "
                "speaks the flat-bucket wire of "
                "update_sharding='scatter'; set "
                "gossip.update_sharding='scatter' to arm it (got "
                f"update_sharding={g.update_sharding!r})")
        if g.comm_dtype and comm.wire_dtype:
            raise ValueError(
                f"gossip.comm_dtype={g.comm_dtype!r} and "
                f"comm.wire_dtype={comm.wire_dtype!r} both name "
                "a wire dtype; set exactly one (comm.wire_dtype is "
                "the substrate-schedule spelling of the same knob)")
        if codec_on and g.algorithm not in ("dsgd", "gossip"):
            raise ValueError(
                f"comm.codec={comm.codec!r} carries a per-bucket "
                "error-feedback residual across single-sweep "
                "consensus rounds; use algorithm dsgd|gossip "
                f"(got {g.algorithm!r}: fedlcon's eps sweeps would "
                "re-encode mid-round, choco already quantizes its "
                "own exchange, nocons|centralized|matching never "
                "run the bucket wire)")
        if codec_on and g.comm_impl == "shift":
            raise ValueError(
                "comm_impl='shift' ships circulant ppermute lanes; "
                "the bucket codec speaks the gathered-bucket wire — "
                "use comm_impl='auto'|'dense' with comm.codec")
    if g.comm_impl not in ("auto", "dense", "shift"):
        raise ValueError(
            f"unknown comm_impl {g.comm_impl!r}; one of auto|dense|shift")
    if g.update_sharding not in ("off", "scatter"):
        raise ValueError(
            f"unknown update_sharding {g.update_sharding!r}; "
            "one of off|scatter")
    robust_active, link_mode = fault_paths(cfg)
    if g.update_sharding == "scatter":
        if g.algorithm not in ("dsgd", "fedlcon", "gossip", "choco"):
            raise ValueError(
                "update_sharding='scatter' shards the consensus "
                "mix; algorithm "
                f"{g.algorithm!r} has no dense mixing step to "
                "shard (dsgd|fedlcon|gossip|choco)")
        if robust_active:
            raise ValueError(
                "update_sharding='scatter' does not compose with "
                "the robust layer (corrupt faults / clip_radius / "
                "quarantine run full-precision pairwise mixing on "
                "the unsharded tree) — drop one of the two")
        if link_mode:
            raise ValueError(
                "update_sharding='scatter' does not compose with "
                "link faults / push-sum (the per-staleness "
                "[D+1, n, n] contraction carries its own buffers) "
                "— drop one of the two")
        if g.mixing == "async":
            raise ValueError(
                "mixing='async' does not compose with "
                "update_sharding='scatter' (the bucketed partial "
                "contractions assume one source tree; the async "
                "diag/off-diag split reads two) — drop one of "
                "the two")
    if g.fused_update == "on":
        if g.update_sharding == "scatter":
            raise ValueError(
                "update_sharding='scatter' already restructures the "
                "consensus/update hot path; fused_update='on' is "
                "the single-device fusion of the same epilogue — "
                "drop one of the two")
        if g.comm_impl == "shift":
            raise ValueError(
                "comm_impl='shift' is incompatible with "
                "fused_update='on': the fused epilogue is one dense "
                "[n, n] contraction, and the ppermute shift "
                "decomposition has no single-pass fused form")


def fault_paths(cfg: ExperimentConfig) -> tuple[bool, bool]:
    """Whether the gossip config takes the robust layer (corrupt faults,
    clipped gossip, quarantine) and the lossy-link path (``msg_drop``/
    ``msg_delay``, push-sum)."""
    g, fc, rc = cfg.gossip, cfg.faults, cfg.robust
    robust_active = ((fc is not None and fc.corrupt > 0)
                     or (rc is not None and (rc.clip_radius > 0
                                             or rc.quarantine_after > 0)))
    link_mode = ((fc is not None and (fc.msg_drop > 0 or fc.msg_delay > 0))
                 or g.correction == "push_sum")
    return robust_active, link_mode


def validate_fault_model(cfg: ExperimentConfig) -> None:
    """dopt's refusals of the gossip fault model (its gossip.py:377-489,
    :662-672 and :877-890), in dopt's words: the robust layer (corrupt
    faults, clipped gossip, quarantine) and the lossy-link path
    (``msg_drop``/``msg_delay``, ``correction="push_sum"``) each need a
    mixing algorithm and the dense pairwise path, and neither composes
    with the fused epilogue."""
    g, fc, rc = cfg.gossip, cfg.faults, cfg.robust
    if fc is not None:
        validate_fault_config(fc)
    if rc is not None:
        validate_robust_config(rc)
        if rc.aggregator != "mean":
            raise ValueError(
                "server-side robust aggregators are a federated-engine "
                "knob; the gossip defense is clipped mixing "
                "(RobustConfig.clip_radius)")
    has_corrupt = fc is not None and fc.corrupt > 0
    clip_tau = rc.clip_radius if rc is not None else 0.0
    quarantine = rc is not None and rc.quarantine_after > 0
    robust_active, link_mode = fault_paths(cfg)
    if has_corrupt:
        if fc.corrupt_mode == "stale":
            raise ValueError(
                "corrupt_mode='stale' needs the worker's previous update, "
                "which only the federated engine carries; use "
                "nan|inf|scale|signflip for gossip")
        if g.algorithm not in ("dsgd", "fedlcon", "gossip"):
            raise ValueError(
                "corrupt faults need a mixing algorithm to lie through "
                f"(dsgd|fedlcon|gossip), not {g.algorithm!r}")
    if robust_active and g.algorithm == "choco":
        raise ValueError("the robust layer does not cover choco's "
                         "compressed exchange; use dsgd|fedlcon|gossip")
    if robust_active and g.comm_dtype:
        raise ValueError(
            "comm_dtype wire compression only applies to the plain "
            "consensus collectives; the robust layer (corrupt faults / "
            "clip_radius / quarantine) runs full-precision pairwise "
            "mixing — drop one of the two")
    if (clip_tau > 0 or quarantine) and g.algorithm == "nocons":
        raise ValueError(
            "RobustConfig clip_radius/quarantine need a mixing algorithm "
            f"to act on (dsgd|fedlcon|gossip); {g.algorithm!r} never "
            "communicates")
    if link_mode:
        if g.algorithm not in ("dsgd", "gossip"):
            raise ValueError(
                "link faults (msg_drop/msg_delay) and "
                "correction='push_sum' need a single-sweep mixing "
                f"algorithm (dsgd|gossip), not {g.algorithm!r}")
        if g.comm_dtype:
            raise ValueError(
                "comm_dtype wire compression only applies to the plain "
                "consensus collectives; the link-fault / push-sum path "
                "runs its own per-staleness contractions — drop one of "
                "the two")
        if clip_tau > 0:
            raise ValueError(
                "clipped gossip does not compose with the lossy-link "
                "consensus path yet — run clip_radius and link faults in "
                "separate experiments")
        if has_corrupt and fc.corrupt_mode in ("nan", "inf"):
            raise ValueError(
                "corrupt_mode='nan'/'inf' under link faults would need "
                "byzantine_mix's poison routing, which the per-staleness "
                "link path does not implement; use the finite lies "
                "(scale|signflip)")
    if g.comm_impl == "shift" and robust_active:
        raise ValueError(
            "comm_impl='shift' is incompatible with the robust layer: "
            "clipped mixing / corrupt sends need the dense pairwise path "
            "(the 'auto' default picks it)")
    if g.comm_impl == "shift" and link_mode:
        raise ValueError(
            "comm_impl='shift' is incompatible with link faults / "
            "push-sum: drop-repaired matrices leave the compiled shift set "
            "and the per-staleness stack needs the dense path (the 'auto' "
            "default picks it)")
    if g.mixing == "async":
        # dopt's async refusals (its gossip.py:814-846); scatter and
        # population are refused earlier, naming their slices.
        if g.algorithm != "dsgd":
            raise ValueError(
                "mixing='async' only applies to the single-sweep "
                f"dsgd consensus, not {g.algorithm!r}: fedlcon's eps "
                "sweeps and choco's compressed exchange have no "
                "staleness-1 diag/off-diag split, and matching/"
                "nocons have no static schedule to stale against")
        if robust_active:
            raise ValueError(
                "mixing='async' does not compose with the robust "
                "layer (corrupt faults / clip_radius / quarantine "
                "screen the CURRENT round's sends; a stale mix has "
                "no current wire to screen) — drop one of the two")
        if link_mode:
            raise ValueError(
                "mixing='async' does not compose with link faults / "
                "push-sum (the per-staleness [D+1, n, n] stack "
                "already models delayed state; staleness-1 is its "
                "D=1 special case) — drop one of the two")
    if g.fused_update == "on" and robust_active:
        raise ValueError(
            "fused_update='on' does not compose with the robust layer "
            "(corrupt faults / clip_radius / quarantine screen the wire "
            "BEFORE mixing; the fused epilogue contracts the carried state "
            "directly) — drop one of the two")
    if g.fused_update == "on" and link_mode:
        raise ValueError(
            "fused_update='on' does not compose with link faults / "
            "push-sum (the per-staleness [D+1, n, n] contraction carries "
            "its own mass/staleness buffers) — drop one of the two")
    if g.fused_update == "on" and g.mixing == "async":
        raise ValueError(
            "fused_update='on' does not compose with "
            "mixing='async' (the staleness-1 diag/off-diag "
            "split reads two source trees; the fused "
            "contraction reads one) — drop one of the two")
    if g.fused_update == "on" and g.comm_dtype:
        raise ValueError(
            "comm_dtype wire compression only applies to the "
            "plain consensus collectives; the fused epilogue "
            "contracts at f32 in one HBM pass — drop one of "
            "the two")


def round_diag(p_new: dict[str, torch.Tensor], m_new: dict[str, torch.Tensor],
               p_start: dict[str, torch.Tensor], losses: torch.Tensor,
               alive: torch.Tensor) -> torch.Tensor:
    """The round's [6] f32 diagnostics on the device (dopt's
    ``round_diag``, gossip.py:1063-1110), from the carried state: the
    L2 norms of the round's displacement ``p_new − p_start`` (a dead
    lane carries its state: zero), of the carried momentum and of the
    carried params; the lanes' train-loss mean and max − min spread;
    and the consensus distance mean_i ||p_i − p̄||.  All six reduce over
    the lanes that are alive and whose state and loss are finite, so
    one NaN lane does not blind every gauge."""
    upd_sq = lane_sq_norms({k: p_new[k].float() - p_start[k].float()
                            for k in p_new})
    m_sq, p_sq = lane_sq_norms(m_new), lane_sq_norms(p_new)
    lane = losses.mean(1).float()
    ok = (alive * torch.isfinite(upd_sq) * torch.isfinite(m_sq)
          * torch.isfinite(p_sq) * torch.isfinite(lane))
    on = ok > 0
    denom = ok.sum().clamp_min(1.0)
    norms = [torch.where(on, v, 0.0).sum().sqrt()
             for v in (upd_sq, m_sq, p_sq)]
    lmean = torch.where(on, lane, 0.0).sum() / denom
    spread = torch.where(ok.sum() > 0,
                         torch.where(on, lane, -math.inf).max()
                         - torch.where(on, lane, math.inf).min(), 0.0)
    sq = None
    for k in sorted(p_new):
        x = p_new[k].float()
        okx = ok.reshape((-1,) + (1,) * (x.dim() - 1))
        x0 = torch.where(okx > 0, x, 0.0)
        d = (x0 - (x0.sum(0) / denom)[None] * okx).reshape(x.shape[0], -1)
        s = (d * d).sum(1)
        sq = s if sq is None else sq + s
    cd = torch.where(on, sq.sqrt(), 0.0).sum() / denom
    return torch.stack([*norms, lmean, spread, cd])


def centralized_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """dopt's rewrite of ``algorithm="centralized"``: one worker on the
    whole IID training set, one local epoch a round, run as ``nocons``
    (a new frozen config; the caller's is untouched)."""
    return cfg.replace(
        data=dataclasses.replace(cfg.data, num_users=1, iid=True),
        gossip=dataclasses.replace(cfg.gossip, local_ep=1,
                                   algorithm="nocons"))


def refuse_fused_across_ranks(group) -> None:
    """dopt's refusal of the fused epilogue on a multi-device mesh
    (its gossip.py:921-926, federated.py:610-615), in its words."""
    if group.size > 1:
        raise ValueError(
            "fused_update='on' needs a single-device worker "
            f"mesh (got {group.shape}): the Pallas epilogue "
            "contracts the full worker axis in one kernel call; "
            "multi-device meshes keep the dense or scatter "
            "paths")


def load_device_data(trainer, cfg: ExperimentConfig, dev: torch.device, *,
                     local_bs: int, group) -> None:
    """Both engines' data setup: load, partition, apply the holdout and
    upload once — the train rows stay flat ``[N, F]`` on the device, the
    test set as a shared ``[S, B, ...]`` eval stack, the holdout's
    local-val stacks (if any) per worker: this rank's rows of dopt's
    whole host stacks on a worker ``group`` of several ranks."""
    mc = cfg.model
    trainer.dataset = ds = load_dataset(
        cfg.data.dataset, data_dir=cfg.data.data_dir,
        train_size=cfg.data.synthetic_train_size,
        test_size=cfg.data.synthetic_test_size, seed=cfg.seed,
        input_shape=mc.input_shape, num_classes=mc.num_classes)
    _, trainer.index_matrix = partition(
        ds.train_y, cfg.data.num_users, iid=cfg.data.iid,
        shards_per_user=cfg.data.shards, seed=cfg.seed)
    trainer._train_matrix, val = prepare_holdout(
        cfg, trainer.index_matrix, batch_size=local_bs)
    trainer._val = (None if val is None else tuple(
        torch.from_numpy(np.ascontiguousarray(
            shard_worker_tree(a, group))).to(dev) for a in val))
    trainer._sample_shape = tuple(ds.train_x.shape[1:])
    trainer._train_x = torch.from_numpy(
        ds.train_x.reshape(len(ds.train_x), -1)).to(dev)
    trainer._train_y = torch.from_numpy(ds.train_y.astype(np.int64)).to(dev)
    ex, ey, ew = eval_batches(ds.test_x, ds.test_y,
                              batch_size=max(local_bs, 256))
    trainer._eval = (torch.from_numpy(ex).to(dev),
                     torch.from_numpy(ey.astype(np.int64)).to(dev),
                     torch.from_numpy(ew).to(dev))


def initial_params(cfg: ExperimentConfig, init_params=None
                   ) -> dict[str, torch.Tensor]:
    """One worker's initial parameters on the CPU in
    ``model.param_dtype``: dopt's flax tree converted (``init_params``),
    or flax's default init drawn from a ``torch.Generator`` seeded with
    ``cfg.seed``.  The f32 init is cast to the storage dtype as dopt
    casts its flax init (exact for a tree that is already bf16)."""
    mc = cfg.model
    name = mc.model.lower()
    if init_params is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        p0 = init_worker_params(name, num_classes=mc.num_classes,
                                input_shape=mc.input_shape, generator=gen,
                                stage_sizes=mc.stage_sizes)
    else:
        p0 = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in params_from_jax(
                  init_params, input_shape=mc.input_shape).items()}
        want = param_shapes(name, num_classes=mc.num_classes,
                            input_shape=mc.input_shape,
                            stage_sizes=mc.stage_sizes)
        got = {k: tuple(v.shape) for k, v in p0.items()}
        if got != want:
            raise ValueError(f"init_params shapes {got} do not match "
                             f"{name}'s {want}")
    pdt = DTYPES[mc.param_dtype]
    return {k: v.to(pdt) for k, v in p0.items()}


def check_checkpoint_args(checkpoint_every: int, checkpoint_path) -> None:
    if checkpoint_every and checkpoint_path is None:
        raise ValueError("checkpoint_every requires checkpoint_path")
    if checkpoint_every < 0:
        raise ValueError(f"checkpoint_every={checkpoint_every} must be >= 0")


def refuse_membership_population(cfg: ExperimentConfig, membership) -> None:
    """dopt's refusal (gossip.py:122-128, federated.py:85-91), in its
    words: the serve membership overlay and the client population do
    not compose."""
    if membership is not None and cfg.population is not None:
        raise ValueError(
            "the serve membership overlay does not compose with the "
            "client population registry (cohort sampling already "
            "models client join/leave; a lane-level overlay would "
            "silently fight the registry's shard assignment) — drop "
            "one of the two")


def serve_rounds(trainer, controller) -> str:
    """Both engines' ``run_served`` loop: ``controller.boundary`` before
    every round, one ``run(rounds=1)`` a ``"run"`` verdict, the summary
    gauge at a drain only."""
    trainer._suppress_run_summary = True
    try:
        while True:
            verdict = controller.boundary(trainer)
            if verdict != "run":
                if verdict == "drain":
                    trainer._suppress_run_summary = False
                    trainer._run_summary_telemetry()
                return verdict
            trainer.run(rounds=1)
    finally:
        trainer._suppress_run_summary = False


def checkpoint_meta(trainer, algorithm: str) -> dict:
    """Both engines' checkpoint meta, under dopt's keys: the round, the
    History and client rows, the fault ledger and the screen's host
    mirrors (zero on an engine without the robust layer)."""
    w = trainer.num_workers
    zeros = np.zeros(w, np.int64)
    return {"round": trainer.round, "name": trainer.cfg.name,
            "algorithm": algorithm, "history": trainer.history.rows,
            "client_history": trainer.client_history.rows,
            "fault_ledger": trainer.history.faults,
            "screen_streak": getattr(trainer, "_screen_streak",
                                     zeros).tolist(),
            "quarantine_until": getattr(trainer, "_quarantine_until",
                                        zeros).tolist()}


def restore_meta(trainer, meta: dict) -> None:
    """The host side of a restore: the round, the rows and the fault
    ledger."""
    trainer.round = int(meta["round"])
    trainer.history.rows = list(meta.get("history", []))
    trainer.history.faults = list(meta.get("fault_ledger", []))
    trainer.client_history.rows = list(meta.get("client_history", []))


def steps_per_round(train_matrix: np.ndarray, local_bs: int,
                    local_ep: int) -> int:
    """SGD steps in a round's plan (the padded last batch included)."""
    l_shard = train_matrix.shape[1]
    return local_ep * -(-l_shard // min(local_bs, l_shard))


class GossipTrainer:
    """Synchronous gossip over ``cfg.data.num_users`` workers: dsgd,
    nocons, centralized, fedlcon, pairwise gossip or choco, on one device
    or over the ranks of a ``torch.distributed`` group
    (``mesh_devices``).

    ``device`` defaults to CUDA and raises where there is none; pass
    ``device="cpu"`` to run on the CPU (the kernels' plain versions).
    ``init_params`` takes one worker's dopt params tree (numpy leaves,
    ``dopt_torch.convert.params_from_jax``'s input) so a run can start
    at dopt's exact init; otherwise the init is drawn from a
    ``torch.Generator`` seeded with ``cfg.seed``, with flax's defaults.
    ``eval_every`` evaluates the test set on rounds t with
    t % eval_every == 0 only (dopt's knob; its bench runs with an
    ``eval_every`` beyond the run).

    The f32 path runs in full f32: on CUDA, ``run`` and ``evaluate`` set
    ``torch.backends.cudnn.allow_tf32 = False`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False`` while they run,
    because cuDNN convolutions default to TF32, which keeps about three
    digits; on the CPU they turn oneDNN off
    (``dopt_torch.models.full_f32``, which restores the flags after).
    On CUDA they also run in the deterministic mode
    (``dopt_torch.models.deterministic``), so a run repeats bit for bit.
    """

    engine_kind = "gossip"

    def __init__(self, cfg: ExperimentConfig, *, eval_every: int = 1,
                 device=None, init_params=None, membership=None):
        refuse_membership_population(cfg, membership)
        validate_slice(cfg)
        if eval_every < 1:
            raise ValueError(f"eval_every={eval_every} must be >= 1")
        self.device = dev = resolve_device(device)
        if cfg.gossip.algorithm == "centralized":
            cfg = centralized_config(cfg)
        g, mc = cfg.gossip, cfg.model
        self.cfg = cfg
        self.eval_every = eval_every
        self.round = 0
        self.history = History(cfg.name)
        # Telemetry (``dopt_torch.obs.attach``): None runs the loop with
        # no emission; every site is host code after a fetch.
        self.timers = PhaseTimers()
        self.telemetry = None
        # Serve-mode hooks (``dopt_torch.serve``): ``run_served`` defers
        # the end-of-run summary gauge to the drain boundary; a follower
        # of a serve fleet takes part in a save but does not write it.
        self._suppress_run_summary = False
        self.checkpoint_writer = True
        self._membership = membership
        self._diag = g.diagnostics == "on"
        self._diag_keys = DIAG_GAUGES + ("consensus_distance",)
        self._compile_watch = CompileWatcher()
        self._last_step_total = 0.0
        w = cfg.data.num_users
        self.num_workers = w
        # The worker axis over ranks (dopt's make_worker_mesh): this rank
        # holds lanes [lane0, lane0 + L) of the W workers; every host
        # draw is dopt's whole [W] draw, of which the rank takes its rows.
        self.group = engine_group(w, cfg.mesh_devices, cfg.mesh_hosts)
        self.lanes = lanes = self.group.lanes
        if g.fused_update == "on":
            refuse_fused_across_ranks(self.group)

        load_device_data(self, cfg, dev, local_bs=g.local_bs,
                         group=self.group)
        self.steps_per_round = steps_per_round(self._train_matrix,
                                               g.local_bs, g.local_ep)
        # The population binding (dopt :280-331): each round a cohort of
        # num_users clients is sampled and bound onto the lanes, lane i
        # training client c_i's shard under c_i's batch stream.
        self._registry = (ClientRegistry(cfg.population, num_shards=w,
                                         seed=cfg.seed, lanes=w)
                          if cfg.population is not None else None)
        # Sharded eval: each worker's round-robin shard of the test rows,
        # gathered from the uploaded eval stack (its first n rows are the
        # test set in order).
        self._eval_shards = None
        if g.eval_mode == "sharded":
            si, sw = sharded_eval_batches(len(self.dataset.test_y), w,
                                          batch_size=max(g.local_bs, 256))
            si, sw = shard_worker_tree((si, sw), self.group)
            self._eval_shards = (
                torch.from_numpy(np.ascontiguousarray(si, np.int64)).to(dev),
                torch.from_numpy(np.ascontiguousarray(sw)).to(dev))
        # Per-epoch per-worker rows, filled when the holdout is on (P2
        # Client.history {iter, train_loss, train_acc, val_acc, val_loss}
        # plus round and worker columns; val_loss is P2's mean flavour).
        self.client_history = History(cfg.name + "-clients")

        # Model + stacked state: every worker starts from the same init.
        p0 = initial_params(cfg, init_params)
        self.param_count = sum(v.numel() for v in p0.values())
        stacked = {k: v.expand(lanes, *v.shape).contiguous().to(dev)
                   for k, v in p0.items()}
        self.model = StackedModel(mc.model.lower(), stacked,
                                  faithful=mc.faithful,
                                  dtype=DTYPES[mc.compute_dtype],
                                  impl=mc.stacked_impl)
        self._names = [k for k, _ in self.model.named_parameters()]
        self._params = list(self.model.parameters())
        self.momentum = [torch.zeros_like(p) for p in self._params]
        # The update's scalars, rounded to the storage dtype once here.
        for x in (cfg.optim.lr, cfg.optim.momentum):
            rounded(float(x), DTYPES[mc.param_dtype])

        # Mixing: a topology's schedule (dsgd, fedlcon), or a matching
        # drawn each round from a stateful stream (gossip); nocons does
        # not mix.  fedlcon runs eps sweeps a round, each on the previous
        # sweep's output (one with faithful_bugs).
        self.mixing = (build_mixing_matrices(
            g.topology, g.mode, w, seed=cfg.seed, self_weight=g.self_weight,
            groups=g.hier_groups, period=g.hier_period)
            if g.algorithm in SCHEDULED else None)
        self._matching_rng = host_rng(cfg.seed, 60551)
        self._sweeps = (g.eps if g.algorithm == "fedlcon"
                        and not g.faithful_bugs else 1)
        self._do_mix = g.algorithm in ("dsgd", "fedlcon", "gossip")
        self._comm_dtype = wire_dtype(g.comm_dtype)
        self._setup_faults(stacked)
        self._setup_choco(stacked)
        self._setup_wire(stacked)
        # Async (staleness-1) mixing carries the previous round's entry
        # state; round −1's is the shared init, so async round 0 mixes
        # what sync round 0 mixes.
        self._async = g.mixing == "async"
        self._async_prev = ({k: v.clone() for k, v in stacked.items()}
                            if self._async else None)

        # Fused epilogue carry: q (post-mix state) and fbuf (displacement
        # to the post-local endpoint) as flat bucket stores; round −1's
        # displacement is zero, so fused round 0 mixes what the default
        # round 0 mixes.
        self._fused_on = g.fused_update == "on"
        self.fused_spec = None
        if self._fused_on:
            self.fused_spec = make_update_shard_spec(
                stacked, bucket_bytes=int(g.update_bucket_mb * (1 << 20)))
            self._q = alloc_flat(w, self.fused_spec, dev)
            self._fbuf = alloc_flat(w, self.fused_spec, dev)
            for k, v in flat_views(self._q, self.fused_spec).items():
                v.copy_(stacked[k])

        # The round's packed metrics: train loss, train acc, test acc,
        # test loss, then the [W] screened flags (robust runs), the
        # [4, W, E] epoch rows (holdout), the device quarantine's [W]
        # streak and until (fused quarantine) and, last, the [6]
        # diagnostics block (``diagnostics="on"``), as dopt packs them.
        width = (4 + (w if self._robust_active else 0)
                 + (4 * w * g.local_ep if self._val is not None else 0)
                 + (2 * w if self._fused_quar else 0)
                 + (len(self._diag_keys) if self._diag else 0))
        self._slot = torch.zeros(width, device=dev)
        # Across ranks the block's rounds run eagerly: a captured graph
        # cannot hold a collective staged through the host.
        self.graphs = RoundGraphs(self._body, self._slot,
                                  eager=self.group.wire)

    def _setup_faults(self, stacked: dict[str, torch.Tensor]) -> None:
        """The fault plan, the robust layer's switches and host mirrors,
        and the device state of the fault model: the fused quarantine's
        streak and until counters, and the link path's push-sum mass and
        staleness buffers (at dopt's initial values: mass one, the
        history buffer at the common init, the in-flight buffer zero)."""
        cfg, w, dev = self.cfg, self.num_workers, self.device
        self.faults = f = FaultPlan(w, cfg.faults, seed=cfg.seed,
                                    dropout=cfg.gossip.dropout,
                                    membership=self._membership)
        self._has_faults = f.active
        self._may_straggle = f.may_straggle
        self._has_corrupt = f.has_corrupt
        rc = cfg.robust
        self._clip_tau = rc.clip_radius if rc is not None else 0.0
        self._quarantine_on = bool(rc is not None and rc.quarantine_after > 0)
        self._quarantine_after = rc.quarantine_after if rc else 0
        self._quarantine_rounds = rc.quarantine_rounds if rc else 0
        self._screen_streak = np.zeros(w, np.int64)
        self._quarantine_until = np.zeros(w, np.int64)
        self._robust_active = (self._has_corrupt or self._clip_tau > 0
                               or self._quarantine_on)
        self._push_sum = cfg.gossip.correction == "push_sum"
        self._has_link = f.has_link
        self._link_mode = self._has_link or self._push_sum
        self._delay_max = f.delay_max
        self._fused_quar = self._quarantine_on and not self._link_mode
        # Lanes that can be down for a round (crash, churn or the serve
        # membership overlay, quarantine): their local work is discarded
        # (dopt does so under faults only).
        self._may_die = f.active and (f.cfg.crash > 0 or f.has_churn
                                      or self._quarantine_on)
        self._steps_per_epoch = self.steps_per_round // cfg.gossip.local_ep
        self._straggle_units = (cfg.gossip.local_ep if self._val is not None
                                else self.steps_per_round)
        if self._fused_quar:
            self._dev_streak = torch.zeros(w, dtype=torch.int32, device=dev)
            self._dev_until = torch.zeros(w, dtype=torch.int32, device=dev)
        self._mass = self._link_buf = self._link_buf_mass = None
        if self._link_mode:
            d = self._delay_max
            if self._push_sum:
                self._mass = torch.ones(w, device=dev)
                if d > 0:
                    self._link_buf = {k: torch.zeros(d, *v.shape,
                                                     dtype=v.dtype, device=dev)
                                      for k, v in stacked.items()}
                    self._link_buf_mass = torch.zeros(d, w, device=dev)
            elif d > 0:
                self._link_buf = {k: v.expand(d, *v.shape).contiguous()
                                  for k, v in stacked.items()}

    def _setup_choco(self, stacked: dict[str, torch.Tensor]) -> None:
        """CHOCO-SGD's state (dopt :252-256, :1008-1025): the public copy
        ``x_hat`` (zeros in the storage dtype), the compressor, γ rounded
        to the storage dtype, the base key ``key(seed ^ 0x0C0C0)`` and
        each tensor's flat index map into dopt's layout, which the
        compressor draws over."""
        g, mc = self.cfg.gossip, self.cfg.model
        self._choco = g.algorithm == "choco"
        self.x_hat: dict[str, torch.Tensor] = {}
        if not self._choco:
            return
        self._compressor = make_compressor(
            g.compression, g.compression_ratio, qsgd_levels=g.qsgd_levels)
        real = (g.compression == "qsgd"
                or (g.compression in ("topk", "randk")
                    and g.compression_ratio < 1.0))
        if g.choco_gamma >= 1.0 and real:
            warnings.warn(
                "choco_gamma >= 1 with a real compressor can diverge: "
                "CHOCO-SGD theory scales γ down with the compressor's "
                "contraction factor (try γ ≈ 0.1·compression_ratio)",
                stacklevel=3)
        self._choco_gamma = rounded(float(g.choco_gamma),
                                    DTYPES[mc.param_dtype])
        self._choco_key = jax_key(self.cfg.seed ^ 0x0C0C0, device=self.device)
        self._choco_order = device_order(dopt_flat_order(
            {k: tuple(v.shape[1:]) for k, v in stacked.items()},
            input_shape=mc.input_shape), self.device)
        self.x_hat = {k: torch.zeros_like(v) for k, v in stacked.items()}

    def _setup_wire(self, stacked: dict[str, torch.Tensor]) -> None:
        """The consensus wire (dopt :599-800): the worker group (one rank,
        no wire), ``comm.wire_dtype``, the shift set, the scatter spec,
        the codec plan, and the codec's error-feedback residual — one
        ``[W, Fb]`` f32 zero buffer a bucket (round −1's residual is
        zero, so round 0 encodes v = x), written in place."""
        cfg, g, w = self.cfg, self.cfg.gossip, self.num_workers
        comm = cfg.comm
        self._codec_on = comm is not None and comm.codec != "none"
        if comm is not None and comm.wire_dtype:
            self._comm_dtype = wire_dtype(comm.wire_dtype)
        # dopt's path choice: the shift path only where it wins — a wire
        # (more than one rank), a sparse shift set, and fewer shipped
        # lanes than the dense gather's with a 2x margin.
        self._shift_ids = None
        if (g.comm_impl != "dense" and not self._robust_active
                and not self._link_mode and not self._codec_on
                and self.mixing is not None and (self._do_mix or self._choco)):
            extra = (0,) if self.faults.affects_matrix else ()
            # A hybrid (hosts × ici) layout keeps the dense path.
            ids = (schedule_shift_decomposition(self.mixing, max_shifts=None,
                                                extra_shifts=extra)
                   if self.group.flat else None)
            size = self.group.size
            lanes = w // size
            if ids is not None and g.comm_impl == "auto":
                shipped = shift_comm_lanes(ids, lanes, size)
                if (size == 1 or len(ids) > max(3, w // 2)
                        or (shipped > 3 and 2 * shipped > max(w - lanes, 1))):
                    ids = None
            if ids is None and g.comm_impl == "shift":
                raise ValueError(
                    "comm_impl='shift' requires a flat 1-D worker mesh "
                    f"(workers={w}, mesh={self.group.shape}) and a mixing "
                    "schedule that decomposes into circulant shifts "
                    f"(topology={g.topology!r})")
            self._shift_ids = ids
        elif g.comm_impl == "shift":
            raise ValueError(
                "comm_impl='shift' needs a mixing-schedule algorithm "
                f"(dsgd|fedlcon|choco), not {g.algorithm!r}")
        self.scatter_spec = None
        if g.update_sharding == "scatter":
            if not self.group.flat:
                raise ValueError(
                    "update_sharding='scatter' needs a flat 1-D worker "
                    f"mesh (got {self.group.shape}); hybrid (hosts × ici) "
                    "meshes keep the dense path")
            self.scatter_spec = make_update_shard_spec(
                stacked, fold=self.group.size,
                bucket_bytes=int(g.update_bucket_mb * (1 << 20)))
        self.codec_plan = None
        self._comm_res: list[torch.Tensor] = []
        if comm is not None:
            self.codec_plan = make_codec_plan(
                self.scatter_spec, codec=comm.codec,
                wire_dtype=comm.wire_dtype,
                byte_budget=int(comm.byte_budget_mb * (1 << 20)),
                min_codec_bytes=comm.min_codec_bytes, chunk=comm.chunk)
        if self._codec_on:
            self._comm_ef = comm.error_feedback == "on"
            self._comm_key = jax_key(cfg.seed ^ 0xC0DEC, device=self.device)
            # The codec's chunks and draws run over dopt's element order.
            self._comm_order = device_order(dopt_flat_order(
                {k: tuple(v.shape[1:]) for k, v in stacked.items()},
                input_shape=cfg.model.input_shape), self.device)
            b = self.scatter_spec.bounds
            self._comm_res = [torch.zeros(self.lanes, hi - lo,
                                          device=self.device)
                              for lo, hi in zip(b, b[1:])]

    # -- one round: host stage, device body -----------------------------
    def _matrix_for_round(self, t: int) -> np.ndarray:
        """Round t's mixing matrix (the identity where the algorithm
        does not mix, as dopt's).  The matching draw advances its
        stream: call once a round, in round order, on the caller's
        thread."""
        if self.cfg.gossip.algorithm == "gossip":
            return random_matching_matrix(self.num_workers,
                                          self._matching_rng)
        if self.mixing is not None:
            return self.mixing.for_round(t)
        return np.eye(self.num_workers)

    def _round_inputs_static(self, t: int, w_raw: np.ndarray):
        """The fused quarantine's per-round inputs that do not depend on
        the quarantine state (dopt :2010): the partition-cut matrix, the
        crash/churn ``alive`` mask, the straggler limits and the corrupt
        mask.  No state is touched and no row is written: a blocked run
        draws these at staging and replays ``_round_inputs`` after the
        block's fetch for the rows and the host mirrors."""
        rf = self.faults.for_round(t)
        alive = (~rf.crashed).astype(np.float32)
        if self.faults.has_churn:
            away = self.faults.away_for_round(t)
            alive = alive * (~away).astype(np.float32)
        limits = FaultPlan.limits_for(rf, self._straggle_units)
        w_t = w_raw
        if rf.partition is not None:
            w_t = repair_for_partition(w_t, rf.partition)
        cmask = np.zeros(self.num_workers, np.float32)
        if self._has_corrupt and rf.corrupt is not None:
            cmask = (rf.corrupt & (alive > 0)).astype(np.float32)
        return w_t.astype(np.float32), alive, limits, cmask

    def _round_inputs(self, t: int, w_raw: np.ndarray):
        """dopt's ``_round_inputs`` (:2034): (mixing argument, alive,
        straggler limits, corrupt mask, ledger rows, quarantine mask)
        for round t from the drawn matrix ``w_raw``.  The argument is
        the repaired ``[n, n]`` matrix, or on the link path the
        ``[D+1, n, n]`` per-staleness stack.  The rows are returned in
        dopt's order (churn, readmissions, partition, crash, straggler,
        corrupt, link drops and delays) for the caller to log after the
        round's screened rows.  Under the fused quarantine the matrix
        is not dropout-repaired and ``alive`` is crash/churn only: the
        device folds the quarantine in and repairs."""
        rows: list[dict] = []
        w_t = w_raw
        n = self.num_workers
        rf = self.faults.for_round(t)
        alive = (~rf.crashed).astype(np.float32)
        away = self.faults.away_for_round(t)
        if self.faults.has_churn:
            rows.extend(churn_ledger_rows(self.faults, t, away))
            alive = alive * (~away).astype(np.float32)
        quar = np.zeros(n, np.float32)
        if self._quarantine_on:
            expired = ((self._quarantine_until != 0)
                       & (t >= self._quarantine_until))
            for i in np.nonzero(expired)[0]:
                rows.append({"round": int(t), "worker": int(i),
                             "kind": "quarantine", "action": "readmitted"})
                self._quarantine_until[i] = 0
                self._screen_streak[i] = 0
            quarantined = self._quarantine_until > t
            quar = quarantined.astype(np.float32)
            if quarantined.any() and not self._fused_quar:
                alive = alive * (~quarantined).astype(np.float32)
        units = self._straggle_units
        limits = FaultPlan.limits_for(rf, units)
        if rf.partition is not None:
            w_t = repair_for_partition(w_t, rf.partition)
            for i, gid in enumerate(rf.partition):
                rows.append({"round": int(t), "worker": int(i),
                             "kind": "partition",
                             "action": f"cut_to_group_{int(gid)}"})
        if alive.min() < 1.0 and not self._fused_quar:
            w_t = repair_for_dropout(w_t, alive)
        for i in np.nonzero(rf.crashed)[0]:
            rows.append({"round": int(t), "worker": int(i), "kind": "crash",
                         "action": "skipped_round"})
        for i in np.nonzero(rf.straggler)[0]:
            rows.append({"round": int(t), "worker": int(i),
                         "kind": "straggler", "action":
                         f"truncated_to_{int(limits[i])}_of_{units}"})
        cmask = np.zeros(n, np.float32)
        if self._has_corrupt and rf.corrupt is not None:
            # A down (or quarantined) worker sends nothing to corrupt; on
            # the fused path the device mutes quarantined liars and the
            # ledger leaves them out.
            liars = rf.corrupt & (alive > 0)
            cmask = liars.astype(np.float32)
            row_liars = liars & (quar <= 0) if self._fused_quar else liars
            mode = self.cfg.faults.corrupt_mode
            for i in np.nonzero(row_liars)[0]:
                rows.append({"round": int(t), "worker": int(i),
                             "kind": "corrupt",
                             "action": f"injected_{mode}"})
        if self._link_mode:
            keep, delay = self.faults.link_for_round(t)
            if self._has_link:
                edges = (w_t * (1.0 - np.eye(n))) > 0.0
                for i, j in zip(*np.nonzero(edges & ~keep)):
                    rows.append({"round": int(t), "worker": int(i),
                                 "kind": "msg_drop",
                                 "action": f"dropped_from_{int(j)}"})
                for i, j in zip(*np.nonzero(edges & keep & (delay > 0))):
                    rows.append({
                        "round": int(t), "worker": int(i),
                        "kind": "msg_delay",
                        "action": f"delayed_from_{int(j)}_by_"
                                  f"{int(delay[i, j])}"})
            m_eff = (push_sum_link_matrix(w_t, keep) if self._push_sum
                     else repair_for_link_drop(w_t, keep))
            mats = split_by_delay(m_eff, delay, self._delay_max)
            return mats, alive, limits, cmask, rows, quar
        return w_t.astype(np.float32), alive, limits, cmask, rows, quar

    def _device_inputs(self, t: int, arg: np.ndarray, alive: np.ndarray,
                       limits: np.ndarray, cmask: np.ndarray
                       ) -> dict[str, np.ndarray]:
        """The round's fault inputs as the body reads them: ``w`` (or the
        link path's ``mats``), ``alive``, the straggler ``limit`` in SGD
        steps (the holdout's epoch budgets times the steps an epoch),
        ``cmask`` and, for the device quarantine, the round ``t``; each
        only where the configuration uses it."""
        out = {}
        shift = self._shift_ids
        if self._link_mode:
            out["mats"] = arg.astype(np.float32)
        elif self._async:
            # The diag/off-diag split after every repair (dopt
            # :2144-2156): a departed lane's identity row becomes diag 1
            # and an all-zero off-diagonal row, a pure local step.
            w_off = (arg * (1.0 - np.eye(self.num_workers))).astype(
                np.float32)
            out["w"] = (w_off if shift is None
                        else coeffs_for_matrix(w_off, shift))
            out["wdiag"] = np.diag(arg).astype(np.float32)
        elif self._do_mix or self._choco:
            # The shift path takes the round's [k, n] coefficient table.
            out["w"] = (arg.astype(np.float32) if shift is None
                        else coeffs_for_matrix(arg.astype(np.float32), shift))
        if self._has_faults or self._fused_quar:
            out["alive"] = alive.astype(np.float32)
        if self._may_straggle:
            per = self._steps_per_epoch if self._val is not None else 1
            lim = (limits.astype(np.int64) * per).astype(np.int32)
            out["limit"] = shard_worker_tree(lim, self.group)
        if self._has_corrupt:
            out["cmask"] = cmask.astype(np.float32)
        if self._fused_quar or self._choco or self._codec_on:
            # Device data: a captured round replays with the next t.
            out["t"] = np.array([t], np.int32)
        return out

    def _plan_inputs(self, t: int) -> dict[str, np.ndarray]:
        """Round t's batch plan (dopt's ``_round_plan``): under churn a
        departed worker's shard goes to its adopter for the round.  In
        population mode the round's cohort is sampled and bound onto
        the lanes — lane i trains client c_i's shard under c_i's batch
        stream (dopt refuses faults there, so no shard is adopted) — and,
        as side effects,
        its participation is recorded and its ``cohort`` row appended to
        the ledger; so this is pure only without a population, and a
        blocked run calls it in ``_draw_block``, in round order."""
        g, cfg, reg = self.cfg.gossip, self.cfg, self._registry
        kw = {}
        if reg is not None:
            cohort = reg.sample_cohort(t)
            binding = reg.bind(t, cohort, cohort)
            ids = binding.lane_ids[0]
            reg.record_participation(t, binding.survivors)
            self.history.faults.append(binding.ledger_row(reg.clients))
            kw = {"workers": ids, "rows": reg.shard_of[ids]}
        plan = make_batch_plan(
            self.faults.plan_matrix_for(t, self._train_matrix),
            batch_size=g.local_bs, local_ep=g.local_ep, seed=cfg.seed,
            round_idx=t, impl=cfg.data.plan_impl, **kw)
        # Every rank plans the whole fleet and takes its lanes' rows.
        return shard_worker_tree({"idx": plan.idx.astype(np.int64),
                                  "bw": plan.weight}, self.group)

    def _param_dict(self) -> dict[str, torch.Tensor]:
        return dict(zip(self._names, self._params))

    def _write_params(self, new: dict[str, torch.Tensor]) -> None:
        for k, p in zip(self._names, self._params):
            p.copy_(new[k])

    @torch.no_grad()
    def _consensus(self, w_t: torch.Tensor, cmask: torch.Tensor | None,
                   wdiag: torch.Tensor | None = None,
                   alive: torch.Tensor | None = None,
                   t: torch.Tensor | None = None) -> torch.Tensor | None:
        """Leave the round's post-consensus state in the model's params;
        returns the robust layer's [W] screened flags (None off it).
        ``comm_dtype`` narrows every sweep's wire (dsgd, fedlcon's
        sweeps, matchings, choco's x̂ mix, async's neighbour term)."""
        if self._fused_on:
            fused_mix_update(self._q, self._fbuf, w_t, self.fused_spec,
                             lr=1.0)
            self._write_params(flat_views(self._q, self.fused_spec))
            return None
        params = self._param_dict()
        if self._codec_on:
            self._write_params(self._codec_mix(params, w_t, t))
            return None
        if self._async:
            self._write_params(self._async_mix(params, w_t, wdiag))
            return None
        if self._choco:
            self._write_params(self._choco_mix(params, w_t, alive, t))
            return None
        if not self._robust_active:
            mixed = params
            for _ in range(self._sweeps):
                mixed = self._mix_once(mixed, w_t)
            self._write_params(mixed)
            return None
        # A liar corrupts only what it broadcasts; its own state trains
        # honestly.  The extra fedlcon sweeps re-mix honest states.  The
        # pairwise screen reads every send: across ranks each rank runs
        # it on the gathered fleet and keeps its rows.
        params = gather_workers(params, self.group, "robust")
        x_send = (corrupt_update(params, cmask, self.cfg.faults.corrupt_mode,
                                 self.cfg.faults.corrupt_scale)
                  if self._has_corrupt else params)
        if self._clip_tau > 0:
            mixed, screened = clipped_gossip_mix(params, x_send, w_t,
                                                 self._clip_tau)
            for _ in range(self._sweeps - 1):
                mixed, _ = clipped_gossip_mix(mixed, mixed, w_t,
                                              self._clip_tau)
        else:
            screened = 1.0 - finite_lane_mask(x_send)
            mixed = byzantine_mix(params, x_send, w_t)
            for _ in range(self._sweeps - 1):
                mixed = mix_dense(mixed, w_t)
        self._write_params(shard_worker_tree(mixed, self.group))
        return screened

    def _mix_once(self, x: dict[str, torch.Tensor], arg: torch.Tensor
                  ) -> dict[str, torch.Tensor]:
        """One consensus sweep (dopt's ``mix_once``): ``arg`` is the
        round's ``[n, n]`` matrix, or the ``[k, n]`` coefficient table on
        the shift path; the scatter path mixes flat buckets."""
        if self.scatter_spec is not None:
            return mix_update_scatter(x, arg, self.group, self.scatter_spec,
                                      shift_ids=self._shift_ids,
                                      comm_dtype=self._comm_dtype)
        if self._shift_ids is not None:
            return mix_shifts(x, self._shift_ids, arg, self.group,
                              self._comm_dtype)
        return mix_dense(x, arg, self._comm_dtype, self.group)

    def _codec_mix(self, params: dict[str, torch.Tensor], w_t: torch.Tensor,
                   t: torch.Tensor) -> dict[str, torch.Tensor]:
        """One compressed sweep over the flat buckets (dopt's
        ``codec_mix``, :958-973): the key is ``fold_in(key(seed ^
        0xC0DEC), t)`` with t on the device, bucket i folds i, each lane
        its global id; the residuals take v − decode(encode(v)) in place
        (zeros with ``error_feedback="off"``)."""
        key = fold_in(self._comm_key, t)
        buckets = stacked_to_buckets(params, self.scatter_spec,
                                     self._comm_order)
        mixed, new_res = mix_codec_gather(buckets, self._comm_res, w_t,
                                          self.group, self.codec_plan, key)
        for r, e in zip(self._comm_res, new_res):
            if self._comm_ef:
                r.copy_(e)
            else:
                r.zero_()
        return buckets_to_stacked(mixed, self.scatter_spec, self._comm_order)

    def _async_mix(self, params: dict[str, torch.Tensor], w_off: torch.Tensor,
                   wdiag: torch.Tensor) -> dict[str, torch.Tensor]:
        """dopt's ``async_mix`` (:987-1006): the self-term reads the
        current params, every neighbour term the previous round's entry
        state, d·p(t) + W_off·prev in f32, cast back to the storage
        dtype.  The mix reads the old prev before this round's entry is
        copied into it (in place: a captured graph holds addresses)."""
        nb = self._mix_once(self._async_prev, w_off)
        wdiag = shard_worker_tree(wdiag, self.group)
        mixed = {k: (wdiag.reshape((-1,) + (1,) * (p.dim() - 1)) * p.float()
                     + nb[k].float()).to(p.dtype)
                 for k, p in params.items()}
        for k, b in self._async_prev.items():
            b.copy_(params[k])
        return mixed

    def _choco_mix(self, params: dict[str, torch.Tensor], w_t: torch.Tensor,
                   alive: torch.Tensor | None, t: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
        """One CHOCO-SGD exchange (dopt's ``choco_mix``, :1027-1044):
        q = Q(x − x̂) with the round's key ``fold_in(key, t)`` (``t`` on
        the device), a dead lane sends nothing (its x̂ freezes), x̂ += q
        in place, and x += γ·(W x̂ − x̂), each op in the storage dtype."""
        key = fold_in(self._choco_key, t)
        diff = {k: p - self.x_hat[k] for k, p in params.items()}
        # The draws cover the whole [W, n] fleet: across ranks each rank
        # compresses the gathered differences and keeps its rows.
        q = shard_worker_tree(self._compressor(
            gather_workers(diff, self.group, "choco"), key,
            self._choco_order), self.group)
        if self._has_faults:
            q = where_mask(shard_worker_tree(alive, self.group), q,
                           {k: torch.zeros_like(v) for k, v in q.items()})
        for k, xh in self.x_hat.items():
            xh.add_(q[k])
        mixed = self._mix_once(self.x_hat, w_t)
        return {k: p + ((mixed[k] - self.x_hat[k]) * self._choco_gamma
                        ).to(p.dtype)
                for k, p in params.items()}

    @torch.no_grad()
    def _link_consensus(self, mats: torch.Tensor,
                        cmask: torch.Tensor | None) -> None:
        """The lossy-link sweep (dopt's ``link_round_core``): ``mats`` is
        the round's ``[D+1, n, n]`` per-staleness stack.  Plain gossip
        mixes the sends against the last D sends (the history buffer);
        push-sum contracts values and mass alike, adds the packets that
        arrive now, queues the delayed ones, and leaves the de-biased
        estimate x/mass in the params.  Every buffer is written in
        place."""
        params = self._param_dict()
        gr = self.group
        x_send = (corrupt_update(params, shard_worker_tree(cmask, gr),
                                 self.cfg.faults.corrupt_mode,
                                 self.cfg.faults.corrupt_scale)
                  if self._has_corrupt else params)
        d_max, buf = self._delay_max, self._link_buf
        if self._push_sum:
            now_x = mix_dense(x_send, mats[0], group=gr)
            now_m = mats[0] @ self._mass
            if d_max > 0:
                now_x = {k: v + buf[k][0] for k, v in now_x.items()}
                now_m = now_m + self._link_buf_mass[0]
                sends = [mix_dense(x_send, mats[d], group=gr)
                         for d in range(1, d_max + 1)]
                sends_m = torch.stack([mats[d] @ self._mass
                                       for d in range(1, d_max + 1)])
                new_buf = {k: torch.cat([b[1:], torch.zeros_like(b[:1])])
                           + torch.stack([s[k] for s in sends])
                           for k, b in buf.items()}
                bm = self._link_buf_mass
                new_bm = (torch.cat([bm[1:], torch.zeros_like(bm[:1])])
                          + sends_m)
                for k, b in buf.items():
                    b.copy_(new_buf[k])
                bm.copy_(new_bm)
            safe = shard_worker_tree(torch.clamp_min(now_m, 1e-12), gr)
            mixed = {k: (v.float() / safe.reshape((-1,) + (1,) * (v.dim() - 1))
                         ).to(v.dtype) for k, v in now_x.items()}
            self._mass.copy_(now_m)
        else:
            mixed = mix_dense(x_send, mats[0], group=gr)
            for d in range(1, d_max + 1):
                snap = mix_dense({k: b[d - 1] for k, b in buf.items()},
                                 mats[d], group=gr)
                mixed = {k: v + snap[k] for k, v in mixed.items()}
            if d_max > 0:
                new_buf = {k: torch.cat([x_send[k][None], b[:-1]])
                           for k, b in buf.items()}
                for k, b in buf.items():
                    b.copy_(new_buf[k])
        self._write_params(mixed)

    def _effective_inputs(self, inp: dict[str, torch.Tensor]):
        """The fused quarantine on the device (dopt's round-start
        readmission and ``effective_inputs``): an expired sentence clears
        the bench and the streak, the quarantined lanes fold into
        ``alive`` and out of ``cmask``, and the matrix is repaired for the
        combined dead set (not on all-alive rounds).  Returns ``(w,
        alive, cmask)``."""
        t, unt, stk = inp["t"], self._dev_until, self._dev_streak
        expired = (unt != 0) & (t >= unt)
        unt.copy_(torch.where(expired, torch.zeros_like(unt), unt))
        stk.copy_(torch.where(expired, torch.zeros_like(stk), stk))
        quar = (unt > t).float()
        alive = inp["alive"] * (1.0 - quar)
        cmask = inp.get("cmask")
        if cmask is not None:
            cmask = cmask * (1.0 - quar)
        w_t = inp.get("w")
        if w_t is not None:
            w_t = torch.where(alive.min() >= 1.0, w_t,
                              repair_for_dropout_torch(w_t, alive))
        return w_t, alive, cmask

    def _quarantine_update(self, screened: torch.Tensor, alive: torch.Tensor,
                           t: torch.Tensor) -> None:
        """Post-round screen feedback on the device's int32 counters,
        the integer rule of ``_apply_screen_feedback``."""
        stk, unt = self._dev_streak, self._dev_until
        flagged = screened > 0.5
        streak2 = torch.where(flagged, stk + 1,
                              torch.where(alive > 0, torch.zeros_like(stk),
                                          stk))
        trigger = flagged & (streak2 >= self._quarantine_after)
        unt.copy_(torch.where(trigger, (t + 1 + self._quarantine_rounds
                                        ).to(unt.dtype), unt))
        stk.copy_(torch.where(trigger, torch.zeros_like(streak2), streak2))

    def _evaluate_round(self) -> dict[str, torch.Tensor]:
        """The in-training test eval: every worker on the whole test
        stack, or (sharded) each on its own shard of it."""
        if self._eval_shards is None:
            ev = stacked_evaluate(self.model, self.lanes, *self._eval)
        else:
            ex, ey, _ = self._eval
            ev = stacked_eval_gathered(
                self.model, *self._eval_shards,
                ex.reshape(-1, *self._sample_shape), ey.reshape(-1),
                self._sample_shape)
        return gather_workers(ev, self.group, "metrics")

    def _body(self, inp: dict[str, torch.Tensor], do_eval: bool) -> None:
        """The round on the device: (fault inputs) → consensus → eval
        (flagged rounds) → local epochs → dead lanes restored → fbuf,
        metrics into the slot.  Every state is written in place and
        nothing touches the host, so the body can be captured
        (``RoundGraphs``)."""
        cfg, g = self.cfg, self.cfg.gossip
        alive, cmask, w_t = inp.get("alive"), inp.get("cmask"), inp.get("w")
        if self._fused_quar:
            w_t, alive, cmask = self._effective_inputs(inp)
        screened = None
        if self._link_mode:
            self._link_consensus(inp["mats"], cmask)
        elif w_t is not None:
            screened = self._consensus(w_t, cmask, inp.get("wdiag"),
                                       alive, inp.get("t"))
        if self._robust_active and screened is None:
            screened = torch.zeros(self.num_workers, device=self.device)
        gr = self.group
        # The post-consensus state: dead lanes fall back to it, and the
        # diagnostics measure the local displacement from it (on the
        # fused carry it is q, which the local phase leaves alone).
        with torch.no_grad():
            p_pre = ([p.clone() for p in self._params]
                     if self._may_die or (self._diag and not self._fused_on)
                     else None)
            m_pre = ([m.clone() for m in self.momentum] if self._may_die
                     else None)
        ev = self._evaluate_round() if do_eval else None
        losses, accs, em = local_steps(
            self.model, self._param_dict(),
            dict(zip(self._names, self.momentum)), inp["idx"], inp["bw"],
            self._train_x, self._train_y, self._sample_shape,
            lr=cfg.optim.lr, momentum=cfg.optim.momentum,
            fused=cfg.optim.fused_update, l2=cfg.optim.weight_decay,
            clip_norm=cfg.optim.clip_norm, local_ep=g.local_ep,
            val=self._val, limit=inp.get("limit"))
        with torch.no_grad():
            if self._may_die:
                # A down lane's local work is discarded: its params and
                # momentum keep their post-consensus values.
                mine = shard_worker_tree(alive, gr)
                for cur, old in zip(self._params + self.momentum,
                                    p_pre + m_pre):
                    up = mine.reshape((-1,) + (1,) * (cur.dim() - 1)) > 0
                    cur.copy_(torch.where(up, cur, old))
            diag = None
            if self._diag:
                # On the de-biased estimates, before push-sum's rebias.
                p_start = (flat_views(self._q, self.fused_spec)
                           if p_pre is None
                           else dict(zip(self._names, p_pre)))
                # Across ranks on the gathered fleet (norms and the
                # consensus distance reduce over every lane).
                diag = round_diag(
                    gather_workers(self._param_dict(), gr, "diag"),
                    gather_workers(dict(zip(self._names, self.momentum)), gr,
                                   "diag"),
                    gather_workers(p_start, gr, "diag"),
                    gather_workers(em["train_loss"] if em else losses, gr,
                                   "diag"),
                    torch.ones(self.num_workers, device=self.device)
                    if alive is None else alive)
            if self._push_sum:
                # The carried state is the numerator: z · mass.
                mass = shard_worker_tree(self._mass, gr)
                for p in self._params:
                    mm = mass.reshape((-1,) + (1,) * (p.dim() - 1))
                    p.copy_((p.float() * mm).to(p.dtype))
            if self._fused_on:
                q = flat_views(self._q, self.fused_spec)
                fb = flat_views(self._fbuf, self.fused_spec)
                for k, p in zip(self._names, self._params):
                    torch.sub(q[k], p, out=fb[k])
            # dopt's round metrics: the epochs' rows with the holdout,
            # the steps' without; the alive workers' mean under faults.
            if em:
                losses, accs = em["train_loss"], em["train_acc"]
            # The round's metrics reduce over the whole fleet: across
            # ranks every rank gathers the lanes' rows and packs the same
            # slot.
            losses, accs, em = gather_workers((losses, accs, em), gr,
                                              "metrics")
            if self._has_faults:
                denom = torch.clamp_min(alive.sum(), 1.0)
                tl = (losses.mean(1) * alive).sum() / denom
                ta = (accs.mean(1) * alive).sum() / denom
            else:
                tl, ta = losses.mean(), accs.mean()
            test = ([ev["acc"].mean(), ev["loss_mean"].mean()] if do_eval
                    else [tl.new_zeros(())] * 2)
            parts = [tl, ta, *test]
            if self._robust_active:
                parts.append(screened)
            if em:
                parts += [em[k] for k in ("train_loss", "train_acc",
                                          "val_acc", "val_loss_mean")]
            if self._fused_quar:
                self._quarantine_update(screened, alive, inp["t"])
                parts += [self._dev_streak, self._dev_until]
            if diag is not None:
                parts.append(diag)
            torch.cat([p.reshape(-1).float() for p in parts], out=self._slot)

    def _record(self, t: int, vals: np.ndarray, do_eval: bool) -> None:
        """Round t's History row (and client rows) from its metrics."""
        row = {"round": t, "avg_train_loss": float(vals[0]),
               "avg_train_acc": float(vals[1])}
        if do_eval:
            row.update(avg_test_acc=float(vals[2]),
                       avg_test_loss=float(vals[3]))
        self.history.append(**row)
        if self._val is not None:
            w, e = self.num_workers, self.cfg.gossip.local_ep
            off = 4 + (w if self._robust_active else 0)
            tl, ta, va, vl = vals[off:off + 4 * w * e].reshape(4, w, e)
            for i in range(w):
                for j in range(e):
                    self.client_history.append(
                        round=t, iter=j, worker=i,
                        train_loss=float(tl[i, j]), train_acc=float(ta[i, j]),
                        val_acc=float(va[i, j]), val_loss=float(vl[i, j]))

    def _finish_round(self, t: int, vals: np.ndarray, do_eval: bool,
                      rows: list, alive) -> None:
        """After round t's fetch, in dopt's order: the screened flags
        into the ledger rows and the quarantine mirrors, the rows into
        ``history.faults``, then the History row.  On the fused
        quarantine the device's counters must equal the host's."""
        w = self.num_workers
        if self._robust_active:
            self._apply_screen_feedback(t, alive, vals[4:4 + w], rows)
        self.history.faults.extend(rows)
        self._record(t, vals, do_eval)
        n_diag = len(self._diag_keys) if self._diag else 0
        if self._fused_quar:
            end = len(vals) - n_diag
            dev = vals[end - 2 * w:end].astype(np.int64)
            if not (np.array_equal(dev[:w], self._screen_streak)
                    and np.array_equal(dev[w:], self._quarantine_until)):
                raise RuntimeError("fused-quarantine host replay diverged "
                                   "from the device counters")
        self._round_telemetry(t, rows, vals[len(vals) - n_diag:]
                              if n_diag else None)

    def _apply_screen_feedback(self, t: int, alive, flags,
                               rows: list) -> None:
        """dopt's screen feedback (:2191): K consecutive screened rounds
        quarantine the worker for ``quarantine_rounds``; one clean alive
        round resets the streak; every screened send is a ledger row."""
        for i in range(self.num_workers):
            if float(flags[i]) > 0.5:
                self._screen_streak[i] += 1
                rows.append({"round": int(t), "worker": i,
                             "kind": "corrupt", "action": "screened"})
                if (self._quarantine_on and self._screen_streak[i]
                        >= self._quarantine_after):
                    until = int(t) + 1 + self._quarantine_rounds
                    self._quarantine_until[i] = until
                    self._screen_streak[i] = 0
                    rows.append({"round": int(t), "worker": i,
                                 "kind": "quarantine",
                                 "action": f"quarantined_until_{until}"})
            elif float(alive[i]) > 0:
                self._screen_streak[i] = 0

    # -- blocks: the stateful draw, the pure build, the rows -----------
    def _draw_block(self, ts: list[int]) -> dict:
        """The block's stateful host draws, on the caller's thread in
        round order: the matrices (the matching stream), and each
        round's fault inputs — on the fused quarantine the
        state-independent ones only (the rows are replayed after the
        fetch), otherwise ``_round_inputs``' whole output."""
        ws = [self._matrix_for_round(t) for t in ts]
        meta = {"ts": ts, "kinds": [t % self.eval_every == 0 for t in ts],
                "ws": ws}
        if self._registry is not None:
            # The cohort binding writes the registry and the ledger.
            meta["plans"] = [self._plan_inputs(t) for t in ts]
        if self._fused_quar:
            meta["faults"] = [self._device_inputs(
                t, *self._round_inputs_static(t, w_t))
                for t, w_t in zip(ts, ws)]
            return meta
        outs = [self._round_inputs(t, w_t) for t, w_t in zip(ts, ws)]
        meta["faults"] = [self._device_inputs(t, *o[:4])
                          for t, o in zip(ts, outs)]
        meta["rows"] = [o[4] for o in outs]
        meta["alive"] = [o[1] for o in outs]
        return meta

    def _build_block(self, meta: dict) -> dict:
        """The block's batch plans beside its drawn inputs, stacked and
        uploaded: pure, so the prefetch stager may run it on its
        background thread."""
        plans = meta.get("plans") or [self._plan_inputs(t)
                                      for t in meta["ts"]]
        rounds = [{**p, **f} for p, f in zip(plans, meta["faults"])]
        meta["dev"] = upload({k: np.stack([r[k] for r in rounds])
                              for k in rounds[0]}, self.device)
        return meta

    def _record_block(self, meta: dict, vals: np.ndarray) -> None:
        for j, (t, do_eval) in enumerate(zip(meta["ts"], meta["kinds"])):
            if self._fused_quar:
                _, alive, _, _, rows, quar = self._round_inputs(
                    t, meta["ws"][j])
                alive = alive * (1.0 - quar)
            else:
                rows, alive = meta["rows"][j], meta["alive"][j]
            self._finish_round(t, vals[j], do_eval, rows, alive)
            self.round += 1
        emit_device_resource(self, meta["ts"][-1], "block_fn")

    def run(self, rounds: int | None = None, eps: int | None = None,
            block: int | None = None, checkpoint_every: int = 0,
            checkpoint_path=None) -> History:
        """Train ``rounds`` rounds (default ``cfg.gossip.rounds``) in
        blocks of ``block`` (default ``cfg.gossip.block_rounds``; the
        last block may be shorter); ``self.round`` persists across
        calls, as in the reference.  ``eps`` is dopt's (the reference
        FedLCon's ``run(rounds, eps)``): fedlcon takes its sweeps from
        ``gossip.eps`` and refuses another value here.

        ``checkpoint_every=K`` (with ``checkpoint_path``) saves the whole
        state every K rounds — per-round runs after each round t with
        (t + 1) % K == 0, blocked runs at the first block boundary at or
        past each multiple of K — and a run killed at any point and
        resumed from the latest checkpoint (``restore``) is the
        continuous run bit for bit."""
        g = self.cfg.gossip
        rounds = g.rounds if rounds is None else rounds
        if eps is not None and eps != g.eps and g.algorithm == "fedlcon":
            raise ValueError("set eps in GossipConfig (a trainer's sweep "
                             "count is fixed at construction, as dopt's "
                             "is fixed at compilation)")
        block = g.block_rounds if block is None else block
        check_checkpoint_args(checkpoint_every, checkpoint_path)
        t0 = time.perf_counter()  # dopt: allow-wallclock -- total_time wall meter, reporting only
        with full_f32(self.device), deterministic(self.device):
            if block > 1:
                run_blocked(self, rounds, block, prefetch=g.prefetch == "on",
                            checkpoint_every=checkpoint_every,
                            checkpoint_path=checkpoint_path)
            else:
                for _ in range(rounds):
                    t = self.round
                    do_eval = t % self.eval_every == 0
                    with self.timers.phase("host_batch_plan"):
                        arg, alive, limits, cmask, rows, quar = \
                            self._round_inputs(t, self._matrix_for_round(t))
                        inp = {**self._plan_inputs(t),
                               **self._device_inputs(t, arg, alive, limits,
                                                     cmask)}
                        inp = {k: torch.from_numpy(v).to(self.device)
                               for k, v in inp.items()}
                    with self.timers.phase("round_step"):
                        self._body(inp, do_eval)
                        # ONE device→host fetch per round.
                        vals = self._slot.cpu().numpy()
                    if self._fused_quar:
                        alive = alive * (1.0 - quar)
                    self._finish_round(t, vals, do_eval, rows, alive)
                    emit_device_resource(self, t, "round_fn")
                    self.round += 1
                    if checkpoint_every and self.round % checkpoint_every == 0:
                        self.save(checkpoint_path)
        self.total_time = time.perf_counter() - t0  # dopt: allow-wallclock -- total_time wall meter, reporting only
        self._run_summary_telemetry()
        return self.history

    # -- telemetry (dopt_torch.obs) -------------------------------------
    def _round_telemetry(self, t: int, frows: list, diag=None) -> None:
        """Round t's bundle (dopt :1917-1953): the fault-ledger rows, the
        host-mirror gauges and the fetched diagnostics as gauges, then
        the History row as the ``round`` event — all from post-fetch
        host data at the same point of the per-round and the blocked
        loops, so their streams are equal.  No-op without telemetry."""
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
        if self._registry is not None:
            population_gauges(self._registry, t, gauges)
        tele.emit_round_bundle(t, engine=self.engine_kind,
                               metrics=self.history.rows[-1], faults=frows,
                               gauges=gauges)

    def _consensus_value(self) -> float | None:
        """Mean over workers of ||x_i − x̄|| on the de-biased estimates,
        or None on round 0 or for a diverged fleet (dopt :1962-1982)."""
        if self.round == 0:
            return None
        cd = consensus_distance(gather_workers(self._debiased_params(),
                                               self.group))
        return cd if math.isfinite(cd) else None

    def _run_summary_telemetry(self) -> None:
        """The end-of-``run()`` consensus-distance gauge, one a call;
        suppressed under ``diagnostics="on"``, whose per-round gauge
        carries it (an extra one mid-stream would break a resumed
        stream's equality)."""
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
        :2295-2324): train one round at a time until the round-boundary
        ``controller`` says otherwise.  ``controller.boundary(trainer)``
        runs before each round with the trainer at a consistent boundary
        and returns ``"run"`` (one more round), ``"drain"`` (stop; the
        one end-of-run summary gauge is emitted here, as a scripted
        ``run()`` emits it), ``"restart"`` (stop with no summary gauge:
        the resumed daemon's drain emits it, so an interrupted and an
        uninterrupted serve emit equal streams) or ``"rebuild"`` (the
        daemon rebuilds the trainer from an updated config)."""
        return serve_rounds(self, controller)

    # -- checkpoint -----------------------------------------------------
    def save(self, path) -> None:
        """Checkpoint the whole training state in dopt's npz layout
        (``dopt_torch.utils.checkpoint``): params and momentum as
        ``[W, ...]`` trees in the port's layout, and with
        ``fused_update="on"`` the displacement ``fused_buf`` — the
        carried params are then the post-mix q, as in dopt — plus
        dopt's meta keys (round, History and client rows, the matching
        stream's state, the fault ledger and the screen's host mirrors),
        on the link path push-sum's ``push_mass``, the staleness buffer
        ``link_buf`` and the in-flight mass ``link_buf_mass``, under
        async mixing the previous round's state ``async_prev``, and
        under choco the public copy ``x_hat``, and with the bucket codec
        the per-bucket residuals ``comm_residual`` (``b0``, ``b1``, ...,
        ``[W, Fb]`` f32 in dopt's element order).  With telemetry attached
        a ``checkpoint`` event follows the save."""
        arrays = {"momentum": dict(zip(self._names, self.momentum))}
        if self._fused_on:
            arrays["params"] = flat_views(self._q, self.fused_spec)
            arrays["fused_buf"] = flat_views(self._fbuf, self.fused_spec)
        else:
            arrays["params"] = dict(zip(self._names, self._params))
        if self._link_mode:
            # The carried params are push-sum's numerators; the mass and
            # the staleness buffers are carried state too.
            if self._push_sum:
                arrays["push_mass"] = {"mass": self._mass}
            if self._delay_max > 0:
                arrays["link_buf"] = self._link_buf
                if self._push_sum:
                    arrays["link_buf_mass"] = {"mass": self._link_buf_mass}
        if self._async:
            # Without it a resumed async run would mix round t against
            # the wrong previous-round state.
            arrays["async_prev"] = self._async_prev
        if self._choco:
            arrays["x_hat"] = self.x_hat
        if self._codec_on:
            # The residual is carried state: a resumed codec run feeds
            # back the quantization error the continuous run would.
            arrays["comm_residual"] = {f"b{i}": r
                                       for i, r in enumerate(self._comm_res)}
        meta = checkpoint_meta(self, self.cfg.gossip.algorithm)
        meta["matching_rng_state"] = self._matching_rng.bit_generator.state
        if self._registry is not None:
            meta["population_registry"] = self._registry.state_dict()
        with self.timers.phase("checkpoint"):
            save_rank_checkpoint(self.group, path, arrays, meta,
                                 replicated=("push_mass", "link_buf_mass"),
                                 lane_axis={"link_buf": 1},
                                 write=self.checkpoint_writer)
        if self.telemetry is not None:
            # After the atomic save landed, with the consensus snapshot.
            ev = {"round": int(self.round)}
            cd = self._consensus_value()
            if cd is not None:
                ev["consensus_distance"] = cd
            self.telemetry.emit("checkpoint", **ev)  # dopt: allow-nondet-event -- checkpoint cadence is an execution-path property, documented non-deterministic

    def restore(self, path) -> None:
        """Resume from a checkpoint written by ``save`` (same config), or
        by dopt's ``GossipTrainer.save`` in its npz layout (its flax
        trees convert through ``params_from_jax``).  Every carried
        tensor is written in place, so graphs this trainer already
        captured replay the restored state."""
        arrays, meta = load_checkpoint(path)
        # Every rank reads the whole file and keeps its lanes' rows.
        arrays = rank_state(self.group, arrays,
                            replicated=("push_mass", "link_buf_mass"),
                            lane_axis={"link_buf": 1})
        if meta.get("algorithm") != self.cfg.gossip.algorithm:
            raise ValueError(
                f"checkpoint is for algorithm {meta.get('algorithm')!r}, "
                f"trainer runs {self.cfg.gossip.algorithm!r}")
        if self._fused_on and "fused_buf" not in arrays:
            raise ValueError(
                "fused_update='on' trainer requires its displacement "
                "buffer ('fused_buf') in the checkpoint — this "
                "checkpoint is from a fused_update='off' run, whose "
                "carried params are the post-local endpoint, not "
                "the (post-mix, displacement) pair")
        if not self._fused_on and "fused_buf" in arrays:
            raise ValueError(
                "checkpoint carries a fused displacement buffer "
                "('fused_buf') but this trainer runs fused_update='off' "
                "— the checkpoint's 'params' are the post-mix state q, "
                "not the post-local endpoint; restore with "
                "fused_update='on'")
        if self._codec_on and "comm_residual" not in arrays:
            raise ValueError(
                "comm.codec trainer requires its per-bucket "
                "error-feedback residual ('comm_residual') in the "
                "checkpoint — this checkpoint is from an "
                "uncompressed run, whose rounds never accumulated "
                "a quantization error to feed back")
        if not self._codec_on and "comm_residual" in arrays:
            raise ValueError(
                "checkpoint carries a comm error-feedback residual "
                "('comm_residual') but this trainer runs without the "
                "bucket codec — the residual's pending correction "
                "would be silently dropped; restore with the same "
                "CommConfig codec armed")
        if self._async and "async_prev" not in arrays:
            raise ValueError(
                "mixing='async' trainer requires its previous-round "
                "state ('async_prev') in the checkpoint")
        if self._choco and "x_hat" not in arrays:
            raise ValueError(
                "choco trainer requires its public-copy state "
                "('x_hat') in the checkpoint")
        shape = self.cfg.model.input_shape
        tree = {k: port_layout(arrays[k], input_shape=shape)
                for k in ("params", "momentum", "fused_buf", "async_prev",
                          "x_hat")
                if k in arrays}
        if self._async:
            copy_into(self._async_prev, tree["async_prev"], what="async_prev")
        if self._choco:
            copy_into(self.x_hat, tree["x_hat"], what="x_hat")
        if self._codec_on:
            copy_into({f"b{i}": r for i, r in enumerate(self._comm_res)},
                      arrays["comm_residual"], what="comm_residual")
        copy_into(dict(zip(self._names, self.momentum)), tree["momentum"],
                  what="momentum")
        if self._fused_on:
            copy_into(flat_views(self._q, self.fused_spec), tree["params"],
                      what="params")
            # The model's params are not carried: the next round's
            # consensus writes them before anything reads them.
            copy_into(flat_views(self._fbuf, self.fused_spec),
                      tree["fused_buf"], what="fused_buf")
        else:
            copy_into(dict(zip(self._names, self._params)), tree["params"],
                      what="params")
        if self._link_mode:
            if self._push_sum:
                if "push_mass" not in arrays:
                    raise ValueError(
                        "push-sum trainer requires its mass vector "
                        "('push_mass') in the checkpoint")
                self._mass.copy_(torch.as_tensor(
                    np.asarray(arrays["push_mass"]["mass"], np.float32)))
            if self._delay_max > 0:
                if "link_buf" not in arrays:
                    raise ValueError(
                        "link-delay trainer requires its staleness buffer "
                        "('link_buf') in the checkpoint")
                copy_into(self._link_buf, port_layout(
                    arrays["link_buf"], input_shape=shape), what="link_buf")
                if self._push_sum:
                    if "link_buf_mass" not in arrays:
                        raise ValueError(
                            "push-sum + delay trainer requires the "
                            "in-flight mass buffer ('link_buf_mass') in "
                            "the checkpoint")
                    self._link_buf_mass.copy_(torch.as_tensor(np.asarray(
                        arrays["link_buf_mass"]["mass"], np.float32)))
        restore_meta(self, meta)
        w = self.num_workers
        self._screen_streak = np.asarray(meta.get("screen_streak", [0] * w),
                                         np.int64)
        self._quarantine_until = np.asarray(
            meta.get("quarantine_until", [0] * w), np.int64)
        if self._fused_quar:
            self._dev_streak.copy_(torch.from_numpy(
                self._screen_streak.astype(np.int32)))
            self._dev_until.copy_(torch.from_numpy(
                self._quarantine_until.astype(np.int32)))
        if meta.get("matching_rng_state"):
            self._matching_rng.bit_generator.state = meta[
                "matching_rng_state"]
        if self._registry is not None:
            restore_registry(self._registry, meta)

    # -- state ----------------------------------------------------------
    @torch.no_grad()
    def _debiased_params(self) -> dict[str, torch.Tensor]:
        """Each worker's current endpoint: the params, q − fbuf on the
        fused carry, or push-sum's de-biased estimate params/mass."""
        if self._fused_on:
            q = flat_views(self._q, self.fused_spec)
            fb = flat_views(self._fbuf, self.fused_spec)
            return {k: q[k] - fb[k] for k in self._names}
        if self._push_sum:
            mm = shard_worker_tree(torch.clamp_min(self._mass, 1e-12),
                                   self.group)
            return {k: (p.float() / mm.reshape((-1,) + (1,) * (p.dim() - 1))
                        ).to(p.dtype)
                    for k, p in zip(self._names, self._params)}
        return {k: p.detach().clone()
                for k, p in zip(self._names, self._params)}

    def worker_params(self) -> dict[str, np.ndarray]:
        """Host copy of every worker's parameters ([W, ...] arrays in the
        port's layout; ``dopt_torch.convert.params_to_jax`` gives dopt's).
        Across ranks the lanes are gathered: every rank must call it."""
        return {k: v.float().cpu().numpy()
                for k, v in gather_workers(self._debiased_params(),
                                           self.group).items()}

    def evaluate(self) -> dict[str, np.ndarray]:
        """Reference-semantics eval: every worker on the full test set,
        whatever ``eval_mode`` (which sets the in-training metric only);
        ``[W]`` arrays on every rank (a collective across ranks)."""
        params = self._debiased_params()
        mc = self.cfg.model
        with full_f32(self.device), deterministic(self.device):
            out = stacked_evaluate(
                lambda x: stacked_forward(
                    mc.model.lower(), params, x, faithful=mc.faithful,
                    dtype=DTYPES[mc.compute_dtype], impl=mc.stacked_impl),
                self.lanes, *self._eval)
        out = gather_workers(out, self.group)
        return {k: v.cpu().numpy() for k, v in out.items()}
