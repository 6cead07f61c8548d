"""Synchronous gossip on one GPU: the port's ``GossipTrainer``.

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
  carried through checkpoints.

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

``model.compute_dtype="bfloat16"`` runs the forward and backward in bf16
at dopt's cast points; ``model.param_dtype="bfloat16"`` stores the
params, momentum and the fused carry in bf16 (both kernels then run
their bf16 instantiations); ``optim.clip_norm > 0`` clips each worker's
gradient to that global norm after the algorithm's edit.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from dopt_torch.config import ExperimentConfig
from dopt_torch.convert import params_from_jax, port_layout
from dopt_torch.data import (eval_batches, load_dataset, make_batch_plan,
                             partition, sharded_eval_batches, upload)
from dopt_torch.engine.graphs import RoundGraphs, run_blocked
from dopt_torch.engine.local import (local_steps, prepare_holdout,
                                     stacked_eval_gathered, stacked_evaluate)
from dopt_torch.models.zoo import (LAYERS, StackedModel, deterministic,
                                   full_f32, init_worker_params,
                                   param_shapes, stacked_forward)
from dopt_torch.ops.fused_update import fused_mix_update
from dopt_torch.optim import rounded
from dopt_torch.parallel.collectives import (alloc_flat, flat_views,
                                             make_update_shard_spec, mix_dense)
from dopt_torch.topology import build_mixing_matrices, random_matching_matrix
from dopt_torch.utils.checkpoint import (copy_into, load_checkpoint,
                                         save_checkpoint)
from dopt_torch.utils.metrics import History
from dopt_torch.utils.prng import host_rng

# The dtypes ``model.compute_dtype`` and ``model.param_dtype`` take.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ALGORITHMS = ("dsgd", "nocons", "centralized", "fedlcon", "gossip", "choco")
# The algorithms that mix with a topology's schedule (gossip draws a
# matching each round; nocons does not mix).
SCHEDULED = ("dsgd", "fedlcon")


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


def later(what: str, slice_name: str) -> ValueError:
    """The refusal of an option a later slice of the port adds."""
    return ValueError(
        f"{what} is not in the PyTorch port yet; it arrives with the "
        f"'{slice_name}' slice (ROADMAP.md, queue 1)")


def validate_common(cfg: ExperimentConfig) -> None:
    """Refusals shared by both engines, each naming its later slice."""
    d, m = cfg.data, cfg.model
    for section, slice_name in (("faults", "faults"), ("robust", "robust"),
                                ("population", "population"),
                                ("comm", "codecs"), ("seqlm", "seqlm")):
        if getattr(cfg, section) is not None:
            raise later(f"cfg.{section}", slice_name)
    if cfg.backend == "torch":
        raise ValueError(
            "backend='torch' is dopt's sequential CPU oracle, which the port "
            "does not copy: the port is itself a torch engine — run it with "
            "device='cpu' for the CPU")
    if cfg.backend != "jax":
        raise ValueError(f"unknown backend {cfg.backend!r}; dopt's default "
                         "'jax' selects the engine, here the port's own")
    for knob in ("mesh_devices", "mesh_hosts"):
        if getattr(cfg, knob) not in (None, 1):
            raise later(f"{knob}={getattr(cfg, knob)}", "scatter and multi-GPU")
    if m.stage_sizes is not None:
        raise later(f"model.stage_sizes={m.stage_sizes}", "ResNet-18")
    if m.stacked_impl == "vmap":
        raise ValueError(
            "stacked_impl='vmap' is dopt's oracle-parity mode (a vmapped "
            "per-worker forward); the port runs the worker-stacked grouped "
            "convs only and will not add it — use 'auto'")
    if m.stacked_impl != "auto":
        raise ValueError(f"unknown stacked_impl {m.stacked_impl!r}; one of "
                         "auto|vmap")
    if d.plan_impl != "numpy":
        raise later(f"plan_impl={d.plan_impl!r}", "native planner")
    if m.model.lower() == "transformer":
        raise later("the sequence model", "seqlm")
    if m.model.lower() == "resnet18":
        raise later("model 'resnet18'", "ResNet-18")
    if m.model.lower() not in LAYERS:
        raise ValueError(f"unknown model {m.model!r}; one of "
                         f"{sorted([*LAYERS, 'resnet18', 'transformer'])}")
    for knob in ("compute_dtype", "param_dtype"):
        if getattr(m, knob) not in DTYPES:
            raise ValueError(f"unknown model.{knob} {getattr(m, knob)!r}; "
                             f"one of {'|'.join(DTYPES)}")
    if cfg.optim.optimizer.lower() != "sgd":
        raise ValueError(f"unknown optimizer {cfg.optim.optimizer!r}: only "
                         "'sgd' exists (the reference's single optimizer)")


def validate_slice(cfg: ExperimentConfig) -> None:
    """Refuse every configuration the gossip engine does not run yet,
    naming the later slice that adds it."""
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
    if g.algorithm == "choco":
        raise later("gossip algorithm 'choco'", "codecs")
    if g.eval_mode not in ("full", "sharded"):
        raise ValueError(f"unknown eval_mode {g.eval_mode!r}; one of "
                         "full|sharded")
    for knob, default, slice_name in (
            ("choco_gamma", 1.0, "codecs"), ("compression", "topk", "codecs"),
            ("compression_ratio", 1.0, "codecs"), ("qsgd_levels", 0, "codecs"),
            ("correction", "none", "faults"), ("dropout", 0.0, "faults")):
        if getattr(g, knob) != default:
            raise later(f"gossip.{knob}={getattr(g, knob)!r}", slice_name)
    if g.diagnostics not in ("off", "on"):
        raise ValueError(f"unknown diagnostics {g.diagnostics!r}; one of "
                         "off|on")
    if g.diagnostics == "on":
        raise later("diagnostics='on'", "telemetry")
    if g.mixing != "sync":
        raise later(f"mixing={g.mixing!r}", "async and one-peer mixing")
    if g.prefetch not in ("off", "on"):
        raise ValueError(f"unknown prefetch {g.prefetch!r}; one of off|on")
    if g.update_sharding != "off":
        raise later(f"update_sharding={g.update_sharding!r}",
                    "scatter and multi-GPU")
    if g.comm_impl == "shift":
        raise later("comm_impl='shift'", "scatter and multi-GPU")
    if g.comm_dtype:
        raise later(f"comm_dtype={g.comm_dtype!r}", "codecs")
    if g.fused_update not in ("off", "on"):
        raise ValueError(f"unknown fused_update {g.fused_update!r}; "
                         "one of off|on")
    if g.fused_update == "on" and g.algorithm not in ("dsgd", "gossip"):
        raise ValueError(
            "fused_update='on' fuses the single dense consensus sweep with "
            f"the update; algorithm {g.algorithm!r} has no such sweep to "
            "fuse (dsgd|gossip: fedlcon's eps sweeps re-enter the matrix, "
            "nocons/centralized never mix)")


def centralized_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """dopt's rewrite of ``algorithm="centralized"``: one worker on the
    whole IID training set, one local epoch a round, run as ``nocons``
    (a new frozen config; the caller's is untouched)."""
    return cfg.replace(
        data=dataclasses.replace(cfg.data, num_users=1, iid=True),
        gossip=dataclasses.replace(cfg.gossip, local_ep=1,
                                   algorithm="nocons"))


def load_device_data(trainer, cfg: ExperimentConfig, dev: torch.device, *,
                     local_bs: int) -> None:
    """Both engines' data setup: load, partition, apply the holdout and
    upload once — the train rows stay flat ``[N, F]`` on the device, the
    test set as a shared ``[S, B, ...]`` eval stack, the holdout's
    local-val stacks (if any) per worker."""
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
    trainer._val = (None if val is None else
                    tuple(torch.from_numpy(a).to(dev) for a in val))
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
                                input_shape=mc.input_shape, generator=gen)
    else:
        p0 = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in params_from_jax(
                  init_params, input_shape=mc.input_shape).items()}
        want = param_shapes(name, num_classes=mc.num_classes,
                            input_shape=mc.input_shape)
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


def checkpoint_meta(trainer, algorithm: str) -> dict:
    """Both engines' checkpoint meta, under dopt's keys: the round, the
    History and client rows, and the fault ledger and the screen's host
    mirrors (empty and zero until the faults slice fills them)."""
    w = trainer.num_workers
    return {"round": trainer.round, "name": trainer.cfg.name,
            "algorithm": algorithm, "history": trainer.history.rows,
            "client_history": trainer.client_history.rows,
            "fault_ledger": [], "screen_streak": [0] * w,
            "quarantine_until": [0] * w}


def restore_meta(trainer, meta: dict) -> None:
    """The host side of a restore: the round and the rows."""
    trainer.round = int(meta["round"])
    trainer.history.rows = list(meta.get("history", []))
    trainer.client_history.rows = list(meta.get("client_history", []))


def steps_per_round(train_matrix: np.ndarray, local_bs: int,
                    local_ep: int) -> int:
    """SGD steps in a round's plan (the padded last batch included)."""
    l_shard = train_matrix.shape[1]
    return local_ep * -(-l_shard // min(local_bs, l_shard))


class GossipTrainer:
    """Synchronous gossip over ``cfg.data.num_users`` workers on one
    device: dsgd, nocons, centralized, fedlcon or pairwise gossip.

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

    def __init__(self, cfg: ExperimentConfig, *, eval_every: int = 1,
                 device=None, init_params=None):
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
        w = cfg.data.num_users
        self.num_workers = w

        load_device_data(self, cfg, dev, local_bs=g.local_bs)
        self.steps_per_round = steps_per_round(self._train_matrix,
                                               g.local_bs, g.local_ep)
        # Sharded eval: each worker's round-robin shard of the test rows,
        # gathered from the uploaded eval stack (its first n rows are the
        # test set in order).
        self._eval_shards = None
        if g.eval_mode == "sharded":
            si, sw = sharded_eval_batches(len(self.dataset.test_y), w,
                                          batch_size=max(g.local_bs, 256))
            self._eval_shards = (torch.from_numpy(si.astype(np.int64)).to(dev),
                                 torch.from_numpy(sw).to(dev))
        # Per-epoch per-worker rows, filled when the holdout is on (P2
        # Client.history {iter, train_loss, train_acc, val_acc, val_loss}
        # plus round and worker columns; val_loss is P2's mean flavour).
        self.client_history = History(cfg.name + "-clients")

        # Model + stacked state: every worker starts from the same init.
        p0 = initial_params(cfg, init_params)
        self.param_count = sum(v.numel() for v in p0.values())
        stacked = {k: v.expand(w, *v.shape).contiguous().to(dev)
                   for k, v in p0.items()}
        self.model = StackedModel(mc.model.lower(), stacked,
                                  faithful=mc.faithful,
                                  dtype=DTYPES[mc.compute_dtype])
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
        # test loss, then (holdout) the [4, W, E] epoch rows.
        width = 4 + (4 * w * g.local_ep if self._val is not None else 0)
        self._slot = torch.zeros(width, device=dev)
        self.graphs = RoundGraphs(self._body, self._slot)

    # -- one round: host stage, device body -----------------------------
    def _matrix_for_round(self, t: int) -> np.ndarray | None:
        """Round t's mixing matrix, or None where the algorithm does not
        mix.  The matching draw advances its stream: call once a round,
        in round order, on the caller's thread."""
        if self.cfg.gossip.algorithm == "gossip":
            return random_matching_matrix(self.num_workers,
                                          self._matching_rng)
        if self.mixing is not None:
            return self.mixing.for_round(t)
        return None

    def _round_inputs(self, t: int, w_t: np.ndarray | None
                      ) -> dict[str, np.ndarray]:
        """Round t's host inputs: the drawn mixing matrix ``w_t`` (if
        any) and the batch plan."""
        g = self.cfg.gossip
        plan = make_batch_plan(self._train_matrix, batch_size=g.local_bs,
                               local_ep=g.local_ep, seed=self.cfg.seed,
                               round_idx=t)
        out = {"idx": plan.idx.astype(np.int64), "bw": plan.weight}
        if w_t is not None:
            out["w"] = w_t.astype(np.float32)
        return out

    @torch.no_grad()
    def _consensus(self, w_t: torch.Tensor) -> None:
        """Leave the round's post-consensus state in the model's params."""
        if self._fused_on:
            fused_mix_update(self._q, self._fbuf, w_t, self.fused_spec,
                             lr=1.0)
            q = flat_views(self._q, self.fused_spec)
            for k, p in zip(self._names, self._params):
                p.copy_(q[k])
            return
        mixed = dict(zip(self._names, self._params))
        for _ in range(self._sweeps):
            mixed = mix_dense(mixed, w_t)
        for k, p in zip(self._names, self._params):
            p.copy_(mixed[k])

    def _evaluate_round(self) -> dict[str, torch.Tensor]:
        """The in-training test eval: every worker on the whole test
        stack, or (sharded) each on its own shard of it."""
        if self._eval_shards is None:
            return stacked_evaluate(self.model, self.num_workers, *self._eval)
        ex, ey, _ = self._eval
        return stacked_eval_gathered(
            self.model, *self._eval_shards,
            ex.reshape(-1, *self._sample_shape), ey.reshape(-1),
            self._sample_shape)

    def _body(self, inp: dict[str, torch.Tensor], do_eval: bool) -> None:
        """The round on the device: consensus → eval (flagged rounds) →
        local epochs → fbuf, metrics into the slot.  Every state is
        written in place and nothing touches the host, so the body can
        be captured (``RoundGraphs``)."""
        cfg, g = self.cfg, self.cfg.gossip
        if "w" in inp:
            self._consensus(inp["w"])
        ev = self._evaluate_round() if do_eval else None
        losses, accs, em = local_steps(
            self.model, dict(zip(self._names, self._params)),
            dict(zip(self._names, self.momentum)), inp["idx"], inp["bw"],
            self._train_x, self._train_y, self._sample_shape,
            lr=cfg.optim.lr, momentum=cfg.optim.momentum,
            fused=cfg.optim.fused_update, l2=cfg.optim.weight_decay,
            clip_norm=cfg.optim.clip_norm, local_ep=g.local_ep,
            val=self._val)
        with torch.no_grad():
            if self._fused_on:
                q = flat_views(self._q, self.fused_spec)
                fb = flat_views(self._fbuf, self.fused_spec)
                for k, p in zip(self._names, self._params):
                    torch.sub(q[k], p, out=fb[k])
            # dopt's round accuracy: the epochs' count-weighted accuracies
            # with the holdout, the steps' mean without.
            if em:
                accs = em["train_acc"]
            test = ([ev["acc"].mean(), ev["loss_mean"].mean()] if do_eval
                    else [losses.new_zeros(())] * 2)
            parts = [losses.mean(), accs.mean(), *test]
            if em:
                parts += [em[k] for k in ("train_loss", "train_acc",
                                          "val_acc", "val_loss_mean")]
            torch.cat([p.reshape(-1) for p in parts], out=self._slot)

    def _record(self, t: int, vals: np.ndarray, do_eval: bool) -> None:
        """Round t's History row (and client rows) from its metrics."""
        row = {"round": t, "avg_train_loss": float(vals[0]),
               "avg_train_acc": float(vals[1])}
        if do_eval:
            row.update(avg_test_acc=float(vals[2]),
                       avg_test_loss=float(vals[3]))
        self.history.append(**row)
        if self._val is not None:
            e = self.cfg.gossip.local_ep
            tl, ta, va, vl = vals[4:].reshape(4, self.num_workers, e)
            for i in range(self.num_workers):
                for j in range(e):
                    self.client_history.append(
                        round=t, iter=j, worker=i,
                        train_loss=float(tl[i, j]), train_acc=float(ta[i, j]),
                        val_acc=float(va[i, j]), val_loss=float(vl[i, j]))

    # -- blocks: the stateful draw, the pure build, the rows -----------
    def _draw_block(self, ts: list[int]) -> dict:
        """The block's rounds, which of them evaluate (the graph kinds)
        and their mixing matrices: the matching stream advances here,
        on the caller's thread, in round order."""
        return {"ts": ts, "kinds": [t % self.eval_every == 0 for t in ts],
                "ws": [self._matrix_for_round(t) for t in ts]}

    def _build_block(self, meta: dict) -> dict:
        """The block's batch plans beside its drawn matrices, stacked and
        uploaded: pure, so the prefetch stager may run it on its
        background thread."""
        rounds = [self._round_inputs(t, w_t)
                  for t, w_t in zip(meta["ts"], meta["ws"])]
        meta["dev"] = upload({k: np.stack([r[k] for r in rounds])
                              for k in rounds[0]}, self.device)
        return meta

    def _record_block(self, meta: dict, vals: np.ndarray) -> None:
        for t, do_eval, v in zip(meta["ts"], meta["kinds"], vals):
            self._record(t, v, do_eval)
            self.round += 1

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
        t0 = time.perf_counter()
        with full_f32(self.device), deterministic(self.device):
            if block > 1:
                run_blocked(self, rounds, block, prefetch=g.prefetch == "on",
                            checkpoint_every=checkpoint_every,
                            checkpoint_path=checkpoint_path)
            else:
                for _ in range(rounds):
                    t = self.round
                    do_eval = t % self.eval_every == 0
                    inp = self._round_inputs(t, self._matrix_for_round(t))
                    self._body({k: torch.from_numpy(v).to(self.device)
                                for k, v in inp.items()}, do_eval)
                    # ONE device→host fetch per round.
                    self._record(t, self._slot.cpu().numpy(), do_eval)
                    self.round += 1
                    if checkpoint_every and self.round % checkpoint_every == 0:
                        self.save(checkpoint_path)
        self.total_time = time.perf_counter() - t0
        return self.history

    # -- checkpoint -----------------------------------------------------
    def save(self, path) -> None:
        """Checkpoint the whole training state in dopt's npz layout
        (``dopt_torch.utils.checkpoint``): params and momentum as
        ``[W, ...]`` trees in the port's layout, and with
        ``fused_update="on"`` the displacement ``fused_buf`` — the
        carried params are then the post-mix q, as in dopt — plus
        dopt's meta keys (round, History and client rows, the matching
        stream's state; the fault ledger and the screen's host mirrors,
        empty until the faults slice)."""
        arrays = {"momentum": dict(zip(self._names, self.momentum))}
        if self._fused_on:
            arrays["params"] = flat_views(self._q, self.fused_spec)
            arrays["fused_buf"] = flat_views(self._fbuf, self.fused_spec)
        else:
            arrays["params"] = dict(zip(self._names, self._params))
        meta = checkpoint_meta(self, self.cfg.gossip.algorithm)
        meta["matching_rng_state"] = self._matching_rng.bit_generator.state
        save_checkpoint(path, arrays=arrays, meta=meta)

    def restore(self, path) -> None:
        """Resume from a checkpoint written by ``save`` (same config), or
        by dopt's ``GossipTrainer.save`` in its npz layout (its flax
        trees convert through ``params_from_jax``).  Every carried
        tensor is written in place, so graphs this trainer already
        captured replay the restored state."""
        arrays, meta = load_checkpoint(path)
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
        shape = self.cfg.model.input_shape
        tree = {k: port_layout(arrays[k], input_shape=shape)
                for k in ("params", "momentum", "fused_buf") if k in arrays}
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
        restore_meta(self, meta)
        if meta.get("matching_rng_state"):
            self._matching_rng.bit_generator.state = meta[
                "matching_rng_state"]

    # -- state ----------------------------------------------------------
    @torch.no_grad()
    def _debiased_params(self) -> dict[str, torch.Tensor]:
        """Each worker's current endpoint: the params, or q − fbuf on the
        fused carry."""
        if self._fused_on:
            q = flat_views(self._q, self.fused_spec)
            fb = flat_views(self._fbuf, self.fused_spec)
            return {k: q[k] - fb[k] for k in self._names}
        return {k: p.detach().clone()
                for k, p in zip(self._names, self._params)}

    def worker_params(self) -> dict[str, np.ndarray]:
        """Host copy of every worker's parameters ([W, ...] arrays in the
        port's layout; ``dopt_torch.convert.params_to_jax`` gives dopt's)."""
        return {k: v.float().cpu().numpy()
                for k, v in self._debiased_params().items()}

    def evaluate(self) -> dict[str, np.ndarray]:
        """Reference-semantics eval: every worker on the full test set,
        whatever ``eval_mode`` (which sets the in-training metric only)."""
        params = self._debiased_params()
        mc = self.cfg.model
        with full_f32(self.device), deterministic(self.device):
            out = stacked_evaluate(
                lambda x: stacked_forward(
                    mc.model.lower(), params, x, faithful=mc.faithful,
                    dtype=DTYPES[mc.compute_dtype]),
                self.num_workers, *self._eval)
        return {k: v.cpu().numpy() for k, v in out.items()}
