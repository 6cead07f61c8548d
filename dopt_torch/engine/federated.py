"""Server-coordinated federated training on one GPU: the port's
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
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dopt_torch.config import ExperimentConfig
from dopt_torch.data import make_batch_plan, stacked_eval_batches, upload
from dopt_torch.convert import port_layout
from dopt_torch.engine.gossip import (DTYPES, check_checkpoint_args,
                                      checkpoint_meta, initial_params, later,
                                      load_device_data, resolve_device,
                                      restore_meta, steps_per_round,
                                      validate_common)
from dopt_torch.engine.graphs import RoundGraphs, run_blocked
from dopt_torch.engine.local import (local_steps, stacked_eval_gathered,
                                     stacked_evaluate)
from dopt_torch.models.zoo import deterministic, full_f32, stacked_forward
from dopt_torch.ops.fused_update import fused_mix_update
from dopt_torch.optim import (admm_dual_ascent, grad_edit, rounded,
                              scaffold_control_update, scaffold_scale)
from dopt_torch.parallel.collectives import (alloc_flat, broadcast_to_workers,
                                             flat_views,
                                             make_update_shard_spec,
                                             masked_average,
                                             mean_weight_matrix, where_mask)
from dopt_torch.robust import finite_lane_mask, masked_mean
from dopt_torch.utils.checkpoint import (copy_into, load_checkpoint,
                                         save_checkpoint)
from dopt_torch.utils.metrics import History
from dopt_torch.utils.prng import host_rng

_LOCAL_ALGORITHM = {"fedavg": "sgd", "fedprox": "fedprox",
                    "fedadmm": "fedadmm", "scaffold": "scaffold"}


def validate_federated(cfg: ExperimentConfig) -> None:
    """Refuse every configuration the federated engine does not run yet,
    naming the later slice that adds it; keep dopt's own refusals of the
    fused epilogue with companion state and with compact sampling."""
    f = cfg.federated
    if f is None:
        raise ValueError("cfg.federated must be set for FederatedTrainer")
    validate_common(cfg)
    for section in ("faults", "robust"):
        if getattr(cfg, section) is not None:
            raise later(f"cfg.{section} on the federated engine",
                        "federated faults")
    if f.algorithm not in _LOCAL_ALGORITHM:
        raise ValueError(f"unknown federated algorithm {f.algorithm!r}")
    if f.update_sharding not in ("off", "scatter"):
        raise ValueError(f"unknown update_sharding {f.update_sharding!r}; "
                         "one of off|scatter")
    for knob in ("prefetch", "diagnostics", "fused_update"):
        if getattr(f, knob) not in ("off", "on"):
            raise ValueError(f"unknown {knob} {getattr(f, knob)!r}; one of "
                             "off|on")
    if f.staleness_max > 0:
        raise later("staleness-aware aggregation (staleness_max > 0)",
                    "network")
    if f.update_sharding == "scatter":
        raise later("update_sharding='scatter'", "scatter and multi-GPU")
    if f.comm_dtype:
        raise later(f"comm_dtype={f.comm_dtype!r}", "codecs")
    if f.diagnostics == "on":
        raise later("diagnostics='on'", "telemetry")
    if f.fused_update == "on":
        if f.algorithm not in ("fedavg", "fedprox"):
            raise ValueError(
                "fused_update='on' fuses the masked-mean contraction with "
                f"the theta update; algorithm {f.algorithm!r} carries "
                "companion state (SCAFFOLD controls / ADMM duals) through "
                "the aggregate, which the fused epilogue does not speak "
                "(fedavg|fedprox)")
        if f.compact:
            raise ValueError(
                "FederatedConfig.compact=True is incompatible with "
                "fused_update='on': the fused epilogue contracts the full "
                "[W, ...] slab — drop one of the two")


def _lanes(tree: dict[str, torch.Tensor], m: int) -> dict[str, torch.Tensor]:
    """m fresh contiguous copies of a single model, as ``[m, ...]``."""
    return {k: x.repeat(m, *([1] * x.dim())) for k, x in tree.items()}


class FederatedTrainer:
    """FedAvg / FedProx / FedADMM / SCAFFOLD over ``cfg.data.num_users``
    clients on one device.

    ``device`` defaults to CUDA and raises where there is none; pass
    ``device="cpu"`` to run on the CPU (the kernels' plain versions).
    ``init_params`` takes one worker's dopt params tree (numpy leaves) so
    a run can start at dopt's exact init.  ``eval_train=False`` skips the
    per-client train-split eval (the History's train_loss/train_acc are
    then 0).  SCAFFOLD's client controls are a ``[W, ...]`` state like
    the ADMM duals (``self.duals``); its server control is
    ``self.c_global``; sampled SCAFFOLD clients start from a fresh zero
    momentum and refresh their control with the step size
    lr/(1 − momentum).  Takes ``model.compute_dtype``,
    ``model.param_dtype`` and ``optim.clip_norm`` as ``GossipTrainer``
    does; with bf16 storage theta, the slab, the displacement store,
    momentum, duals and controls are all bf16.  On CUDA ``run`` and the
    evals run in full f32 and in the deterministic mode, as
    ``GossipTrainer``'s do.
    """

    def __init__(self, cfg: ExperimentConfig, *, device=None,
                 init_params=None, eval_train: bool = True):
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
        # the sampled clients only.
        self.client_history = History(cfg.name + "-clients")
        w = self.num_workers = cfg.data.num_users

        load_device_data(self, cfg, dev, local_bs=f.local_bs)
        self.steps_per_round = steps_per_round(self._train_matrix,
                                               f.local_bs, f.local_ep)
        ti, tw = stacked_eval_batches(self._train_matrix,
                                      batch_size=max(f.local_bs, 256))
        self._train_eval = (torch.from_numpy(ti.astype(np.int64)).to(dev),
                            torch.from_numpy(tw).to(dev))

        p0 = {k: v.to(dev) for k, v in initial_params(cfg,
                                                      init_params).items()}
        self.param_count = sum(v.numel() for v in p0.values())
        self.params = {k: v.requires_grad_(True)
                       for k, v in _lanes(p0, w).items()}
        zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
        self.momentum = _lanes(zeros, w)
        self.duals = (_lanes(zeros, w)
                      if f.algorithm in ("fedadmm", "scaffold") else None)
        self.c_global = zeros if f.algorithm == "scaffold" else None

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
        # train loss, train acc, then (holdout) the [4, m, E] epoch rows
        # of the sampled clients.
        width = 5 + (4 * self._sampled_count() * f.local_ep
                     if self._val is not None else 0)
        self._slot = torch.zeros(width, device=dev)
        self.graphs = RoundGraphs(self._body, self._slot)

    # -- sampling and path choice ---------------------------------------
    def _sampled_count(self) -> int:
        return max(int(self.cfg.federated.frac * self.num_workers), 1)

    def _sample_indices(self) -> np.ndarray:
        """m = max(int(frac·W), 1) clients without replacement, sorted —
        dopt's draw from dopt's stream, round after round."""
        m = self._sampled_count()
        chosen = self._sample_rng.choice(self.num_workers, m, replace=False)
        return np.sort(chosen).astype(np.int32)

    def _use_compact(self) -> bool:
        if self._fused_on:
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

    # -- one round ------------------------------------------------------
    def _local(self, theta, params, moms, duals, idx, bw, val):
        """The algorithm's local phase on however many lanes ``params``
        carries, in place; returns (losses, accs, em, the lanes' new
        companion state or None)."""
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
            clip_norm=cfg.optim.clip_norm, local_ep=f.local_ep, val=val)
        with torch.no_grad():
            if algo == "fedadmm":
                new = admm_dual_ascent(duals, params, theta, cfg.optim.rho)
            elif algo == "scaffold":
                lr_eff = cfg.optim.lr / max(1.0 - cfg.optim.momentum, 1e-8)
                new = scaffold_control_update(
                    duals, self.c_global, theta, params, lr=lr_eff,
                    num_steps=bw.shape[1])
            else:
                new = None
        return losses, accs, em, new

    def _full_round(self, inp: dict[str, torch.Tensor]):
        """All W lanes train; the mask keeps what the aggregate sees."""
        w = self.num_workers
        scaffold = self.cfg.federated.algorithm == "scaffold"
        mask = inp["mask"]
        theta = self._theta()
        theta_b = (flat_views(self._theta_flat, self.fused_spec)
                   if self._fused_on else broadcast_to_workers(theta, w))
        with torch.no_grad():
            prev_p = {k: v.detach().clone() for k, v in self.params.items()}
            start = where_mask(mask, theta_b, prev_p)
            for k, p in self.params.items():
                p.copy_(start[k])
            prev_m = {k: v.clone() for k, v in self.momentum.items()}
        # SCAFFOLD keeps no momentum across rounds: a fresh zero buffer.
        moms = ({k: torch.zeros_like(v) for k, v in prev_m.items()}
                if scaffold else self.momentum)
        losses, accs, em, sub_new = self._local(theta, self.params, moms,
                                                self.duals, inp["idx"],
                                                inp["bw"], self._val)
        with torch.no_grad():
            p_t = self.params
            agg = mask * finite_lane_mask(p_t)
            # Every carried state is written in place (RoundGraphs).
            if sub_new is not None:
                new_duals = where_mask(agg, sub_new, self.duals)
                if scaffold:
                    for k, c in self.c_global.items():
                        c.copy_(c + (new_duals[k] - self.duals[k]).sum(0) / w)
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
            new_p = where_mask(agg, p_t, prev_p)
            for k, p in p_t.items():
                p.copy_(new_p[k])
            if not scaffold:
                new_m = where_mask(agg, self.momentum, prev_m)
                for k, m in self.momentum.items():
                    m.copy_(new_m[k])
            if not self._fused_on:
                # A round with no survivor keeps theta.
                avg = masked_average(new_p, agg)
                alive = agg.sum() > 0
                for k, v in theta.items():
                    v.copy_(torch.where(alive, avg[k], v))
            lane_loss = losses.mean(1)
            lane_loss = torch.where(torch.isfinite(lane_loss), lane_loss, 0.0)
            local_loss = (lane_loss * agg).sum() / agg.sum().clamp_min(1.0)
            if em:
                em = {k: v[inp["sel"]] for k, v in em.items()}
        return local_loss, em

    def _compact_round(self, inp: dict[str, torch.Tensor]):
        """Only the m sampled lanes train: gather → local → scatter."""
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
                                                inp["idx"], inp["bw"], val)
        with torch.no_grad():
            fin = finite_lane_mask(lanes)
            all_fin = fin.min() >= 1.0
            if sub_new is not None:
                kept = where_mask(fin, sub_new, duals)
                for k, d in self.duals.items():
                    d.index_copy_(0, sel_t, kept[k])
                if scaffold:
                    for k, c in self.c_global.items():
                        c.copy_(c + (kept[k] - duals[k]).sum(0) / w)
            p_keep = where_mask(fin, lanes, prev_p)
            for k, p in self.params.items():
                p.index_copy_(0, sel_t, p_keep[k])
            if not scaffold:
                m_keep = where_mask(fin, moms, prev_m)
                for k, mo in self.momentum.items():
                    mo.index_copy_(0, sel_t, m_keep[k])
            masked = masked_mean(p_keep, fin)
            any_fin = fin.sum() > 0
            for k, x in p_keep.items():
                theta[k].copy_(torch.where(
                    any_fin, torch.where(all_fin, x.mean(0), masked[k]),
                    theta[k]))
            lane_loss = losses.mean(1)
            lane_loss = torch.where(torch.isfinite(lane_loss), lane_loss, 0.0)
            local_loss = torch.where(
                all_fin, losses.mean(),
                (lane_loss * fin).sum() / fin.sum().clamp_min(1.0))
        return local_loss, em

    def _round_inputs(self, t: int, sel: np.ndarray) -> dict[str, np.ndarray]:
        """Round t's host inputs for the sample ``sel``: the batch plan
        (of the sampled lanes on the compact path), the selection and,
        at full width, the [W] 0/1 mask."""
        cfg, f = self.cfg, self.cfg.federated
        compact = self._use_compact()
        plan = make_batch_plan(self._train_matrix, batch_size=f.local_bs,
                               local_ep=f.local_ep, seed=cfg.seed,
                               round_idx=t, workers=sel if compact else None,
                               impl=cfg.data.plan_impl)
        out = {"idx": plan.idx.astype(np.int64), "bw": plan.weight,
               "sel": sel.astype(np.int64)}
        if not compact:
            out["mask"] = np.zeros(self.num_workers, np.float32)
            out["mask"][sel] = 1.0
        return out

    def _body(self, inp: dict[str, torch.Tensor], kind=None) -> None:
        """The round on the device: train, aggregate, evaluate, metrics
        into the slot (``kind`` is unused: one kind of round)."""
        step = self._compact_round if self._use_compact() else self._full_round
        local_loss, em = step(inp)
        ev = self._global_eval()
        parts = [local_loss, ev["acc"], ev["loss_sum"]]
        if self.eval_train:
            tm = stacked_eval_gathered(self._forward(self.params),
                                       *self._train_eval, self._train_x,
                                       self._train_y, self._sample_shape)
            parts += [tm["loss_mean"].mean(), tm["acc"].mean()]
        else:
            parts += [local_loss.new_zeros(())] * 2
        if em:
            parts += [em[k] for k in ("train_loss", "train_acc", "val_acc",
                                      "val_loss_sum")]
        with torch.no_grad():
            torch.cat([p.reshape(-1).float() for p in parts], out=self._slot)

    def _record(self, t: int, sel: np.ndarray, vals: np.ndarray) -> None:
        """Round t's History row (and client rows) from its metrics."""
        f = self.cfg.federated
        ll, acc, loss_sum, t_loss, t_acc = (float(v) for v in vals[:5])
        self.history.append(round=t, test_acc=acc, test_loss=loss_sum,
                            train_loss=t_loss, train_acc=t_acc,
                            local_loss=ll)
        if self._val is not None:
            tl, ta, va, vl = vals[5:].reshape(4, len(sel), f.local_ep)
            for j, wid in enumerate(sel):
                for e in range(f.local_ep):
                    self.client_history.append(
                        global_round=t, epoch=e, worker=int(wid),
                        train_loss=float(tl[j, e]), train_acc=float(ta[j, e]),
                        val_acc=float(va[j, e]), val_loss=float(vl[j, e]))

    # -- blocks: the stateful draw, the pure build, the rows -----------
    def _draw_block(self, ts: list[int]) -> dict:
        """The block's client samples: the sampling stream advances here,
        on the caller's thread, in block order.  One kind of round."""
        return {"ts": ts, "kinds": [None] * len(ts),
                "sels": [self._sample_indices() for _ in ts]}

    def _build_block(self, meta: dict) -> dict:
        """The block's batch plans, masks and selections, stacked and
        uploaded: pure, so the prefetch stager may run it on its
        background thread."""
        rounds = [self._round_inputs(t, sel)
                  for t, sel in zip(meta["ts"], meta["sels"])]
        meta["dev"] = upload({k: np.stack([r[k] for r in rounds])
                              for k in rounds[0]}, self.device)
        return meta

    def _record_block(self, meta: dict, vals: np.ndarray) -> None:
        for t, sel, v in zip(meta["ts"], meta["sels"], vals):
            self._record(t, sel, v)
            self.round += 1

    def run(self, rounds: int | None = None, block: int | None = None,
            checkpoint_every: int = 0, checkpoint_path=None) -> History:
        """Train ``rounds`` rounds (default ``cfg.federated.rounds``) at
        client fraction ``cfg.federated.frac``, in blocks of ``block``
        (default ``cfg.federated.block_rounds``; the last block may be
        shorter); ``self.round`` and the sampling stream persist across
        calls.  ``checkpoint_every``/``checkpoint_path`` as
        ``GossipTrainer.run``: a killed run resumes bit for bit, the
        client sample included."""
        f = self.cfg.federated
        rounds = f.rounds if rounds is None else rounds
        block = f.block_rounds if block is None else block
        check_checkpoint_args(checkpoint_every, checkpoint_path)
        t0 = time.perf_counter()
        with full_f32(self.device), deterministic(self.device):
            if block > 1:
                run_blocked(self, rounds, block, prefetch=f.prefetch == "on",
                            checkpoint_every=checkpoint_every,
                            checkpoint_path=checkpoint_path)
            else:
                for _ in range(rounds):
                    t = self.round
                    sel = self._sample_indices()
                    host = self._round_inputs(t, sel)
                    self._body({k: torch.from_numpy(v).to(self.device)
                                for k, v in host.items()})
                    # ONE device→host fetch per round.
                    self._record(t, sel, self._slot.cpu().numpy())
                    self.round += 1
                    if checkpoint_every and self.round % checkpoint_every == 0:
                        self.save(checkpoint_path)
        self.total_time = time.perf_counter() - t0
        return self.history

    # -- checkpoint -----------------------------------------------------
    def save(self, path) -> None:
        """Checkpoint theta, the stacked params, momentum (not for
        SCAFFOLD, whose momentum is round-local), the duals or controls
        and SCAFFOLD's server control, with dopt's meta keys and the
        client-sampling stream's state — without it a resumed run would
        replay round 0's sample.  The fused slab's rows are one model,
        so theta is written as row 0: fused and unfused checkpoints are
        interchangeable, as in dopt."""
        algo = self.cfg.federated.algorithm
        arrays = {"theta": self._theta(), "params": self.params,
                  "duals": self.duals, "c_global": self.c_global}
        if algo != "scaffold":
            arrays["momentum"] = self.momentum
        meta = checkpoint_meta(self, algo)
        w = self.num_workers
        meta.update(stale_admit_round=[0] * w, stale_weight=[0.0] * w,
                    stale_origin=[0] * w,
                    sample_rng_state=self._sample_rng.bit_generator.state)
        save_checkpoint(path, arrays=arrays, meta=meta)

    def restore(self, path) -> None:
        """Resume from a checkpoint written by ``save`` (same config), or
        by dopt's ``FederatedTrainer.save`` in its npz layout.  Every
        carried tensor is written in place (the fused slab's every row
        from the saved theta), so captured graphs stay valid."""
        arrays, meta = load_checkpoint(path)
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
        if meta.get("sample_rng_state"):
            self._sample_rng.bit_generator.state = meta["sample_rng_state"]

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
        exact for bf16 storage)."""
        return {k: v.detach().float().cpu().numpy()
                for k, v in self.params.items()}
