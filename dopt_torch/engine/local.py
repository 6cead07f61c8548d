"""The local-training phase: stacked SGD steps over the whole fleet.

Counterpart of dopt/engine/local.py's grouped stacked path (the step
core :130-164, the gathered step scan :494-623, the epoch loop with
local-val eval :796-924 and the evaluators :777, :955).  One step runs
the fleet's forward on the full ``[W, B, ...]`` slab, differentiates
the SUM of the workers' losses — workers are independent, so each
worker's gradient is exactly its own — applies the algorithm's gradient
edit (FedProx, FedADMM, SCAFFOLD), then the per-worker global-norm clip,
then momentum SGD to every tensor (dopt's order, local.py:151-160).
Gradients come in the storage dtype of the params.  The
train set stays on the device as flat ``[N, F]`` rows; each step
gathers its minibatch from the round's ``[W, S, B]`` index plan.
Nothing syncs with the host inside the phase: per-step losses and
accuracies stay on the device.

The straggler deadline (dopt local.py:215-230, :275-290, :388-410): a
``[W]`` int32 ``limit`` on the device freezes worker w's params and
momentum from step ``limit[w]`` on.  The gate is a device comparison of
the step index against the limit, so a captured round replays it with
new limits: the fused kernel skips the gated-off lanes, the plain
update selects the old values after the step (dopt's
update-then-select).  Rows past a worker's limit are computed on its
frozen params, as dopt's.
"""

from __future__ import annotations

import torch

from dopt_torch.data import holdout_split, stacked_eval_batches
from dopt_torch.models.losses import (accuracy_stacked, cross_entropy_stacked,
                                      l2_stacked)
from dopt_torch.ops.fused_update import fused_sgd_momentum
from dopt_torch.optim import clip_by_global_norm_stacked, sgd_step


def validate_optimizer(cfg) -> None:
    """Only 'sgd' exists (the reference's single optimizer,
    clients.py:14): anything else fails at trainer construction rather
    than silently running SGD.  The one check every engine makes."""
    if cfg.optim.optimizer.lower() != "sgd":
        raise ValueError(
            f"unknown optimizer {cfg.optim.optimizer!r}: only 'sgd' "
            "exists (the reference's single optimizer, clients.py:14)")


def prepare_holdout(cfg, index_matrix, *, batch_size: int):
    """The reference's local train/val holdout (``train_val_test``):
    returns ``(train_matrix, val)`` where ``val`` is the per-worker
    ``([W, Sv, Bv] idx, weight)`` local-val eval stack, or None when
    ``cfg.data.local_holdout`` is 0 (training uses the full shard)."""
    if cfg.data.local_holdout <= 0.0:
        return index_matrix, None
    train, val = holdout_split(index_matrix, fraction=cfg.data.local_holdout,
                               mode=cfg.data.holdout_mode, seed=cfg.seed)
    return train, stacked_eval_batches(val, batch_size=batch_size)


def stacked_step(apply, params: dict, moms: dict, x: torch.Tensor,
                 y: torch.Tensor, w: torch.Tensor, *, lr: float,
                 momentum: float, fused: bool, edit=None, l2: float = 0.0,
                 clip_norm: float = 0.0, limit: torch.Tensor | None = None,
                 step: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One SGD step of every worker, in place over ``params``/``moms``
    (dicts of leaf tensors; params with ``requires_grad``).
    ``apply(x) → [W, B, C]`` reads ``params``; ``edit(grads, params)``
    is the algorithm's gradient edit (``dopt_torch.optim.grad_edit``);
    ``l2`` adds ½·λ‖p‖² to each worker's loss; ``clip_norm`` > 0 clips
    each worker's edited gradient to that global norm; ``limit`` ([W]
    int32) updates worker w only while ``step < limit[w]``.  Returns the
    detached per-worker [W] loss (ℓ2 term included) and accuracy."""
    names = list(params)
    out = apply(x)
    lw = cross_entropy_stacked(out, y, w)
    if l2:
        lw = lw + l2_stacked(params, l2)
    grads = torch.autograd.grad(lw.sum(), [params[k] for k in names])
    with torch.no_grad():
        if edit is not None or clip_norm:
            gd = dict(zip(names, grads))
            if edit is not None:
                gd = edit(gd, params)
            if clip_norm:
                gd = clip_by_global_norm_stacked(gd, clip_norm)
            grads = [gd[k] for k in names]
        ps, ms = [params[k] for k in names], [moms[k] for k in names]
        if fused:
            fused_sgd_momentum(ps, ms, grads, lr=lr, mu=momentum,
                               limit=limit, step=step)
        elif limit is None:
            sgd_step(ps, ms, grads, lr=lr, momentum=momentum)
        else:
            old = [t.clone() for t in ps + ms]
            sgd_step(ps, ms, grads, lr=lr, momentum=momentum)
            gate = step < limit
            for t, o in zip(ps + ms, old):
                t.copy_(torch.where(
                    gate.reshape((-1,) + (1,) * (t.dim() - 1)), t, o))
        return lw.detach(), accuracy_stacked(out.detach(), y, w)


def local_steps(apply, params, moms, idx: torch.Tensor, bw: torch.Tensor,
                train_x: torch.Tensor, train_y: torch.Tensor,
                sample_shape: tuple[int, ...], *, lr: float, momentum: float,
                fused: bool, edit=None, l2: float = 0.0,
                clip_norm: float = 0.0, local_ep: int = 1, val=None,
                limit: torch.Tensor | None = None):
    """All S steps of a round's ``[W, S, B]`` plan over the resident
    train rows; returns per-step ``[W, S]`` losses and accuracies and
    the epoch-history dict.  The dict is empty without ``val``.  With
    ``val`` (the holdout's ``([W, Sv, Bv] idx, weight)`` device stack)
    the loop is the reference's epoch loop: after each of the
    ``local_ep`` epochs every worker evaluates its local val split, and
    the dict holds per-epoch ``[W, E]`` train_loss, train_acc (count
    weighted), val_acc, val_loss_sum and val_loss_mean.  ``limit`` ([W]
    int32 step budgets, a whole number of epochs with ``val``) is the
    straggler gate; with ``val`` an epoch at or past a worker's limit
    reports train_loss and train_acc 0 (dopt's epoch-gated rows: the
    worker did no work) and its val metrics on the frozen params."""
    w, s, b = idx.shape
    losses = torch.empty(w, s, device=idx.device)
    accs = torch.empty(w, s, device=idx.device)
    per_epoch = s // local_ep
    vals = []
    for k in range(s):
        ik = idx[:, k]
        x = train_x[ik].view(w, b, *sample_shape)
        lw, aw = stacked_step(apply, params, moms, x, train_y[ik], bw[:, k],
                              lr=lr, momentum=momentum, fused=fused,
                              edit=edit, l2=l2, clip_norm=clip_norm,
                              limit=limit, step=k)
        losses[:, k] = lw
        accs[:, k] = aw
        if val is not None and (k + 1) % per_epoch == 0:
            vals.append(stacked_eval_gathered(apply, *val, train_x, train_y,
                                              sample_shape))
    if val is None:
        return losses, accs, {}
    shape = (w, local_ep, per_epoch)
    counts = bw.sum(-1).view(shape)
    em = {"train_loss": losses.view(shape).mean(2),
          "train_acc": ((accs.view(shape) * counts).sum(2)
                        / counts.sum(2).clamp_min(1.0))}
    if limit is not None:
        starts = torch.arange(local_ep, device=idx.device) * per_epoch
        on = starts[None, :] < limit[:, None]
        em = {k: torch.where(on, v, torch.zeros_like(v))
              for k, v in em.items()}
    for key, name in (("val_acc", "acc"), ("val_loss_sum", "loss_sum"),
                      ("val_loss_mean", "loss_mean")):
        em[key] = torch.stack([v[name] for v in vals], 1)
    return losses, accs, em


@torch.no_grad()
def _evaluate(apply, batches) -> dict[str, torch.Tensor]:
    """Per-worker metrics over ``(x [W, B, ...], y [W, B], w [W, B])``
    batches: [W] ``acc``, ``loss_sum`` and ``loss_mean`` (both reference
    loss flavours: P1 sums the batch losses, P2 averages them) and
    ``count``."""
    losses, corrects, counts = [], [], []
    for x, y, w in batches:
        out = apply(x)
        losses.append(cross_entropy_stacked(out, y, w))
        corrects.append(accuracy_stacked(out, y, w) * w.sum(-1))
        counts.append(w.sum(-1))
    losses = torch.stack(losses)
    total = torch.stack(counts).sum(0).clamp_min(1.0)
    return {"acc": torch.stack(corrects).sum(0) / total,
            "loss_sum": losses.sum(0), "loss_mean": losses.mean(0),
            "count": total}


def stacked_evaluate(apply, num_workers: int, ex: torch.Tensor,
                     ey: torch.Tensor, ew: torch.Tensor
                     ) -> dict[str, torch.Tensor]:
    """Every worker on the same eval stack ``[S, B, ...]``: each batch is
    broadcast across the worker axis (``num_workers = 1`` with a
    single-model ``apply`` is dopt's ``make_evaluator``)."""
    return _evaluate(apply, ((x.expand(num_workers, *x.shape),
                              y.expand(num_workers, *y.shape),
                              w.expand(num_workers, *w.shape))
                             for x, y, w in zip(ex, ey, ew)))


def stacked_eval_gathered(apply, idx: torch.Tensor, weight: torch.Tensor,
                          train_x: torch.Tensor, train_y: torch.Tensor,
                          sample_shape: tuple[int, ...]
                          ) -> dict[str, torch.Tensor]:
    """Each worker on ITS OWN ``[W, S, B]`` stack of resident train rows
    (dopt's ``_stacked_eval_scan``): the local-val holdout eval and the
    per-client train-split eval."""
    w, _, b = idx.shape
    return _evaluate(apply, ((train_x[idx[:, s]].view(w, b, *sample_shape),
                              train_y[idx[:, s]], weight[:, s])
                             for s in range(idx.shape[1])))
