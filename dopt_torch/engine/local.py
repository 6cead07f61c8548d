"""The local-training phase: stacked SGD steps over the whole fleet.

Counterpart of dopt/engine/local.py's grouped stacked path (the step
core :130-164, the gathered step scan :494-623 and the stacked
evaluator :955).  One step runs the fleet's forward on the full
``[W, B, ...]`` slab, differentiates the SUM of the workers' losses —
workers are independent, so each worker's gradient is exactly its own —
and applies momentum SGD to every tensor.  The train set stays on the
device as flat ``[N, F]`` rows; each step gathers its minibatch from the
round's ``[W, S, B]`` index plan.  Nothing syncs with the host inside
the phase: per-step losses and accuracies stay on the device.
"""

from __future__ import annotations

import torch

from dopt_torch.models.losses import accuracy_stacked, cross_entropy_stacked
from dopt_torch.ops.fused_update import fused_sgd_momentum
from dopt_torch.optim import sgd_step


def stacked_step(apply, params: list[torch.Tensor], moms: list[torch.Tensor],
                 x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                 lr: float, momentum: float, fused: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One SGD step of every worker, in place over ``params``/``moms``
    (leaf tensors with ``requires_grad``).  ``apply(x) → [W, B, C]``
    reads ``params``.  Returns the detached per-worker [W] loss and
    accuracy of the step's batch."""
    out = apply(x)
    lw = cross_entropy_stacked(out, y, w)
    grads = torch.autograd.grad(lw.sum(), params)
    with torch.no_grad():
        if fused:
            fused_sgd_momentum(params, moms, grads, lr=lr, mu=momentum)
        else:
            sgd_step(params, moms, grads, lr=lr, momentum=momentum)
        return lw.detach(), accuracy_stacked(out.detach(), y, w)


def local_steps(apply, params, moms, idx: torch.Tensor, bw: torch.Tensor,
                train_x: torch.Tensor, train_y: torch.Tensor,
                sample_shape: tuple[int, ...], *, lr: float, momentum: float,
                fused: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """All S steps of a round's ``[W, S, B]`` plan over the resident
    train rows.  Returns per-worker ``[W, S]`` losses and accuracies."""
    w, s, b = idx.shape
    losses = torch.empty(w, s, device=idx.device)
    accs = torch.empty(w, s, device=idx.device)
    for k in range(s):
        ik = idx[:, k]
        x = train_x[ik].view(w, b, *sample_shape)
        lw, aw = stacked_step(apply, params, moms, x, train_y[ik], bw[:, k],
                              lr=lr, momentum=momentum, fused=fused)
        losses[:, k] = lw
        accs[:, k] = aw
    return losses, accs


@torch.no_grad()
def stacked_evaluate(apply, num_workers: int, ex: torch.Tensor,
                     ey: torch.Tensor, ew: torch.Tensor
                     ) -> dict[str, torch.Tensor]:
    """Every worker on the same eval stack ``[S, B, ...]``: each batch is
    broadcast across the worker axis.  Returns per-worker [W] ``acc``,
    ``loss_sum``, ``loss_mean`` and ``count`` (both reference loss
    flavours: P1 sums the batch losses, P2 averages them)."""
    losses, corrects, counts = [], [], []
    for x, y, w in zip(ex, ey, ew):
        xw = x.expand(num_workers, *x.shape)
        yw = y.expand(num_workers, *y.shape)
        ww = w.expand(num_workers, *w.shape)
        out = apply(xw)
        losses.append(cross_entropy_stacked(out, yw, ww))
        corrects.append(accuracy_stacked(out, yw, ww) * w.sum())
        counts.append(w.sum())
    losses = torch.stack(losses)
    total = torch.stack(counts).sum().clamp_min(1.0)
    return {"acc": torch.stack(corrects).sum(0) / total,
            "loss_sum": losses.sum(0), "loss_mean": losses.mean(0),
            "count": total.expand(num_workers)}
