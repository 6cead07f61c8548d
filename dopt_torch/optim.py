"""Local optimizer: momentum SGD with torch semantics, and the federated
algorithms' gradient edits.

The reference trains every client with ``torch.optim.SGD(lr, momentum)``:

    buf ← momentum·buf + grad        (buf starts at grad on first step)
    p   ← p − lr·buf

(no dampening, no Nesterov).  Zero-initialised buffers are exactly
equivalent to torch's lazy buf-starts-at-grad initialisation.  This is
the port of ``dopt.optim``: ``sgd_step`` updates tensors in place; the
FedProx / FedADMM / SCAFFOLD edits and refreshes take and return dicts
of tensors (dopt's pytrees), where a single-model operand (theta, the
server control) broadcasts against ``[W, ...]`` stacked ones.

Every op here has jnp's arithmetic in the storage dtype: jnp multiplies
an array by a Python scalar in the array's dtype (weak typing), so in
bf16 it rounds lr, μ, rho and the SCAFFOLD scale to bf16 first (0.9 is
0.8984375) and rounds each op's result to bf16.  torch computes such an
op in f32 with the scalar in f32, so each scalar goes through
``_scalar`` first; in f32 that changes nothing.  The rounding is cached
(``rounded``), and the trainers round their constants at construction,
so a round body only looks them up: nothing in it builds a host tensor,
and a CUDA graph captured from it bakes in the same values the eager
body uses.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


@functools.lru_cache(maxsize=None)
def rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (through a CPU tensor, once per value
    and dtype), as jnp's weak typing rounds a Python scalar before it
    meets an array."""
    return torch.tensor(x, dtype=dtype).item()


def _scalar(x: float, like: torch.Tensor) -> float:
    """``x`` rounded to ``like``'s dtype (``rounded``)."""
    return rounded(float(x), like.dtype)


class SGDState(NamedTuple):
    """One model's momentum buffers: a dict of tensors matching its
    parameters (dopt's pytree)."""
    momentum: dict[str, torch.Tensor]


@torch.no_grad()
def init_sgd(params: dict[str, torch.Tensor]) -> SGDState:
    """Zero momentum buffers, contiguous, each in its parameter's dtype
    and on its device (a torch SGD buffer starts at the first gradient,
    which from zero is the same step)."""
    return SGDState(momentum={
        k: torch.zeros_like(p, memory_format=torch.contiguous_format)
        for k, p in params.items()})


@torch.no_grad()
def sgd_step(params, moms, grads, *, lr: float, momentum: float) -> None:
    """One momentum-SGD step over lists of tensors, in place: dopt's
    unfused update (``dopt.optim.sgd_step``), every op rounded to the
    storage dtype.  In bf16 this is not kernel 1's arithmetic (f32 math,
    one rounding at the store: ``dopt_torch.ops.sgd_momentum_reference``);
    in f32 the two agree bit for bit."""
    for p, m, g in zip(params, moms, grads):
        m.mul_(_scalar(momentum, m)).add_(g)
        p.sub_(m * _scalar(lr, p))


def clip_by_global_norm(grads: dict[str, torch.Tensor],
                        max_norm: float) -> dict[str, torch.Tensor]:
    """Scale one model's gradient dict so its global ℓ2 norm is at most
    ``max_norm`` (dopt's ``clip_by_global_norm``): the one-lane
    ``clip_by_global_norm_stacked``."""
    out = clip_by_global_norm_stacked({k: g[None] for k, g in grads.items()},
                                      max_norm)
    return {k: g[0] for k, g in out.items()}


@torch.no_grad()
def clip_by_global_norm_stacked(grads: dict[str, torch.Tensor],
                                max_norm: float) -> dict[str, torch.Tensor]:
    """Per-worker global-norm clip of a stacked ``[W, ...]`` gradient
    dict (``dopt.optim.clip_by_global_norm_stacked``): each worker's
    squared norm accumulates in f32 over all tensors, in jax's leaf
    order (sorted names), and its scale
    min(1, max_norm / max(‖g‖, 1e-12)) is cast to the gradient's dtype
    before the multiply."""
    sq = 0.0
    for k in sorted(grads):
        g = grads[k]
        sq = sq + g.float().square().reshape(g.shape[0], -1).sum(1)
    scale = (max_norm / sq.sqrt().clamp_min(1e-12)).clamp_max(1.0)
    return {k: g * scale.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)
            for k, g in grads.items()}


def prox_grad_edit(grads, params, theta, rho: float):
    """FedProx: g + rho·(p − theta)  (reference clients.py:111)."""
    return {k: g + _scalar(rho, g) * (params[k] - theta[k])
            for k, g in grads.items()}


def admm_grad_edit(grads, params, theta, alpha, rho: float):
    """FedADMM: g + alpha + rho·(p − theta)  (reference clients.py:135)."""
    return {k: g + alpha[k] + _scalar(rho, g) * (params[k] - theta[k])
            for k, g in grads.items()}


def admm_dual_ascent(alpha, params, theta, rho: float):
    """After the local epochs: alpha + rho·(p − theta)
    (reference clients.py:141-144)."""
    return {k: a + _scalar(rho, a) * (params[k] - theta[k])
            for k, a in alpha.items()}


def scaffold_grad_edit(grads, c_global, c_local):
    """SCAFFOLD's variance-reduced step: g − c_i + c."""
    return {k: g - c_local[k] + c_global[k] for k, g in grads.items()}


def scaffold_control_update(c_local, c_global, theta, params, *, lr: float,
                            num_steps):
    """Option-II control refresh after K local steps:
    c_i⁺ = c_i − c + (theta − y_i)/(K·lr), ``lr`` the EFFECTIVE step
    size (the engine passes lr/(1 − momentum)).  ``num_steps`` is an int,
    or a [W] int tensor of each lane's executed steps (a straggler
    refreshes with the steps it finished): the scale is then f32 per
    lane, as dopt's, and the result is cast back to the storage dtype."""
    if isinstance(num_steps, torch.Tensor):
        scale = 1.0 / (lr * torch.clamp_min(num_steps, 1).float())
        return {k: (ci - c_global[k] + scale.reshape(
                    (-1,) + (1,) * (ci.dim() - 1)) * (theta[k] - params[k])
                    ).to(ci.dtype)
                for k, ci in c_local.items()}
    scale = scaffold_scale(lr, num_steps)
    return {k: ci - c_global[k]
            + _scalar(scale, ci) * (theta[k] - params[k])
            for k, ci in c_local.items()}


def scaffold_scale(lr: float, num_steps: int) -> float:
    """1/(K·lr), the factor of SCAFFOLD's option-II control refresh."""
    return 1.0 / (lr * max(num_steps, 1))


def grad_edit(algorithm: str, *, rho: float = 0.0, theta=None, alpha=None):
    """The local step's gradient edit for ``algorithm`` as
    ``edit(grads, params) → grads`` (dicts), or None for plain SGD.
    SCAFFOLD's ``theta`` slot carries the server control c and its
    ``alpha`` slot the client controls c_i, as in dopt."""
    if algorithm == "sgd":
        return None
    if algorithm == "fedprox":
        return lambda g, p: prox_grad_edit(g, p, theta, rho)
    if algorithm == "fedadmm":
        return lambda g, p: admm_grad_edit(g, p, theta, alpha, rho)
    if algorithm == "scaffold":
        return lambda g, p: scaffold_grad_edit(g, theta, alpha)
    raise ValueError(f"unknown local algorithm {algorithm!r}")
