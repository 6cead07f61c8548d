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
"""

from __future__ import annotations

import torch


@torch.no_grad()
def sgd_step(params, moms, grads, *, lr: float, momentum: float) -> None:
    """One momentum-SGD step over lists of tensors, in place.  Each op
    is rounded on its own, in f32, and the results are cast back to the
    storage dtype — the same arithmetic as the fused CUDA kernel, whose
    plain version this is (``dopt_torch.ops.sgd_momentum_reference``)."""
    for p, m, g in zip(params, moms, grads):
        buf = m.float() * momentum + g.float()
        p.copy_(p.float() - lr * buf)
        m.copy_(buf)


def prox_grad_edit(grads, params, theta, rho: float):
    """FedProx: g + rho·(p − theta)  (reference clients.py:111)."""
    return {k: g + rho * (params[k] - theta[k]) for k, g in grads.items()}


def admm_grad_edit(grads, params, theta, alpha, rho: float):
    """FedADMM: g + alpha + rho·(p − theta)  (reference clients.py:135)."""
    return {k: g + alpha[k] + rho * (params[k] - theta[k])
            for k, g in grads.items()}


def admm_dual_ascent(alpha, params, theta, rho: float):
    """After the local epochs: alpha + rho·(p − theta)
    (reference clients.py:141-144)."""
    return {k: a + rho * (params[k] - theta[k]) for k, a in alpha.items()}


def scaffold_grad_edit(grads, c_global, c_local):
    """SCAFFOLD's variance-reduced step: g − c_i + c."""
    return {k: g - c_local[k] + c_global[k] for k, g in grads.items()}


def scaffold_control_update(c_local, c_global, theta, params, *, lr: float,
                            num_steps: int):
    """Option-II control refresh after K local steps:
    c_i⁺ = c_i − c + (theta − y_i)/(K·lr), ``lr`` the EFFECTIVE step
    size (the engine passes lr/(1 − momentum))."""
    scale = 1.0 / (lr * max(num_steps, 1))
    return {k: ci - c_global[k] + scale * (theta[k] - params[k])
            for k, ci in c_local.items()}


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
