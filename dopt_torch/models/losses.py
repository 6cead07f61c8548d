"""Loss and metric over one model's outputs, and per worker over the
stacked fleet's.

``cross_entropy_stacked`` is ``nn.CrossEntropyLoss`` applied to the
model output, per worker: with the faithful head the output is already
softmax probabilities, so this is the reference's double softmax.  The
per-sample weights are the batch plan's padding mask; the weighted mean
with ``Σw`` in the denominator makes padded samples invisible.
"""

from __future__ import annotations

import torch


def _one_lane(outputs, labels, weights):
    """One model's batch as the stacked forms' one lane: ``[1, B, ...]``
    with unit weights where none are given."""
    if weights is None:
        weights = torch.ones(labels.shape, device=labels.device)
    return outputs[None], labels[None], weights[None]


def cross_entropy(outputs: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over one model's batch (dopt's ``cross_entropy``): the
    one-lane ``cross_entropy_stacked``, unit weights when none given."""
    return cross_entropy_stacked(*_one_lane(outputs, labels, weights))[0]


def accuracy(outputs: torch.Tensor, labels: torch.Tensor,
             weights: torch.Tensor | None = None) -> torch.Tensor:
    """Fraction of correct argmax predictions over one model's batch:
    the one-lane ``accuracy_stacked``."""
    return accuracy_stacked(*_one_lane(outputs, labels, weights))[0]


def l2_regulariser(params: dict[str, torch.Tensor], lam: float
                   ) -> torch.Tensor:
    """½·λ·Σ‖p‖² over one model's tensors in jax's leaf order (sorted
    names): the one-lane ``l2_stacked``, the a9a logistic model's ℓ2
    term."""
    return l2_stacked({k: params[k][None] for k in sorted(params)}, lam)[0]


def cross_entropy_stacked(outputs: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """[W, B, C] outputs → [W] weighted-mean CE, in float32."""
    logp = torch.log_softmax(outputs.float(), dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    w = weights.float()
    return (nll * w).sum(-1) / w.sum(-1).clamp_min(1.0)


def accuracy_stacked(outputs: torch.Tensor, labels: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """[W, B, C] outputs → [W] weighted fraction of correct argmax
    predictions (first index on ties, as ``jnp.argmax``)."""
    correct = (outputs.argmax(-1) == labels).float()
    w = weights.float()
    return (correct * w).sum(-1) / w.sum(-1).clamp_min(1.0)


def l2_stacked(params: dict[str, torch.Tensor], lam: float) -> torch.Tensor:
    """Per-worker ℓ2 penalty ½·λ·Σ‖p‖² over a stacked ``[W, ...]`` dict
    → [W] (``optim.weight_decay`` as a loss term)."""
    tot = 0.0
    for p in params.values():
        tot = tot + (p.float() ** 2).reshape(p.shape[0], -1).sum(1)
    return 0.5 * lam * tot
