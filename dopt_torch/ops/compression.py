"""choco's compressors (dopt/ops/compression.py:49-160, :243-271).

CHOCO-SGD (``gossip.algorithm="choco"``) has each worker send a
compressed difference ``Q(x_i − x̂_i)``.  ``Q`` acts per worker on every
tensor of a stacked ``[W, ...]`` dict:

* ``top_k_compress`` keeps the k = ceil(ratio·n) largest-|·| entries of
  each row (f32 math, cast back);
* ``rand_k_compress`` keeps exactly k entries drawn without replacement
  — the k largest of a uniform score tensor — scaled by n/k (mask and
  scale in the tensor's dtype);
* ``qsgd_compress`` rounds each row stochastically to ``s`` levels of
  its 2,048-element buckets' norms (f32 math, cast back).

The draws are dopt's, bit for bit: the caller folds the round into the
base key once, and tensor i (in sorted-name order, which is dopt's
flatten order of its tree) draws from ``fold_in(key, i)``
(``dopt_torch.utils.prng``).  dopt draws its scores, buckets and tie
order over each leaf flattened in *its* layout, so with ``order``
(``dopt_torch.convert.dopt_flat_order``, as device index tensors) each
row is read in dopt's element order for the selection and the buckets,
and the result is written back in the port's.  Without ``order`` the
tensors are taken to be in dopt's layout already.

Selections break ties toward the lower index, as ``jax.lax.top_k``
does: the k-th largest value is the threshold, every entry above it is
kept, and the equal ones are kept in index order until k are kept — the
same set whatever order ``torch.topk`` returns.  QSGD's bucket norm is
an f32 sum whose order torch does not share with XLA, so a level near a
rounding boundary may land one step away from dopt's (the tests state
that bound).

All of this is stock torch on the tensors' device, with no host sync:
a choco round captures into a CUDA graph.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from dopt_torch.utils.prng import fold_in, uniform

Order = dict[str, tuple[torch.Tensor, torch.Tensor] | None]
COMPRESSORS = ("none", "topk", "randk", "qsgd")


def device_order(order: dict[str, np.ndarray | None],
                 device=None) -> Order:
    """``dopt_flat_order``'s maps as ``(to dopt, back to port)`` index
    tensors on ``device``: ``row[:, fwd]`` is a row in dopt's element
    order and ``row_d[:, inv]`` takes it back."""
    out: Order = {}
    for name, fwd in order.items():
        if fwd is None:
            out[name] = None
            continue
        inv = np.empty_like(fwd)
        inv[fwd] = np.arange(fwd.size)
        out[name] = (torch.from_numpy(fwd).to(device),
                     torch.from_numpy(inv).to(device))
    return out


def _rows(x: torch.Tensor, maps) -> torch.Tensor:
    """x as ``[W, n]`` rows in dopt's element order."""
    flat = x.reshape(x.shape[0], -1)
    return flat if maps is None else flat.index_select(1, maps[0])


def _back(rows: torch.Tensor, maps, like: torch.Tensor) -> torch.Tensor:
    """``[W, n]`` rows in dopt's order back to ``like``'s port layout."""
    if maps is not None:
        rows = rows.index_select(1, maps[1])
    return rows.reshape(like.shape)


def top_k_mask(score: torch.Tensor, k: int) -> torch.Tensor:
    """A bool mask of the k largest entries of each row of ``score``
    ``[W, n]``, ties toward the lower index (``jax.lax.top_k``'s set)."""
    thr = torch.topk(score, k, dim=1, sorted=False).values.amin(
        1, keepdim=True)
    above = score > thr
    tied = score == thr
    room = k - above.sum(1, keepdim=True, dtype=torch.int32)
    return above | (tied & (torch.cumsum(tied, 1, dtype=torch.int32) <= room))


def _leaf_size(x: torch.Tensor) -> int:
    return math.prod(x.shape[1:]) or 1


def _k(ratio: float, n: int) -> int:
    return max(int(math.ceil(ratio * n)), 1)


def top_k_compress(tree: dict[str, torch.Tensor], ratio: float, *,
                   order: Order | None = None) -> dict[str, torch.Tensor]:
    """Magnitude top-k per worker per tensor, k = ceil(ratio · n)."""
    if ratio >= 1.0:
        return tree
    out = {}
    for name in sorted(tree):
        x = tree[name]
        n = _leaf_size(x)
        k = _k(ratio, n)
        if k >= n:
            out[name] = x
            continue
        maps = None if order is None else order[name]
        flat = x.reshape(x.shape[0], n).float()
        keep = top_k_mask(_rows(flat, maps).abs(), k)
        mask = _back(keep, maps, flat).to(torch.float32)
        out[name] = (flat * mask).reshape(x.shape).to(x.dtype)
    return out


def rand_k_compress(tree: dict[str, torch.Tensor], ratio: float,
                    key: torch.Tensor, *,
                    order: Order | None = None) -> dict[str, torch.Tensor]:
    """Exactly k = ceil(ratio · n) entries per worker per tensor, drawn
    without replacement (the k largest of ``uniform(fold_in(key, i),
    (W, n))``), scaled by n/k; mask and scale in the tensor's dtype."""
    if ratio >= 1.0:
        return tree
    out = {}
    for i, name in enumerate(sorted(tree)):
        x = tree[name]
        w, n = x.shape[0], _leaf_size(x)
        k = _k(ratio, n)
        maps = None if order is None else order[name]
        keep = top_k_mask(uniform(fold_in(key, i), (w, n)), k)
        flat = x.reshape(w, n)
        mask = _back(keep, maps, flat).to(x.dtype)
        # n/k rounded to the dtype, as dopt's scale array holds it.
        scale = float(torch.tensor(n / k, dtype=x.dtype))
        out[name] = (flat * mask * scale).reshape(x.shape)
    return out


def qsgd_compress(tree: dict[str, torch.Tensor], ratio: float,
                  key: torch.Tensor, *, bucket_size: int = 2048,
                  levels: int | None = None,
                  order: Order | None = None) -> dict[str, torch.Tensor]:
    """QSGD (Alistarh et al. 2017) per worker per tensor over buckets of
    ``bucket_size`` elements in dopt's order: x → ‖b‖·sign(x)·ξ/s with ξ
    the stochastic rounding of s·|x|/‖b‖, s = ``levels`` or
    max(round(ratio · 256), 1)."""
    s = levels if levels else max(int(round(ratio * 256)), 1)
    out = {}
    for i, name in enumerate(sorted(tree)):
        x = tree[name]
        w, n = x.shape[0], _leaf_size(x)
        b = min(bucket_size, n)
        nb = -(-n // b)
        maps = None if order is None else order[name]
        flat = _rows(x.reshape(w, n), maps).float()
        if nb * b > n:
            flat = torch.nn.functional.pad(flat, (0, nb * b - n))
        bk = flat.reshape(w, nb, b)
        norm = (bk * bk).sum(2, keepdim=True).sqrt()
        safe = torch.clamp_min(norm, 1e-12)
        level = s * bk.abs() / safe
        floor = torch.floor(level)
        up = (uniform(fold_in(key, i), bk.shape) < level - floor).float()
        q = torch.sign(bk) * (floor + up) * safe / s
        q = torch.where(norm > 0, q, 0.0).reshape(w, nb * b)[:, :n]
        out[name] = _back(q, maps, x).to(x.dtype)
    return out


def make_compressor(name: str, ratio: float, *, qsgd_levels: int = 0
                    ) -> Callable[..., dict[str, torch.Tensor]]:
    """dopt's factory: ``fn(tree, key, order=None)`` → compressed tree.
    'topk' ignores the key; 'none' (and a sparsifier at ratio 1) is the
    identity."""
    if name not in COMPRESSORS:
        raise ValueError(
            f"unknown compressor {name!r}; one of none|topk|randk|qsgd")
    if name != "none" and not 0.0 < ratio <= 1.0:
        raise ValueError(f"compression_ratio must be in (0, 1], got {ratio}")
    if qsgd_levels and name != "qsgd":
        raise ValueError(
            f"qsgd_levels only applies to compression='qsgd' (got {name!r})")
    if qsgd_levels < 0:
        raise ValueError(f"qsgd_levels must be >= 0, got {qsgd_levels}")
    if name == "none" or (name != "qsgd" and ratio >= 1.0):
        return lambda tree, key, order=None: tree
    if name == "topk":
        return lambda tree, key, order=None: top_k_compress(
            tree, ratio, order=order)
    if name == "qsgd":
        return lambda tree, key, order=None: qsgd_compress(
            tree, ratio, key, levels=qsgd_levels or None, order=order)
    return lambda tree, key, order=None: rand_k_compress(
        tree, ratio, key, order=order)
