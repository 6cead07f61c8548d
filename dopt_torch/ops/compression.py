"""choco's compressors and the bucket wire's integer codec
(dopt/ops/compression.py:49-271).

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

The scatter path's codec (``CommConfig(codec="qsgd")``) rounds each
``[L, F]`` bucket slab stochastically to 8- or 4-bit levels with one f32
scale per (lane, ``chunk`` elements): ``qint_encode`` returns the packed
payload and the scales, the two tensors that cross the wire, and
``qint_decode`` inverts them.  Lane i draws from ``fold_in(key, i)`` with
i its GLOBAL lane id (``lane_fold_keys``), so a lane's bits do not
depend on the rank that encodes it.

All of this is stock torch on the tensors' device, with no host sync:
a choco or codec round captures into a CUDA graph.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from dopt_torch.utils.prng import fold_in, fold_in_many, uniform, uniform_many

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


QINT_QMAX = {8: 127, 4: 7}


def lane_fold_keys(key: torch.Tensor, lane_ids) -> torch.Tensor:
    """``[L, 2]`` per-lane keys ``fold_in(key, global lane id)``."""
    ids = torch.as_tensor(lane_ids, dtype=torch.int64, device=key.device)
    return fold_in_many(key, ids)


def _chunk_pad(f: int, chunk: int) -> tuple[int, int]:
    nc = -(-f // chunk)
    return nc, nc * chunk - f


def qint_encode(v: torch.Tensor, lane_ids, key: torch.Tensor, *,
                chunk: int = 1024, bits: int = 8
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Round an ``[L, F]`` slab stochastically to ``bits``-bit levels with
    per-(lane, chunk) max-abs scales: ``(payload, scale)``.

    * bits=8: ``payload`` int8 ``[L, Fp]``, levels in [-127, 127];
    * bits=4: ``payload`` uint8 ``[L, Fp/2]``, two nibbles a byte, the
      level biased by +8 into [1, 15], the even element in the low
      nibble;

    ``scale`` is f32 ``[L, Fp/chunk]`` and Fp is F rounded up to a chunk
    multiple.  level = floor(v/scale + u), u ~ U[0, 1) from the lane's
    key, so the rounding is unbiased."""
    if bits not in QINT_QMAX:
        raise ValueError(f"qint codec supports bits in {{8, 4}}, got {bits}")
    if chunk % 2:
        raise ValueError(f"qint chunk must be even, got {chunk}")
    qmax = QINT_QMAX[bits]
    lanes, f = v.shape
    nc, pad = _chunk_pad(f, chunk)
    vf = v.float()
    if pad:
        vf = torch.nn.functional.pad(vf, (0, pad))
    bk = vf.reshape(lanes, nc, chunk)
    # A true division, as XLA's: CUDA divides by a Python scalar through
    # its reciprocal, which can differ from the quotient in the last bit.
    scale = bk.abs().amax(2) / torch.full((), float(qmax), device=v.device)
    safe = torch.where(scale > 0, scale, 1.0)
    y = bk / safe[:, :, None]
    u = uniform_many(lane_fold_keys(key, lane_ids), (nc, chunk))
    lv = torch.clamp(torch.floor(y + u), -qmax, qmax).to(torch.int32)
    lv = lv.reshape(lanes, nc * chunk)
    if bits == 8:
        return lv.to(torch.int8), scale
    biased = (lv + 8).to(torch.uint8)
    return biased[:, 0::2] | (biased[:, 1::2] << 4), scale


def qint_decode(payload: torch.Tensor, scale: torch.Tensor, f: int, *,
                chunk: int = 1024, bits: int = 8,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``qint_encode``'s inverse: levels · scale, cut to width ``f``.
    The leading axis is whatever crossed the wire (L lanes or the n of
    a gathered fleet)."""
    rows = payload.shape[0]
    if bits == 8:
        lv = payload.float()
    else:
        lo = (payload & 0xF).to(torch.int32)
        hi = ((payload >> 4) & 0xF).to(torch.int32)
        lv = torch.stack([lo, hi], dim=-1).reshape(rows, -1).float() - 8.0
    nc = scale.shape[-1]
    safe = torch.where(scale > 0, scale, 1.0)
    bk = lv.reshape(rows, nc, -1) * safe[:, :, None]
    return bk.reshape(rows, -1)[:, :f].to(out_dtype)


def qint_wire_bytes(f: int, *, chunk: int = 1024, bits: int = 8) -> int:
    """Per-lane wire bytes of one encoded bucket: the packed levels and
    the f32 scale sidecar."""
    nc, pad = _chunk_pad(f, chunk)
    return (f + pad) * bits // 8 + nc * 4


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
