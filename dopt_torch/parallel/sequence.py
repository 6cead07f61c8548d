"""Sequence parallelism over ranks: ring attention and Ulysses all-to-all.

The port of dopt/parallel/sequence.py.  dopt writes both as
``shard_map`` programs over a 1-D device mesh; here each rank of a
``WorkerGroup`` (``dopt_torch.parallel.mesh.make_seq_group``) calls the
function on its own contiguous block of the sequence, and the
collectives cross ``torch.distributed`` (NCCL, one GPU a rank; or gloo,
on the CPU or for ranks that share one card, host-staged).  A group
without a wire is dopt's one-device mesh: no collective is issued.

* ``ring_attention`` — blockwise-softmax attention with the KV blocks
  rotating around the ranks, one hop a step: rank d receives from rank
  d + 1 (dopt's ``perm = [((d+1)%n, d)]``), so at step t it holds key
  block (d + t) mod n.  The running (num, den, max) accumulators make
  the result exact.  The rotation is an autograd function whose
  backward sends the gradient the other way; the rotation after the
  last block is skipped.  ``kv_chunk`` scans each block's KV in chunks
  with exact cross-chunk causal masks.  Every block (and every chunk)
  runs under ``torch.utils.checkpoint`` — dopt's ``jax.checkpoint``
  remat — so autograd keeps only its inputs and recomputes the
  ``[B, Lq, H, Lk]`` scores in the backward: a rank's score memory is
  O(block · kv_chunk), not O(L²).
* ``ulysses_attention`` — one all-to-all turns the sequence-sharded
  ``[B, L/n, H, Dh]`` q, k and v into head-sharded ``[B, L, H/n, Dh]``,
  dense attention runs over the full sequence for this rank's heads, and
  a second all-to-all turns the result back.  Each all-to-all's
  backward is the same all-to-all on the gradient.

dopt's attention is plain ``jnp`` that XLA compiles without Pallas, so
these are stock torch ops mirroring its formulas (``m_safe``, the
``isfinite`` zeroing, the flash combine); dense, ring and chunked share
one arithmetic.  ``F.scaled_dot_product_attention`` cannot stand in for
``_block_attn``: the ring needs the partial (num, den, max).  The group's
byte meter counts the ring's sends as ``("send", "ring")`` and Ulysses'
exchanges as ``("all_to_all", "ulysses")``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from dopt_torch.parallel.collectives import _all_to_all, _rotate, _wired


def _scale(q: torch.Tensor) -> float:
    """dopt's ``1 / sqrt(Dh)`` computed in q's dtype (so rounded to bf16
    for bf16 compute), as a Python float."""
    d = torch.tensor(float(q.shape[-1])).sqrt().to(q.dtype)
    return (1.0 / d).item()


def _block_attn(q, k, v, *, scale, mask=None):
    """Unnormalised blockwise attention: (numerator [B, Lq, H, Dh],
    denominator [B, Lq, H], rowmax [B, Lq, H]) for one KV block."""
    s = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale   # [B, Lq, H, Lk]
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1)                                       # [B, Lq, H]
    # All-masked rows (a causal block wholly in the future) have rowmax
    # -inf; zero it so exp() never sees NaN and the rows contribute 0.
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    num = torch.einsum("bqhk,bkhd->bqhd", p, v)
    return num, p.sum(-1), m_safe


def _combine(num1, den1, m1, num2, den2, m2):
    """Merge two blockwise-softmax partial results (flash combine)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    num = num1 * a1[..., None] + num2 * a2[..., None]
    den = den1 * a1 + den2 * a2
    return num, den, m


def _block_attn_remat(q, k, v, scale, mask):
    """``_block_attn`` under rematerialisation (dopt's ``jax.checkpoint``):
    only (q, k, v) are kept for the backward, which recomputes the
    scores — the flash-attention trade of ~⅓ more attention FLOPs for
    O(block · chunk) peak memory."""
    return checkpoint(lambda q, k, v: _block_attn(q, k, v, scale=scale,
                                                  mask=mask),
                      q, k, v, use_reentrant=False, preserve_rng_state=False)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """[1, Lq, 1, Lk]: query position i sees key positions ≤ i."""
    return (q_pos[:, None] >= k_pos[None, :])[None, :, None, :]


def _accumulators(q: torch.Tensor):
    """The scans' starting (num, den, max) = (0, 0, -inf)."""
    num = torch.zeros_like(q)
    den = num.sum(-1)
    return num, den, den - float("inf")


def dense_attention(q, k, v, *, causal: bool = False):
    """One rank's exact attention — the correctness reference.
    q, k, v: [B, L, H, Dh]."""
    s = torch.einsum("bqhd,bkhd->bqhk", q, k) * _scale(q)
    if causal:
        lq, lk = s.shape[1], s.shape[3]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask[None, :, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", p, v)


def _block_attn_chunked(qb, kb_t, vb_t, *, scale, q_pos, k_pos0, chunk):
    """Blockwise attention against one KV block, itself scanned in
    ``chunk``-sized KV slices: peak score memory drops from O(Lq·Lk) to
    O(Lq·chunk) without changing the exact result.  ``q_pos``/``k_pos0``
    are global positions for exact cross-chunk causal masking
    (``q_pos=None`` for non-causal)."""
    num, den, m = _accumulators(qb)
    for c0 in range(0, kb_t.shape[1], chunk):
        mask = None
        if q_pos is not None:
            k_pos = k_pos0 + c0 + torch.arange(chunk, device=qb.device)
            mask = _causal_mask(q_pos, k_pos)
        num2, den2, m2 = _block_attn_remat(qb, kb_t[:, c0:c0 + chunk],
                                           vb_t[:, c0:c0 + chunk], scale,
                                           mask)
        num, den, m = _combine(num, den, m, num2, den2, m2)
    return num, den, m


class _RingShift(torch.autograd.Function):
    """The ring's hop: rank d receives rank d + 1's payload; the gradient
    travels back to rank d + 1."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rotate(x, 1, group, "ring")

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, -1, ctx.group, "ring"), None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``[size, ...]`` pieces; it is its own
    transpose, so the backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group, "ulysses")

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, "ulysses"), None


def ring_attention(q, k, v, group=None, *, causal: bool = False,
                   kv_chunk: int | None = None):
    """Exact attention with the sequence split over ``group``'s ranks.

    q, k, v: this rank's [B, block, H, Dh] block of the sequence (rank r
    holds positions [r·block, (r+1)·block)).  Rank r starts with key
    block r and receives blocks r+1, r+2, ... as the KV pair rotates
    around the ring — n − 1 hops.  Causal masking is exact across
    blocks.  ``kv_chunk`` additionally scans each block's KV in chunks of
    that size (it must divide the block).  ``group=None`` (or a group
    without a wire) is one rank: a one-block ring."""
    wired = _wired(group)
    n, my = (group.size, group.rank) if wired else (1, 0)
    block = q.shape[1]
    if kv_chunk is not None and (kv_chunk <= 0 or block % kv_chunk):
        raise ValueError(f"kv_chunk {kv_chunk} must divide the per-device "
                         f"block {block}")
    scale = _scale(q)
    q_pos = my * block + torch.arange(block, device=q.device)
    num, den, m = _accumulators(q)
    kv = torch.stack([k, v])
    for t in range(n):
        kv_idx = (my + t) % n               # the key block held now
        kb_t, vb_t = kv[0], kv[1]
        if kv_chunk is not None:
            num2, den2, m2 = _block_attn_chunked(
                q, kb_t, vb_t, scale=scale, q_pos=q_pos if causal else None,
                k_pos0=kv_idx * block, chunk=kv_chunk)
        else:
            mask = None
            if causal:
                mask = _causal_mask(q_pos, kv_idx * block + torch.arange(
                    block, device=q.device))
            num2, den2, m2 = _block_attn_remat(q, kb_t, vb_t, scale, mask)
        num, den, m = _combine(num, den, m, num2, den2, m2)
        # The rotation after the last block would be discarded: skipped.
        if t < n - 1:
            kv = _RingShift.apply(kv, group)
    # Fully-masked rows (never for causal self-attention, where every
    # query sees at least itself) would have den 0.
    return num / den.clamp_min(1e-30)[..., None]


def ulysses_attention(q, k, v, group=None, *, causal: bool = False):
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses pattern).

    q, k, v: this rank's [B, L/n, H, Dh] block.  One all-to-all (q, k and
    v in one exchange) makes them [B, L, H/n, Dh] — rank r's heads
    [r·H/n, (r+1)·H/n) over the whole sequence —, dense attention runs
    locally, and a second all-to-all restores the sequence split.  The
    head count must divide by the rank count."""
    n = group.size if _wired(group) else 1
    h = q.shape[2]
    if h % n:
        raise ValueError(f"num heads {h} not divisible by mesh axis {n}")
    if n == 1:
        return dense_attention(q, k, v, causal=causal)
    b, lb, _, d = q.shape
    # [3, B, Lb, n, H/n, Dh] → [n, 3, B, Lb, H/n, Dh]: piece j for rank j.
    parts = torch.stack([q, k, v]).reshape(3, b, lb, n, h // n, d)
    got = _AllToAll.apply(parts.permute(3, 0, 1, 2, 4, 5), group)
    # Piece i came from rank i: sequence block i of this rank's heads.
    qh, kh, vh = got.permute(1, 2, 0, 3, 4, 5).reshape(3, b, n * lb,
                                                       h // n, d)
    out = dense_attention(qh, kh, vh, causal=causal)
    # [B, L, H/n, Dh] → [n, B, Lb, H/n, Dh]: sequence block j for rank j.
    parts = out.reshape(b, n, lb, h // n, d).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(parts, group)
    # Piece i came from rank i: head group i of this rank's block.
    return got.permute(1, 2, 0, 3, 4).reshape(b, lb, h, d)
