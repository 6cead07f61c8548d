"""Worker-axis consensus on one device, and the flat-bucket layout.

``mix_dense`` is the consensus step x_i ← Σ_j W_ij x_j over a stacked
``[W, ...]`` parameter dict: an f32 ``[W, W] × [W, F]`` product per
tensor (dopt leaves it to XLA outside Pallas; here it is
``torch.matmul``).

``UpdateShardSpec`` is dopt's flat-bucket plan (collectives.py:349):
the stacked tensors, in sorted-name order (the order ``jax.tree``
flattens dopt's dict trees in), concatenated along a per-worker flat
axis, zero-padded to a ``fold`` multiple and cut into column buckets of
at most ``bucket_bytes`` a worker.  The fused epilogue kernel runs once
per bucket.  The port keeps the flat form as persistent ``[W, ld]``
stores (``alloc_flat``), so a bucket is a column view, never a copy.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def mix_dense(stacked: dict[str, torch.Tensor],
              w_matrix: torch.Tensor) -> dict[str, torch.Tensor]:
    """x_i ← Σ_j W_ij x_j for every tensor of a stacked ``[W, ...]``
    dict; the matrix is cast to the tensors' dtype, as dopt does."""
    out = {}
    for k, x in stacked.items():
        w = w_matrix.to(x.device, x.dtype)
        out[k] = (w @ x.reshape(x.shape[0], -1)).reshape(x.shape)
    return out


@dataclasses.dataclass(frozen=True)
class UpdateShardSpec:
    """Static flattening/bucketing plan for a stacked ``[W, ...]`` dict.
    ``bounds`` are fold-aligned offsets into the zero-padded flat axis."""

    names: tuple[str, ...]              # sorted tensor names
    shapes: tuple[tuple[int, ...], ...]   # per-tensor shapes sans worker axis
    sizes: tuple[int, ...]
    dtype: torch.dtype
    fold: int
    flat: int      # true flattened per-worker element count
    padded: int    # flat rounded up to a fold multiple
    bounds: tuple[int, ...]

    @property
    def num_buckets(self) -> int:
        return len(self.bounds) - 1


def make_update_shard_spec(tree: dict[str, torch.Tensor], *, fold: int = 1,
                           bucket_bytes: int = 4 << 20) -> UpdateShardSpec:
    """Plan the flat bucketing of ``tree`` (one dtype for all tensors)."""
    if not tree:
        raise ValueError("cannot bucket an empty tree")
    names = tuple(sorted(tree))
    dtypes = {tree[k].dtype for k in names}
    if len(dtypes) != 1:
        raise ValueError(f"update buckets need one tensor dtype, got {dtypes}")
    dtype = dtypes.pop()
    shapes = tuple(tuple(tree[k].shape[1:]) for k in names)
    sizes = tuple(math.prod(s) for s in shapes)
    flat = sum(sizes)
    fold = max(int(fold), 1)
    padded = -(-flat // fold) * fold
    itemsize = torch.empty((), dtype=dtype).element_size()
    step = max(int(bucket_bytes) // itemsize // fold, 1) * fold
    bounds = tuple(range(0, padded, step)) + (padded,)
    return UpdateShardSpec(names=names, shapes=shapes, sizes=sizes,
                           dtype=dtype, fold=fold, flat=flat, padded=padded,
                           bounds=bounds)


def alloc_flat(num_workers: int, spec: UpdateShardSpec,
               device=None) -> torch.Tensor:
    """A zeroed ``[W, padded]`` flat store whose row stride is rounded up
    to 16 bytes, so every row (and every bucket) starts aligned for the
    kernel's vector accesses."""
    itemsize = torch.empty((), dtype=spec.dtype).element_size()
    per = 16 // itemsize
    ld = -(-spec.padded // per) * per
    base = torch.zeros(num_workers, ld, dtype=spec.dtype, device=device)
    return base[:, :spec.padded]


def flat_views(flat: torch.Tensor,
               spec: UpdateShardSpec) -> dict[str, torch.Tensor]:
    """The stacked tensors as views into a ``[W, ≥flat]`` flat store."""
    out, off = {}, 0
    w = flat.shape[0]
    for name, shape, size in zip(spec.names, spec.shapes, spec.sizes):
        out[name] = flat[:, off:off + size].view(w, *shape)
        off += size
    return out


def flat_buckets(flat: torch.Tensor,
                 spec: UpdateShardSpec) -> list[torch.Tensor]:
    """The spec's ``[W, Fb]`` buckets as column views of ``flat``."""
    return [flat[:, a:b] for a, b in zip(spec.bounds, spec.bounds[1:])]


def stacked_to_buckets(tree: dict[str, torch.Tensor],
                       spec: UpdateShardSpec) -> list[torch.Tensor]:
    """Flatten a stacked dict into the spec's ``[W, Fb]`` buckets
    (zero-padded tail); ``buckets_to_stacked`` inverts it bit-exactly."""
    w = tree[spec.names[0]].shape[0]
    flat = torch.zeros(w, spec.padded, dtype=spec.dtype,
                       device=tree[spec.names[0]].device)
    for name, view in flat_views(flat, spec).items():
        view.copy_(tree[name])
    return flat_buckets(flat, spec)


def buckets_to_stacked(buckets: list[torch.Tensor],
                       spec: UpdateShardSpec) -> dict[str, torch.Tensor]:
    flat = torch.cat(buckets, dim=1)
    return {k: v.clone() for k, v in flat_views(flat, spec).items()}
