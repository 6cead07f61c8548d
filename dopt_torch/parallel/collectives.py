"""Worker-axis consensus and aggregation on one device, and the
flat-bucket layout.

``mix_dense`` is the consensus step x_i ← Σ_j W_ij x_j over a stacked
``[W, ...]`` parameter dict: an f32 ``[W, W] × [W, F]`` product per
tensor (dopt leaves it to XLA outside Pallas; here it is
``torch.matmul``).  The federated aggregation's helpers —
``where_mask``, ``masked_average``, ``mean_weight_matrix``,
``broadcast_to_workers`` — take and return dicts of tensors (dopt's
pytrees), single-device (no mesh).

``comm_dtype`` (``wire_dtype``: bfloat16, float16, float32) is dopt's
wire narrowing in its one-device form.  ``mix_dense`` narrows each
tensor to the wire dtype and contracts the f32 matrix against its f32
upcast (``_mix_dense_compressed``); ``masked_average`` sums in f32 and
narrows the one partial sum (``_masked_average_compressed``).  Both
change numbers on one device, as dopt's do on a one-device mesh.

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


# The wire dtypes: the names ``jnp.dtype`` takes in dopt that torch has.
WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               "float32": torch.float32}


def wire_dtype(name: str | None) -> torch.dtype | None:
    """``comm_dtype``'s torch dtype (None for no narrowing)."""
    if not name:
        return None
    if name not in WIRE_DTYPES:
        raise ValueError(f"unknown comm_dtype {name!r}; one of "
                         f"{'|'.join(WIRE_DTYPES)}")
    return WIRE_DTYPES[name]


def mix_dense(stacked: dict[str, torch.Tensor], w_matrix: torch.Tensor,
              comm_dtype: torch.dtype | None = None
              ) -> dict[str, torch.Tensor]:
    """x_i ← Σ_j W_ij x_j for every tensor of a stacked ``[W, ...]``
    dict; the matrix is cast to the tensors' dtype, as dopt does.  With
    ``comm_dtype`` each tensor is narrowed to it, and the f32 matrix
    contracts its f32 upcast in f32 before the cast to the tensor's
    dtype (with bf16 storage and a bf16 wire this is another
    arithmetic, not a no-op)."""
    out = {}
    for k, x in stacked.items():
        rows = x.reshape(x.shape[0], -1)
        if comm_dtype is None:
            y = w_matrix.to(x.device, x.dtype) @ rows
        else:
            y = (w_matrix.to(x.device, torch.float32)
                 @ rows.to(comm_dtype).float()).to(x.dtype)
        out[k] = y.reshape(x.shape)
    return out


def _lane(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A [W] mask shaped to broadcast over a ``[W, ...]`` tensor."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def where_mask(mask: torch.Tensor, a: dict[str, torch.Tensor],
               b: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Per-worker select over stacked dicts: mask[i] ? a_i : b_i."""
    return {k: torch.where(_lane(mask, x).bool(), x, b[k])
            for k, x in a.items()}


def masked_average(stacked: dict[str, torch.Tensor], mask: torch.Tensor,
                   comm_dtype: torch.dtype | None = None
                   ) -> dict[str, torch.Tensor]:
    """theta ← Σ_i m_i x_i / max(Σ_i m_i, 1), a dict WITHOUT the worker
    axis (reference ``average_weights`` with client sampling as data).
    With ``comm_dtype`` the sum runs in f32, the one partial sum is
    narrowed to the wire dtype and upcast, and the f32 divide is cast
    to the tensor's dtype."""
    m = mask.float()
    denom = m.sum().clamp_min(1.0)
    if comm_dtype is not None:
        return {k: ((x.float() * _lane(m, x)).sum(0).to(comm_dtype).float()
                    / denom).to(x.dtype)
                for k, x in stacked.items()}
    return {k: (x * _lane(m, x).to(x.dtype)).sum(0) / denom.to(x.dtype)
            for k, x in stacked.items()}


def mean_weight_matrix(mask: torch.Tensor) -> torch.Tensor:
    """The masked mean as a contiguous [W, W] f32 contraction matrix:
    every row is mask / max(Σ mask, 1), so M @ X is ``masked_average``
    broadcast back over the worker axis.  An all-dead mask gives the zero
    matrix.  Feeds the federated fused epilogue (kernel 2, lr = −1)."""
    m = mask.float().reshape(-1)
    row = m / m.sum().clamp_min(1.0)
    return row.expand(m.shape[0], m.shape[0]).contiguous()


def broadcast_to_workers(tree: dict[str, torch.Tensor],
                         num_workers: int) -> dict[str, torch.Tensor]:
    """theta → stacked ``[W, ...]`` views (the server handing every
    client a copy of the global model; no copy is made)."""
    return {k: x.expand(num_workers, *x.shape) for k, x in tree.items()}


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
