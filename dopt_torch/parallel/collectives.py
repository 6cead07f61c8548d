"""Worker-axis consensus and aggregation, the flat-bucket layout, and
the scatter, shift and bucket-codec collectives.

``mix_dense`` is the consensus step x_i ← Σ_j W_ij x_j over a stacked
``[W, ...]`` parameter dict: an f32 ``[W, W] × [W, F]`` product per
tensor (dopt leaves it to XLA outside Pallas; here it is
``torch.matmul``).  The federated aggregation's helpers —
``where_mask``, ``masked_average``, ``mean_weight_matrix``,
``broadcast_to_workers`` — take and return dicts of tensors (dopt's
pytrees); on a ``WorkerGroup`` with a wire each rank passes its own
lanes and the global ``[W]`` mask.

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
With ``order`` (``dopt_torch.ops.compression.device_order`` of
``convert.dopt_flat_order``) each tensor enters the flat axis in dopt's
element order, so a bucket holds what dopt's holds — what the codec's
per-chunk scales and draws need.

The scatter and shift paths take a ``WorkerGroup`` (``dopt_torch.
parallel.mesh``; None is one rank): each rank passes its own lanes'
``[L, ...]`` rows, workers folded contiguously.

* ``mix_dense_scatter`` (dopt :445): each rank contracts the f32 mixing
  matrix's columns of its lanes against its ``[L, Fb]`` slab into an
  ``[n, Fb]`` partial, optionally narrowed to ``comm_dtype``, and one
  reduce-scatter over the row axis (an ``all_to_all_single`` and a
  local sum in rank order) completes the sum and hands each rank its
  own rows.
* ``masked_average_scatter`` (dopt :512): the masked partial sum over a
  rank's lanes, a reduce-scatter over the flat axis, the divide on the
  rank's shard, one ``all_gather_into_tensor``.
* ``mix_shifts`` (dopt :159): x_i ← Σ_s c_s[i]·x_{(i+s) mod n} as ring
  rotations of ranks plus a static lane slice; each nonzero rotation is
  one paired send/recv (``batch_isend_irecv``) carrying only the lanes
  its consumers need (``_shift_plan``).
* ``mix_codec_gather`` (dopt :719): per bucket of the ``BucketCodecPlan``
  encode v = x + e (``qint_encode``), all-gather the packed payload and
  the f32 scales, decode, contract this rank's mixing rows; the
  residual v − decode(encode(v)) feeds the next round.
* ``mix_dense`` and ``masked_average`` on a group are dopt's dense
  forms (:81, :301): the shards (narrowed to ``comm_dtype`` if set) are
  all-gathered and this rank's matrix rows contract them; the ranks'
  partial sums are all-gathered and summed in rank order in f32.

Every reduction over the worker axis crosses ranks as an all-gather or
an all-to-all followed by a local sum in rank order, never an
``all_reduce``: a run repeats bit for bit whatever the library's
algorithm, and NCCL and gloo give the same bits.  On a gloo group CUDA
payloads are staged through pinned host memory (``WorkerGroup.staged``:
gloo's all-gather, all-to-all and send/recv take host tensors), so
ranks that share one card run over gloo while their compute stays on
the card.

With no wire every function does what dopt's one-device mesh compiles
to, a narrowing cast included.  A group's ``meter`` counts the bytes
each collective hands to ``torch.distributed``, by operation and kind:
the bucket's wire kind (raw, bf16, f16, q8, q4; the scale sidecar as
``q8-scale``/``q4-scale``) or the caller (dense, mean, shift).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dopt_torch.ops.compression import (qint_decode, qint_encode,
                                        qint_wire_bytes)
from dopt_torch.utils.prng import fold_in


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
              comm_dtype: torch.dtype | None = None, group=None
              ) -> dict[str, torch.Tensor]:
    """x_i ← Σ_j W_ij x_j for every tensor of a stacked ``[W, ...]``
    dict; the matrix is cast to the tensors' dtype, as dopt does.  With
    ``comm_dtype`` each tensor is narrowed to it, and the f32 matrix
    contracts its f32 upcast in f32 before the cast to the tensor's
    dtype (with bf16 storage and a bf16 wire this is another
    arithmetic, not a no-op).  On a ``group`` with a wire the tensors
    are this rank's ``[L, ...]`` lanes: they are all-gathered (at the
    wire dtype) and this rank's matrix rows contract the gathered
    fleet."""
    wired = group is not None and group.wire
    out = {}
    for k, x in stacked.items():
        rows = x.reshape(x.shape[0], -1)
        w = w_matrix.to(x.device)
        if wired:
            w = group.local(w)
            rows = _all_gather(rows if comm_dtype is None
                               else rows.to(comm_dtype), group, "dense")
        if comm_dtype is None:
            y = w.to(x.dtype) @ rows
        else:
            y = (w.float() @ rows.to(comm_dtype).float()).to(x.dtype)
        out[k] = y.reshape(x.shape)
    return out


def mix_power(stacked: dict[str, torch.Tensor], w_matrix: torch.Tensor,
              eps: int = 1, group=None, comm_dtype: torch.dtype | None = None
              ) -> dict[str, torch.Tensor]:
    """``eps`` consensus sweeps of ``mix_dense`` (FedLCon,
    simulators.py:182-212), each reading the previous sweep's output, as
    dopt fixed the reference's stale accumulation; eps = 1 is plain
    consensus.  ``group`` takes dopt's ``mesh`` place."""
    out = stacked
    for _ in range(eps):
        out = mix_dense(out, w_matrix, comm_dtype, group)
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
                   comm_dtype: torch.dtype | None = None, group=None
                   ) -> dict[str, torch.Tensor]:
    """theta ← Σ_i m_i x_i / max(Σ_i m_i, 1), a dict WITHOUT the worker
    axis (reference ``average_weights`` with client sampling as data).
    With ``comm_dtype`` the sum runs in f32, the one partial sum is
    narrowed to the wire dtype and upcast, and the f32 divide is cast
    to the tensor's dtype.  On a ``group`` with a wire ``mask`` is the
    global ``[W]`` mask and the tensors this rank's lanes: each rank's
    partial sum over its lanes (f32, narrowed with ``comm_dtype``; in
    the tensor's dtype without) is all-gathered and the ranks' partials
    summed in rank order in f32 — the same on every rank, whatever the
    transport — then divided and cast to the tensor's dtype."""
    m = mask.float()
    denom = m.sum().clamp_min(1.0)
    if group is not None and group.wire:
        ml = group.local(m)
        out = {}
        for k, x in stacked.items():
            if comm_dtype is None:
                part = (x * _lane(ml, x).to(x.dtype)).sum(0)
            else:
                part = (x.float() * _lane(ml, x)).sum(0).to(comm_dtype)
            parts = _all_gather(part[None], group, "mean")
            out[k] = (parts.float().sum(0) / denom).to(x.dtype)
        return out
    if comm_dtype is not None:
        return {k: ((x.float() * _lane(m, x)).sum(0).to(comm_dtype).float()
                    / denom).to(x.dtype)
                for k, x in stacked.items()}
    return {k: (x * _lane(m, x).to(x.dtype)).sum(0) / denom.to(x.dtype)
            for k, x in stacked.items()}


def lane_sum(stacked: dict[str, torch.Tensor], group=None
             ) -> dict[str, torch.Tensor]:
    """Σ_i x_i over the worker axis in the tensors' dtype: on a group
    with a wire each rank's partial sum over its lanes, all-gathered and
    summed in rank order (SCAFFOLD's control increment)."""
    if group is None or not group.wire:
        return {k: x.sum(0) for k, x in stacked.items()}
    return {k: _all_gather(x.sum(0)[None], group, "sum").sum(0)
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
                         num_workers: int, group=None
                         ) -> dict[str, torch.Tensor]:
    """theta → stacked ``[W, ...]`` views (the server handing every
    client a copy of the global model; no copy is made).  On a group
    with a wire theta is replicated on every rank and each rank takes
    its ``[L, ...]`` lanes: no collective."""
    if group is not None and group.wire:
        num_workers = group.lanes
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


def stacked_to_buckets(tree: dict[str, torch.Tensor], spec: UpdateShardSpec,
                       order=None) -> list[torch.Tensor]:
    """Flatten a stacked dict into the spec's ``[W, Fb]`` buckets
    (zero-padded tail), each tensor in dopt's element order where
    ``order`` maps it; ``buckets_to_stacked`` inverts it bit-exactly."""
    w = tree[spec.names[0]].shape[0]
    flat = torch.zeros(w, spec.padded, dtype=spec.dtype,
                       device=tree[spec.names[0]].device)
    off = 0
    for name, size in zip(spec.names, spec.sizes):
        rows = tree[name].reshape(w, size)
        maps = None if order is None else order[name]
        if maps is not None:
            rows = rows.index_select(1, maps[0])
        flat[:, off:off + size].copy_(rows)
        off += size
    return flat_buckets(flat, spec)


def _flat_to_tree(flat: torch.Tensor, spec: UpdateShardSpec,
                  order=None) -> dict[str, torch.Tensor]:
    lead = flat.shape[:-1]
    out, off = {}, 0
    for name, shape, size in zip(spec.names, spec.shapes, spec.sizes):
        rows = flat[..., off:off + size]
        maps = None if order is None else order[name]
        rows = (rows.clone() if maps is None
                else rows.index_select(rows.dim() - 1, maps[1]))
        out[name] = rows.reshape(*lead, *shape)
        off += size
    return out


def buckets_to_stacked(buckets: list[torch.Tensor], spec: UpdateShardSpec,
                       order=None) -> dict[str, torch.Tensor]:
    return _flat_to_tree(torch.cat(buckets, dim=1), spec, order)


def buckets_to_tree(buckets: list[torch.Tensor], spec: UpdateShardSpec,
                    order=None) -> dict[str, torch.Tensor]:
    """The one-lane form: ``[Fb]`` buckets → the θ dict (no worker axis)."""
    return _flat_to_tree(torch.cat(buckets, dim=0), spec, order)


# -- the wire ------------------------------------------------------------
def _dist():
    import torch.distributed as dist

    return dist


def _host(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the collective hands it over: itself, or a pinned host
    copy where the group stages CUDA payloads (gloo)."""
    if not group.staged(x):
        return x
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A collective's output back on ``like``'s device."""
    return h if h.device == like.device else h.to(like.device)


def _all_gather(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``[L, ...]`` on each rank → ``[size·L, ...]`` in rank order."""
    dist = _dist()
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    x = x.detach().contiguous()
    group.count("all_gather", kind, x)
    h = _host(x, group)
    out = h.new_empty((x.shape[0] * group.size,) + tuple(x.shape[1:]))
    gather(out, h, group=group.group)
    return _back(out, x)


def _reduce_scatter(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """Sum over ranks of ``[size·k, ...]``, rank r keeping rows
    [r·k, (r+1)·k).  The partial crosses by ``all_to_all_single`` — the
    same bytes a reduce-scatter sends — and its ``size`` pieces are
    summed in f32 in rank order, so every run and every transport give
    the same bits; a narrowed partial is rounded once to the wire dtype
    after the sum, as XLA reduces a bf16/f16 ``psum_scatter`` (a library
    reduce-scatter would round after every add)."""
    dist = _dist()
    x = x.detach().contiguous()
    k = x.shape[0] // group.size
    group.count("reduce_scatter", kind, x)
    h = _host(x, group)
    pieces = torch.empty_like(h)
    dist.all_to_all_single(pieces, h, group=group.group)
    pieces = _back(pieces, x)
    return pieces.view(group.size, k, *x.shape[1:]).float().sum(0).to(
        x.dtype)


def _all_to_all(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``[size, ...]`` on each rank: piece j goes to rank j, and piece i
    of the result came from rank i (``all_to_all_single``)."""
    dist = _dist()
    x = x.detach().contiguous()
    group.count("all_to_all", kind, x)
    h = _host(x, group)
    out = torch.empty_like(h)
    dist.all_to_all_single(out, h, group=group.group)
    return _back(out, x)


def _wired(group) -> bool:
    return group is not None and group.wire


def _narrow(part: torch.Tensor, comm_dtype) -> torch.Tensor:
    return part if comm_dtype is None else part.to(comm_dtype)


def _kind_of(comm_dtype) -> str:
    return {None: "raw", torch.bfloat16: "bf16", torch.float16: "f16",
            torch.float32: "raw"}[comm_dtype]


def _require_flat_group(group, what: str) -> None:
    """dopt's ``_require_flat_mesh`` (collectives.py:435-442), in its
    words: the scatter and codec collectives run over one worker axis
    (the engines refuse a hybrid layout first)."""
    if group is not None and not group.flat:
        raise ValueError(
            f"{what} runs psum_scatter over ONE worker axis; hybrid "
            f"(hosts × ici) meshes are not supported — got {group.shape}")


# -- scatter ---------------------------------------------------------------
def mix_dense_scatter(buckets: list[torch.Tensor], w_matrix: torch.Tensor,
                      group=None, comm_dtype: torch.dtype | None = None
                      ) -> list[torch.Tensor]:
    """Reduce-scatter ``mix_dense`` over this rank's ``[L, Fb]`` buckets:
    the f32 partial ``W[:, my lanes] @ x`` ([n, Fb]), narrowed to
    ``comm_dtype`` (a real cast round trip on one rank too), summed over
    ranks by one ``reduce_scatter_tensor`` that leaves each rank its own
    rows, cast back to the bucket dtype.  W and the accumulation stay
    f32 whatever the bucket dtype (dopt :455-461); across ranks the sum
    runs at the wire dtype."""
    _require_flat_group(group, "update_sharding='scatter'")
    out = []
    for x in buckets:
        w = w_matrix.to(x.device, torch.float32)
        if _wired(group):
            w = w[:, group.lane0:group.lane0 + group.lanes]
        part = _narrow(w @ x.float(), comm_dtype)
        if _wired(group):
            part = _reduce_scatter(part, group, _kind_of(comm_dtype))
        out.append(part.to(x.dtype))
    return out


def mix_update_scatter(stacked: dict[str, torch.Tensor], arg: torch.Tensor,
                       group, spec: UpdateShardSpec, shift_ids=None,
                       comm_dtype: torch.dtype | None = None
                       ) -> dict[str, torch.Tensor]:
    """The engines' scatter consensus step: flatten into the spec's
    buckets, mix each (the dense reduce-scatter, or ``mix_shifts`` over
    the buckets when ``shift_ids`` is set, ``arg`` then being the
    ``[k, n]`` coefficient table), and restore the dict."""
    buckets = stacked_to_buckets(stacked, spec)
    if shift_ids is not None:
        mixed = mix_shifts(buckets, shift_ids, arg, group, comm_dtype)
    else:
        mixed = mix_dense_scatter(buckets, arg, group, comm_dtype)
    return buckets_to_stacked(mixed, spec)


def masked_average_scatter(stacked: dict[str, torch.Tensor],
                           mask: torch.Tensor, group, spec: UpdateShardSpec,
                           denom: torch.Tensor | None = None,
                           comm_dtype: torch.dtype | None = None
                           ) -> dict[str, torch.Tensor]:
    """The scatter form of ``masked_average``: per bucket, this rank's
    f32 masked partial sum ``[Fb]`` (narrowed to ``comm_dtype``), a
    ``reduce_scatter_tensor`` over the flat axis (the spec's fold makes
    every bucket divide), the divide by ``denom`` (default max(Σ mask,
    1), the global ``[W]`` mask's) on the shard in f32 cast to the
    bucket dtype, and one ``all_gather_into_tensor``.  Returns θ (no
    worker axis)."""
    _require_flat_group(group, "update_sharding='scatter'")
    m = mask.float()
    denom = (m.sum().clamp_min(1.0) if denom is None
             else torch.as_tensor(denom, dtype=torch.float32,
                                  device=m.device))
    ml = group.local(m) if _wired(group) else m
    out = []
    for x in stacked_to_buckets(stacked, spec):
        part = _narrow((x.float() * ml[:, None]).sum(0), comm_dtype)
        if _wired(group):
            part = _reduce_scatter(part, group, _kind_of(comm_dtype))
        upd = (part.float() / denom).to(x.dtype)
        if _wired(group):
            upd = _all_gather(upd, group, "raw")
        out.append(upd)
    return buckets_to_tree(out, spec)


# -- shift -----------------------------------------------------------------
def _shift_plan(shift_ids, lanes: int, num_devices: int):
    """dopt's static routing plan: ``plan[k] = (q0, q1, r)`` splits shift
    ``shift_ids[k]`` into its rank rotations and lane offset, and
    ``ship[q]`` lists the source lanes rotation q must carry (the union
    over the shifts that read it; a straddling shift, r ≠ 0, needs lanes
    r.. from rotation q and ..r from q+1)."""
    plan: list[tuple[int, int, int]] = []
    need: dict[int, set[int]] = {}
    for s in shift_ids:
        q, r = divmod(int(s), lanes)
        q0, q1 = q % num_devices, (q + 1) % num_devices
        plan.append((q0, q1, r))
        if r == 0:
            if q0 != 0:
                need.setdefault(q0, set()).update(range(lanes))
        else:
            if q0 != 0:
                need.setdefault(q0, set()).update(range(r, lanes))
            if q1 != 0:
                need.setdefault(q1, set()).update(range(r))
    ship = {q: sorted(v) for q, v in need.items()}
    return plan, ship


def device_rotations(shift_ids, lanes: int, num_devices: int
                     ) -> tuple[int, ...]:
    """The nonzero rank rotations (one paired send/recv each) a shift
    set needs."""
    _, ship = _shift_plan(shift_ids, lanes, num_devices)
    return tuple(sorted(ship))


def shift_comm_lanes(shift_ids, lanes: int, num_devices: int) -> int:
    """Lanes each rank ships per ``mix_shifts`` call, which the engine's
    'auto' rule weighs against the dense gather's n − L remote lanes."""
    _, ship = _shift_plan(shift_ids, lanes, num_devices)
    return sum(len(v) for v in ship.values())


def _rotate(payload: torch.Tensor, q: int, group,
            kind: str = "shift") -> torch.Tensor:
    """Rotation q: rank r receives rank (r + q)'s payload and sends its
    own to rank (r − q)."""
    dist = _dist()
    h = _host(payload.detach().contiguous(), group)
    recv = torch.empty_like(h)
    r, d = group.rank, group.size
    group.count("send", kind, payload)
    ops = [dist.P2POp(dist.isend, h, (r - q) % d, group.group),
           dist.P2POp(dist.irecv, recv, (r + q) % d, group.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _back(recv, payload)


def mix_shifts(tree, shift_ids, coeff_table: torch.Tensor, group=None,
               comm_dtype: torch.dtype | None = None):
    """x_i ← Σ_s coeff_s[i] · x_{(i+s) mod n} for every tensor of ``tree``
    (a dict or a list of this rank's ``[L, ...]`` tensors).
    ``shift_ids`` is the static shift set, ``coeff_table`` the round's
    ``[k, n]`` f32 coefficients (``coeffs_for_matrix``).  Global shift
    s = q·L + r reads lanes r.. of rank +q and, for r ≠ 0, lanes ..r of
    rank +q+1; each nonzero rotation ships only the lanes in ``ship[q]``,
    narrowed to ``comm_dtype`` on the wire only.  The accumulation runs
    at the tensor's dtype in plan order, ``acc = acc + c·contrib``
    (dopt :215-224).  On one rank every rotation is local."""
    d = group.size if _wired(group) else 1
    shift_ids = tuple(int(s) for s in shift_ids)
    n = coeff_table.shape[1]
    if n % d:
        raise ValueError(f"{n} workers do not fold onto {d} devices evenly")
    lanes = n // d
    plan, ship = _shift_plan(shift_ids, lanes, d)
    pos = {q: {lane: i for i, lane in enumerate(lanes_q)}
           for q, lanes_q in ship.items()}
    lane0 = group.lane0 if _wired(group) else 0

    def mix_one(x: torch.Tensor) -> torch.Tensor:
        coeffs = coeff_table.to(x.device, torch.float32)[:, lane0:lane0 + lanes]
        xc = _narrow(x, comm_dtype)
        blocks = {}
        for q, lanes_q in ship.items():
            payload = (xc if len(lanes_q) == lanes
                       else xc[torch.as_tensor(lanes_q, device=x.device)])
            blocks[q] = _rotate(payload.contiguous(), q, group).to(x.dtype)

        def part(q, a, b):
            if q == 0:
                return x[a:b]
            p = pos[q][a]
            return blocks[q][p:p + (b - a)]

        acc = torch.zeros_like(x)
        for k, (q0, q1, r) in enumerate(plan):
            contrib = (part(q0, 0, lanes) if r == 0 else
                       torch.cat([part(q0, r, lanes), part(q1, 0, r)]))
            c = coeffs[k].reshape((lanes,) + (1,) * (x.dim() - 1))
            acc = acc + c.to(x.dtype) * contrib
        return acc

    if isinstance(tree, dict):
        return {k: mix_one(x) for k, x in tree.items()}
    return [mix_one(x) for x in tree]


def mix_shifts_shardmap(tree, shifts, group=None, comm_dtype=None):
    """``mix_shifts`` from ``shift_decomposition``'s ``[(shift, coeffs),
    ...]`` pairs."""
    table = torch.as_tensor(np.asarray([c for _, c in shifts], np.float32))
    return mix_shifts(tree, [s for s, _ in shifts], table, group, comm_dtype)


# -- the bucket codec -------------------------------------------------------
_WIRE_KINDS = ("raw", "bf16", "f16", "q8", "q4")
_NARROW = {"raw": None, "bf16": torch.bfloat16, "f16": torch.float16}


@dataclasses.dataclass(frozen=True)
class BucketCodecPlan:
    """The static per-bucket wire schedule of an ``UpdateShardSpec``:
    ``kinds[i]`` is bucket i's format — ``raw`` (the exact scatter
    path), ``bf16``/``f16`` (narrowed), ``q8``/``q4`` (the integer codec
    with error feedback)."""

    kinds: tuple[str, ...]
    chunk: int
    dense_bytes: int   # per-lane f32 wire bytes of the whole tree a round
    wire_bytes: int    # per-lane scheduled wire bytes of the same

    @property
    def any_codec(self) -> bool:
        return any(k in ("q8", "q4") for k in self.kinds)

    @property
    def compression(self) -> float:
        return self.dense_bytes / max(self.wire_bytes, 1)


def _bucket_wire_bytes(width: int, kind: str, chunk: int) -> int:
    if kind == "raw":
        return width * 4
    if kind in ("bf16", "f16"):
        return width * 2
    return qint_wire_bytes(width, chunk=chunk, bits=8 if kind == "q8" else 4)


def make_codec_plan(spec: UpdateShardSpec, *, codec: str = "none",
                    wire_dtype=None, byte_budget: int = 0,
                    min_codec_bytes: int = 4096,
                    chunk: int = 1024) -> BucketCodecPlan:
    """Map a byte budget onto per-bucket wire formats (dopt :623).  The
    base is ``wire_dtype`` narrowing (or ``raw``).  With the codec and no
    budget every bucket of at least ``min_codec_bytes`` a lane in f32
    gets q8; with ``byte_budget`` > 0 (per lane per round) the eligible
    buckets escalate largest first, base → q8 → q4, until the total fits
    or every one is at q4."""
    if codec not in ("none", "qsgd"):
        raise ValueError(f"unknown comm codec {codec!r}; one of none|qsgd")
    base = {None: "raw", "bfloat16": "bf16", "float16": "f16"}.get(
        str(wire_dtype) if wire_dtype is not None else None)
    if base is None:
        raise ValueError(
            f"unknown comm wire_dtype {wire_dtype!r}; one of "
            "bfloat16|float16 (or None for the leaf dtype)")
    widths = [b - a for a, b in zip(spec.bounds, spec.bounds[1:])]
    dense = sum(w * 4 for w in widths)
    kinds = [base] * len(widths)
    eligible = [i for i, w in enumerate(widths)
                if codec != "none" and w * 4 >= min_codec_bytes]
    by_size = sorted(eligible, key=lambda i: -widths[i])
    if codec != "none" and byte_budget <= 0:
        for i in eligible:
            kinds[i] = "q8"
    elif codec != "none":
        def total():
            return sum(_bucket_wire_bytes(w, k, chunk)
                       for w, k in zip(widths, kinds))

        for tier in ("q8", "q4"):
            for i in by_size:
                if total() <= byte_budget:
                    break
                kinds[i] = tier
    wire = sum(_bucket_wire_bytes(w, k, chunk)
               for w, k in zip(widths, kinds))
    return BucketCodecPlan(kinds=tuple(kinds), chunk=int(chunk),
                           dense_bytes=int(dense), wire_bytes=int(wire))


def link_byte_budget(dense_bytes: int, *, msg_drop: float = 0.0,
                     msg_delay: float = 0.0, msg_delay_max: int = 0) -> int:
    """The per-link per-round byte budget of the lossy-link model: goodput
    factor (1 − p) / (1 + q·D) of the raw rate, times ``dense_bytes``."""
    p = min(max(float(msg_drop), 0.0), 0.99)
    q = min(max(float(msg_delay), 0.0), 1.0)
    d = max(int(msg_delay_max), 0)
    factor = (1.0 - p) / (1.0 + q * d)
    return max(int(dense_bytes * factor), 1)


def _codec_mix_bucket(w_rows: torch.Tensor, x: torch.Tensor, e: torch.Tensor,
                      lane0: int, kind: str, chunk: int, key: torch.Tensor,
                      group) -> tuple[torch.Tensor, torch.Tensor]:
    """One bucket on one rank: encode v = x + e per local lane (keys of
    the GLOBAL lane ids), gather the packed payloads and scales, decode
    the fleet slab, contract this rank's mixing rows.  Returns (mixed
    ``[L, Fb]`` in the bucket dtype, residual' ``[L, Fb]`` f32)."""
    lanes, fb = x.shape
    bits = 8 if kind == "q8" else 4
    lane_ids = torch.arange(lane0, lane0 + lanes, device=x.device)
    v = x.float() + e
    payload, scale = qint_encode(v, lane_ids, key, chunk=chunk, bits=bits)
    vq = qint_decode(payload, scale, fb, chunk=chunk, bits=bits)
    new_e = v - vq
    if _wired(group):
        payload = _all_gather(payload, group, kind)
        scale = _all_gather(scale, group, kind + "-scale")
        vg = qint_decode(payload, scale, fb, chunk=chunk, bits=bits)
    else:
        vg = vq
    return (w_rows @ vg).to(x.dtype), new_e


def mix_codec_gather(buckets: list[torch.Tensor],
                     residuals: list[torch.Tensor], w_matrix: torch.Tensor,
                     group, plan: BucketCodecPlan, key: torch.Tensor
                     ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Compressed consensus over this rank's flat buckets: codec buckets
    go through encode → packed all-gather → decode → this rank's f32
    mixing rows; the others keep the exact reduce-scatter
    (``mix_dense_scatter`` at their narrowing).  ``key`` is the
    round-folded key; bucket i draws from ``fold_in(key, i)`` and then
    per global lane.  Returns (mixed, residuals), the residuals of
    codec buckets updated and the others passed through."""
    _require_flat_group(group, "comm codec")
    w = w_matrix.to(buckets[0].device, torch.float32)
    lane0 = group.lane0 if _wired(group) else 0
    w_rows = w[lane0:lane0 + buckets[0].shape[0]]
    mixed, new_res = [], []
    for i, (b, e, kind) in enumerate(zip(buckets, residuals, plan.kinds)):
        if kind in ("q8", "q4"):
            y, e2 = _codec_mix_bucket(w_rows, b, e, lane0, kind, plan.chunk,
                                      fold_in(key, i), group)
            mixed.append(y)
            new_res.append(e2)
        else:
            mixed.append(mix_dense_scatter([b], w, group,
                                           _NARROW[kind])[0])
            new_res.append(e)
    return mixed, new_res


def mix_codec_reference(buckets: list[torch.Tensor],
                        residuals: list[torch.Tensor], w_matrix: torch.Tensor,
                        plan: BucketCodecPlan, key: torch.Tensor
                        ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The global-view reference of ``mix_codec_gather``: ``[W, Fb]``
    buckets, lane ids 0..W−1, the same per-lane draws."""
    w = w_matrix.to(buckets[0].device, torch.float32)
    mixed, new_res = [], []
    for i, (b, e, kind) in enumerate(zip(buckets, residuals, plan.kinds)):
        if kind in ("q8", "q4"):
            y, e2 = _codec_mix_bucket(w, b, e, 0, kind, plan.chunk,
                                      fold_in(key, i), None)
            mixed.append(y)
            new_res.append(e2)
        else:
            cd = _NARROW[kind]
            x = b if cd is None else b.to(cd).float()
            mixed.append((w @ x.float()).to(b.dtype))
            new_res.append(e)
    return mixed, new_res
