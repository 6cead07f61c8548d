"""The training round's two bandwidth-bound update ops, as CUDA kernels.

``fused_sgd_momentum`` replaces dopt/ops/fused_update.py
``fused_sgd_momentum`` (+ its tree wrapper, ``fused_sgd_momentum_tree``
here too, over one model's tensor dicts):
every SGD step's ``buf ← μ·buf + g;  p ← p − lr·buf`` over all of the
step's tensors.  Bound on the H100: bytes — 20 an f32 element (read p,
m, g; write p, m), ~60 µs a Model1 step of six workers at 3.35 TB/s.
Design: one launch for all tensors of the step, 16-byte vector
accesses, in place (``data_ptr`` never changes).  With ``limit`` (a
``[W]`` int32 device tensor) and ``step`` it takes the straggler gate:
worker w's lane updates only while ``step < limit[w]``, and a gated-off
lane skips its loads and stores (its plain version is ``torch.where``
over the ungated plain step, dopt's update-then-select).

``fused_mix_sgd`` replaces dopt/ops/fused_update.py ``fused_mix_sgd``
(+ ``fused_mix_update``): ``p ← W@p − lr·buf`` on one ``[n, F]`` flat
bucket, W ``[n, n]`` in f32, n <= 32 — the gossip epilogue (lr = 1) and
the federated masked mean + theta update (lr = −1).  Bound: bytes — 12
an f32 element (read p, buf; write p) against 2n + 2 FLOPs, at most
5.5 FLOP/byte, so tensor cores (TF32 would also break the f32 contract)
have nothing to add.  No thread holds W across columns: the design this
replaces unrolled its loops over a compile-time n inside a column loop,
so the compiler hoisted every read of W into each thread (255 registers
and 3.5 KB of spills a thread at n ≤ 32, 2% of the bound at n = 16).
Two kernels now, one launch a bucket either way.  n <= 8: one thread a
4-column pack, no column loop, all 2n row loads in flight.  n > 8:
persistent blocks stream ``[n, BF]`` column tiles of p and buf through
a 3-stage shared-memory ring (16-byte ``cp.async``); a thread computes
8 rows × 4 columns of outputs from the staged tile, reading W from
shared memory inside a loop over the runtime n.  ``mix_plan`` picks BF
so that a stage holds about 32 KB; the kernel source checks the plan.

The kernels live in ``dopt_torch/csrc/fused_update.cu`` (see its header
for the design).  Beside each is its plain PyTorch version
(``sgd_momentum_reference``, ``mix_sgd_reference``).  A wrapper takes
the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises — there is no fallback.  Each wrapper
counts its kernel launches in ``.launches``; empty work launches
nothing and counts nothing.  The counters are Python increments, so a
CUDA-graph capture (which launches nothing) would count once and its
replays (which run no Python) nothing: ``dopt_torch.engine.graphs``
moves a capture's increments to the graph and adds them back at every
replay (``launch_counts``, ``add_launch_counts``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dopt_torch.ops._build import check, load_library
from dopt_torch.parallel.collectives import flat_buckets

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TENSORS = 16   # tensors per kernel-1 launch (kMaxTensors in the source)
MAX_MIX_N = 32     # workers per kernel-2 bucket (kMixMaxN in the source)
MIX_NARROW_N = 8   # kNarrowN: buckets up to this n take the narrow kernel
# The ring kernel's shared-memory plan (n > MIX_NARROW_N); each mirrors
# a constant of the source.
MIX_STAGES = 3                 # kMixStages: depth of the tile ring
MIX_W_BYTES = 4 * MAX_MIX_N ** 2   # kMixWBytes: W^T, zero-padded
MIX_MAX_SMEM = 232_448         # kMixMaxSmem: 227 KB, a block's limit
MIX_STAGE_BYTES = 32 << 10     # target size of one ring stage (p + buf)
MIX_MAX_TILE = 1024            # widest tile, in columns


@torch.no_grad()
def sgd_momentum_reference(params, moms, grads, *, lr: float,
                           momentum: float) -> None:
    """Plain PyTorch version of kernel 1, the Pallas kernel's arithmetic:
    f32 math with each op rounded alone, one rounding to the storage
    dtype at the store.  In bf16 this is not dopt's unfused update
    (``dopt_torch.optim.sgd_step`` rounds every op to bf16)."""
    for p, m, g in zip(params, moms, grads):
        buf = m.float() * momentum + g.float()
        p.copy_(p.float() - lr * buf)
        m.copy_(buf)


@torch.no_grad()
def gated_sgd_momentum_reference(params, moms, grads, *, lr: float,
                                 momentum: float, limit: torch.Tensor,
                                 step: int) -> None:
    """Plain PyTorch version of the gated kernel 1: the ungated plain
    step on copies, then ``torch.where(step < limit, new, old)`` per
    lane of every ``[W, ...]`` tensor."""
    gate = step < limit
    new_p = [p.clone() for p in params]
    new_m = [m.clone() for m in moms]
    sgd_momentum_reference(new_p, new_m, grads, lr=lr, momentum=momentum)
    for olds, news in ((params, new_p), (moms, new_m)):
        for old, new in zip(olds, news):
            g = gate.reshape((-1,) + (1,) * (old.dim() - 1))
            old.copy_(torch.where(g, new, old))


def _cuda_or_cpu(t: torch.Tensor, what: str) -> bool:
    """True for CUDA, False for CPU; raises for any other device."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: tensors on {t.device} are not supported")
    return t.device.type == "cuda"


def fused_sgd_momentum(params, moms, grads, *, lr: float, mu: float,
                       limit: torch.Tensor | None = None,
                       step: int = 0) -> None:
    """In-place momentum SGD over lists of equally shaped tensors:
    ``m ← μ·m + g;  p ← p − lr·m``, math in f32, storage f32 or bf16.
    All tensors contiguous, of one dtype, on one device.  With
    ``limit`` ([W] int32 on the tensors' device; every tensor
    ``[W, ...]``) lane w updates only while ``step < limit[w]``."""
    params, moms, grads = list(params), list(moms), list(grads)
    if not (len(params) == len(moms) == len(grads)) or not params:
        raise ValueError("fused_sgd_momentum: params/moms/grads must be "
                         "non-empty lists of equal length")
    dtype, device = params[0].dtype, params[0].device
    if dtype not in _DTYPES:
        raise ValueError(f"fused_sgd_momentum: dtype {dtype} is not f32/bf16")
    for p, m, g in zip(params, moms, grads):
        for t in (p, m, g):
            if t.dtype != dtype or t.device != device:
                raise ValueError("fused_sgd_momentum: mixed dtypes/devices")
            if not t.is_contiguous():
                raise ValueError("fused_sgd_momentum: non-contiguous tensor")
        if not (p.shape == m.shape == g.shape):
            raise ValueError(f"fused_sgd_momentum: shapes {p.shape}, "
                             f"{m.shape}, {g.shape} differ")
    if limit is not None:
        lanes = limit.shape[0]
        if (limit.dim() != 1 or limit.dtype != torch.int32
                or limit.device != device or not limit.is_contiguous()):
            raise ValueError("fused_sgd_momentum: limit must be a contiguous "
                             "[W] int32 tensor on the tensors' device")
        if any(p.dim() < 1 or p.shape[0] != lanes for p in params):
            raise ValueError(f"fused_sgd_momentum: limit has {lanes} lanes "
                             "but a tensor's leading dim differs")
    if not _cuda_or_cpu(params[0], "fused_sgd_momentum"):
        if limit is None:
            sgd_momentum_reference(params, moms, grads, lr=lr, momentum=mu)
        else:
            gated_sgd_momentum_reference(params, moms, grads, lr=lr,
                                         momentum=mu, limit=limit, step=step)
        return
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    nonempty = [i for i, p in enumerate(params) if p.numel()]
    for a in range(0, len(nonempty), MAX_TENSORS):
        chunk = nonempty[a:a + MAX_TENSORS]
        n = len(chunk)
        ptrs = [(ctypes.c_void_p * n)(*[ts[i].data_ptr() for i in chunk])
                for ts in (params, moms, grads)]
        sizes = (ctypes.c_int64 * n)(*[params[i].numel() for i in chunk])
        if limit is None:
            code = lib.dopt_fused_sgd_momentum(n, *ptrs, sizes,
                                               _DTYPES[dtype], lr, mu, stream)
        else:
            code = lib.dopt_fused_sgd_momentum_gated(
                n, *ptrs, sizes, _DTYPES[dtype], lr, mu, limit.data_ptr(),
                limit.shape[0], step, stream)
        check(lib, code, "fused_sgd_momentum")
        fused_sgd_momentum.launches += 1


fused_sgd_momentum.launches = 0


def fused_sgd_momentum_tree(params: dict[str, torch.Tensor],
                            momentum: dict[str, torch.Tensor],
                            grads: dict[str, torch.Tensor], *, lr: float,
                            mu: float, interpret: bool | None = None):
    """Kernel 1 over one model's tensor dicts (dopt's pytrees), in place:
    one ``fused_sgd_momentum`` call over the model's tensor list, as the
    engines' sites make it (a launch per 16 tensors).  Returns
    ``(params, momentum)``, the same dicts updated, so dopt's
    ``p, m = fused_sgd_momentum_tree(p, m, g, ...)`` reads unchanged.
    dopt's ``interpret`` picks Pallas's interpreter off the TPU; here the
    tensors' device decides (CUDA: the kernel or an error; CPU: the
    plain version), so only ``None`` is taken."""
    if interpret is not None:
        raise ValueError("fused_sgd_momentum_tree: interpret= selects "
                         "Pallas's interpreter, which the port has not; the "
                         "tensors' device picks the kernel or its plain "
                         "version")
    if not (params.keys() == momentum.keys() == grads.keys()):
        raise ValueError("fused_sgd_momentum_tree: params, momentum and "
                         "grads must have the same keys")
    names = list(params)
    fused_sgd_momentum([params[k] for k in names],
                       [momentum[k] for k in names],
                       [grads[k] for k in names], lr=lr, mu=mu)
    return params, momentum


def mix_sgd_reference(p: torch.Tensor, buf: torch.Tensor, w: torch.Tensor,
                      *, lr: float) -> None:
    """Plain PyTorch version of kernel 2 (in place over ``p``): the f32
    matrix product then the subtract, cast back to the storage dtype."""
    mixed = w.to(p.device, torch.float32) @ p.float()
    p.copy_((mixed - lr * buf.float()).to(p.dtype))


class MixPlan(NamedTuple):
    """The ring kernel's tiling of an ``[n, F]`` bucket: column tiles of
    ``tile_cols`` (a power of two, at least 32, so every tile of an
    aligned bucket starts 16-byte aligned) and the dynamic shared memory
    a block takes for them (W^T plus ``MIX_STAGES`` stages of p and buf)."""

    tile_cols: int
    smem_bytes: int


def mix_plan(n: int, itemsize: int) -> MixPlan:
    """The widest tile up to ``MIX_MAX_TILE`` whose stage (n rows of p
    and of buf) fits in ``MIX_STAGE_BYTES``, so that a block keeps about
    two stages, ~64 KB, in flight at any n.  Whole tiles of an aligned
    bucket go through the ring; the ragged tail (F mod ``tile_cols``
    columns) through the kernel's synchronous path."""
    tile = MIX_MAX_TILE
    while tile > 32 and 2 * n * tile * itemsize > MIX_STAGE_BYTES:
        tile //= 2
    return MixPlan(tile, MIX_W_BYTES + MIX_STAGES * 2 * n * tile * itemsize)


def fused_mix_sgd(p: torch.Tensor, buf: torch.Tensor, w: torch.Tensor, *,
                  lr: float) -> None:
    """In place ``p ← W@p − lr·buf`` on one ``[n, F]`` bucket.  ``p`` and
    ``buf`` may be row-strided views (unit column stride), f32 or bf16
    storage of one dtype; ``w`` is ``[n, n]`` (used in f32), n <= 32."""
    if p.dim() != 2 or buf.shape != p.shape:
        raise ValueError(f"fused_mix_sgd: p {tuple(p.shape)} and buf "
                         f"{tuple(buf.shape)} must be one [n, F] shape")
    n, f = p.shape
    if w.shape != (n, n):
        raise ValueError(f"fused_mix_sgd: w {tuple(w.shape)} is not [{n}, {n}]")
    if n > MAX_MIX_N:
        raise ValueError(f"fused_mix_sgd: {n} workers in one bucket; the "
                         f"kernel supports n <= {MAX_MIX_N}")
    if p.dtype not in _DTYPES or buf.dtype != p.dtype:
        raise ValueError(f"fused_mix_sgd: dtypes {p.dtype}/{buf.dtype} "
                         "must be one of f32/bf16")
    if p.device != buf.device or w.device != p.device:
        raise ValueError("fused_mix_sgd: p, buf and w on different devices")
    for name, t in (("p", p), ("buf", buf)):
        if f > 1 and t.stride(1) != 1 or n > 1 and t.stride(0) < f:
            raise ValueError(f"fused_mix_sgd: {name} strides {t.stride()} "
                             "are not row-major with unit column stride")
    if not _cuda_or_cpu(p, "fused_mix_sgd"):
        mix_sgd_reference(p, buf, w, lr=lr)
        return
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("fused_mix_sgd: w must be contiguous float32")
    if f == 0:
        return
    launch_mix(p, buf, w, lr=lr, tile_cols=(
        0 if n <= MIX_NARROW_N else mix_plan(n, p.element_size()).tile_cols))
    fused_mix_sgd.launches += 1


fused_mix_sgd.launches = 0


def launch_mix(p: torch.Tensor, buf: torch.Tensor, w: torch.Tensor, *,
               lr: float, tile_cols: int) -> None:
    """One launch of kernel 2 on CUDA tensors that ``fused_mix_sgd`` has
    checked: ``tile_cols`` 0 takes the narrow kernel (n <= 8), a plan's
    tile width the ring kernel.  ``fused_mix_sgd`` picks by n; chip_smoke
    also runs the ring at n <= 8 to time the two against each other.
    Counts nothing."""
    n, f = p.shape
    lib = load_library()
    code = lib.dopt_fused_mix_sgd(
        p.data_ptr(), max(p.stride(0), f), buf.data_ptr(),
        max(buf.stride(0), f), w.data_ptr(), n, f, _DTYPES[p.dtype], lr,
        tile_cols, torch.cuda.current_stream(p.device).cuda_stream)
    check(lib, code, "fused_mix_sgd")


def fused_mix_update(flat_p: torch.Tensor, flat_buf: torch.Tensor,
                     w: torch.Tensor, spec, *, lr: float) -> None:
    """The fused epilogue over a whole flat store: ``fused_mix_sgd`` on
    each of ``spec``'s buckets of the ``[W, padded]`` stores ``flat_p``
    (updated in place) and ``flat_buf``.  Gossip calls it with
    ``lr=1.0``: ``q_t = W·q_{t-1} − fbuf_{t-1}``; the federated epilogue
    with ``lr=-1.0``: ``θ'_b = M(mask)·disp + θ_b`` (``flat_p`` the
    displacement store, ``flat_buf`` the theta slab)."""
    for p, b in zip(flat_buckets(flat_p, spec), flat_buckets(flat_buf, spec)):
        fused_mix_sgd(p, b, w, lr=lr)


def launch_counts() -> dict[str, int]:
    """Every wrapper's launch counter, by wrapper name."""
    return {f.__name__: f.launches for f in (fused_sgd_momentum,
                                             fused_mix_sgd)}


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (``launch_counts``' keys) to the counters."""
    for f in (fused_sgd_momentum, fused_mix_sgd):
        f.launches += delta.get(f.__name__, 0)
