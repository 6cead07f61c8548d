"""The native (C++) batch planner, bound through ctypes.

The port's copy of ``dopt.native``: ``plan.cpp`` here is dopt's source
(one Fisher-Yates shuffle per (round, epoch, worker) from a
SplitMix64-seeded xoshiro256** stream), so a ``plan_impl="native"``
plan is dopt's native plan bit for bit.  The library is built with
``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``build/dopt_torch/native/<source hash>/libdopt_torch_plan.so`` in the
checkout (``dopt_torch.ops._build``'s hash-keyed cache) and reused while
the source is unchanged.

One difference from dopt: where dopt falls back to its numpy planner
when the library cannot be built or loaded, the port raises.  The two
planners draw different streams, so a silent fallback would train the
same config on other batches.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
from pathlib import Path

import numpy as np

from dopt_torch.ops._build import BUILD_DIR, build_cached, hashed_path

_SRC = Path(__file__).resolve().parent / "plan.cpp"
ABI_VERSION = 2
LIB_NAME = "libdopt_torch_plan.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    return hashed_path((_SRC,), GXX_FLAGS, BUILD_DIR / "native", LIB_NAME)


def build() -> Path:
    """Compile plan.cpp unless this source hash is already built;
    raises if there is no ``g++`` or the build fails."""
    out = library_path()
    if out.is_file():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "plan_impl='native' needs g++ to build dopt_torch/native/"
            "plan.cpp, and none is on PATH; the port does not fall back to "
            "the numpy planner (another draw stream) — use "
            "plan_impl='numpy'")
    return build_cached([gxx], (_SRC,), GXX_FLAGS, out)


@functools.lru_cache(maxsize=1)
def load_native() -> ctypes.CDLL:
    """Build (if needed) and load the planner library, its entry points'
    types declared; raises if it cannot be built or loaded or reports
    another ABI version."""
    lib = ctypes.CDLL(str(build()))
    lib.dopt_native_abi_version.restype = ctypes.c_int
    if lib.dopt_native_abi_version() != ABI_VERSION:
        raise RuntimeError(
            f"native planner ABI {lib.dopt_native_abi_version()} != "
            f"{ABI_VERSION}")
    lib.dopt_fill_batch_plan.restype = ctypes.c_int
    lib.dopt_fill_batch_plan.argtypes = [
        ctypes.POINTER(ctypes.c_int32),                  # index_matrix
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # W, L, B
        ctypes.c_int64, ctypes.c_int64,                  # local_ep, steps
        ctypes.c_int32,                                  # drop_last
        ctypes.c_int64, ctypes.c_int64,                  # seed, round_idx
        ctypes.POINTER(ctypes.c_int64),                  # worker ids or NULL
        ctypes.POINTER(ctypes.c_int32),                  # idx_out
        ctypes.POINTER(ctypes.c_float),                  # w_out
    ]
    return lib


def native_available() -> bool:
    """Whether the planner builds and loads here (dopt's probe before
    its fallback; the port has none, so ``plan_impl="native"`` raises
    where this is False)."""
    try:
        load_native()
    except (OSError, RuntimeError, AttributeError):
        return False
    return True


def fill_batch_plan_native(index_matrix: np.ndarray, *, batch_size: int,
                           local_ep: int, seed: int, round_idx: int,
                           worker_ids: np.ndarray | None = None
                           ) -> tuple[np.ndarray, np.ndarray]:
    """The native plan ``(idx [W, S, B] int32, weight [W, S, B] f32)``,
    shaped as ``make_batch_plan``'s: wraparound padding with a 0-weight
    tail.  ``worker_ids`` keys each row's stream by its true worker id
    (None: row i is worker i).  Raises where dopt would fall back."""
    lib = load_native()
    im = np.ascontiguousarray(index_matrix, dtype=np.int32)
    w, l = im.shape
    bs = min(batch_size, l)
    steps_per_epoch = -(-l // bs)
    s = local_ep * steps_per_epoch
    idx = np.empty((w, s, bs), dtype=np.int32)
    weight = np.empty((w, s, bs), dtype=np.float32)
    wid_ptr = None
    if worker_ids is not None:
        wid = np.ascontiguousarray(worker_ids, dtype=np.int64)
        if wid.shape != (w,):
            raise ValueError(f"worker_ids shape {wid.shape} != ({w},)")
        wid_ptr = wid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = lib.dopt_fill_batch_plan(
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), w, l, bs,
        local_ep, steps_per_epoch, 0, seed, round_idx, wid_ptr,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        weight.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"native planner refused the plan (code {rc})")
    return idx, weight


__all__ = ["build", "fill_batch_plan_native", "library_path", "load_native"]
