"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

The sources under ``dopt_torch/csrc`` have a plain C interface, so one
``nvcc`` call builds them in seconds (no PyTorch headers).  The library
goes to ``build/dopt_torch/<source hash>/libdopt_torch_kernels.so`` in
the checkout at first use and is reused while the sources are
unchanged; ptxas's register and spill report for every kernel is kept
beside it (``resource_report``).  Nothing is built or loaded at import
time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "fused_update.cu",)
BUILD_DIR = _PKG.parent / "build" / "dopt_torch"
LIB_NAME = "libdopt_torch_kernels.so"
REPORT_NAME = "ptxas.txt"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from dopt_torch/csrc at first use")


def hashed_path(sources, flags, build_dir: Path, name: str) -> Path:
    """``build_dir/<hash>/name``, the hash over the sources' bytes and
    the compiler flags: a changed source or flag builds anew."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(Path(src).read_bytes())
    digest.update(" ".join(flags).encode())
    return build_dir / digest.hexdigest()[:16] / name


def build_cached(cmd_prefix, sources, flags, out: Path,
                 report: str | None = None) -> Path:
    """Compile ``sources`` with ``cmd_prefix + flags`` into ``out``
    unless it exists (the hash-keyed cache of ``hashed_path``); keeps
    the compiler's stderr as ``report`` beside the library when named.
    The write is atomic (temp file, then rename), so a concurrent or
    interrupted build never leaves a truncated library behind."""
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [*cmd_prefix, *flags, "-o", tmp, *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"{cmd[0]} failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}")
        if report is not None:
            (out.parent / report).write_text(res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library_path() -> Path:
    return hashed_path(_SOURCES, NVCC_FLAGS, BUILD_DIR, LIB_NAME)


def build() -> Path:
    """Compile the kernels unless this source hash is already built;
    returns the library path."""
    out = library_path()
    if out.is_file():
        return out
    return build_cached([_nvcc()], _SOURCES, NVCC_FLAGS, out,
                        report=REPORT_NAME)


def resource_report() -> str:
    """ptxas's per-kernel report of the built library (registers, stack
    frame, spill stores and loads), as nvcc printed it."""
    return (build().parent / REPORT_NAME).read_text()


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_PROPS = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> dict[str, dict[str, int]]:
    """ptxas's ``-v`` report as ``{function: {registers, stack_frame,
    spill_stores, spill_loads}}``, keyed by the (mangled) name ptxas
    prints.  A function without a ``Used N registers`` line (a device
    function that was not inlined) has ``registers`` -1."""
    out: dict[str, dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        if m := _PTXAS_ENTRY.search(line) or _PTXAS_PROPS.search(line):
            current = out.setdefault(m.group(1), {
                "registers": -1, "stack_frame": 0, "spill_stores": 0,
                "spill_loads": 0})
        elif current is not None and (m := _PTXAS_FRAME.search(line)):
            current.update(stack_frame=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        elif current is not None and (m := _PTXAS_REGS.search(line)):
            current["registers"] = int(m.group(1))
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    vp, i64, c_int, c_float = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_float)
    lib.dopt_fused_sgd_momentum.argtypes = [
        c_int, ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(vp),
        ctypes.POINTER(i64), c_int, c_float, c_float, vp]
    lib.dopt_fused_sgd_momentum.restype = c_int
    lib.dopt_fused_sgd_momentum_gated.argtypes = [
        c_int, ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(vp),
        ctypes.POINTER(i64), c_int, c_float, c_float, vp, i64, i64, vp]
    lib.dopt_fused_sgd_momentum_gated.restype = c_int
    lib.dopt_fused_mix_sgd.argtypes = [vp, i64, vp, i64, vp, c_int, i64,
                                       c_int, c_float, c_int, vp]
    lib.dopt_fused_mix_sgd.restype = c_int
    lib.dopt_error_string.argtypes = [c_int]
    lib.dopt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = lib.dopt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
