"""Phase timers, device-time and FLOP meters and the device-resource
channel — the port's copy of ``dopt.utils.profiling``.

* ``PhaseTimers`` — wall-clock accumulators per named round phase
  (``host_batch_plan``: the stage's draws, plans and uploads;
  ``round_step``: the round or block on the device up to its fetch;
  ``checkpoint``), with dopt's ``tracer`` hook: attaching telemetry
  turns every ``phase`` site into a host span.  ``measure`` waits for
  the devices of its result, so it times the device work too.
* ``trace(log_dir)`` — a ``torch.profiler`` trace of the block (host
  and CUDA activity), written as ``log_dir/trace.json``.
* ``classify_phase``/``phase_totals`` — dopt's conv | comm | update |
  other split of a round's device time, with the rules extended to the
  names of the card's kernels; ``device_stats_of``/``device_time_of``
  run a callable under the profiler (device activity only) and reduce
  it (``profiler_op_stats``, the counterpart of dopt's
  ``xplane_op_stats``).
* ``PEAK_FLOPS``/``device_peak_flops`` and ``fwd_flops_per_sample``/
  ``train_flops_per_sample`` — the MFU meters, in dopt's FLOP
  convention.
* ``device_memory_stats`` — the CUDA caching allocator's bytes in use
  and peak (``source="device"``), or on the CPU the process RSS
  (``source="host_rss"``), dopt's fallback.
* ``emit_device_resource`` — the engines' non-deterministic
  ``resource``/``compile`` channel under ``diagnostics="on"``.
* ``CompileWatcher`` — dopt's retrace detector; for the port a
  ``RoundGraphs`` capture is what a jit retrace is for dopt, so its
  ``compile`` events count captures.
"""

from __future__ import annotations

import contextlib
import math
import re
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Any, Iterator

import torch


class PhaseTimers:
    """Accumulates wall-clock per named phase.  ``tracer`` (a
    ``dopt_torch.obs.SpanTracer``, or anything with a ``span(name)``
    context manager) makes every ``phase`` also record a nested host
    span; None keeps the plain accounting."""

    def __init__(self, tracer=None) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.tracer = tracer

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Host wall-clock of the block (a CUDA launch returns before the
        device finishes: the engines end ``round_step`` with the fetch)."""
        span = (self.tracer.span(name) if self.tracer is not None
                else contextlib.nullcontext())
        t0 = time.perf_counter()  # dopt: allow-wallclock -- phase span timing, not training math
        try:
            with span:
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0  # dopt: allow-wallclock -- phase span timing, not training math
            self.counts[name] += 1

    def measure(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for the devices of its result, attribute the time
        to ``name``."""
        span = (self.tracer.span(name) if self.tracer is not None
                else contextlib.nullcontext())
        t0 = time.perf_counter()  # dopt: allow-wallclock -- measure span timing, not training math
        with span:
            out = fn(*args, **kwargs)
            block_until_ready(out)
        self.totals[name] += time.perf_counter() - t0  # dopt: allow-wallclock -- measure span timing, not training math
        self.counts[name] += 1
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name]
                                / max(self.counts[name], 1), 5),
            }
            for name in self.totals
        }

    def report(self) -> str:
        """dopt's ``--timers`` table: one row a phase, the longest first."""
        rows = ["phase                total_s   count   mean_s"]
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            rows.append(f"{name:20s} {s['total_s']:8.3f} {s['count']:7d} "
                        f"{s['mean_s']:9.5f}")
        return "\n".join(rows)


def device_memory_stats(device: torch.device) -> dict | None:
    """Device-memory occupancy: ``{live_bytes, peak_bytes, source}``.

    On a CUDA device, the caching allocator's counters
    (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
    ``.peak``, the ``memory_allocated``/``max_memory_allocated`` pair;
    ``source="device"``).  Elsewhere dopt's fallback, the process
    resident set (live = current RSS from ``/proc/self/statm``, peak =
    ``ru_maxrss``; ``source="host_rss"``).  None only when neither is
    available."""
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        return {"live_bytes": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
                "source": "device"}
    try:
        import os
        import resource

        # Linux reports ru_maxrss in KiB.
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        try:
            with open("/proc/self/statm") as f:
                live = int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
        except (OSError, ValueError, IndexError):
            live = peak
        return {"live_bytes": int(live), "peak_bytes": int(peak),
                "source": "host_rss"}
    except (ImportError, OSError):  # pragma: no cover - non-POSIX hosts
        return None


def emit_device_resource(trainer, t: int, fn_name: str) -> None:
    """The engines' non-deterministic device channel
    (``diagnostics="on"`` with telemetry attached): after each round of
    a per-round run and each block of a blocked one, a ``compile`` event
    when the trainer's ``RoundGraphs`` captured since the last sample
    (``seconds`` = the ``round_step`` wall since then, an upper bound on
    the capture), and a ``resource`` sample of the device's memory.
    Neither kind is deterministic: the cadence is the execution path's."""
    tele = trainer.telemetry
    if tele is None or not trainer._diag:
        return
    step_total = trainer.timers.totals.get("round_step", 0.0)
    seconds = max(step_total - trainer._last_step_total, 0.0)
    trainer._last_step_total = step_total
    comp = trainer._compile_watch.observe(fn_name, trainer.graphs)
    if comp is not None:
        tele.emit("compile", round=int(t), fn=fn_name, count=comp["count"],  # dopt: allow-nondet-event -- retrace channel is execution-path state, documented non-deterministic
                  total=comp["total"], seconds=round(seconds, 6))
    stats = device_memory_stats(trainer.device)
    if stats is not None:
        tele.emit("resource", round=int(t), engine=trainer.engine_kind,  # dopt: allow-nondet-event -- HBM occupancy sampling cadence is execution-path state, documented non-deterministic
                  **stats)


class CompileWatcher:
    """Capture detector for the round graphs: ``observe(name, graphs)``
    reads a ``RoundGraphs``' capture count and returns ``{"count": new
    captures, "total": captures}`` when it grew since the previous
    observation of ``name``, else None.  A healthy blocked run captures
    each kind of round once."""

    def __init__(self) -> None:
        self._seen: dict[str, int] = {}

    def observe(self, name: str, graphs) -> dict | None:
        n = len(graphs.captures)
        prev = self._seen.get(name, 0)
        self._seen[name] = n
        if n > prev:
            return {"count": n - prev, "total": n}
        return None


def block_until_ready(out):
    """Wait for every CUDA device that holds a tensor of ``out`` (a
    tensor, or a dict, list or tuple of them, nested) to finish its
    queued work; returns ``out``."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(out)
    for d in devices:
        torch.cuda.synchronize(d)
    return out


@contextlib.contextmanager
def trace(log_dir) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, host and CUDA activity,
    written as ``log_dir/trace.json`` (Chrome/Perfetto-viewable) when
    the block ends."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = Path(log_dir)
        path.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path / "trace.json"))


# ---------------------------------------------------------------------
# Round-phase attribution: conv / mixing-comm / update / other
# ---------------------------------------------------------------------
# dopt's markers: the engines' ``dopt_update``/``dopt_mix`` scopes and
# XLA's collective op names.
_COMM_MARKERS = ("all-reduce", "all-gather", "reduce-scatter",
                 "collective-permute", "all-to-all", "allreduce",
                 "allgather", "reducescatter", "collectivepermute",
                 "alltoall")

# "conv" but NOT "convert": dtype-conversion ops are everywhere on the
# bf16 fast leg and must not inflate the conv fraction with cast
# overhead.
_CONV_RE = re.compile(r"conv(?!ert)")

# The card's kernels carry no scope: a blocked round is a CUDA-graph
# replay with no host ranges, so the rules below read kernel names alone.
# Kernel 1 (``sgd_momentum_kernel``) and the plain update's foreach
# kernels are the update.
_UPDATE_KERNELS = ("sgd_momentum_kernel", "multi_tensor_apply_kernel")
# Kernel 2 is the mixing contraction fused with the update, which dopt
# counts as comm (its ``dopt_mix`` scope), and NCCL's kernels are the
# wire.
_COMM_KERNELS = ("mix_sgd_narrow_kernel", "mix_sgd_ring_kernel", "nccl")
# cuDNN's kernels run the convolutions: its namespace (layout transposes,
# scaling) and its algorithms' names, some of which carry no "cudnn"
# (``sm80_xmma_dgrad_implicit_gemm_...``; the FFT algorithm's transforms,
# complex GEMMs and ``flip_filter``: the port does no complex math).
_CONV_KERNELS = re.compile(r"cudnn|implicit_gemm|fprop|dgrad|wgrad|winograd"
                           r"|fft|flip_filter|cf32")
# The f64 kernels are the card's rounded training layers' (the f64 GEMMs,
# their reductions and casts, ``_RoundedConv``'s im2col copy), and a name
# cannot tell a conv's from a dense layer's: they file under the phase of
# the layer that the window's model rounds (``models.zoo.ROUNDED_F64``;
# conv where the caller names no model).  tests/test_torch_profiling.py
# fails when f64 tensor work appears anywhere else in the package.
_F64_KERNELS = re.compile(r"f64|dgemm|d\d{3}gemm|\bdouble\b")

PHASES = ("conv", "comm", "update", "other")


def classify_phase(op_type: str | None, operation: str | None = None,
                   f64_phase: str = "conv") -> str:
    """Classify one profiled op into conv | comm | update | other.

    ``op_type`` is its category and ``operation`` its name: for the
    card's kernels the demangled kernel name, for dopt's rows the op
    name with its scope.  dopt's precedence: the update first (its
    ``dopt_update`` tag, or an update kernel), then collectives, NCCL and
    the mixing contraction (the ``dopt_mix`` scope, or kernel 2) as
    comm, then convolutions; then an f64 kernel under ``f64_phase``, the
    phase of the window's rounded layer (``models.zoo.ROUNDED_F64``)."""
    t = (op_type or "").lower()
    n = (operation or "").lower()
    if "dopt_update" in n or any(k in n for k in _UPDATE_KERNELS):
        return "update"
    if any(k in t for k in _COMM_MARKERS) or any(k in n for k in _COMM_MARKERS):
        return "comm"
    if "dopt_mix" in n or any(k in n for k in _COMM_KERNELS):
        return "comm"
    if _CONV_RE.search(t) or _CONV_RE.search(n) or _CONV_KERNELS.search(n):
        return "conv"
    if _F64_KERNELS.search(n):
        return f64_phase
    return "other"


def phase_totals(rows, f64_phase: str = "conv") -> dict[str, Any]:
    """Reduce ``(op_type, operation, self_time_us)`` rows to per-phase
    totals + fractions: ``{conv_us, ..., conv_fraction, ...}``
    (``f64_phase`` as ``classify_phase``'s)."""
    tot = {k: 0.0 for k in PHASES}
    for op_type, operation, self_us in rows:
        tot[classify_phase(op_type, operation, f64_phase)] += float(self_us)
    dev = sum(tot.values())
    out: dict[str, Any] = {f"{k}_us": round(v, 1) for k, v in tot.items()}
    for k, v in tot.items():
        out[f"{k}_fraction"] = round(v / dev, 4) if dev > 0 else 0.0
    return out


def f64_phase_of(model: str | None) -> str:
    """The phase that the f64 kernels of a window training zoo model
    ``model`` file under (``models.zoo.ROUNDED_F64``); conv when no model
    is named or the model rounds no layer (it launches no f64 kernel)."""
    from dopt_torch.models.zoo import ROUNDED_F64

    return ROUNDED_F64.get(model, (None, "conv"))[1]


def _device_category(name: str) -> str:
    """A device row's category: a copy, a fill, or a kernel."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _self_device_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total",
                 "device_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


# CUPTI, under torch.profiler, loses records at the ends of a window: on
# the H100, up to ~750 of the first and ~7,500 of the last records of a
# padded Model1 headline round (without a pad, the round's own first and
# last kernels went missing).  ``device_stats_of`` pads the window with
# this many one-element int16 fills on each side (the port runs no int16
# fill) and leaves them out of the reduction.  Each guard costs ~0.2 ms
# of host time in the profiler, outside the window.
_GUARDS = (2_048, 12_288)
_GUARD_KERNEL = "FillFunctor<short>"


def _union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def _overlap(recs) -> dict[str, Any]:
    """Where the device records' summed time exceeds their union.
    ``recs`` are ``(start, end, phase, stream, name)``, sorted.  Each
    record's overlap is the part of it that an earlier-starting record
    still covers; these sum to exactly summed − busy (``overlap_us``),
    and are given by the later record's phase and by name (the 5
    largest).  ``same_stream_us`` is the part within one stream: a
    stream runs its kernels in order, so that overlap is a kernel whose
    recorded interval began before its predecessor's ended (a
    programmatic dependent launch, whose kernel is resident and waits).
    ``duplicate_records`` counts records equal to an earlier one in
    name, stream and interval."""
    late = {k: 0.0 for k in PHASES}
    names: Counter = Counter()
    end = -math.inf
    streams: dict[Any, list] = {}
    for a, b, phase, stream, name in recs:
        ov = max(0.0, min(b, end) - a)
        late[phase] += ov
        names[name] += ov
        end = max(end, b)
        streams.setdefault(stream, []).append((a, b))
    same = sum(sum(b - a for a, b in ivs) - _union_us(ivs)
               for ivs in streams.values())
    keys = [(r[3], r[4], r[0], r[1]) for r in recs]
    return {"overlap_us": round(sum(late.values()), 1),
            "same_stream_us": round(same, 1),
            "streams": len(streams),
            "duplicate_records": len(keys) - len(set(keys)),
            "by_phase_us": {k: round(v, 1) for k, v in late.items()},
            "top_names": [[n, round(v, 1)]
                          for n, v in names.most_common(5) if v > 0]}


def profiler_op_stats(prof, f64_phase: str = "conv") -> dict[str, Any]:
    """Reduce a stopped ``torch.profiler.profile`` to dopt's
    ``xplane_op_stats`` shape: ``{device_self_time_us, host_self_time_us,
    device_categories: [{op_type, self_time_us, pct_of_device,
    occurrences, phase}], device_phases: {conv_us, comm_us, update_us,
    other_us, *_fraction}, top_device_ops: [...]}``, with the device rows
    by kernel name (``op_type`` is the name, so ``device_categories`` is
    the time by kernel, each with its ``classify_phase``).  Also
    ``device_busy_us``: the union of the device intervals, which an
    overlap between kernels makes less than the summed self time;
    ``device_phases_busy``: each phase's own union of intervals
    (``*_us``) and its share of ``device_busy_us`` (``*_fraction``; the
    shares pass 1 in sum where kernels of two phases overlap);
    ``device_overlap`` (``_overlap``): where the summed time exceeds the
    busy time, and why; and ``guard_records``: how many of
    ``device_stats_of``'s guard kernels the trace holds before and after
    the window's own first record, which are left out of everything
    else.  ``f64_phase`` files the f64 kernels (``classify_phase``)."""
    cuda = torch.autograd.DeviceType.CUDA
    device_total = host_total = 0.0
    ops, phase_rows = [], []
    for e in prof.key_averages():
        if e.device_type == cuda and _GUARD_KERNEL in e.key:
            continue
        if e.device_type == cuda:
            self_us = _self_device_us(e)
            if self_us <= 0:
                continue
            device_total += self_us
            phase_rows.append((_device_category(e.key), e.key, self_us))
            ops.append({"op_type": _device_category(e.key),
                        "operation": e.key, "occurrences": int(e.count),
                        "total_self_time_us": round(self_us, 1)})
        else:
            host_total += float(e.self_cpu_time_total)
    recs, guards = [], []
    for e in prof.events():
        if e.device_type != cuda:
            continue
        if _GUARD_KERNEL in e.name:
            guards.append(e.time_range.start)
            continue
        recs.append((e.time_range.start, e.time_range.end,
                     classify_phase(_device_category(e.name), e.name,
                                    f64_phase),
                     getattr(e, "device_resource_id", e.thread), e.name))
    recs.sort()
    first = recs[0][0] if recs else math.inf
    head = sum(a < first for a in guards)
    busy = _union_us([r[:2] for r in recs])
    ops.sort(key=lambda o: -o["total_self_time_us"])
    by_phase = {k: _union_us([r[:2] for r in recs if r[2] == k])
                for k in PHASES}
    return {
        "device_self_time_us": round(device_total, 1),
        "host_self_time_us": round(host_total, 1),
        "device_busy_us": round(busy, 1),
        "device_phases_busy": {
            **{f"{k}_us": round(v, 1) for k, v in by_phase.items()},
            **{f"{k}_fraction": round(v / busy, 4) if busy > 0 else 0.0
               for k, v in by_phase.items()}},
        "device_overlap": _overlap(recs),
        "guard_records": [head, len(guards) - head],
        "device_categories": [
            {"op_type": o["operation"],
             "self_time_us": o["total_self_time_us"],
             "pct_of_device": round(100.0 * o["total_self_time_us"]
                                    / max(device_total, 1e-9), 2),
             "occurrences": o["occurrences"],
             "phase": classify_phase(o["op_type"], o["operation"],
                                     f64_phase)}
            for o in ops],
        "device_phases": phase_totals(phase_rows, f64_phase),
        "top_device_ops": ops[:20],
    }


def device_stats_of(fn, *, trace_prefix: str = "dopt-devtime-",
                    telemetry=None, model: str | None = None) -> dict:
    """Run ``fn()`` under ``torch.profiler`` with the device activity
    only (recording the host ops too doubles the profiler's cost) and
    return ``profiler_op_stats``' reduction: the device self time and
    the conv/comm/update split.  On CUDA the window is padded with guard
    kernels on each side (``_GUARDS``), so the records the profiler
    loses at its ends are guards; a side whose guards were all lost
    gives a ``warning`` when the window has device records of its own
    (they may be short).  Where
    no CUDA device is up there are no device rows: the device time is
    0.0 and the host ops' self time is ``host_self_time_us``.
    ``trace_prefix`` keeps dopt's signature; the port's profiler writes
    no trace directory.

    dopt's degrade contract: if the profiler cannot start or stop, or
    the reduction fails, the result carries NaN device time, empty
    breakdowns and a ``warning`` field describing the failure — and a
    ``warning`` telemetry event when ``telemetry``
    (``dopt_torch.obs.Telemetry``) is given.  ``fn()``'s own exceptions
    propagate."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])
    guard = torch.zeros(1, dtype=torch.int16, device="cuda") if cuda else None

    def pad(n):
        if guard is not None:
            for _ in range(n):
                guard.fill_(1)
            torch.cuda.synchronize()

    warning = None
    started = True
    try:
        prof.start()
    except Exception as e:
        started = False
        warning = f"profiler start failed: {e!r}"
    try:
        pad(_GUARDS[0])
        fn()
        if cuda:
            torch.cuda.synchronize()
        pad(_GUARDS[1])
    finally:
        if started:
            try:
                prof.stop()
            except Exception as e:
                warning = warning or f"profiler stop failed: {e!r}"
    stats = None
    if warning is None:
        try:
            stats = profiler_op_stats(prof, f64_phase_of(model))
        except Exception as e:
            warning = f"profiler reduction failed: {e!r}"
    if stats is not None and cuda and stats["device_categories"] \
            and 0 in stats["guard_records"]:
        warning = (f"the profiler lost every guard record at one end of the "
                   f"window ({stats['guard_records']} of {list(_GUARDS)} "
                   "kept): the window's own records may be short")
    if stats is None:
        stats = {"device_self_time_us": float("nan"),
                 "host_self_time_us": float("nan"),
                 "device_categories": [], "device_phases": {},
                 "top_device_ops": []}
    if warning is not None:
        stats["warning"] = warning
        if telemetry is not None:
            telemetry.emit("warning", message=warning,  # dopt: allow-nondet-event -- degraded-profiler warning, outside DETERMINISTIC_KINDS by design
                           source="device_stats_of")
    return stats


def device_time_of(fn, *, trace_prefix: str = "dopt-devtime-",
                   telemetry=None) -> float:
    """Run ``fn()`` under the profiler and return the device self time
    in microseconds; NaN (plus a warning event, see ``device_stats_of``)
    when the profiler degrades."""
    return device_stats_of(fn, trace_prefix=trace_prefix,
                           telemetry=telemetry)["device_self_time_us"]


# ---------------------------------------------------------------------
# FLOP accounting (the MFU meters)
# ---------------------------------------------------------------------

# Dense bf16 peak by the exact device name ``torch.cuda.get_device_name``
# gives, from the part's data sheet.  An f32 run's MFU is reported
# against the same bf16 peak, as dopt reports it, so modes stay
# comparable.  The H100 SXM figure assumes its 700 W limit; other H100
# parts (PCIe, NVL) have lower peaks and get None until their own
# figure is entered here.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def device_peak_flops() -> tuple[str, float | None]:
    """(device name, bf16 dense peak FLOP/s, or None on the CPU or for a
    part that ``PEAK_FLOPS`` does not name exactly)."""
    if not torch.cuda.is_available():
        return "cpu", None
    kind = torch.cuda.get_device_name()
    return kind, PEAK_FLOPS.get(kind)


def _in_bounds_taps(size: int, k: int, stride: int, pad: int, dil: int,
                    out: int) -> int:
    """The kernel taps of one spatial axis that land inside the input,
    summed over the output positions."""
    return sum(1 for o in range(out) for j in range(k)
               if 0 <= o * stride - pad + j * dil < size)


def _conv_flop_in_bounds(x_shape, w_shape, _bias, stride, padding, dilation,
                         transposed, *args, out_shape=None, **kwargs) -> int:
    """2·MACs of a convolution over its in-bounds taps only, as XLA's
    cost analysis counts a padded conv (``FlopCounterMode`` counts the
    whole padded window)."""
    if transposed:
        from torch.utils.flop_counter import conv_flop_count

        return conv_flop_count(x_shape, w_shape, out_shape, transposed=True)
    taps = 1
    for i in range(len(w_shape) - 2):
        taps *= _in_bounds_taps(x_shape[2 + i], w_shape[2 + i], stride[i],
                                padding[i], dilation[i], out_shape[2 + i])
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def fwd_flops_per_sample(fn, params, input_shape, *, batch: int = 8,
                         dtype=None) -> float:
    """Forward-pass FLOPs per sample, in dopt's convention (XLA's cost
    analysis): ``fn(params, x)`` runs once on the CPU over a zero batch
    ``[batch, *input_shape]`` under ``torch.utils.flop_counter``'s
    ``FlopCounterMode``, and the count is divided by ``batch``.

    ``fn`` is a port forward, e.g. ``lambda p, x:
    stacked_forward("model1", p, x[None], faithful=True)`` over one
    lane's ``[1, ...]`` params.  Matmuls and convolutions count 2·MACs;
    a convolution counts only its in-bounds taps, as XLA counts a padded
    conv (the counter's own formula counts the padded window: +14-16% on
    the zoo's CNNs).  It runs on the CPU whatever device trains: on the
    card an f32 conv is ``_RoundedConv``'s f64 GEMMs over a padded
    im2col, which would count the padded taps again.  The gap to dopt's
    count (the zoo at batch 8): the elementwise ops, which XLA counts
    and the counter does not (−0.2% to −0.4% on model1, model3, mlp and
    logistic), and ResNet-18's uneven 'SAME' pads, which the port
    applies with an explicit ``F.pad`` so the counter sees them as input
    (+0.5%).  NaN where nothing is counted."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    x = torch.zeros((batch, *input_shape), dtype=dtype or torch.float32)
    counter = FlopCounterMode(display=False, custom_mapping={
        aten.convolution: _conv_flop_in_bounds,
        aten._convolution: _conv_flop_in_bounds})
    with torch.no_grad(), counter:
        fn(_to_cpu(params), x)
    total = counter.get_total_flops()
    if not total:
        return float("nan")
    return float(total) / batch


def train_flops_per_sample(fn, params, input_shape, *, batch: int = 8,
                           dtype=None) -> float:
    """Training FLOPs per sample ≈ 3 × forward (the forward and about
    twice it in the backward), the MFU literature's accounting."""
    return 3.0 * fwd_flops_per_sample(fn, params, input_shape, batch=batch,
                                      dtype=dtype)
