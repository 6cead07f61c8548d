"""Phase timers and the device-resource channel — the port's copy of
``dopt.utils.profiling``'s host half.

* ``PhaseTimers`` — wall-clock accumulators per named round phase
  (``host_batch_plan``: the stage's draws, plans and uploads;
  ``round_step``: the round or block on the device up to its fetch;
  ``checkpoint``), with dopt's ``tracer`` hook: attaching telemetry
  turns every ``phase`` site into a host span.
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
import time
from collections import defaultdict
from typing import Iterator

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
        t0 = time.perf_counter()
        try:
            with span:
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

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
        tele.emit("compile", round=int(t), fn=fn_name, count=comp["count"],
                  total=comp["total"], seconds=round(seconds, 6))
    stats = device_memory_stats(trainer.device)
    if stats is not None:
        tele.emit("resource", round=int(t), engine=trainer.engine_kind,
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
