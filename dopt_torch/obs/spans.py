"""Host-side span tracing with a Chrome-trace (Perfetto) export — the
port's copy of dopt's ``obs.spans``.

``SpanTracer.span("block")`` is a nestable context manager recording
(name, start, duration, depth) against the tracer's epoch, the newest
``DEFAULT_SPAN_CAPACITY`` records kept (the per-name totals stay
exact).  The engines reach it through
``dopt_torch.utils.profiling.PhaseTimers``'
``tracer`` hook: attaching telemetry (``dopt_torch.obs.attach``) turns
every ``timers.phase(...)`` site — host batch planning, the round or
block dispatch with its fetch, checkpoint writes — into a span.
``write_chrome`` emits the ``{"traceEvents": [...]}`` JSON that
Perfetto and the Chrome tracing UI load; the device side of the same
run is ``python -m dopt_torch.run --trace DIR`` (torch.profiler).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from pathlib import Path
from typing import Any, Iterator

from dopt_torch.utils.metrics import atomic_write_text

DEFAULT_SPAN_CAPACITY = 100_000


class SpanTracer:
    """Accumulates nested host spans; cheap enough to leave attached."""

    def __init__(self):
        self._t0 = time.perf_counter()  # dopt: allow-wallclock -- span timing only, never training math
        self._depth = 0
        self._ring: deque[dict[str, Any]] = deque(
            maxlen=DEFAULT_SPAN_CAPACITY)
        self._totals: dict[str, float] = {}

    @property
    def spans(self) -> list[dict[str, Any]]:
        return list(self._ring)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()  # dopt: allow-wallclock -- span timing only, never training math
        self._depth += 1
        depth = self._depth - 1
        try:
            yield
        finally:
            self._depth -= 1
            t1 = time.perf_counter()  # dopt: allow-wallclock -- span timing only, never training math
            name = str(name)
            self._ring.append({"name": name, "ts_us": (t0 - self._t0) * 1e6,
                               "dur_us": (t1 - t0) * 1e6, "depth": depth})
            self._totals[name] = self._totals.get(name, 0.0) + (t1 - t0)

    def totals(self) -> dict[str, float]:
        """Per-name wall-clock seconds, exact after ring eviction."""
        return dict(self._totals)

    def to_chrome(self) -> list[dict[str, Any]]:
        """Chrome-trace complete events, sorted by start time."""
        return [{"name": s["name"], "cat": "dopt", "ph": "X", "pid": 0,
                 "tid": 0, "ts": round(s["ts_us"], 3),
                 "dur": round(s["dur_us"], 3)}
                for s in sorted(self.spans, key=lambda s: s["ts_us"])]

    def write_chrome(self, path: str | Path) -> Path:
        payload = {"traceEvents": self.to_chrome(), "displayTimeUnit": "ms"}
        return atomic_write_text(path, json.dumps(payload))
