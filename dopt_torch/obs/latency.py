"""SLO latency channel: fixed-bucket histograms over ``latency`` events.

The port's copy of dopt's ``dopt.obs.latency``.  The serve daemon
measures its runtime latencies — checkpoint-restore p99, alert latency
under live churn — and streams each observation as a non-deterministic v1
``latency`` event (``dopt_torch.obs.events``).  This module is the math under
them: a stdlib fixed-bucket histogram with JSON-able state (like the
rule windows, so a monitor checkpoint carries it across restarts),
quantile estimation, and the Prometheus *histogram* exposition
(``_bucket``/``_sum``/``_count`` with cumulative ``le`` labels) that
``PrometheusSink`` renders.

The SLO latency names a served run records (``SLO_LATENCIES``):

``boundary_tick``       one round-boundary visit of the serve
                        controller — command ingest, directive
                        publish/await, apply, checkpoint decision —
                        the per-round control-plane overhead;
``command_apply``       enqueue → applied: the queue ``ts`` the
                        submitter stamped to the boundary that applied
                        the command (what an operator actually waits);
``checkpoint_save``     one atomic checkpoint (fleet barrier included);
``checkpoint_restore``  one restore — daemon start resume or a
                        config-change rebuild's restore leg;
``alert_latency``       the triggering round bundle's ``ts`` to the
                        alert event's ``ts`` — how stale a page is by
                        the time it exists.

Buckets are fixed (``DEFAULT_BUCKETS``: 1 ms → 120 s, log-spaced, +Inf
overflow) so histograms merge across processes and restarts by adding
counts; quantiles interpolate linearly inside the owning bucket and
clamp to the observed min/max, so small samples report honest values
instead of bucket-edge artifacts.

Stdlib-only (no torch/numpy): the aggregator and an SLO report run
anywhere the checker does.
"""

from __future__ import annotations

import math
from typing import Any, Iterable

# The latency names a served run records; the soak's SLO report asserts
# finite p50/p99 for each (alert_latency only when an alert fired).
SLO_LATENCIES = ("boundary_tick", "command_apply", "checkpoint_save",
                 "checkpoint_restore", "alert_latency")

# Fixed upper bounds in seconds (the +Inf overflow bucket is implicit):
# 1 ms resolution at the fast end (an idle boundary tick), 120 s at the
# slow end (a fleet checkpoint barrier on a loaded host).  Fixed, not
# adaptive: histograms with identical bounds merge by adding counts.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

QUANTILES = (0.5, 0.95, 0.99)


class LatencyHistogram:
    """Fixed-bucket latency histogram with JSON-able state.

    ``counts[i]`` holds observations in ``(bounds[i-1], bounds[i]]``
    (first bucket from 0); ``counts[-1]`` is the +Inf overflow.  State
    round-trips through JSON exactly (ints and the float bounds), so it
    checkpoints like a rule window.
    """

    def __init__(self, bounds: Iterable[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly "
                             f"increasing, got {self.bounds}")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, seconds: float) -> None:
        v = float(seconds)
        if not math.isfinite(v) or v < 0:
            raise ValueError(f"latency observation must be finite "
                             f">= 0, got {seconds!r}")
        i = 0
        while i < len(self.bounds) and v > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> float | None:
        """Estimate the ``q``-quantile (0 < q <= 1) by linear
        interpolation inside the owning bucket, clamped to the observed
        [min, max]; None when empty."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = (self.bounds[i] if i < len(self.bounds)
                      else (self.max if self.max is not None else lo))
                frac = (target - cum) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                lo_clamp = self.min if self.min is not None else est
                hi_clamp = self.max if self.max is not None else est
                return max(lo_clamp, min(hi_clamp, est))
            cum += c
        return self.max

    def summary(self) -> dict[str, Any]:
        """The p50/p95/p99 block the HealthReport and the soak's SLO
        report carry."""
        out: dict[str, Any] = {"count": self.count,
                               "sum": round(self.sum, 6),
                               "min": self.min, "max": self.max}
        for q in QUANTILES:
            v = self.quantile(q)
            out[f"p{int(q * 100)}"] = None if v is None else round(v, 6)
        return out

    # -- state (JSON round-trip, like rule windows) --------------------
    def state(self) -> dict[str, Any]:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}

    @classmethod
    def from_state(cls, st: dict[str, Any]) -> "LatencyHistogram":
        h = cls(st.get("bounds", DEFAULT_BUCKETS))
        counts = list(st.get("counts", []))
        if len(counts) == len(h.counts):
            h.counts = [int(c) for c in counts]
        h.count = int(st.get("count", sum(h.counts)))
        h.sum = float(st.get("sum", 0.0))
        h.min = st.get("min")
        h.max = st.get("max")
        return h

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Add ``other``'s counts into this histogram (fixed identical
        bounds are the contract that makes cross-process merges exact)."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket bounds")
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.count += other.count
        self.sum += other.sum
        for v in (other.min, other.max):
            if v is None:
                continue
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
        return self

    # -- Prometheus histogram exposition -------------------------------
    def exposition(self, family: str, labels: str = "") -> list[str]:
        """The ``_bucket``/``_sum``/``_count`` sample lines for this
        histogram (cumulative ``le`` per the exposition format).
        ``labels`` is a pre-rendered ``name="value"`` fragment the
        ``le`` label is appended to."""
        sep = "," if labels else ""
        lines = []
        cum = 0
        for bound, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{family}_bucket{{{labels}{sep}le="{bound:g}"}} '
                         f"{cum}")
        lines.append(f'{family}_bucket{{{labels}{sep}le="+Inf"}} '
                     f"{self.count}")
        brace = f"{{{labels}}}" if labels else ""
        lines.append(f"{family}_sum{brace} {self.sum!r}")
        lines.append(f"{family}_count{brace} {self.count}")
        return lines


def summarize_latency_events(events: Iterable[dict]) -> dict[str, Any]:
    """Fold a stream's ``latency`` events into per-name summaries —
    the soak's SLO report in one call (events from several processes'
    merged streams simply add up; the buckets are fixed)."""
    hists: dict[str, LatencyHistogram] = {}
    for ev in events:
        if ev.get("kind") != "latency":
            continue
        name = str(ev.get("name"))
        v = ev.get("seconds")
        if isinstance(v, (int, float)) and math.isfinite(v) and v >= 0:
            hists.setdefault(name, LatencyHistogram()).observe(float(v))
    return {name: h.summary() for name, h in sorted(hists.items())}
