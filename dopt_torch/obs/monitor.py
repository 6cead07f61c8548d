"""Streaming run-health monitor over the dopt_torch.obs event stream.

``HealthMonitor`` consumes the v1 event stream *while a run trains* and
evaluates a declarative rule set (dopt_torch.obs.rules), emitting ``alert``
events and an end-of-run ``HealthReport`` verdict.  Two attachment
modes, one ``observe(event)`` core:

* **in-process** — the monitor is a ``Sink``: ``monitor.attach(tele)``
  appends it to a ``Telemetry``'s sink list, so every round bundle the
  engines emit flows through the rules as it happens, and fired alerts
  are forwarded to the OTHER sinks (they land in the JSONL stream just
  after the round that triggered them);
* **tailing** — ``monitor.poll_file(path)`` incrementally reads a
  growing JSONL metrics file (complete lines only, byte-offset
  watermark), the ``scan_watermark``-style resume: a monitor restarted
  from ``monitor.state()`` continues where it stopped without
  re-firing a single alert.

Because rules read only the deterministic kinds (round/gauge/fault)
plus run headers, the alert sequence is identical for per-round,
fused-blocked and killed-and-resumed execution of the same config —
the canonical-stream guarantee lifted to alerts (tests/test_torch_monitor.py
holds it on synthetic streams and chaos runs).

Stdlib-only: tailing a metrics file must not drag torch onto a laptop.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Iterable

from dopt_torch.obs.events import make_event, validate_event
from dopt_torch.obs.latency import LatencyHistogram
from dopt_torch.obs.rules import Rule, RunContext, default_rules
from dopt_torch.obs.sinks import Sink

# Fields of an alert event that identify it across executions —
# everything but the wall clock.
_ALERT_CANON_DROP = ("ts",)


class JsonlTail:
    """Incremental JSONL reader with a byte-offset watermark.

    ``poll()`` returns the complete-line events appended since the last
    poll and advances the offset past them; a trailing partial line (a
    writer mid-flush, or the torn tail a SIGKILL leaves) stays pending
    until its newline lands, so a tailer never parses half an event.
    A complete line that is not JSON raises — mid-file garbage means
    the file is corrupt, and silently skipping it would desynchronize
    every downstream consumer."""

    def __init__(self, path: str | Path, offset: int = 0):
        self.path = Path(path)
        self.offset = int(offset)

    def poll(self) -> list[dict[str, Any]]:
        if not self.path.exists():
            return []
        with open(self.path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            if size < self.offset:
                # The file SHRANK below our watermark —
                # JsonlSink.repair_tail does this on kill-and-resume
                # when it drops the torn tail / orphan lines of an
                # unsealed bundle.  Clamp to the new end: the removed
                # bytes were already consumed, and everything the
                # resumed producer appends lands after this point.
                # (Orphan fault/gauge rows of a torn bundle may thus be
                # seen twice — pre-repair and re-emitted — but their
                # bundle's round event only ever seals once.)
                self.offset = size
            f.seek(self.offset)
            chunk = f.read()
        if not chunk:
            return []
        end = chunk.rfind(b"\n")
        if end < 0:
            return []
        events: list[dict[str, Any]] = []
        for i, line in enumerate(chunk[:end + 1].splitlines()):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                raise ValueError(
                    f"{self.path}: offset {self.offset}, line {i + 1} is "
                    f"not JSON: {line[:80]!r}")
        self.offset += end + 1
        return events


@dataclasses.dataclass
class HealthReport:
    """End-of-run verdict: what a soak's CI gate (and ``/healthz``)
    consume.  ``verdict``: 'healthy' (no alerts), 'warn' (only warn-
    severity alerts), 'critical', or 'empty' (no rounds observed)."""

    verdict: str
    rounds: int
    segments: int
    alerts: int
    by_rule: dict[str, int]
    by_severity: dict[str, int]
    last_round: int | None
    engines: list[str]
    # SLO latency summaries (p50/p95/p99 per latency name) folded from
    # the stream's ``latency`` events plus the monitor's own measured
    # alert latency — what the soak's SLO report and ``final.json``
    # carry.  Empty when the stream carries no latency channel.
    latency: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.verdict in ("healthy", "warn", "empty")

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def write(self, path: str | Path) -> Path:
        from dopt_torch.utils.metrics import atomic_write_text

        return atomic_write_text(path, json.dumps(self.to_dict(), indent=2))


class HealthMonitor(Sink):
    """Evaluates a rule set over an event stream; collects alerts.

    As a ``Sink`` it can sit in a ``Telemetry``'s fan-out (use
    ``attach`` so fired alerts are forwarded to the other sinks); as a
    tailer it polls a JSONL file.  ``state()``/``state=`` checkpoint
    and resume the whole thing — rule windows included — so a
    restarted tail never duplicates an alert."""

    def __init__(self, rules: list[Rule] | None = None, *,
                 workers: int | None = None,
                 state: dict[str, Any] | None = None):
        self.rules = rules if rules is not None else default_rules()
        self.alerts: list[dict[str, Any]] = []
        self.ctx = RunContext(workers=workers)
        self.rounds_seen = 0
        self.segments = 0
        self._engines: list[str] = []
        self._by_rule: dict[str, int] = {}
        self._by_severity: dict[str, int] = {}
        # SLO latency histograms: per-name fixed-bucket histograms fed
        # from the stream's ``latency`` events, plus the monitor's own
        # ``alert_latency`` measurement (triggering round bundle ts →
        # alert emit ts, taken at fire time).  JSON-able, part of
        # ``state()`` like the rule windows — a restarted monitor keeps
        # accumulating instead of forgetting the run's tail latencies.
        self.latency: dict[str, LatencyHistogram] = {}
        # Wall-clock staleness meters: the ts of the newest event seen
        # (any kind) and of the newest round event — /healthz reports
        # "last event ts vs wall" so a stalled producer is
        # distinguishable from a healthy idle one.
        self.last_event_ts: float | None = None
        self._last_round_ts: float | None = None
        self._telemetry = None
        self._tail: JsonlTail | None = None
        self._tail_offset = 0
        if state is not None:
            self.load_state(state)

    # -- consumption ---------------------------------------------------
    def emit(self, event: dict[str, Any]) -> None:
        """Sink protocol: evaluate the event (alerts accumulate on the
        monitor and are forwarded to the attached Telemetry's other
        sinks)."""
        self.observe(event)

    def observe(self, ev: dict[str, Any]) -> list[dict[str, Any]]:
        """Evaluate one event against every rule; returns the alert
        events fired (schema-stamped, already recorded)."""
        kind = ev.get("kind")
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            self.last_event_ts = (float(ts) if self.last_event_ts is None
                                  else max(self.last_event_ts, float(ts)))
        if kind == "alert":
            return []   # never feed alerts back into the rules
        if kind == "latency":
            # The SLO latency channel: accumulate into the per-name
            # histograms the HealthReport summarizes.  No rule reads
            # the kind (wall-clock durations), so fall through is safe
            # but pointless.
            v = ev.get("seconds")
            if isinstance(v, (int, float)) and v >= 0:
                self.latency.setdefault(
                    str(ev.get("name", "?")),
                    LatencyHistogram()).observe(float(v))
            return []
        if kind == "run":
            self.ctx.engine = ev.get("engine")
            if isinstance(ev.get("workers"), int):
                self.ctx.workers = ev["workers"]
            if int(ev.get("round", 0)) == 0:
                # A fresh logical run (bench legs share one file); a
                # header with round > 0 is a resume CONTINUATION and
                # must keep the rule windows — the resumed stream's
                # alerts must match the continuous run's.
                self.segments += 1
                self.ctx.cohort = None
                self.ctx.population = None
                self.ctx.participating = None
                self.ctx.checkpoint_every = None
                for r in self.rules:
                    r.reset()
            elif self.segments == 0:
                self.segments = 1
            ce = ev.get("checkpoint_every")
            if isinstance(ce, int) and not isinstance(ce, bool):
                # The run's configured checkpoint cadence, read by the
                # checkpoint_cadence rule; resume continuations restate
                # it, so a restarted tail keeps monitoring the cadence.
                self.ctx.checkpoint_every = ce
        elif kind == "control":
            # A served run's applied control-plane commands: a cadence
            # change moves the checkpoint_cadence rule's expectation
            # from the boundary it was applied.
            if (ev.get("cmd") == "config"
                    and ev.get("key") == "checkpoint_every"
                    and isinstance(ev.get("value"), (int, float))):
                self.ctx.checkpoint_every = int(ev["value"]) or None
        elif kind == "round":
            self.rounds_seen += 1
            self.ctx.round = int(ev["round"])
            if isinstance(ts, (int, float)):
                self._last_round_ts = float(ts)
        elif kind == "gauge":
            # Denominator gauges the engines emit for the
            # fleet-fraction rules.
            name = ev.get("name")
            if name == "cohort_size":
                self.ctx.cohort = float(ev["value"])
            elif name == "population_size":
                self.ctx.population = float(ev["value"])
            elif name == "participating_lanes":
                self.ctx.participating = float(ev["value"])
        fired: list[dict[str, Any]] = []
        extras: list[dict[str, Any]] = []
        for rule in self.rules:
            for payload in rule.update(ev, self.ctx):
                alert = self._record(rule, payload)
                fired.append(alert)
                lat = self._alert_latency(alert, ev)
                if lat is not None:
                    extras.append(lat)
        if (fired or extras) and self._telemetry is not None:
            for s in self._telemetry.sinks:
                if s is not self:
                    s.emit_many(fired + extras)
        return fired

    def _alert_latency(self, alert: dict[str, Any],
                       trigger: dict[str, Any]) -> dict[str, Any] | None:
        """Measure one alert's latency — the TRIGGERING event's ``ts``
        (the gauge/round/fault of its bundle that tripped the rule; a
        gauge-driven rule fires before the bundle's round event lands,
        so the previous round event would overstate by a full round
        interval) to the alert event's ``ts``, both stamped by the same
        producer clock — into the ``alert_latency`` histogram, and
        return the ``latency`` event to forward into the stream.  ONLY
        measured when the monitor rides the live fan-out (``attach``):
        a tail/replay-fed monitor (fleet endpoint, watch, an offline
        soak gate) observes historical ``ts`` stamps, so "alert now
        minus event then" would report poll cadence, not alert latency
        — those consumers get the channel from the stream's own
        embedded latency events instead (the ``latency``-kind branch
        above)."""
        if self._telemetry is None:
            return None
        ts = alert.get("ts")
        anchor = trigger.get("ts")
        if not isinstance(anchor, (int, float)):
            anchor = self._last_round_ts
        if anchor is None or not isinstance(ts, (int, float)):
            return None
        lat = max(0.0, float(ts) - float(anchor))
        self.latency.setdefault("alert_latency",
                                LatencyHistogram()).observe(lat)
        return make_event("latency", round=int(alert.get("round", 0)),
                          name="alert_latency", seconds=round(lat, 6))

    def lag_seconds(self, now: float | None = None) -> float | None:
        """Wall seconds since the newest event this monitor has seen —
        the "is the producer stalled or just idle" meter /healthz
        reports; None before any event."""
        if self.last_event_ts is None:
            return None
        if now is None:
            import time

            now = time.time()  # dopt: allow-wallclock -- staleness meter vs the event ts stamps, reporting only
        return max(0.0, float(now) - self.last_event_ts)

    def _record(self, rule: Rule, payload: dict[str, Any]) -> dict[str, Any]:
        ev = make_event(
            "alert",
            round=int(payload.get("round", max(self.ctx.round, 0))),
            rule=rule.name, severity=rule.severity,
            message=str(payload.get("message", rule.name)),
            value=payload.get("value"),
            engine=self.ctx.engine)
        validate_event(ev)
        self.alerts.append(ev)
        self._by_rule[rule.name] = self._by_rule.get(rule.name, 0) + 1
        self._by_severity[rule.severity] = \
            self._by_severity.get(rule.severity, 0) + 1
        eng = self.ctx.engine
        if eng and eng not in self._engines:
            self._engines.append(eng)
        return ev

    def feed(self, events: Iterable[dict[str, Any]]) -> list[dict[str, Any]]:
        """Batch observe; returns all alerts fired by the batch."""
        fired: list[dict[str, Any]] = []
        for ev in events:
            fired.extend(self.observe(ev))
        return fired

    def poll_file(self, path: str | Path) -> list[dict[str, Any]]:
        """Tail a growing JSONL stream: process only the bytes
        appended since the previous poll (complete lines only).  The
        offset is part of ``state()`` — a monitor rebuilt from saved
        state resumes the tail exactly where it stopped."""
        path = Path(path)
        if self._tail is None or self._tail.path != path:
            self._tail = JsonlTail(path, offset=self._tail_offset)
        fired = self.feed(self._tail.poll())
        self._tail_offset = self._tail.offset
        return fired

    # -- attachment ----------------------------------------------------
    def attach(self, telemetry) -> "HealthMonitor":
        """Join a ``Telemetry``'s sink fan-out (appended LAST, so a
        round bundle reaches the file/ring sinks before any alert it
        triggers) and forward fired alerts to the other sinks."""
        self._telemetry = telemetry
        if self not in telemetry.sinks:
            telemetry.sinks.append(self)
        return self

    # -- state (resume) ------------------------------------------------
    def state(self) -> dict[str, Any]:
        """JSON-able checkpoint of the monitor: tail offset, counters,
        context, and every rule's windowed state."""
        return {
            "v": 1,
            "offset": (self._tail.offset if self._tail is not None
                       else self._tail_offset),
            "rounds_seen": self.rounds_seen,
            "segments": self.segments,
            "engines": list(self._engines),
            "by_rule": dict(self._by_rule),
            "by_severity": dict(self._by_severity),
            "ctx": {"engine": self.ctx.engine, "workers": self.ctx.workers,
                    "cohort": self.ctx.cohort,
                    "population": self.ctx.population,
                    "participating": self.ctx.participating,
                    "checkpoint_every": self.ctx.checkpoint_every,
                    "round": self.ctx.round},
            "rules": {r.name: json.loads(json.dumps(r.s))
                      for r in self.rules},
            "latency": {name: h.state()
                        for name, h in self.latency.items()},
            "last_event_ts": self.last_event_ts,
            "last_round_ts": self._last_round_ts,
        }

    def load_state(self, st: dict[str, Any]) -> None:
        self._tail_offset = int(st.get("offset", 0))
        self._tail = None
        self.rounds_seen = int(st.get("rounds_seen", 0))
        self.segments = int(st.get("segments", 0))
        self._engines = list(st.get("engines", []))
        self._by_rule = dict(st.get("by_rule", {}))
        self._by_severity = dict(st.get("by_severity", {}))
        ctx = st.get("ctx", {})
        self.ctx.engine = ctx.get("engine")
        self.ctx.workers = ctx.get("workers")
        self.ctx.cohort = ctx.get("cohort")
        self.ctx.population = ctx.get("population")
        self.ctx.participating = ctx.get("participating")
        self.ctx.checkpoint_every = ctx.get("checkpoint_every")
        self.ctx.round = int(ctx.get("round", -1))
        saved = st.get("rules", {})
        for r in self.rules:
            if r.name in saved:
                r.s = dict(saved[r.name])
        self.latency = {name: LatencyHistogram.from_state(hs)
                        for name, hs in st.get("latency", {}).items()}
        self.last_event_ts = st.get("last_event_ts")
        self._last_round_ts = st.get("last_round_ts")

    # -- results -------------------------------------------------------
    def canonical_alerts(self) -> list[dict[str, Any]]:
        """Alerts minus wall-clock fields — the comparison form for the
        per-round vs blocked vs resumed equality invariant."""
        return [{k: v for k, v in a.items() if k not in _ALERT_CANON_DROP}
                for a in self.alerts]

    def report(self) -> HealthReport:
        if self.rounds_seen == 0 and not self.alerts:
            verdict = "empty"
        elif self._by_severity.get("critical"):
            verdict = "critical"
        elif self.alerts:
            verdict = "warn"
        else:
            verdict = "healthy"
        return HealthReport(
            verdict=verdict, rounds=self.rounds_seen,
            segments=self.segments, alerts=len(self.alerts),
            by_rule=dict(self._by_rule),
            by_severity=dict(self._by_severity),
            last_round=self.ctx.round if self.ctx.round >= 0 else None,
            engines=list(self._engines),
            latency={name: h.summary()
                     for name, h in sorted(self.latency.items())})
