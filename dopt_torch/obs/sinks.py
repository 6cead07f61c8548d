"""Telemetry sinks — the port's copy of dopt's ``obs.sinks``.

* ``JsonlSink`` — one JSON object a line, flushed per event (a round's
  bundle in one write), so a killed run leaves a whole prefix;
  ``repair_tail`` heals what a kill leaves before a resumed run appends,
  and ``scan_watermark`` recovers the highest streamed round.
* ``MemorySink`` — a bounded in-memory ring.
* ``PrometheusSink`` — the latest value of every numeric round metric
  and gauge plus per-kind counters, rendered as Prometheus text; for
  the same events its text is dopt's.
"""

from __future__ import annotations

import json
import math
import re
from collections import deque
from pathlib import Path
from typing import Any, Iterator

from dopt_torch.utils.metrics import atomic_write_text


def _jsonable(v: Any):
    """json.dumps fallback: unwrap numpy scalars and 0-d tensors."""
    item = getattr(v, "item", None)
    if callable(item):
        return item()
    raise TypeError(f"event field {v!r} is not JSON-serialisable")


def _line(ev: dict[str, Any]) -> str:
    return json.dumps(ev, separators=(",", ":"), default=_jsonable) + "\n"


class Sink:
    def emit(self, event: dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def emit_many(self, events: list[dict[str, Any]]) -> None:
        """A round's bundle; file sinks write it at once."""
        for ev in events:
            self.emit(ev)

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    """JSONL file sink, flushed per write (a crash leaves a whole
    prefix)."""

    def __init__(self, path: str | Path, *, append: bool = False):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if append:
            JsonlSink.repair_tail(self.path)
        self._f = open(self.path, "a" if append else "w")

    def emit(self, event: dict[str, Any]) -> None:
        self._f.write(_line(event))
        self._f.flush()

    def emit_many(self, events: list[dict[str, Any]]) -> None:
        """One round's bundle as ONE write and flush, so a kill leaves
        the whole bundle or none of it (a bundle longer than the stdio
        buffer can still tear: ``repair_tail`` drops its orphans)."""
        self._f.write("".join(_line(ev) for ev in events))
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    @staticmethod
    def read(path: str | Path) -> list[dict[str, Any]]:
        """Load a JSONL stream.  A truncated FINAL line (what a kill can
        leave) is dropped; garbage anywhere else raises."""
        lines = Path(path).read_text().splitlines()
        events: list[dict[str, Any]] = []
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                if i == len(lines) - 1:
                    break
                raise ValueError(
                    f"{path}: line {i + 1} is not JSON: {line[:80]!r}")
        return events

    @staticmethod
    def repair_tail(path: str | Path) -> None:
        """Repair what a kill mid-write can leave, before a resumed
        segment appends: an unterminated final line gets its newline if
        it parses and is dropped if not; then the trailing
        ``fault``/``gauge``/``control`` events of a round no ``round``
        event sealed are dropped (the resumed run re-emits that round's
        whole bundle).  Decisions are made on the repaired bytes, so
        ``scan_watermark`` agrees with what stays on disk."""
        path = Path(path)
        if not path.exists():
            return
        orig = raw = path.read_bytes()
        if raw and not raw.endswith(b"\n"):
            nl = raw.rfind(b"\n") + 1
            try:
                json.loads(raw[nl:].strip())
            except ValueError:
                raw = raw[:nl]
            else:
                raw = raw + b"\n"
        sealed = -1
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # mid-file garbage: left for read() to report
            if ev.get("kind") == "round" and isinstance(ev.get("round"), int):
                sealed = max(sealed, ev["round"])
        keep = len(raw)
        while keep > 0:
            prev = raw.rfind(b"\n", 0, keep - 1) + 1
            line = raw[prev:keep].strip()
            if line:
                try:
                    ev = json.loads(line)
                except ValueError:
                    break
                if not (ev.get("kind") in ("fault", "gauge", "control")
                        and isinstance(ev.get("round"), int)
                        and ev["round"] > sealed):
                    break
            keep = prev
        if raw[:keep] != orig:
            atomic_write_text(path, raw[:keep].decode("utf-8"))

    @staticmethod
    def scan_watermark(path: str | Path) -> int | None:
        """The highest round already streamed to ``path``, or None when
        the file is absent or holds no round event."""
        path = Path(path)
        if not path.exists():
            return None
        best: int | None = None
        for ev in JsonlSink.read(path):
            if ev.get("kind") == "round" and isinstance(ev.get("round"), int):
                best = ev["round"] if best is None else max(best, ev["round"])
        return best


class MemorySink(Sink):
    """Bounded in-memory ring (``capacity=None`` keeps everything)."""

    def __init__(self, capacity: int | None = None):
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)

    def emit(self, event: dict[str, Any]) -> None:
        self._ring.append(event)

    @property
    def events(self) -> list[dict[str, Any]]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return iter(self.events)


# Prometheus metric names must match [a-zA-Z_:][a-zA-Z0-9_:]*; colons
# are reserved for recording rules, so they are mapped away too.
_METRIC_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_LABEL_ESC_RE = re.compile(r'(["\\\n])')

# dopt's fixed latency buckets in seconds (+Inf implicit), so a
# ``latency`` event renders as dopt renders it.
_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def _metric_name(name: str) -> str:
    return "dopt_" + (_METRIC_NAME_RE.sub("_", str(name)) or "metric")


def _label_value(v: str) -> str:
    """Escape per the exposition format: backslash, quote, newline."""
    return _LABEL_ESC_RE.sub(
        lambda m: {"\\": r"\\", '"': r"\"", "\n": r"\n"}[m.group(1)],
        str(v))


class _Histogram:
    """A fixed-bucket latency histogram's exposition lines."""

    def __init__(self):
        self.counts = [0] * (len(_LATENCY_BUCKETS) + 1)
        self.count, self.sum = 0, 0.0

    def observe(self, v: float) -> None:
        i = 0
        while i < len(_LATENCY_BUCKETS) and v > _LATENCY_BUCKETS[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.sum += v

    def exposition(self, family: str, labels: str) -> list[str]:
        lines, cum = [], 0
        for bound, c in zip(_LATENCY_BUCKETS, self.counts):
            cum += c
            lines.append(f'{family}_bucket{{{labels},le="{bound:g}"}} {cum}')
        lines.append(f'{family}_bucket{{{labels},le="+Inf"}} {self.count}')
        lines.append(f"{family}_sum{{{labels}}} {self.sum!r}")
        lines.append(f"{family}_count{{{labels}}} {self.count}")
        return lines


def _num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class PrometheusSink(Sink):
    """Latest-value snapshot in Prometheus text-exposition format: one
    gauge family per signal with the producing engine as an
    ``engine_kind`` label, and counters of faults, alerts and
    captures."""

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path is not None else None
        # family name -> (help text, {engine label or None: value})
        self._gauges: dict[str, tuple[str, dict[str | None, float]]] = {}
        self._faults: dict[str, int] = {}
        self._alerts: dict[tuple[str, str], int] = {}
        self._compiles: dict[str, int] = {}
        self._latency: dict[str, _Histogram] = {}

    def _set(self, name: str, help_: str, engine: str | None,
             value: float) -> None:
        fam = self._gauges.setdefault(_metric_name(name), (help_, {}))
        fam[1][engine] = float(value)

    def emit(self, event: dict[str, Any]) -> None:
        kind = event.get("kind")
        if kind == "round":
            eng = event.get("engine")
            self._set("round", "latest completed training round", eng,
                      float(event["round"]))
            for k, v in event.get("metrics", {}).items():
                if _num(v):
                    self._set(k, f"latest value of round metric {k!r}",
                              eng, float(v))
        elif kind == "gauge":
            self._set(event["name"],
                      f"latest value of gauge {event['name']!r}",
                      event.get("engine"), float(event["value"]))
        elif kind == "fault":
            f = str(event["fault"])
            self._faults[f] = self._faults.get(f, 0) + 1
        elif kind == "alert":
            key = (str(event["rule"]), str(event.get("severity", "warn")))
            self._alerts[key] = self._alerts.get(key, 0) + 1
        elif kind == "resource":
            eng = event.get("engine")
            for key in ("live_bytes", "peak_bytes"):
                v = event.get(key)
                if _num(v):
                    self._set(f"hbm_{key}",
                              f"latest device-memory {key} sample "
                              "(resource events)", eng, float(v))
        elif kind == "compile":
            fn = str(event.get("fn", "?"))
            c = event.get("count")
            self._compiles[fn] = self._compiles.get(fn, 0) + (
                int(c) if isinstance(c, int) else 1)
        elif kind == "latency":
            v = event.get("seconds")
            if _num(v) and v >= 0 and math.isfinite(v):
                name = str(event.get("name", "?"))
                self._latency.setdefault(name, _Histogram()).observe(
                    float(v))

    def render(self) -> str:
        lines = []
        for name in sorted(self._gauges):
            help_, series = self._gauges[name]
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            for eng in sorted(series, key=lambda e: e or ""):
                label = (f'{{engine_kind="{_label_value(eng)}"}}'
                         if eng else "")
                lines.append(f"{name}{label} {series[eng]!r}")
        if self._faults:
            lines.append("# HELP dopt_faults_total fault-ledger rows "
                         "observed, by ledger kind")
            lines.append("# TYPE dopt_faults_total counter")
            for kind in sorted(self._faults):
                lines.append(
                    f'dopt_faults_total{{kind="{_label_value(kind)}"}} '
                    f'{self._faults[kind]}')
        if self._alerts:
            lines.append("# HELP dopt_alerts_total health-rule alerts "
                         "fired, by rule and severity")
            lines.append("# TYPE dopt_alerts_total counter")
            for rule, sev in sorted(self._alerts):
                lines.append(
                    f'dopt_alerts_total{{rule="{_label_value(rule)}",'
                    f'severity="{_label_value(sev)}"}} '
                    f'{self._alerts[(rule, sev)]}')
        if self._compiles:
            lines.append("# HELP dopt_compiles_total round-function "
                         "(re)trace events observed, by function")
            lines.append("# TYPE dopt_compiles_total counter")
            for fn in sorted(self._compiles):
                lines.append(
                    f'dopt_compiles_total{{fn="{_label_value(fn)}"}} '
                    f'{self._compiles[fn]}')
        if self._latency:
            lines.append("# HELP dopt_latency_seconds SLO latency "
                         "observations (latency events), by name")
            lines.append("# TYPE dopt_latency_seconds histogram")
            for name in sorted(self._latency):
                lines.extend(self._latency[name].exposition(
                    "dopt_latency_seconds", f'name="{_label_value(name)}"'))
        return "\n".join(lines) + "\n"

    def write(self, path: str | Path | None = None) -> Path:
        target = Path(path) if path is not None else self.path
        if target is None:
            raise ValueError("PrometheusSink needs a path to write to")
        return atomic_write_text(target, self.render())

    def close(self) -> None:
        if self.path is not None:
            self.write()
