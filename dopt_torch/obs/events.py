"""The telemetry event schema, version 1 — the port's copy of dopt's.

Every record is one JSON object with a ``v`` schema version, a ``kind``
and a wall-clock ``ts``.  The kinds, as dopt defines them:

``run``        a stream segment header (once per attached run, again on
               resume with ``round`` = the resume watermark);
``round``      one per training round: ``metrics`` is the History row;
``gauge``      a named scalar from host-mirror state or the fetched
               on-card diagnostics block;
``fault``      one per fault-ledger row (``fault`` = the ledger kind);
``phase``, ``bench``, ``warning``, ``alert``, ``control``, ``latency``
               producer kinds the port's engines do not emit; they
               validate as in dopt so a mixed stream checks alike;
``checkpoint`` an auto-checkpoint committed at ``round``;
``resource``   a device-memory sample (``diagnostics="on"``):
               ``peak_bytes``/``live_bytes`` from the CUDA caching
               allocator, or the process RSS on the CPU (``source``);
``compile``    a round-graph capture (the port's counterpart of a jit
               retrace): ``fn``, ``count`` new captures, ``total``.

``DETERMINISTIC_KINDS`` are derived only from post-fetch host data, so
per-round, blocked and killed-and-resumed runs of one config emit equal
sequences of them; ``canonical()`` is the comparison form.  Stdlib only.
"""

from __future__ import annotations

import math
import time
from typing import Any, Iterable

SCHEMA_VERSION = 1

KINDS = ("run", "round", "gauge", "fault", "phase", "bench", "warning",
         "alert", "checkpoint", "resource", "compile", "control",
         "latency")

ALERT_SEVERITIES = ("warn", "critical")

# Kinds whose content is a pure function of the round's host-replay
# data: streams filtered to these (ts dropped) are equal across
# per-round, blocked and resumed execution of one config.
DETERMINISTIC_KINDS = ("round", "fault", "gauge", "control")

# The per-round diagnostics gauges (``diagnostics="on"``), in packed
# order.  The sixth is the engine's dispersion meter:
# ``consensus_distance`` (gossip, mean_i ||p_i - p_bar||) or
# ``lane_dispersion`` (federated, mean_i ||p_i - theta||).
DIAG_GAUGES = ("update_norm", "grad_norm", "param_norm",
               "lane_loss_mean", "lane_loss_spread")


def finite_diag_gauges(keys: Iterable[str], block) -> dict[str, float]:
    """Zip a fetched diagnostics block into a gauge dict, dropping the
    non-finite values (a gauge must be finite; absent beats
    unparsable)."""
    out: dict[str, float] = {}
    for name, value in zip(keys, block):
        v = float(value)
        if math.isfinite(v):
            out[name] = v
    return out


def make_event(kind: str, **fields: Any) -> dict[str, Any]:
    """One schema-stamped event; top-level ``None`` fields are dropped."""
    ev: dict[str, Any] = {"v": SCHEMA_VERSION, "kind": kind,
                          "ts": round(time.time(), 6)}  # dopt: allow-wallclock -- the schema ts stamp; canonical() drops it before any replay comparison
    ev.update({k: v for k, v in fields.items() if v is not None})
    return ev


def sanitize_metrics(metrics) -> dict[str, Any]:
    """Non-finite floats become null (NaN is not JSON)."""
    return {k: (None if isinstance(v, float) and not math.isfinite(v)
                else v) for k, v in dict(metrics).items()}


def _fail(msg: str, ev: Any) -> None:
    raise ValueError(f"{msg}: {ev!r}")


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _req_int(ev: dict, key: str, *, lo: int = 0) -> int:
    v = ev.get(key)
    if not isinstance(v, int) or isinstance(v, bool) or v < lo:
        _fail(f"event needs int {key!r} >= {lo}", ev)
    return v


def _req_str(ev: dict, key: str) -> str:
    v = ev.get(key)
    if not isinstance(v, str) or not v:
        _fail(f"event needs non-empty str {key!r}", ev)
    return v


def _req_finite(ev: dict, key: str, msg: str) -> None:
    v = ev.get(key)
    if not _is_num(v) or not math.isfinite(v) or v < 0:
        _fail(msg, ev)


def validate_event(ev: Any) -> dict[str, Any]:
    """Validate one event against the schema; returns it, raises
    ``ValueError`` naming the offending object otherwise.  Unknown extra
    keys are allowed; known keys are typed."""
    if not isinstance(ev, dict):
        _fail("event is not an object", ev)
    if ev.get("v") != SCHEMA_VERSION:
        _fail(f"unknown schema version (want v={SCHEMA_VERSION})", ev)
    kind = ev.get("kind")
    if kind not in KINDS:
        _fail(f"unknown event kind (want one of {KINDS})", ev)
    ts = ev.get("ts")
    if not _is_num(ts) or ts < 0:
        _fail("event needs numeric ts >= 0", ev)
    if kind == "run":
        _req_str(ev, "engine")
        _req_str(ev, "name")
        _req_int(ev, "round")
        if "workers" in ev:
            _req_int(ev, "workers", lo=1)
        if "checkpoint_every" in ev:
            _req_int(ev, "checkpoint_every")
    elif kind == "round":
        _req_int(ev, "round")
        _req_str(ev, "engine")
        m = ev.get("metrics")
        if not isinstance(m, dict):
            _fail("round event needs a metrics object", ev)
        for k, v in m.items():
            if not isinstance(k, str):
                _fail("round metrics keys must be strings", ev)
            if v is None or isinstance(v, (str, bool)):
                continue
            if not _is_num(v) or not math.isfinite(v):
                _fail(f"round metric {k!r} must be finite", ev)
        if "consensus_distance" in ev and not _is_num(
                ev["consensus_distance"]):
            _fail("consensus_distance must be numeric", ev)
        if "collective_bytes" in ev:
            _req_int(ev, "collective_bytes")
    elif kind == "gauge":
        _req_int(ev, "round")
        _req_str(ev, "name")
        v = ev.get("value")
        if not _is_num(v) or not math.isfinite(v):
            _fail("gauge event needs a finite numeric value", ev)
        if "engine" in ev:
            _req_str(ev, "engine")
    elif kind == "fault":
        _req_int(ev, "round")
        # worker -1 is a fleet-level row.
        _req_int(ev, "worker", lo=-1)
        _req_str(ev, "fault")
        _req_str(ev, "action")
    elif kind == "phase":
        fr = ev.get("fractions")
        if not isinstance(fr, dict) or not fr:
            _fail("phase event needs a fractions object", ev)
        for k, v in fr.items():
            if not isinstance(k, str) or not _is_num(v) or not (
                    0.0 <= v <= 1.0):
                _fail(f"phase fraction {k!r} must be in [0, 1]", ev)
        if "round" in ev:
            _req_int(ev, "round")
    elif kind == "bench":
        m = ev.get("metrics")
        if not isinstance(m, dict):
            _fail("bench event needs a metrics object", ev)
        for k, v in m.items():
            if not isinstance(k, str):
                _fail("bench metrics keys must be strings", ev)
            if _is_num(v) and not math.isfinite(v):
                _fail(f"bench metric {k!r} must be finite", ev)
    elif kind == "warning":
        _req_str(ev, "message")
    elif kind == "alert":
        _req_int(ev, "round")
        _req_str(ev, "rule")
        _req_str(ev, "message")
        if ev.get("severity") not in ALERT_SEVERITIES:
            _fail(f"alert severity must be one of {ALERT_SEVERITIES}", ev)
        if "value" in ev and not _is_num(ev["value"]):
            _fail("alert value must be numeric", ev)
    elif kind == "checkpoint":
        _req_int(ev, "round")
        if "consensus_distance" in ev:
            v = ev["consensus_distance"]
            if not _is_num(v) or not math.isfinite(v):
                _fail("checkpoint consensus_distance must be finite", ev)
    elif kind == "resource":
        _req_int(ev, "round")
        _req_finite(ev, "peak_bytes",
                    "resource event needs finite peak_bytes >= 0")
        if "live_bytes" in ev:
            _req_finite(ev, "live_bytes",
                        "resource live_bytes must be finite >= 0")
        if "source" in ev:
            _req_str(ev, "source")
    elif kind == "control":
        _req_int(ev, "round")
        _req_str(ev, "cmd")
        if "key" in ev:
            _req_str(ev, "key")
        if "action" in ev:
            _req_str(ev, "action")
        if "worker" in ev:
            _req_int(ev, "worker")
        if "id" in ev:
            _req_str(ev, "id")
        if "value" in ev:
            v = ev["value"]
            if isinstance(v, float) and not math.isfinite(v):
                _fail("control value must be finite", ev)
            if not isinstance(v, (int, float, str, bool)):
                _fail("control value must be a scalar", ev)
    elif kind == "compile":
        _req_int(ev, "round")
        _req_str(ev, "fn")
        _req_int(ev, "count", lo=1)
        if "total" in ev:
            _req_int(ev, "total", lo=1)
        _req_finite(ev, "seconds",
                    "compile event needs finite seconds >= 0")
    elif kind == "latency":
        _req_int(ev, "round")
        _req_str(ev, "name")
        _req_finite(ev, "seconds",
                    "latency event needs finite seconds >= 0")
    return ev


def check_stream(events: Iterable[Any]) -> dict[str, Any]:
    """Validate a whole stream and its continuity: within each segment
    (opened by a ``run`` event, whose ``round`` is the segment's first
    round), the ``round`` events must run gapless and duplicate-free.
    Returns a summary; raises ``ValueError`` on the first violation."""
    kinds: dict[str, int] = {}
    expected: int | None = None
    rounds = segments = total = 0
    for ev in events:
        validate_event(ev)
        total += 1
        kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
        if ev["kind"] == "run":
            expected = int(ev["round"])
            segments += 1
        elif ev["kind"] == "round":
            t = int(ev["round"])
            if expected is None:
                # A headerless stream: its first round event anchors it.
                expected = t
                segments += 1
            if t != expected:
                _fail(f"round sequence broken: expected round {expected}",
                      ev)
            expected = t + 1
            rounds += 1
    return {"events": total, "rounds": rounds, "segments": segments,
            "kinds": kinds}


def canonical(events: Iterable[dict],
              kinds: tuple[str, ...] = DETERMINISTIC_KINDS,
              drop: tuple[str, ...] = ("ts",)) -> list[dict[str, Any]]:
    """The comparison form of a stream: the deterministic kinds with the
    wall-clock fields dropped."""
    return [{k: v for k, v in ev.items() if k not in drop}
            for ev in events if ev.get("kind") in kinds]
