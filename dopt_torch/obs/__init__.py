"""dopt_torch.obs — the port's telemetry: event stream, sinks, spans,
health monitor and fleet aggregation.

The port's copy of dopt's ``dopt.obs``:

* a JSONL **event stream** with dopt's versioned schema
  (``dopt_torch.obs.events``): per-round ``round`` events, host-mirror
  and diagnostics ``gauge`` events, the fault ledger as typed ``fault``
  events, ``checkpoint`` events, the serve daemon's ``control`` and
  ``latency`` events, and under ``diagnostics="on"`` the ``resource``
  (CUDA caching-allocator memory) and ``compile`` (round graph
  captures) channel;
* host **span tracing** (``dopt_torch.obs.spans``) with a Chrome-trace
  export, hooked into the engines' ``PhaseTimers`` sites;
* the **sinks** (``dopt_torch.obs.sinks``): JSONL file, in-memory ring,
  Prometheus text;
* the streaming **health monitor** (``dopt_torch.obs.monitor`` over the
  rules of ``dopt_torch.obs.rules`` and the SLO latency histograms of
  ``dopt_torch.obs.latency``): ``alert`` events and an end-of-run
  ``HealthReport`` verdict, served by ``python -m dopt_torch.obs.serve``
  (/metrics and /healthz over a metrics file);
* **fleet aggregation** (``dopt_torch.obs.aggregate``): a serve fleet's
  per-process streams merged and checked for cross-process equality,
  ``python -m dopt_torch.obs.aggregate --state-dir D``;
* the stream **checker**, ``python -m dopt_torch.obs.check PATH`` (or
  ``--state-dir D`` for every stream of a served run);
* the stream **differ** (``dopt_torch.obs.diff``: ``first_divergence``,
  ``python -m dopt_torch.obs.diff A B``), which names the first canonical
  event where two streams part;
* the live terminal **watch** over a stream or a fleet's state dir,
  ``python -m dopt_torch.obs.watch PATH`` (``--state-dir D``);
* the bench **regression ledger** (``dopt_torch.obs.regress`` over
  ``results/bench_history.jsonl``), keyed on metric and device kind.

The contracts are dopt's.  Off path: ``trainer.telemetry`` is None by
default and every emission site is host code gated on it after the
round's fetch, so a run without telemetry runs what it ran before.
Execution-path equality: the deterministic kinds derive only from the
fetched metrics and the host replay, at the same point of the
per-round and the blocked loops, so their streams are equal
(``canonical()``).  Resume watermark: ``Telemetry.to_jsonl(path,
resume=True)`` continues a killed run's file without a gap or a
duplicate round.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

from dopt_torch.obs.events import (DETERMINISTIC_KINDS, KINDS,
                                   SCHEMA_VERSION, canonical, check_stream,
                                   make_event, sanitize_metrics,
                                   validate_event)
from dopt_torch.obs.latency import (SLO_LATENCIES, LatencyHistogram,
                                    summarize_latency_events)
from dopt_torch.obs.monitor import HealthMonitor, HealthReport, JsonlTail
from dopt_torch.obs.rules import RULES, build_rules, default_rules
from dopt_torch.obs.sinks import JsonlSink, MemorySink, PrometheusSink, Sink
from dopt_torch.obs.spans import SpanTracer

__all__ = [
    "DETERMINISTIC_KINDS", "KINDS", "RULES", "SCHEMA_VERSION",
    "SLO_LATENCIES", "FleetAggregator", "FleetMetricsServer",
    "HealthMonitor", "HealthReport", "JsonlSink", "JsonlTail",
    "LatencyHistogram", "MemorySink", "PrometheusSink", "Sink",
    "SpanTracer", "Telemetry", "attach", "build_rules", "canonical",
    "check_stream", "consensus_distance", "default_rules",
    "first_divergence", "make_event", "sanitize_metrics",
    "summarize_latency_events", "validate_event",
]


def __getattr__(name: str):
    # The fleet aggregation layer and the stream differ are imported
    # lazily: they carry their own http.server and argparse surface,
    # which the engines' per-round emission path does not need.
    if name in ("FleetAggregator", "FleetMetricsServer"):
        from dopt_torch.obs import aggregate

        return getattr(aggregate, name)
    if name == "first_divergence":
        from dopt_torch.obs.diff import first_divergence

        return first_divergence
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Telemetry:
    """Emitter: builds schema-stamped events, fans them out to the sinks,
    owns the span tracer and the monotonic round watermark."""

    def __init__(self, sinks: Iterable[Sink] = (), *, watermark: int = 0):
        self.sinks: list[Sink] = list(sinks)
        self.tracer = SpanTracer()
        self.watermark = int(watermark)

    @classmethod
    def to_jsonl(cls, path, *, resume: bool = False,
                 ring: int = 0) -> "Telemetry":
        """JSONL-file telemetry.  ``resume=True`` appends and recovers
        the round watermark from the file, so a resumed run continues the
        stream; ``ring`` > 0 also keeps the last N events in memory
        (``.sinks[-1].events``)."""
        wm = 0
        if resume:
            prev = JsonlSink.scan_watermark(path)
            wm = 0 if prev is None else prev + 1
        sinks: list[Sink] = [JsonlSink(path, append=resume)]
        if ring:
            sinks.append(MemorySink(capacity=ring))
        return cls(sinks, watermark=wm)

    def emit(self, kind: str, **fields: Any) -> dict[str, Any]:
        ev = make_event(kind, **fields)
        for s in self.sinks:
            s.emit(ev)
        return ev

    def emit_round_bundle(self, t: int, *, engine: str,
                          metrics: Mapping[str, Any],
                          faults: Iterable[Mapping[str, Any]] = (),
                          gauges: Mapping[str, float] | None = None) -> bool:
        """One round's deterministic events in the canonical order: the
        fault-ledger rows, the gauges, then the ``round`` event LAST (the
        bundle's commit record: ``repair_tail`` drops a torn bundle's
        orphans and the resumed run emits it whole).  Suppressed below
        the resume watermark (returns False); advances it past ``t``."""
        t = int(t)
        if t < self.watermark:
            return False
        bundle = [make_event("fault", round=int(r["round"]),
                             worker=int(r["worker"]), fault=str(r["kind"]),
                             action=str(r["action"])) for r in faults]
        bundle.extend(make_event("gauge", round=t, name=name,
                                 value=float(value), engine=engine)
                      for name, value in (gauges or {}).items())
        bundle.append(make_event("round", round=t, engine=engine,
                                 metrics=sanitize_metrics(metrics)))
        for s in self.sinks:
            s.emit_many(bundle)
        self.watermark = t + 1
        return True

    def write_trace(self, path):
        return self.tracer.write_chrome(path)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def attach(trainer, telemetry: Telemetry, *, fresh: bool = False,
           checkpoint_every: int | None = None) -> Telemetry:
    """Wire a Telemetry into a trainer: sets ``trainer.telemetry`` (read
    by the engines' gated emission sites), hooks the span tracer into
    ``trainer.timers`` (each ``phase`` site becomes a span) and emits
    the segment header.  ``fresh=True`` resets the watermark to 0 (a new
    logical run on a shared sink); a resumed trainer streaming into a
    fresh file starts its segment at ``trainer.round``.
    ``checkpoint_every`` stamps the run's checkpoint cadence on the
    header."""
    if fresh:
        telemetry.watermark = 0
    trainer.telemetry = telemetry
    trainer.timers.tracer = telemetry.tracer
    engine = getattr(trainer, "engine_kind", type(trainer).__name__.lower())
    start = max(telemetry.watermark, int(getattr(trainer, "round", 0) or 0))
    telemetry.watermark = start
    telemetry.emit("run", engine=engine,
                   name=getattr(getattr(trainer, "cfg", None), "name", None)
                   or "run",
                   round=start,
                   workers=getattr(trainer, "num_workers", None),
                   checkpoint_every=(int(checkpoint_every)
                                     if checkpoint_every else None))
    return telemetry


def consensus_distance(stacked: Mapping[str, Any],
                       center: Mapping[str, Any] | None = None) -> float:
    """Mean over workers of ||x_i - c||_2 for a dict of ``[W, ...]``
    tensors: ``center`` (no worker axis; the federated engine passes
    theta) or the workers' mean.  One device reduction and one scalar
    fetch, f32-accumulated."""
    import torch

    sq = None
    with torch.no_grad():
        for k in sorted(stacked):
            p = stacked[k].float()
            c = (p.mean(0) if center is None else center[k].float())
            d = (p - c[None]).reshape(p.shape[0], -1)
            s = (d * d).sum(1)
            sq = s if sq is None else sq + s
        return float(torch.sqrt(sq).mean())
