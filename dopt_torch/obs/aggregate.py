"""Fleet-scope telemetry aggregation: ``python -m dopt_torch.obs.aggregate``.

A ``python -m dopt_torch.serve --num-processes N`` fleet emits one metrics JSONL
stream per process (the leader's ``metrics.jsonl`` plus
``metrics-p<i>.jsonl`` per follower).  Followers replay the leader's
boundary directives verbatim, so the DETERMINISTIC_KINDS of every
stream — ``round``/``fault``/``gauge``/``control`` — must be
bit-identical across processes: divergence means a follower applied a
different command schedule, trained a different round, or fetched
different values than the leader, which is exactly the replay drift
the serve contract forbids.  ``FleetAggregator`` turns that invariant
into a live meter:

* **tails** every process's stream (``JsonlTail`` byte-offset
  watermarks, torn-tail tolerant per process — a writer mid-flush
  never desynchronizes the merge);
* **merges** on the deterministic round watermark: a round is
  *fleet-sealed* once every process has sealed it (emitted its
  ``round`` event), events are keyed by (process, segment, round), and
  the merged stream advances only to the minimum sealed round — it
  never claims a round some process hasn't confirmed;
* **verifies** cross-process consistency of the deterministic kinds at
  every fleet-sealed round — the FIRST divergence is reported with
  both events (leader's and the diverging process's), the round, and
  the canonical index, then the merge stops consuming (everything
  after a divergence is noise);
* **exposes** one merged view: the leader's stream verbatim (already a
  valid checkable stream) with each event stamped ``process``, plus
  every follower's non-deterministic events (``latency``/``resource``/
  ``compile``/``checkpoint``/``alert``/``warning``) with THEIR process
  stamp — so fleet latency histograms aggregate across processes and
  alert provenance survives the merge.

``FleetMetricsServer`` mounts the merged view as the supervisor's one
fleet scrape surface: ``GET /metrics`` (PrometheusSink over the merged
stream — SLO latency histograms included) and ``GET /healthz`` (the
merged ``HealthMonitor`` report plus per-process watermarks/lag and
any divergence; 503 with a ``Retry-After`` header and a JSON body once
critical or diverged).

Stdlib-only (no torch): aggregate a fleet's streams from any laptop.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any

from dopt_torch.obs.events import DETERMINISTIC_KINDS, check_stream
from dopt_torch.obs.monitor import HealthMonitor, JsonlTail
from dopt_torch.obs.sinks import PrometheusSink

# Window (round-event wall clocks) for the per-process rounds/sec
# estimate the fleet watch renders.
_RATE_WINDOW = 32

# Non-deterministic kinds a FOLLOWER contributes to the merged stream
# (its deterministic kinds are byte-identical to the leader's — one
# copy suffices — and its `run` headers would duplicate segment
# structure the leader's stream already carries).
_FOLLOWER_KINDS = ("latency", "resource", "compile", "checkpoint",
                   "alert", "warning")


def fleet_metric_paths(state_dir: str | Path,
                       num_processes: int | None = None,
                       ) -> dict[int, Path]:
    """Per-process metrics stream paths under a serve state dir:
    process 0 writes ``metrics.jsonl``, follower ``i`` writes
    ``metrics-p<i>.jsonl``.  With ``num_processes`` the full expected
    map is returned (files may not exist yet — tails wait for them);
    otherwise followers are discovered by glob."""
    state = Path(state_dir)
    paths = {0: state / "metrics.jsonl"}
    if num_processes is not None:
        for i in range(1, int(num_processes)):
            paths[i] = state / f"metrics-p{i}.jsonl"
        return paths
    for p in sorted(state.glob("metrics-p*.jsonl")):
        stem = p.name[len("metrics-p"):-len(".jsonl")]
        if stem.isdigit():
            paths[int(stem)] = p
    return paths


# How many alert events each process state retains for the provenance
# feed (totals stay exact; a resident supervisor must not grow without
# bound).
_ALERT_RING = 256

# Bytes of already-consumed stream re-read before each poll to detect
# a shrink-then-regrow rewrite (JsonlSink.repair_tail truncates, the
# resumed daemon appends past the old offset before the next poll —
# size alone cannot see it, but the dropped tail's bytes change).
_TAIL_GUARD = 64


class _ProcessState:
    """One tailed process stream: byte-offset tail, the pending events
    of the not-yet-sealed round, the sealed-round queue awaiting
    fleet-wide verification, and the live stats the watch renders."""

    def __init__(self, process: int, path: Path):
        self.process = int(process)
        self.path = Path(path)
        self.tail = JsonlTail(self.path)
        self.pending: list[dict[str, Any]] = []
        # (round, canonical det bundle, full chunk) per sealed round.
        self.sealed: deque[tuple[int, list, list]] = deque()
        self.watermark: int | None = None   # last FLEET-sealed round
        self.segments = 0
        self.last_metrics: dict[str, Any] = {}
        self.last_event_ts: float | None = None
        self.alerts: deque[dict[str, Any]] = deque(maxlen=_ALERT_RING)
        self.alerts_total = 0
        self.guard = b""   # last consumed bytes (rewrite detector)
        # After a resync replay, events at or before this ts were
        # already counted once — display counters skip them.
        self.replay_cut: float | None = None
        self._round_ts: deque[float] = deque(maxlen=_RATE_WINDOW)

    def counted(self, ts) -> bool:
        return (self.replay_cut is not None
                and isinstance(ts, (int, float))
                and float(ts) <= self.replay_cut)

    def rounds_per_sec(self) -> float | None:
        ts = self._round_ts
        if len(ts) < 2 or ts[-1] <= ts[0]:
            return None
        return (len(ts) - 1) / (ts[-1] - ts[0])

    def lag_seconds(self, now: float) -> float | None:
        if self.last_event_ts is None:
            return None
        return max(0.0, float(now) - self.last_event_ts)

    def snapshot(self, now: float) -> dict[str, Any]:
        from dopt_torch.obs.rules import loss_of

        return {"path": str(self.path),
                "round": self.watermark,
                "sealed_ahead": len(self.sealed),
                "segments": self.segments,
                "rounds_per_sec": self.rounds_per_sec(),
                "lag_seconds": self.lag_seconds(now),
                "loss": loss_of(self.last_metrics)[1],
                "alerts": self.alerts_total}


def _canon(ev: dict[str, Any]) -> dict[str, Any]:
    return {k: v for k, v in ev.items() if k != "ts"}


class FleetDivergenceError(AssertionError):
    """Raised (strict mode) when two processes' deterministic streams
    disagree; carries the structured ``record``."""

    def __init__(self, record: dict[str, Any]):
        self.record = record
        super().__init__(format_fleet_divergence(record))


def format_fleet_divergence(d: dict[str, Any]) -> str:
    return "\n".join([
        f"fleet streams diverge at round {d['round']} "
        f"(process {d['process']} vs leader, canonical event "
        f"{d['index']}): {d['reason']}",
        f"  leader:  {json.dumps(d['leader'], sort_keys=True)}",
        f"  p{d['process']}:      "
        f"{json.dumps(d['other'], sort_keys=True)}",
    ])


class FleetAggregator:
    """Merge + verify a serve fleet's per-process telemetry streams.

    ``poll()`` consumes whatever every tail has appended, fleet-seals
    rounds confirmed by all processes, verifies deterministic-kind
    consistency at each, and extends ``merged``.  ``divergence`` holds
    the first inconsistency (then the merge stops consuming; strict
    mode raises instead).  ``flush_trailing()`` settles the events
    after the last round (the drain boundary's control rows, the
    end-of-run summary gauge) once the run is over.
    """

    def __init__(self, state_dir: str | Path | None = None, *,
                 num_processes: int | None = None,
                 paths: dict[int, str | Path] | None = None,
                 strict: bool = False):
        if paths is None:
            if state_dir is None:
                raise ValueError(
                    "FleetAggregator needs a state_dir or explicit "
                    "paths")
            paths = fleet_metric_paths(state_dir, num_processes)
        self.strict = bool(strict)
        self._procs: dict[int, _ProcessState] = {
            int(p): _ProcessState(int(p), Path(path))
            for p, path in sorted(paths.items())}
        if 0 not in self._procs:
            raise ValueError("the fleet needs a process-0 (leader) "
                             f"stream, got processes {sorted(paths)}")
        self.merged: list[dict[str, Any]] = []
        self.merged_total = 0
        self.divergence: dict[str, Any] | None = None
        self.rounds_merged = 0

    @property
    def processes(self) -> list[int]:
        return sorted(self._procs)

    # -- consumption ---------------------------------------------------
    def poll(self) -> int:
        """Consume every tail's new complete lines, fleet-seal what all
        processes confirm; returns the number of newly merged events."""
        if self.divergence is not None:
            # Everything after a divergence is noise; stop reading so a
            # resident endpoint's buffers stop growing too.
            return 0
        before = len(self.merged)
        for st in self._procs.values():
            self._poll_proc(st)
        self._drain_sealed()
        return len(self.merged) - before

    def _poll_proc(self, st: _ProcessState) -> None:
        try:
            size = st.path.stat().st_size
        except OSError:
            size = 0
        if size < st.tail.offset or not self._guard_ok(st):
            # The file SHRANK — or shrank and REGREW past our offset
            # between polls (the guard bytes changed): JsonlSink.
            # repair_tail dropped the torn tail / unsealed-bundle
            # orphans before a resume appended.  Our pending buffer
            # holds exactly those dropped orphans (and on a regrow the
            # byte offset may now point mid-line): resync from byte 0,
            # skipping the rounds already fleet-sealed.
            self._resync(st)
        for ev in st.tail.poll():
            self._ingest(st, ev)
        self._update_guard(st)

    def _guard_ok(self, st: _ProcessState) -> bool:
        """True while the bytes just before our offset still match what
        we consumed — a truncate-then-append rewrite changes them even
        when the file size already grew past the old offset."""
        if not st.guard or st.tail.offset == 0:
            return True
        try:
            with open(st.path, "rb") as f:
                f.seek(st.tail.offset - len(st.guard))
                return f.read(len(st.guard)) == st.guard
        except OSError:
            return True   # absent/racing file: the poll handles it

    def _update_guard(self, st: _ProcessState) -> None:
        off = st.tail.offset
        if off == 0:
            st.guard = b""
            return
        try:
            with open(st.path, "rb") as f:
                f.seek(max(0, off - _TAIL_GUARD))
                st.guard = f.read(min(off, _TAIL_GUARD))
        except OSError:
            pass

    def _resync(self, st: _ProcessState) -> None:
        """Re-read ``st``'s stream from byte 0 after a rewrite.  Rounds
        at or below the fleet watermark were already verified and
        merged — ``_ingest`` drops their re-read chunks — and locally
        sealed-but-unmerged rounds re-seal from the fresh bytes."""
        st.tail = JsonlTail(st.path)
        st.pending = []
        st.sealed.clear()
        st.guard = b""
        st.replay_cut = st.last_event_ts

    def _ingest(self, st: _ProcessState, ev: dict[str, Any]) -> None:
        kind = ev.get("kind")
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            st.last_event_ts = (float(ts) if st.last_event_ts is None
                                else max(st.last_event_ts, float(ts)))
        st.pending.append(ev)
        if kind == "round":
            t = int(ev.get("round", -1))
            if st.watermark is not None and t <= st.watermark:
                # A resync replayed a round the fleet already sealed
                # and merged: drop the chunk (it was verified when it
                # first sealed).
                st.pending = []
                return
            st.last_metrics = dict(ev.get("metrics", {}))
            if isinstance(ts, (int, float)):
                st._round_ts.append(float(ts))
            det = [_canon(e) for e in st.pending
                   if e.get("kind") in DETERMINISTIC_KINDS]
            st.sealed.append((t, det, st.pending))
            st.pending = []
        elif kind == "run":
            if not st.counted(ts):
                st.segments += 1
        elif kind == "alert":
            if not st.counted(ts):
                st.alerts.append({**ev, "process": st.process})
                st.alerts_total += 1

    def _drain_sealed(self) -> None:
        while self.divergence is None:
            heads = []
            for p in self.processes:
                st = self._procs[p]
                if not st.sealed:
                    return   # a process hasn't confirmed the round yet
                heads.append((p, st.sealed[0]))
            r0, det0, chunk0 = heads[0][1]
            for p, (r, det, chunk) in heads[1:]:
                rec = self._compare(p, r0, det0, r, det)
                if rec is not None:
                    self._diverge(rec)
                    return
            # Verified: leader's chunk verbatim (stamped), followers'
            # non-deterministic events with their own provenance.
            self._append_merged({**ev, "process": 0} for ev in chunk0)
            for p, (r, det, chunk) in heads[1:]:
                self._append_merged(
                    {**ev, "process": p} for ev in chunk
                    if ev.get("kind") in _FOLLOWER_KINDS)
            for p in self.processes:
                st = self._procs[p]
                st.sealed.popleft()
                st.watermark = r0
            self.rounds_merged += 1

    def _compare(self, process: int, r0: int, det0: list,
                 r: int, det: list) -> dict[str, Any] | None:
        if r != r0:
            return {"round": r0, "process": process, "index": 0,
                    "leader": {"kind": "round", "round": r0},
                    "other": {"kind": "round", "round": r},
                    "reason": f"round sequence mismatch: leader sealed "
                              f"round {r0}, process {process} sealed "
                              f"round {r}"}
        for i in range(min(len(det0), len(det))):
            if det0[i] != det[i]:
                return {"round": r0, "process": process, "index": i,
                        "leader": det0[i], "other": det[i],
                        "reason": "deterministic payload mismatch"}
        if len(det0) != len(det):
            i = min(len(det0), len(det))
            longer = det0 if len(det0) > len(det) else det
            return {"round": r0, "process": process, "index": i,
                    "leader": det0[i] if i < len(det0) else None,
                    "other": det[i] if i < len(det) else None,
                    "reason": f"bundle length mismatch at round {r0}: "
                              f"leader {len(det0)} deterministic events,"
                              f" process {process} {len(det)} "
                              f"(next unmatched: {longer[i].get('kind')})"}
        return None

    def _diverge(self, record: dict[str, Any]) -> None:
        self.divergence = record
        if self.strict:
            raise FleetDivergenceError(record)

    def flush_trailing(self) -> None:
        """End-of-run settlement: the events after the last ``round``
        (the drain boundary's control events, the end-of-run summary
        gauge, the final checkpoint marker) never fleet-seal through a
        round event — verify their deterministic subset across
        processes and append them to the merge.  Call once the run is
        over (CLI ``--once`` mode); a live endpoint never flushes."""
        if self.divergence is not None:
            return
        st0 = self._procs[0]
        det0 = [_canon(e) for e in st0.pending
                if e.get("kind") in DETERMINISTIC_KINDS]
        for p in self.processes[1:]:
            st = self._procs[p]
            det = [_canon(e) for e in st.pending
                   if e.get("kind") in DETERMINISTIC_KINDS]
            tail_round = st0.watermark if st0.watermark is not None else -1
            rec = self._compare(p, tail_round, det0, tail_round, det)
            if rec is not None:
                rec["reason"] = "trailing (post-last-round) " \
                    + rec["reason"]
                self._diverge(rec)
                return
        self._append_merged({**ev, "process": 0} for ev in st0.pending)
        st0.pending = []
        for p in self.processes[1:]:
            st = self._procs[p]
            self._append_merged({**ev, "process": p} for ev in st.pending
                                if ev.get("kind") in _FOLLOWER_KINDS)
            st.pending = []

    def _append_merged(self, events) -> None:
        for ev in events:
            self.merged.append(ev)
            self.merged_total += 1

    def drain_merged(self) -> list[dict[str, Any]]:
        """Hand over (and forget) the merged events accumulated since
        the last drain — the streaming-consumer mode: a resident fleet
        endpoint feeds its sinks from the drain so supervisor memory
        stays flat over days, while batch callers (the CLI) read
        ``merged`` whole.  ``merged_total`` keeps the lifetime count."""
        out, self.merged = self.merged, []
        return out

    # -- results -------------------------------------------------------
    def alerts(self) -> list[dict[str, Any]]:
        """Every process's stream-embedded alerts, process-stamped,
        in (process, observation) order."""
        out: list[dict[str, Any]] = []
        for p in self.processes:
            out.extend(self._procs[p].alerts)
        return out

    def stats(self, now: float | None = None) -> dict[str, Any]:
        if now is None:
            now = time.time()  # dopt: allow-wallclock -- lag meter vs event ts stamps, reporting only
        return {
            "processes": {p: self._procs[p].snapshot(now)
                          for p in self.processes},
            "fleet_round": min(
                (st.watermark for st in self._procs.values()
                 if st.watermark is not None), default=None),
            "rounds_merged": self.rounds_merged,
            "merged_events": self.merged_total,
            "divergence": self.divergence,
        }

    def write_merged(self, path: str | Path) -> Path:
        """Write the merged stream as JSONL — the artifact
        ``python -m dopt_torch.obs.check`` validates in the soak."""
        from dopt_torch.utils.metrics import atomic_write_text

        return atomic_write_text(Path(path), "".join(
            json.dumps(ev, separators=(",", ":"), sort_keys=True) + "\n"
            for ev in self.merged))


class FleetMetricsServer:
    """The supervisor's one fleet scrape surface over a serve state
    dir: ``/metrics`` (PrometheusSink over the merged stream — the
    fleet's SLO latency histograms aggregate across processes) and
    ``/healthz`` (merged HealthMonitor report + per-process
    watermark/lag + divergence; 503 with ``Retry-After`` and a JSON
    body once critical or diverged)."""

    def __init__(self, state_dir: str | Path, *,
                 num_processes: int | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 rules=None, workers: int | None = None):
        self.state_dir = Path(state_dir)
        self.agg = FleetAggregator(self.state_dir,
                                   num_processes=num_processes)
        self.monitor = HealthMonitor(rules, workers=workers)
        self.prom = PrometheusSink()
        self._error: str | None = None
        # RLock held for whole request bodies (refresh AND render):
        # ThreadingHTTPServer serves scrapes concurrently, and a
        # render iterating the sink's dicts while another request's
        # refresh mutates them would tear the exposition.
        self._lock = threading.RLock()
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def refresh(self) -> None:
        with self._lock:
            try:
                self.agg.poll()
                self._error = None
            except ValueError as e:
                # Mid-file garbage in one stream: surface it through
                # /healthz instead of crashing the request handler.
                self._error = str(e)
            # Drain, don't slice: the supervisor is resident for days
            # and must not retain the whole run's event history.
            for ev in self.agg.drain_merged():
                self.prom.emit(ev)
                # The fleet monitor re-derives alerts from the merged
                # stream for ITS verdict only — the stream's embedded
                # alert events (the leader monitor's, just emitted
                # above) are the fleet's alert COUNT; counting the
                # re-derivation too would double dopt_alerts_total.
                self.monitor.observe(ev)

    def render_metrics(self) -> str:
        with self._lock:
            return self._render_metrics_locked()

    def _render_metrics_locked(self) -> str:
        self.refresh()
        stats = self.agg.stats()
        lines = [self.prom.render().rstrip("\n")]
        lines.append("# HELP dopt_fleet_processes processes whose "
                     "streams the aggregator tails")
        lines.append("# TYPE dopt_fleet_processes gauge")
        lines.append(f"dopt_fleet_processes {len(self.agg.processes)}")
        lines.append("# HELP dopt_fleet_round last fleet-sealed round "
                     "per process stream")
        lines.append("# TYPE dopt_fleet_round gauge")
        lines.append("# HELP dopt_fleet_lag_seconds wall seconds since "
                     "each process stream's newest event")
        lines.append("# TYPE dopt_fleet_lag_seconds gauge")
        for p, snap in sorted(stats["processes"].items()):
            if snap["round"] is not None:
                lines.append(f'dopt_fleet_round{{process="{p}"}} '
                             f'{snap["round"]}')
            if snap["lag_seconds"] is not None:
                lines.append(f'dopt_fleet_lag_seconds{{process="{p}"}} '
                             f'{snap["lag_seconds"]:.3f}')
        lines.append("# HELP dopt_fleet_divergent 1 once any process's "
                     "deterministic stream diverged from the leader's")
        lines.append("# TYPE dopt_fleet_divergent gauge")
        lines.append("dopt_fleet_divergent "
                     f"{1 if self.agg.divergence else 0}")
        return "\n".join(lines) + "\n"

    def render_health(self) -> tuple[int, str]:
        with self._lock:
            return self._render_health_locked()

    def _render_health_locked(self) -> tuple[int, str]:
        self.refresh()
        report = self.monitor.report()
        body = report.to_dict()
        body["fleet"] = self.agg.stats()
        body["lag_seconds"] = self.monitor.lag_seconds()
        body["state_dir"] = str(self.state_dir)
        body["alerts_by_process"] = [
            {"process": a.get("process"), "rule": a.get("rule"),
             "severity": a.get("severity"), "round": a.get("round")}
            for a in self.agg.alerts()]
        body["error"] = self._error
        ok = (report.ok and self.agg.divergence is None
              and self._error is None)
        return (200 if ok else 503), json.dumps(body, indent=2)

    def _handler(self) -> type[BaseHTTPRequestHandler]:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    body = server.render_metrics().encode()
                    self._reply(200, body,
                                "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    code, text = server.render_health()
                    self._reply(code, text.encode(), "application/json")
                elif path == "/":
                    self._reply(200,
                                b"dopt fleet metrics: /metrics /healthz\n",
                                "text/plain")
                else:
                    self._reply(404, b'{"error": "not found"}\n',
                                "application/json")

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                from dopt_torch.obs.serve import http_reply

                http_reply(self, code, body, ctype)

            def log_message(self, fmt: str, *args: Any) -> None:
                pass   # scrapes would flood the supervisor's stderr

        return Handler

    def start(self) -> "FleetMetricsServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--state-dir", required=True,
                    help="serve state dir holding metrics.jsonl (+ "
                         "metrics-p<i>.jsonl per follower)")
    ap.add_argument("--processes", type=int, default=None, metavar="N",
                    help="expected fleet size (default: discover "
                         "follower streams by glob)")
    ap.add_argument("--merged-out", default=None, metavar="PATH",
                    help="write the merged, process-stamped stream "
                         "here (the artifact dopt_torch.obs.check validates)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)

    agg = FleetAggregator(args.state_dir, num_processes=args.processes)
    try:
        agg.poll()
        agg.flush_trailing()
    except ValueError as e:   # mid-file garbage from a corrupt stream
        print(f"FAIL {e}", file=sys.stderr)
        return 1
    summary = None
    error = None
    if agg.divergence is None:
        try:
            summary = check_stream(
                [{k: v for k, v in ev.items() if k != "process"}
                 for ev in agg.merged])
        except ValueError as e:
            error = str(e)
    if args.merged_out:
        agg.write_merged(args.merged_out)
    stats = agg.stats()
    if args.json:
        json.dump({"tool": "dopt_torch.obs.aggregate",
                   "state_dir": args.state_dir,
                   "ok": agg.divergence is None and error is None,
                   "divergence": agg.divergence, "error": error,
                   "stats": stats, "merged_check": summary},
                  sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    elif agg.divergence is not None:
        print(format_fleet_divergence(agg.divergence), file=sys.stderr)
    elif error is not None:
        print(f"FAIL merged stream: {error}", file=sys.stderr)
    else:
        procs = " ".join(
            f"p{p}@{snap['round']}"
            for p, snap in sorted(stats["processes"].items()))
        print(f"fleet consistent: {stats['rounds_merged']} rounds "
              f"verified across {len(agg.processes)} processes "
              f"({procs}), {len(agg.merged)} merged events")
    return 0 if (agg.divergence is None and error is None) else 1


if __name__ == "__main__":
    raise SystemExit(main())
