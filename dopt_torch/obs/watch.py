"""Live terminal tail over a growing metrics file.

``python -m dopt_torch.obs.watch``: the port's copy of
``dopt.obs.watch``, with its flags, exit codes and screen.

The at-a-glance view of a run *while it trains*: rounds/sec (from the
round events' wall clocks), the loss curve's latest point, fleet gauges
(quarantine load, consensus distance), fault counts, the latest phase
fractions, and every health alert the attached ``HealthMonitor`` fires
— all from incremental polls of the JSONL stream (byte-offset tail, so
a million-round file costs nothing to keep watching).

It reads no device: run it anywhere against a file copied or streamed
off the training host::

    python -m dopt_torch.obs.watch metrics.jsonl          # live, 2s refresh
    python -m dopt_torch.obs.watch metrics.jsonl --once   # one snapshot
    python -m dopt_torch.obs.watch --state-dir run/       # FLEET mode

Fleet mode (``--state-dir``) tails every process's stream of a
``python -m dopt_torch.serve --num-processes N`` state dir through the
``FleetAggregator``: one terminal view with per-process rounds/s and
loss columns, the cross-process consistency verdict, the merged alert
feed with process provenance, and the admin endpoint read from the
daemon's ``serve.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import deque
from pathlib import Path
from typing import Any

from dopt_torch.obs.monitor import HealthMonitor, JsonlTail
from dopt_torch.obs.rules import loss_of

# Wall-clock window (round events) for the rounds/sec estimate.
_RATE_WINDOW = 32


class WatchState:
    """Incremental reduction of the event stream into one screenful.

    ``gauge_filter`` (a set of gauge names, or None) narrows the gauge
    line; by DEFAULT every gauge in the stream renders — new producer
    gauges (the ``diagnostics="on"`` convergence block, future
    engines') surface without a code edit here."""

    def __init__(self, monitor: HealthMonitor,
                 gauge_filter: set[str] | None = None):
        self.monitor = monitor
        self.gauge_filter = gauge_filter
        self.tail: JsonlTail | None = None
        self.run: dict[str, Any] | None = None
        self.round: int | None = None
        self.loss_key: str | None = None
        self.loss: float | None = None
        self.metrics: dict[str, Any] = {}
        self.gauges: dict[str, float] = {}
        self.faults: dict[str, int] = {}
        self.phases: dict[str, float] | None = None
        self.resource: dict[str, Any] | None = None
        self.compiles = 0
        self.events = 0
        # Alerts EMBEDDED in the stream (a producer-side monitor wrote
        # them) — kept separate from self.monitor's own firings, which
        # may use different rule parameters.
        self.stream_alerts: list[dict[str, Any]] = []
        self._round_ts: deque[float] = deque(maxlen=_RATE_WINDOW)

    def poll(self, path: str) -> list[dict[str, Any]]:
        """Feed the events appended to ``path`` since the last poll
        (byte-offset tail); returns the alerts they fired."""
        if self.tail is None:
            self.tail = JsonlTail(path)
        return self.feed(self.tail.poll())

    def feed(self, events: list[dict[str, Any]]) -> list[dict[str, Any]]:
        """Consume a poll's events; returns the alerts fired by it."""
        fired: list[dict[str, Any]] = []
        for ev in events:
            self.events += 1
            fired.extend(self.monitor.observe(ev))
            kind = ev.get("kind")
            if kind == "run":
                self.run = ev
            elif kind == "round":
                self.round = ev.get("round")
                self.metrics = ev.get("metrics", {})
                k, v = loss_of(self.metrics)
                if k is not None:
                    self.loss_key, self.loss = k, v
                ts = ev.get("ts")
                if isinstance(ts, (int, float)):
                    self._round_ts.append(float(ts))
            elif kind == "gauge":
                self.gauges[str(ev.get("name"))] = float(ev.get("value", 0))
            elif kind == "fault":
                f = str(ev.get("fault"))
                self.faults[f] = self.faults.get(f, 0) + 1
            elif kind == "phase":
                self.phases = ev.get("fractions")
            elif kind == "resource":
                self.resource = ev
            elif kind == "compile":
                self.compiles += 1
            elif kind == "alert":
                self.stream_alerts.append(ev)
        return fired

    def all_alerts(self) -> list[dict[str, Any]]:
        """Stream-embedded alerts plus this watcher's own firings,
        minus own firings that duplicate an embedded one (same rule at
        the same round — the producer's monitor and the stock local
        rules re-deriving the same condition from the same events)."""
        seen = {(a.get("rule"), a.get("round"), a.get("severity"))
                for a in self.stream_alerts}
        return self.stream_alerts + [
            a for a in self.monitor.alerts
            if (a.get("rule"), a.get("round"), a.get("severity"))
            not in seen]

    def critical(self) -> bool:
        """Any critical alert, embedded in the stream or fired by this
        watcher's own monitor."""
        return any(a.get("severity") == "critical"
                   for a in self.all_alerts())

    def rounds_per_sec(self) -> float | None:
        ts = self._round_ts
        if len(ts) < 2 or ts[-1] <= ts[0]:
            return None
        return (len(ts) - 1) / (ts[-1] - ts[0])

    def render(self) -> str:
        lines = []
        run = self.run or {}
        head = (f"dopt_torch watch — {run.get('name', '?')} "
                f"[{run.get('engine', '?')}"
                + (f", {run['workers']} workers" if run.get("workers")
                   else "") + "]")
        lines.append(head)
        rps = self.rounds_per_sec()
        lines.append(
            f"  round {self.round if self.round is not None else '-'}"
            + (f" @ {rps:.3f} rounds/s" if rps else "")
            + (f" | {self.loss_key}={self.loss:.5g}"
               if self.loss is not None and self.loss_key else
               (f" | {self.loss_key}=non-finite" if self.loss_key else "")))
        # ALL gauges render by default (sorted, %g-formatted) so new
        # producer gauges — the diagnostics="on" convergence block
        # included — surface without a code edit; --gauges narrows.
        shown = self.gauges
        if self.gauge_filter is not None:
            shown = {k: v for k, v in shown.items()
                     if k in self.gauge_filter}
        if shown:
            lines.append("  gauges  " + "  ".join(
                f"{k}={v:g}" for k, v in sorted(shown.items())))
        if self.resource is not None:
            peak = self.resource.get("peak_bytes")
            live = self.resource.get("live_bytes")
            bits = [f"peak={peak / 2**30:.2f}GiB"
                    if isinstance(peak, (int, float)) else None,
                    f"live={live / 2**30:.2f}GiB"
                    if isinstance(live, (int, float)) else None,
                    (f"({self.resource.get('source')})"
                     if self.resource.get("source") else None),
                    f"compiles={self.compiles}" if self.compiles else None]
            lines.append("  memory  " + "  ".join(b for b in bits if b))
        if self.faults:
            lines.append("  faults  " + "  ".join(
                f"{k}={v}" for k, v in sorted(self.faults.items())))
        if self.phases:
            lines.append("  phases  " + "  ".join(
                f"{k}={v:.0%}" for k, v in sorted(self.phases.items())))
        rep = self.monitor.report()
        alerts = self.all_alerts()
        verdict = "CRITICAL" if self.critical() else \
            ("WARN" if alerts else rep.verdict.upper())
        lines.append(f"  health  {verdict} "
                     f"({len(alerts)} alerts, {rep.rounds} rounds, "
                     f"{self.events} events)")
        for a in alerts[-5:]:
            lines.append(f"  ALERT [{a.get('severity')}] "
                         f"{a.get('rule')} @ round {a.get('round')}: "
                         f"{a.get('message')}")
        return "\n".join(lines)


class FleetWatchState:
    """One screenful over a whole serve fleet's streams, built on the
    ``FleetAggregator``: per-process round/rate/loss/lag rows, the
    cross-process consistency verdict, and the merged alert feed with
    process provenance."""

    def __init__(self, state_dir: str, processes: int | None = None):
        self.state_dir = Path(state_dir)
        self._processes = processes
        self.error: str | None = None
        self.status: dict[str, Any] = {}   # serve.json, one read per tick
        self._refresh_status()
        self.agg = self._build()

    def _build(self):
        from dopt_torch.obs.aggregate import FleetAggregator

        return FleetAggregator(self.state_dir,
                               num_processes=self._expected())

    def _refresh_status(self) -> None:
        """ONE status read per tick (serve.json, falling back to the
        supervisor's fleet.json), shared by the expected-fleet-size
        probe and the render header — the state dir may be remote."""
        for name in ("serve.json", "fleet.json"):
            try:
                self.status = json.loads(
                    (self.state_dir / name).read_text())
                return
            except (OSError, ValueError):
                continue
        self.status = {}

    def _expected(self) -> int | None:
        """Expected fleet size: the explicit --processes, else the
        daemon's own status-file claim — so a watch started before
        follower streams exist still waits for them instead of
        silently degrading to a leader-only 'consistency ok'."""
        if self._processes is not None:
            return self._processes
        n = self.status.get("num_processes")
        if isinstance(n, int) and n >= 1:
            return n
        return None   # glob discovery (single-process dirs)

    def poll(self) -> None:
        self._refresh_status()
        expected = self._expected()
        if expected is not None and expected > len(self.agg.processes):
            # Followers appeared (or the daemon finally wrote its
            # status) after we built the aggregator: rebuild over the
            # full fleet — a restarted merge beats a silent
            # leader-only view.
            self.agg = self._build()
        try:
            self.agg.poll()
            self.error = None
        except ValueError as e:
            # Mid-file garbage: render the error, keep watching.
            self.error = str(e)
        # The live watch consumes stats()/alerts(), never the merged
        # event list — drop it, or a days-long watch of a resident
        # fleet retains every event of every process in memory.
        self.agg.drain_merged()

    def critical(self) -> bool:
        return (self.agg.divergence is not None
                or any(a.get("severity") == "critical"
                       for a in self.agg.alerts()))

    def render(self) -> str:
        from dopt_torch.obs.aggregate import format_fleet_divergence

        # The lag column against the events' ts stamps; display only.
        now = time.time()  # dopt: allow-wallclock -- lag column vs event ts stamps, display only
        stats = self.agg.stats(now)
        status = self.status
        head = f"dopt_torch fleet watch — {self.state_dir}"
        bits = []
        if status.get("status"):
            bits.append(status["status"])
        if status.get("admin_port"):
            bits.append(f"admin :{status['admin_port']}")
        if stats["fleet_round"] is not None:
            bits.append(f"fleet round {stats['fleet_round']}")
        if bits:
            head += "  [" + ", ".join(bits) + "]"
        lines = [head]
        if self.error:
            lines.append(f"  STREAM ERROR: {self.error}")
        lines.append("  proc  round     rounds/s  loss          "
                     "lag(s)  segs  alerts")
        for p, snap in sorted(stats["processes"].items()):
            loss = snap["loss"]
            rps = snap["rounds_per_sec"]
            lag = snap["lag_seconds"]
            lines.append(
                f"  p{p:<4} "
                f"{str('-' if snap['round'] is None else snap['round']):<9} "
                f"{f'{rps:.3f}' if rps else '-':<9} "
                f"{f'{loss:.6g}' if isinstance(loss, (int, float)) else '-':<13} "
                f"{f'{lag:.1f}' if lag is not None else '-':<7} "
                f"{snap['segments']:<5} {snap['alerts']}")
        if self.agg.divergence is not None:
            lines.append("  CONSISTENCY: DIVERGED")
            lines.extend("  " + line for line in
                         format_fleet_divergence(self.agg.divergence)
                         .splitlines())
        else:
            lines.append(f"  consistency ok through round "
                         f"{stats['fleet_round'] if stats['fleet_round'] is not None else '-'} "
                         f"({stats['rounds_merged']} rounds verified, "
                         f"{stats['merged_events']} merged events)")
        alerts = self.agg.alerts()
        for a in alerts[-5:]:
            lines.append(f"  ALERT [{a.get('severity')}] "
                         f"p{a.get('process')} {a.get('rule')} @ round "
                         f"{a.get('round')}: {a.get('message')}")
        return "\n".join(lines)


def watch_fleet(args) -> int:
    state = FleetWatchState(args.state_dir, processes=args.processes)
    try:
        while True:
            state.poll()
            if args.once:
                print(state.render())
                # Corrupt streams fail the exit-code contract too:
                # check/aggregate exit 1 on the same dir, so must the
                # scripted one-shot watch.
                return 1 if (state.critical()
                             or state.error is not None) else 0
            if not args.no_clear:
                sys.stdout.write("\x1b[H\x1b[2J")
            print(state.render(), flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        print()
        return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("metrics", nargs="?", default=None,
                    metavar="METRICS_JSONL")
    ap.add_argument("--state-dir", default=None, metavar="DIR",
                    help="FLEET mode: watch every process stream of a "
                         "serve state dir (metrics.jsonl + "
                         "metrics-p<i>.jsonl), one merged view with "
                         "per-process columns and alert provenance")
    ap.add_argument("--processes", type=int, default=None, metavar="N",
                    help="fleet mode: expected fleet size (default: "
                         "discover follower streams by glob)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period, seconds")
    ap.add_argument("--once", action="store_true",
                    help="render one snapshot of the current file and "
                         "exit (CI / scripting mode)")
    ap.add_argument("--no-clear", action="store_true",
                    help="append snapshots instead of redrawing in "
                         "place (for dumb terminals / logs)")
    ap.add_argument("--workers", type=int, default=None,
                    help="fleet-size denominator override for rules")
    ap.add_argument("--gauges", default=None, metavar="NAME[,NAME...]",
                    help="show only these gauges (comma-separated); "
                         "default shows every gauge in the stream")
    args = ap.parse_args(argv)

    if args.state_dir is not None:
        return watch_fleet(args)
    if args.metrics is None:
        ap.error("give a METRICS_JSONL path or --state-dir")

    monitor = HealthMonitor(workers=args.workers)
    gauge_filter = (set(g.strip() for g in args.gauges.split(",")
                        if g.strip())
                    if args.gauges else None)
    state = WatchState(monitor, gauge_filter=gauge_filter)
    try:
        while True:
            fired = state.poll(args.metrics)
            if args.once:
                print(state.render())
                return 1 if state.critical() else 0
            if not args.no_clear:
                # Home + clear-to-end: redraw in place without
                # scrollback spam.
                sys.stdout.write("\x1b[H\x1b[2J")
            print(state.render(), flush=True)
            for a in fired:
                # New alerts also go to stderr so a piped log keeps them.
                print(f"ALERT [{a.get('severity')}] {a.get('rule')} "
                      f"@ round {a.get('round')}: {a.get('message')}",
                      file=sys.stderr)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        print()
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
