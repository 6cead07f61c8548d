"""The telemetry stream checker: ``python -m dopt_torch.obs.check PATH``.

The port's copy of ``dopt.obs.check``: validates every event against
the schema (``dopt_torch.obs.events``) and the continuity rule — within
each ``run`` segment the round sequence is gapless and duplicate-free,
so a killed-and-resumed stream passes only if the resume neither lost
nor repeated a round — and prints one line per file.  ``--summary``
adds an inventory (events per kind, each segment's rounds, the gauges,
the fault kinds); ``--json`` prints one machine-readable report.  Exit
code 0 when every stream is clean, 1 on any violation, 2 on a usage
error.  dopt's ``--state-dir`` (a serve daemon's fleet of streams)
arrives with the port's serve slice.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from dopt_torch.obs.events import check_stream
from dopt_torch.obs.sinks import JsonlSink


def check_file(path: str) -> dict[str, Any]:
    """Validate one JSONL stream; returns ``check_stream``'s summary
    (raises ``ValueError`` on a schema or continuity violation)."""
    events = JsonlSink.read(path)
    if not events:
        raise ValueError(f"{path}: empty telemetry stream")
    return check_stream(events)


def summarize(events: list[dict[str, Any]]) -> dict[str, Any]:
    """Inventory of a validated stream: counts per kind, each segment's
    round span, the gauges (count, last value), the round-metric keys,
    the fault kinds and the alert rules."""
    kinds: dict[str, int] = {}
    segments: list[dict[str, Any]] = []
    gauges: dict[str, dict[str, Any]] = {}
    metric_keys: dict[str, int] = {}
    faults: dict[str, int] = {}
    alerts: dict[str, int] = {}
    for ev in events:
        kind = ev.get("kind")
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "run":
            segments.append({"engine": ev.get("engine"),
                             "name": ev.get("name"),
                             "start": ev.get("round"),
                             "first": None, "last": None, "rounds": 0})
        elif kind == "round":
            if not segments:
                segments.append({"engine": ev.get("engine"),
                                 "name": None, "start": ev.get("round"),
                                 "first": None, "last": None, "rounds": 0})
            seg = segments[-1]
            t = ev.get("round")
            seg["first"] = t if seg["first"] is None else seg["first"]
            seg["last"] = t
            seg["rounds"] += 1
            for k in ev.get("metrics", {}):
                metric_keys[k] = metric_keys.get(k, 0) + 1
        elif kind == "gauge":
            g = gauges.setdefault(str(ev.get("name")),
                                  {"count": 0, "last": None})
            g["count"] += 1
            g["last"] = ev.get("value")
        elif kind == "fault":
            f = str(ev.get("fault"))
            faults[f] = faults.get(f, 0) + 1
        elif kind == "alert":
            r = str(ev.get("rule"))
            alerts[r] = alerts.get(r, 0) + 1
    return {"kinds": kinds, "segments": segments, "gauges": gauges,
            "metric_keys": metric_keys, "faults": faults, "alerts": alerts}


def print_summary(path: str, inv: dict[str, Any]) -> None:
    print(f"{path}:")
    print("  kinds     " + "  ".join(
        f"{k}={v}" for k, v in sorted(inv["kinds"].items())))
    for i, seg in enumerate(inv["segments"]):
        span = ("-" if seg["first"] is None
                else f"{seg['first']}..{seg['last']}")
        print(f"  segment {i}  {seg['engine'] or '?'}"
              f"/{seg['name'] or '?'} start={seg['start']} "
              f"rounds {span} ({seg['rounds']} events)")
    if inv["metric_keys"]:
        print("  metrics   " + "  ".join(
            f"{k}({v})" for k, v in sorted(inv["metric_keys"].items())))
    for name in sorted(inv["gauges"]):
        g = inv["gauges"][name]
        print(f"  gauge     {name}: {g['count']} obs, last={g['last']:g}")
    if inv["faults"]:
        print("  faults    " + "  ".join(
            f"{k}={v}" for k, v in sorted(inv["faults"].items())))
    if inv["alerts"]:
        print("  alerts    " + "  ".join(
            f"{k}={v}" for k, v in sorted(inv["alerts"].items())))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", metavar="METRICS_JSONL")
    ap.add_argument("--summary", action="store_true",
                    help="print a per-file inventory after validating")
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable report on stdout")
    args = ap.parse_args(argv)
    rc = 0
    report: list[dict[str, Any]] = []
    for path in args.paths:
        try:
            events = JsonlSink.read(path)
            if not events:
                raise ValueError(f"{path}: empty telemetry stream")
            s = check_stream(events)
        except (OSError, ValueError) as e:
            if args.json:
                report.append({"path": path, "ok": False, "error": str(e)})
            else:
                print(f"{path}: FAIL {e}", file=sys.stderr)
            rc = 1
            continue
        if args.json:
            entry: dict[str, Any] = {"path": path, "ok": True, **s}
            if args.summary:
                entry["summary"] = summarize(events)
            report.append(entry)
            continue
        kinds = " ".join(f"{k}={v}" for k, v in sorted(s["kinds"].items()))
        print(f"{path}: ok — {s['events']} events, {s['rounds']} rounds, "
              f"{s['segments']} segment(s) [{kinds}]")
        if args.summary:
            print_summary(path, summarize(events))
    if args.json:
        json.dump({"tool": "dopt_torch.obs.check", "checked": len(args.paths),
                   "files": report, "clean": rc == 0},
                  sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
