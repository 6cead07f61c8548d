"""Perf-regression ledger over the bench trajectory.

The port's copy of ``dopt.obs.regress``: the same ledger format, the
same dedupe, the same judgement and report texts, and the same CLI
flags and exit codes, so one ledger file serves both packages.

``results/bench_history.jsonl`` is an append-only ledger: every
bench headline JSON line lands as one entry stamped with the git sha
and a run id (``append_entry`` — deduped on ``(run_id, metric)``, so a
re-run replaces its prior entry instead of stacking duplicates that
skew the trailing trimmed median, while one run's several metric lines
— headline + seqlm — coexist).

``check_regression`` compares a candidate entry against the trailing
window of earlier entries with the same ``(metric, device_kind)`` key,
one tracked throughput/efficiency key at a time.  A port entry carries
the card's name (``torch.cuda.get_device_name()``, e.g. "NVIDIA H100
80GB HBM3") as its ``device_kind``, so it is never judged against
another device's rows:

* baseline = min/max-trimmed median of the trailing window
  (``dopt_torch.utils.metrics.trimmed_stats``);
* noise band = max(``min_band_pct``, half the trimmed spread): a
  trajectory that historically wobbles ±13% does not alarm at −8%, a
  flat one alarms past the 5% floor;
* only ADVERSE deltas flag (throughput down, ``host_gap_pct`` up) —
  an improvement is never a regression.

CLI (reads no device):

    python -m dopt_torch.obs.regress results/bench_history.jsonl
    python -m dopt_torch.obs.regress results/bench_history.jsonl \
        --candidate bench-quick.json --advisory

Exit 1 when any tracked metric regresses (``--advisory`` reports but
always exits 0 — the CI annotation mode), 2 when the ledger or the
candidate cannot be read.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any

from dopt_torch.utils.metrics import trimmed_stats

LEDGER_VERSION = 1

# Headline keys the regressor watches, with the adverse direction:
# "higher" means higher is better (a drop regresses), "lower" the
# opposite (host_gap_pct growing back means the overlap eroded).
TRACKED_METRICS: dict[str, str] = {
    "value": "higher",
    "device_rounds_per_sec": "higher",
    "samples_per_sec": "higher",
    "model_tflops_per_sec": "higher",
    "mfu_vs_bf16_peak": "higher",
    "faithful_f32_rounds_per_sec": "higher",
    "gossip_rounds_per_sec_chaos": "higher",
    "chaos_speedup_vs_per_round": "higher",
    "clients_per_sec_1k": "higher",
    "clients_per_sec_10k": "higher",
    "host_gap_pct": "lower",
    "fused_rounds_per_sec": "higher",
    "fused_speedup": "higher",
    "seqlm_tokens_per_sec": "higher",
    # The comm-substrate headline: the round's wire bytes (less is
    # better — the codec's whole point) and the compressed leg's
    # throughput.  NO_BASELINE on first appearance.
    "bytes_on_wire": "lower",
    "compressed_rounds_per_sec": "higher",
}


def git_sha(cwd: str | Path | None = None) -> str | None:
    """Current commit sha, or None outside a repo / without git."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def make_entry(headline: dict[str, Any], *, run_id: str | None = None,
               sha: str | None = None,
               ts: float | None = None) -> dict[str, Any]:
    """Wrap one bench headline dict into a ledger entry."""
    if not isinstance(headline, dict) or "metric" not in headline:
        raise ValueError(f"not a bench headline line: {headline!r}")
    if ts is None:
        # The entry's timestamp; the regression math never reads it.
        ts = round(time.time(), 3)  # dopt: allow-wallclock -- ledger entry timestamp, never judged by the regression math
    if run_id is None:
        run_id = (sha[:9] if sha else "run") + f"-{int(ts)}"
    return {"v": LEDGER_VERSION, "run_id": run_id, "git_sha": sha,
            "ts": ts, "device_kind": headline.get("device_kind", "unknown"),
            "bench": dict(headline)}


def append_entry(path: str | Path, headline: dict[str, Any], *,
                 run_id: str | None = None, sha: str | None = None,
                 ts: float | None = None) -> dict[str, Any]:
    """Append one headline to the ledger (sha auto-detected when not
    given); returns the entry written.

    DEDUPED on ``(run_id, metric)``: a re-run at the same run id
    REPLACES its prior entry for that metric (the ledger is atomically
    rewritten without the duplicates) instead of stacking copies — N
    retries of one run would otherwise occupy N slots of the trailing
    window and drag the trimmed median toward that single run's value.
    One run's SEVERAL metric lines (the gossip headline plus the seqlm
    leg) land as separate entries under the shared run id.  Fresh
    slots take the plain-append fast path.

    The pre-append scan parses TOLERANTLY (unlike ``read_ledger``'s
    strict contract): the plain-append path is not atomic, so a crash
    mid-write can leave a torn final line — a strict read here would
    make every future append raise until the ledger is hand-repaired.
    Any torn line triggers the atomic-rewrite (repair) path, which
    drops it: the ledger stays ``read_ledger``-clean, so the
    regressor CLI keeps working after a crash."""
    if sha is None:
        sha = git_sha(Path(path).resolve().parent)
    entry = make_entry(headline, run_id=run_id, sha=sha, ts=ts)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        torn = False
        existing = []
        for line in path.read_text().splitlines():
            try:
                e = json.loads(line)
            except ValueError:
                torn = True
                continue
            if isinstance(e, dict):
                existing.append(e)
            else:
                torn = True

        def _same_slot(e):
            # Dedup key is (run_id, metric): one run legitimately
            # appends several metric lines (headline + seqlm), and
            # only a re-run of the SAME metric replaces its entry.
            return (e.get("run_id") == entry["run_id"]
                    and (e.get("bench") or {}).get("metric")
                    == entry["bench"]["metric"])

        if torn or any(_same_slot(e) for e in existing):
            from dopt_torch.utils.metrics import atomic_write_text

            kept = [e for e in existing if not _same_slot(e)]
            kept.append(entry)
            atomic_write_text(path, "".join(
                json.dumps(e, separators=(",", ":")) + "\n"
                for e in kept))
            return entry
    with open(path, "a") as f:
        f.write(json.dumps(entry, separators=(",", ":")) + "\n")
    return entry


def read_ledger(path: str | Path) -> list[dict[str, Any]]:
    """Load the ledger; every line must parse (this file is written a
    whole line at a time — garbage means hand-editing went wrong)."""
    entries = []
    for i, line in enumerate(Path(path).read_text().splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            e = json.loads(line)
        except ValueError:
            raise ValueError(f"{path}: line {i + 1} is not JSON: "
                             f"{line[:80]!r}")
        if not isinstance(e, dict) or "bench" not in e:
            raise ValueError(f"{path}: line {i + 1} is not a ledger "
                             f"entry: {line[:80]!r}")
        entries.append(e)
    return entries


def _key(entry: dict[str, Any]) -> tuple[str, str]:
    return (str(entry["bench"].get("metric", "?")),
            str(entry.get("device_kind", "unknown")))


def check_regression(entries: list[dict[str, Any]],
                     candidate: dict[str, Any] | None = None, *,
                     window: int = 8, min_history: int = 3,
                     min_band_pct: float = 5.0) -> dict[str, Any]:
    """Judge ``candidate`` (default: the ledger's newest entry) against
    the trailing ``window`` earlier entries sharing its
    ``(metric, device_kind)`` key.  Returns::

        {"status": "ok"|"regression"|"no_baseline",
         "key": [metric, device_kind], "run_id": ...,
         "checks": [{"metric", "candidate", "baseline_median",
                     "delta_pct", "band_pct", "n_baseline",
                     "direction", "regressed"}, ...]}
    """
    if candidate is None:
        if not entries:
            raise ValueError("empty ledger and no candidate")
        entries, candidate = entries[:-1], entries[-1]
    key = _key(candidate)
    baseline = [e for e in entries if _key(e) == key][-window:]
    result: dict[str, Any] = {
        "status": "ok", "key": list(key),
        "run_id": candidate.get("run_id"), "checks": [],
    }
    if len(baseline) < min_history:
        result["status"] = "no_baseline"
        result["n_baseline"] = len(baseline)
        return result
    cand = candidate["bench"]
    for name, direction in TRACKED_METRICS.items():
        cv = cand.get(name)
        if not isinstance(cv, (int, float)) or isinstance(cv, bool):
            continue
        hist = [e["bench"][name] for e in baseline
                if isinstance(e["bench"].get(name), (int, float))
                and not isinstance(e["bench"].get(name), bool)]
        if len(hist) < min_history:
            # The candidate CARRIES this metric but the trailing window
            # does not (a newly-promoted headline field, e.g. the fused
            # or seqlm legs) — report NO_BASELINE explicitly instead of
            # silently passing, so a first-seen metric starts an honest
            # window the reader can see filling up.
            result["checks"].append({
                "metric": name, "candidate": float(cv),
                "baseline_median": None, "delta_pct": None,
                "band_pct": None, "n_baseline": len(hist),
                "direction": direction, "regressed": False,
                "no_baseline": True,
            })
            continue
        med, spread, _ = trimmed_stats(hist)
        if med == 0:
            continue
        delta = 100.0 * (float(cv) - med) / abs(med)
        band = max(float(min_band_pct), spread / 2.0)
        adverse = -delta if direction == "higher" else delta
        regressed = adverse > band
        result["checks"].append({
            "metric": name, "candidate": float(cv),
            "baseline_median": med, "delta_pct": round(delta, 2),
            "band_pct": round(band, 2), "n_baseline": len(hist),
            "direction": direction, "regressed": regressed,
        })
        if regressed:
            result["status"] = "regression"
    return result


def format_report(result: dict[str, Any]) -> str:
    """Human-readable per-metric delta report."""
    key = result.get("key", ["?", "?"])
    lines = [f"bench regression check: {key[0]} @ {key[1]} "
             f"(run {result.get('run_id')}) -> {result['status'].upper()}"]
    if result["status"] == "no_baseline":
        lines.append(f"  only {result.get('n_baseline', 0)} prior "
                     "entries with this (metric, device_kind) key — "
                     "nothing to judge against yet")
    for c in result.get("checks", []):
        if c.get("no_baseline"):
            lines.append(
                f"  {c['metric']:<28} {c['candidate']:>12.4g} "
                f"NO_BASELINE (n={c['n_baseline']} prior entries carry "
                "this metric — window still filling)")
            continue
        arrow = "REGRESSED" if c["regressed"] else "ok"
        lines.append(
            f"  {c['metric']:<28} {c['candidate']:>12.4g} vs median "
            f"{c['baseline_median']:>12.4g} ({c['delta_pct']:+7.2f}% | "
            f"band ±{c['band_pct']:.1f}%, n={c['n_baseline']}) {arrow}")
    return "\n".join(lines)


def _load_candidate(path: str) -> dict[str, Any]:
    """A candidate file is either a ledger entry line, a bench stdout
    capture (comment lines + JSON lines — the first JSON line is the
    headline), or a bare headline JSON object."""
    text = Path(path).read_text()
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        obj = json.loads(line)
        if "bench" in obj and "run_id" in obj:
            return obj
        return make_entry(obj, run_id=f"candidate:{Path(path).name}",
                          sha=None)
    raise ValueError(f"{path}: no JSON object line found")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ledger", metavar="BENCH_HISTORY_JSONL")
    ap.add_argument("--candidate", default=None, metavar="PATH",
                    help="judge this bench output / ledger-entry file "
                         "instead of the ledger's newest entry")
    ap.add_argument("--window", type=int, default=8,
                    help="trailing entries forming the baseline")
    ap.add_argument("--min-history", type=int, default=3,
                    help="baseline entries required before judging")
    ap.add_argument("--min-band", type=float, default=5.0,
                    help="noise-band floor (%%) when the trailing "
                         "spread is tighter")
    ap.add_argument("--advisory", action="store_true",
                    help="report but always exit 0 (CI annotation mode)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the check result as JSON here")
    args = ap.parse_args(argv)

    try:
        entries = read_ledger(args.ledger)
        candidate = (_load_candidate(args.candidate)
                     if args.candidate else None)
        result = check_regression(entries, candidate,
                                  window=args.window,
                                  min_history=args.min_history,
                                  min_band_pct=args.min_band)
    except (OSError, ValueError) as e:
        print(f"regress: FAIL {e}", file=sys.stderr)
        return 2
    print(format_report(result))
    if args.json:
        from dopt_torch.utils.metrics import atomic_write_text

        atomic_write_text(args.json, json.dumps(result, indent=2))
    if result["status"] == "regression" and not args.advisory:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
