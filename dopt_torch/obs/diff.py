"""First-divergence stream differ: ``python -m dopt_torch.obs.diff A B``.

The bit-identity assertion every soak re-implemented inline — "these
two telemetry streams are canonically equal" — as a reusable CLI with
a readable report.  Both streams are reduced to their canonical form
(events filtered to ``DETERMINISTIC_KINDS``, wall-clock ``ts``
dropped — exactly ``dopt_torch.obs.canonical``) and compared
element-wise; on divergence the report names the FIRST differing
canonical event: its index, kind, round, and both payloads, which is
what you actually need to debug a replay drift (a wall of "streams
differ" tells you nothing; "gauge quarantine_active at round 17: 2.0
vs 3.0" tells you where to look).

Exit codes follow the convention of dopt's analysis CLIs: 0 streams
canonically identical, 1 divergent (or unreadable), 2 usage error;
``--json`` prints one machine-readable report.  ``--kinds`` narrows or
widens the compared kinds (``--kinds round,control``); ``--all-kinds``
compares every event including the non-deterministic channels (then
only ``ts`` is dropped — useful for comparing two copies of the SAME
file, not two executions).

The port's copy of ``dopt.obs.diff``, with its flags, exit codes and
report texts; it reads no device and runs anywhere the package imports.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Iterable, Sequence

from dopt_torch.obs.events import DETERMINISTIC_KINDS, KINDS, canonical
from dopt_torch.obs.sinks import JsonlSink


def first_divergence(events_a: Iterable[dict], events_b: Iterable[dict],
                     kinds: Sequence[str] = DETERMINISTIC_KINDS,
                     ) -> dict[str, Any] | None:
    """Compare two event streams in canonical form; None when equal,
    else a report dict: the first differing canonical index, both
    events (None for the stream that ended early), kind and round of
    the surviving side, and a one-line ``reason``."""
    return diverge_canonical(canonical(events_a, kinds=tuple(kinds)),
                             canonical(events_b, kinds=tuple(kinds)))


def diverge_canonical(ca: list[dict], cb: list[dict],
                      ) -> dict[str, Any] | None:
    """The comparison core over ALREADY-canonicalized streams (callers
    that need the canonical lists anyway avoid building them twice)."""
    for i in range(min(len(ca), len(cb))):
        if ca[i] != cb[i]:
            return {"index": i, "a": ca[i], "b": cb[i],
                    "kind": ca[i].get("kind"),
                    "round": ca[i].get("round"),
                    "reason": "payload mismatch"}
    if len(ca) != len(cb):
        i = min(len(ca), len(cb))
        longer = ca if len(ca) > len(cb) else cb
        return {"index": i,
                "a": ca[i] if i < len(ca) else None,
                "b": cb[i] if i < len(cb) else None,
                "kind": longer[i].get("kind"),
                "round": longer[i].get("round"),
                "reason": (f"stream {'b' if len(cb) < len(ca) else 'a'} "
                           f"ends at canonical event {i} (other has "
                           f"{max(len(ca), len(cb))})")}
    return None


def format_divergence(path_a: str, path_b: str,
                      div: dict[str, Any]) -> str:
    def _show(ev: Any) -> str:
        return "<stream ended>" if ev is None else json.dumps(
            ev, sort_keys=True)

    return "\n".join([
        f"streams diverge at canonical event {div['index']} "
        f"(kind={div['kind']}, round={div['round']}): {div['reason']}",
        f"  a ({path_a}):",
        f"    {_show(div['a'])}",
        f"  b ({path_b}):",
        f"    {_show(div['b'])}",
    ])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("a", metavar="METRICS_A")
    ap.add_argument("b", metavar="METRICS_B")
    ap.add_argument("--kinds", default=None, metavar="KIND[,KIND...]",
                    help="compare these event kinds (default: the "
                         f"deterministic kinds {DETERMINISTIC_KINDS})")
    ap.add_argument("--all-kinds", action="store_true",
                    help="compare every kind (only ts dropped) — for "
                         "comparing two copies of the same stream, not "
                         "two executions")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout (the "
                         "dopt.analysis CLI convention)")
    args = ap.parse_args(argv)

    kinds: Sequence[str] = DETERMINISTIC_KINDS
    if args.all_kinds:
        kinds = KINDS
    elif args.kinds:
        kinds = tuple(k.strip() for k in args.kinds.split(",") if k.strip())
        unknown = [k for k in kinds if k not in KINDS]
        if unknown:
            ap.error(f"unknown kinds {unknown} (want a subset of {KINDS})")

    try:
        ev_a = JsonlSink.read(args.a)
        ev_b = JsonlSink.read(args.b)
    except (OSError, ValueError) as e:
        if args.json:
            json.dump({"tool": "dopt_torch.obs.diff", "identical": False,
                       "error": str(e)}, sys.stdout, indent=2,
                      sort_keys=True)
            sys.stdout.write("\n")
        else:
            print(f"FAIL {e}", file=sys.stderr)
        return 1

    ca = canonical(ev_a, kinds=tuple(kinds))
    cb = canonical(ev_b, kinds=tuple(kinds))
    div = diverge_canonical(ca, cb)
    n = len(ca)
    if args.json:
        json.dump({"tool": "dopt_torch.obs.diff", "a": args.a, "b": args.b,
                   "kinds": list(kinds), "identical": div is None,
                   "canonical_events": n, "divergence": div},
                  sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    elif div is None:
        print(f"identical: {n} canonical events "
              f"(kinds {','.join(kinds)})")
    else:
        print(format_divergence(args.a, args.b, div), file=sys.stderr)
    return 0 if div is None else 1


if __name__ == "__main__":
    raise SystemExit(main())
