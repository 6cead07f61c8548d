"""Structured metrics sink (the reference's ``history`` pattern, typed).

The port's copy of ``dopt.utils.metrics``: the same row schema, the
same CSV layout (the reference's results/*.csv columns) and the same
``History`` surface (rows and columns, the fault ledger, CSV and JSON
export and the CSV read-back), so a History from either package diffs
cleanly against the other.
"""

from __future__ import annotations

import csv
import io
import json
import os
import statistics
from pathlib import Path
from typing import Any, Iterator


def atomic_write_text(path: str | Path, text: str,
                      newline: str | None = None) -> Path:
    """Crash-safe file write: materialise into a same-directory temp
    file, then ``os.replace`` into place (atomic on POSIX).  ``newline``
    passes through to the write (pass ``""`` to keep the csv module's
    ``\\r\\n`` terminators byte-exact)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    try:
        tmp.write_text(text, newline=newline)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


class History:
    """Append-only per-round record store with CSV/JSON export."""

    # Reference results/*.csv column order; extra columns follow in
    # first-seen order.
    _CSV_ORDER = ("round", "avg_test_acc", "avg_test_loss",
                  "avg_train_loss", "test_acc", "test_loss", "train_loss",
                  "train_acc")

    def __init__(self, name: str = "history"):
        self.name = name
        self.rows: list[dict[str, Any]] = []
        # The fault ledger: one row per (round, worker, kind, action).
        self.faults: list[dict[str, Any]] = []

    def append(self, **row: Any) -> None:
        self.rows.append({k: _scalar(v) for k, v in row.items()})

    def log_fault(self, *, round: int, worker: int, kind: str,
                  action: str) -> None:
        """Record one injected fault in the ledger (round, worker, kind,
        the action taken)."""
        self.faults.append({"round": int(round), "worker": int(worker),
                            "kind": str(kind), "action": str(action)})

    @staticmethod
    def faults_from_json(path: str | Path) -> list[dict[str, Any]]:
        """Re-load a ``--faults-json`` export, row for row."""
        with open(path) as f:
            rows = json.load(f)
        if not isinstance(rows, list) or any(
                not isinstance(r, dict) for r in rows):
            raise ValueError(f"{path}: not a fault-ledger export "
                             "(expected a JSON list of row objects)")
        return rows

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return iter(self.rows)

    def __getitem__(self, key: str) -> list[Any]:
        """Column access: history['avg_test_acc'] -> list over rounds."""
        return [r.get(key) for r in self.rows]

    def last(self) -> dict[str, Any]:
        return self.rows[-1] if self.rows else {}

    def to_csv(self, path: str | Path) -> Path:
        """Write rows in the reference results/*.csv layout (leading
        unnamed index column, then the union of the rows' columns)."""
        seen: dict[str, None] = {}
        for r in self.rows:
            for k in r:
                seen.setdefault(k)
        cols = [c for c in self._CSV_ORDER if c in seen]
        cols += [c for c in seen if c not in cols]
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow([""] + cols)
        for i, r in enumerate(self.rows):
            w.writerow([i] + [r.get(c, "") for c in cols])
        return atomic_write_text(path, buf.getvalue(), newline="")

    def to_json(self, path: str | Path) -> Path:
        return atomic_write_text(path, json.dumps(self.rows, indent=2))

    @classmethod
    def from_csv(cls, path: str | Path, name: str = "history") -> "History":
        """Read a ``to_csv`` file back: blank cells are absent keys (the
        layout fills the union of the rows' columns with "")."""
        h = cls(name)
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                h.rows.append({k: _maybe_num(v) for k, v in row.items()
                               if k not in ("", None) and v != ""})
        return h

    def merge_resumed(self, rows, *, key: str = "round") -> int:
        """Fold the rows of a RESUMED run into this history under the
        telemetry stream's watermark rule: rows at rounds this history
        already holds are dropped (the continuous prefix wins), and the
        first new row must continue the sequence (a gap raises: the
        resume lost a round).  Returns the number of rows appended."""
        last = -1
        for r in self.rows:
            if key in r and isinstance(r[key], int):
                last = max(last, r[key])
        appended = 0
        for r in rows:
            t = r.get(key)
            if not isinstance(t, int):
                raise ValueError(
                    f"merge_resumed: row without an int {key!r}: {r!r}")
            if t <= last:
                continue
            if t != last + 1:
                raise ValueError(
                    f"merge_resumed: round gap {last} -> {t} (the resumed "
                    "stream is missing rounds)")
            self.rows.append(dict(r))
            last = t
            appended += 1
        return appended

    def faults_to_json(self, path: str | Path) -> Path:
        """The fault ledger as dopt's ``--faults-json`` writes it."""
        return atomic_write_text(path, json.dumps(self.faults, indent=2))


def time_to_target(history: History, *, target: float,
                   key: str = "avg_test_acc",
                   seconds_per_round: float | None = None) -> dict[str, Any]:
    """dopt's north-star meter: the first round at which ``key`` reaches
    ``target`` and, given a measured wall-clock a round, the implied
    time to target.  Returns {reached, round, rounds, seconds}:
    ``round`` is the row's round number, ``rounds`` counts the rows up
    to and including it, ``seconds`` is rounds × seconds_per_round (None
    without a rate).  Rows without ``key`` (eval-skipped rounds) are
    passed over."""
    for i, row in enumerate(history.rows):
        v = row.get(key)
        if v is not None and v >= target:
            rounds = i + 1
            return {"reached": True, "round": row.get("round", i),
                    "rounds": rounds,
                    "seconds": (None if seconds_per_round is None
                                else rounds * seconds_per_round)}
    return {"reached": False, "round": None, "rounds": None, "seconds": None}


def _scalar(v: Any) -> Any:
    """Unwrap 0-d arrays / tensors so rows are plain JSON-able."""
    if hasattr(v, "item") and getattr(v, "ndim", 0) == 0:
        return v.item()
    return v


def _maybe_num(v: str) -> Any:
    """A CSV cell as dopt reads it: an int where it has no '.', a float
    where it parses, else the string."""
    try:
        f = float(v)
        return int(f) if f.is_integer() and "." not in v else f
    except (TypeError, ValueError):
        return v


def trimmed_stats(values) -> tuple[float, float, list[float]]:
    """Outlier-hardened reduction of timing samples: with >= 4 samples
    the min and max are discarded, then (median, spread_pct, kept) over
    the survivors; spread_pct = (max−min)/median·100 of the kept set."""
    vals = sorted(float(v) for v in values)
    kept = vals[1:-1] if len(vals) >= 4 else vals
    med = statistics.median(kept)
    spread = 100.0 * (kept[-1] - kept[0]) / med if med > 0 else 0.0
    return med, spread, kept
