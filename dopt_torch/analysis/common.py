"""Shared conventions for the ``dopt_torch.analysis`` CLIs.

Exit codes (the ``dopt_torch.obs.check`` contract, shared by every
analysis gate): ``EXIT_CLEAN`` (0) — no findings; ``EXIT_FINDINGS``
(1) — the gate found violations; ``EXIT_USAGE`` (2) — bad invocation
(argparse's own convention, so ``--help`` typos and gate failures are
distinguishable in CI).

Findings are plain records with a stable JSON form (``--json`` on every
CLI) so CI can annotate them; the text form is one grep-able line per
finding (``path:line: [rule] message``).

Pragmas: a finding is suppressed by an end-of-line comment on the
flagged line (or the line above, for multi-line statements)::

    t0 = time.time()  # dopt: allow-wallclock -- span timing, not math

The justification after ``--`` is REQUIRED — a bare ``allow-<rule>``
still fails, with a finding pointing at the pragma itself.  This module
is stdlib-only.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
from pathlib import Path
from typing import Any, Iterable, Iterator

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2

# ``# dopt: allow-<rule>`` with an optional ``-- justification`` tail.
_PRAGMA_RE = re.compile(
    r"#\s*dopt:\s*allow-(?P<rule>[a-z0-9-]+)"
    r"(?:\s*--\s*(?P<why>.*\S))?")


@dataclasses.dataclass(frozen=True)
class Pragma:
    rule: str
    line: int
    justification: str | None


@dataclasses.dataclass(frozen=True)
class Finding:
    """One gate violation, pointing at a file:line."""

    rule: str
    path: str
    line: int
    message: str

    def text(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def parse_pragmas(source: str) -> dict[int, list[Pragma]]:
    """All ``# dopt: allow-*`` pragmas in ``source``, keyed by the
    1-based line they sit on.  Parsed textually (not via the AST) so a
    pragma on a continuation line or above a decorator still counts."""
    out: dict[int, list[Pragma]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        for m in _PRAGMA_RE.finditer(line):
            out.setdefault(i, []).append(
                Pragma(rule=m.group("rule"), line=i,
                       justification=m.group("why")))
    return out


def pragma_for(pragmas: dict[int, list[Pragma]], rule: str,
               line: int, end_line: int | None = None) -> Pragma | None:
    """The pragma covering ``rule`` for a statement spanning
    ``line``..``end_line``: any line of the statement itself (so a
    pragma at the natural end of a multi-line call counts) or the line
    directly above it."""
    for ln in range(line - 1, max(end_line or line, line) + 1):
        for p in pragmas.get(ln, ()):
            if p.rule == rule:
                return p
    return None


def iter_py_files(roots: Iterable[str | Path],
                  exclude: tuple[str, ...] = ()) -> Iterator[Path]:
    """Yield ``.py`` files under each root (a file root yields itself),
    sorted for deterministic output; ``exclude`` drops any file whose
    posix path contains one of the fragments."""
    seen: set[Path] = set()
    for root in roots:
        root = Path(root)
        paths = [root] if root.is_file() else sorted(root.rglob("*.py"))
        for p in paths:
            posix = p.as_posix()
            if p in seen or any(frag in posix for frag in exclude):
                continue
            seen.add(p)
            yield p


def emit_report(findings: list[Finding], *, as_json: bool, tool: str,
                checked: int, unit: str = "file",
                extra: dict[str, Any] | None = None,
                stream=None) -> int:
    """Print findings (text or one JSON document) and return the exit
    code: ``EXIT_FINDINGS`` if any finding survived, else
    ``EXIT_CLEAN``."""
    stream = sys.stdout if stream is None else stream
    findings = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    if as_json:
        doc: dict[str, Any] = {
            "tool": tool,
            "checked": checked,
            "findings": [f.to_json() for f in findings],
            "clean": not findings,
        }
        if extra:
            doc.update(extra)
        json.dump(doc, stream, indent=2, sort_keys=True)
        stream.write("\n")
    else:
        for f in findings:
            print(f.text(), file=stream)
        verdict = ("clean" if not findings
                   else f"{len(findings)} finding(s)")
        print(f"{tool}: {verdict} ({checked} {unit}(s) checked)",
              file=stream)
    return EXIT_FINDINGS if findings else EXIT_CLEAN
