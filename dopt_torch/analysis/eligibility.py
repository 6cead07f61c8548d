"""Eligibility-matrix extractor: ``python -m dopt_torch.analysis.eligibility``.

The port's copy of dopt's gate (dopt/analysis/eligibility.py).  The
composition matrix — which feature pairs the constructors reject
(scatter × choco, population × staleness, compact × comm_dtype, ...) —
lives twice: as ``raise ValueError`` guards over the config and engine
constructors, and as a table in the docs.  This gate makes the CODE the
source of truth and the doc a checked projection of it:

* **Harvest** — a stdlib-``ast`` pass over the port's constructor
  surface (``dopt_torch/config.py``, ``dopt_torch/engine/``,
  ``dopt_torch/parallel/``, ``dopt_torch/population.py``,
  ``dopt_torch/robust.py``, ``dopt_torch/serve/daemon.py``) collects
  every ``raise ValueError`` site: file, line, enclosing scope, the
  guard condition, and the message template (f-string holes become
  ``{}``).  Sites whose message uses the composition-rejection idiom
  ("does not compose", "incompatible", "only applies", "drop one of
  the two", ...) are classified ``composition: true`` — the
  feature×feature matrix rows.

* **Artifact** — ``--write`` serializes the harvest to
  ``dopt_torch/analysis/eligibility.json`` (schema below).  The default
  (check) mode re-harvests and compares against the committed artifact
  by ``(file, scope, message)`` key — line numbers may drift freely,
  new or vanished rejections fail until the artifact is regenerated.

* **Doc cross-check** — ``dopt_torch/ELIGIBILITY.md`` carries the
  matrix between ``<!-- eligibility-matrix:begin/end -->`` markers, one
  row per composition rejection keyed by a message prefix.  Check mode
  verifies both directions: every doc row's key still matches a
  harvested message, and every harvested composition site is covered
  by a doc row.  ``--update-doc`` regenerates the table in place.

Artifact schema (``dopt_torch/analysis/eligibility.json``)::

    {"v": 1,
     "roots": ["dopt_torch/config.py", ...],
     "counts": {"sites": N, "construction": M, "composition": K},
     "sites": [{"file": ..., "line": ..., "scope": ...,
                "construction": true|false, "composition": true|false,
                "guard": "pop.cohort != w" | null,
                "message": "gossip population mode does not ..."}]}

Exit codes: 0 in sync, 1 drift, 2 usage error; ``--json`` prints the
machine-readable report.
"""

from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from pathlib import Path
from typing import Any, Iterable

from dopt_torch.analysis.common import (EXIT_USAGE, Finding, emit_report,
                                  iter_py_files)

# The constructor surface the matrix lives in.  dopt_torch/serve/daemon.py
# joins for the serve-mode construction rejections (engine choice,
# on_term); the rest of dopt_torch/serve is command-schema validation,
# not configuration eligibility.
DEFAULT_ROOTS = ("dopt_torch/config.py", "dopt_torch/engine",
                 "dopt_torch/parallel", "dopt_torch/population.py",
                 "dopt_torch/robust.py", "dopt_torch/serve/daemon.py")
DEFAULT_ARTIFACT = "dopt_torch/analysis/eligibility.json"
DEFAULT_DOC = "dopt_torch/ELIGIBILITY.md"

DOC_BEGIN = "<!-- eligibility-matrix:begin -->"
DOC_END = "<!-- eligibility-matrix:end -->"

# The message idioms that mark a feature x feature composition
# rejection (vs plain value validation).  New rejections written in
# these idioms must land a doc-matrix row or the gate fails — that is
# the drift contract, so USE the idiom when rejecting a composition.
_COMPOSITION_PHRASES = (
    "does not compose", "incompatible", "only applies",
    "drop one of the two", "does not cover", "-engine knob",
    "-engine feature", "jax-backend feature", "are not supported",
    "keep the dense path", "restructures the", "no dense mixing step",
)

# Scopes that run at construction/validation time.
_CTOR_NAMES = re.compile(r"(^|\.)(__init__|__post_init__|validate\w*|"
                         r"_validate\w*|check\w*)$")

_KEY_LEN = 72


def _msg_template(node: ast.AST) -> str:
    """The message argument as a template string: constant parts kept,
    f-string holes and ``%``/``.format`` interpolations become ``{}``,
    whitespace normalized."""
    parts: list[str] = []

    def walk(n: ast.AST) -> None:
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            parts.append(n.value)
        elif isinstance(n, ast.JoinedStr):
            for v in n.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                else:
                    parts.append("{}")
        elif isinstance(n, ast.BinOp):
            for side in (n.left, n.right):
                if isinstance(side, (ast.Constant, ast.JoinedStr,
                                     ast.BinOp)):
                    walk(side)
                else:
                    parts.append("{}")
        elif isinstance(n, ast.Call):
            # "...".format(...) — keep the receiver's constants.
            if isinstance(n.func, ast.Attribute):
                walk(n.func.value)

    walk(node)
    return re.sub(r"\s+", " ", "".join(parts)).strip()


class _RaiseHarvester(ast.NodeVisitor):
    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.source = source
        self.scope: list[str] = []
        self.guards: list[ast.expr] = []
        self.sites: list[dict[str, Any]] = []

    def _enter_scoped(self, node, name: str) -> None:
        self.scope.append(name)
        self.generic_visit(node)
        self.scope.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter_scoped(node, node.name)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._enter_scoped(node, node.name)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._enter_scoped(node, node.name)

    def visit_If(self, node: ast.If) -> None:
        self.guards.append(node.test)
        for stmt in node.body:
            self.visit(stmt)
        self.guards.pop()
        for stmt in node.orelse:
            self.visit(stmt)

    def visit_Raise(self, node: ast.Raise) -> None:
        exc = node.exc
        if not (isinstance(exc, ast.Call) and exc.args):
            return
        fn = exc.func
        name = (fn.id if isinstance(fn, ast.Name)
                else fn.attr if isinstance(fn, ast.Attribute) else "")
        if name != "ValueError":
            return
        message = _msg_template(exc.args[0])
        if not message:
            return
        scope = ".".join(self.scope) or "<module>"
        guard = (ast.get_source_segment(self.source, self.guards[-1])
                 if self.guards else None)
        if guard is not None:
            guard = re.sub(r"\s+", " ", guard).strip()
        self.sites.append({
            "file": self.path,
            "line": node.lineno,
            "scope": scope,
            "construction": bool(_CTOR_NAMES.search(scope)
                                 or scope == "<module>"),
            "composition": any(p in message
                               for p in _COMPOSITION_PHRASES),
            "guard": guard,
            "message": message,
        })


def harvest(roots: Iterable[str] = DEFAULT_ROOTS) -> dict[str, Any]:
    """Harvest every ``raise ValueError`` site under ``roots`` into the
    artifact dict (sorted by file, then line)."""
    sites: list[dict[str, Any]] = []
    for p in iter_py_files(roots):
        src = p.read_text()
        h = _RaiseHarvester(p.as_posix(), src)
        h.visit(ast.parse(src, filename=str(p)))
        sites.extend(h.sites)
    sites.sort(key=lambda s: (s["file"], s["line"]))
    return {
        "v": 1,
        "roots": sorted(Path(r).as_posix() for r in roots),
        "counts": {
            "sites": len(sites),
            "construction": sum(s["construction"] for s in sites),
            "composition": sum(s["composition"] for s in sites),
        },
        "sites": sites,
    }


def site_key(site: dict[str, Any]) -> tuple[str, str, str]:
    """Identity of a rejection, line-number-free: committed artifacts
    stay fresh across pure line drift."""
    return (site["file"], site["scope"], site["message"])


def doc_key(site: dict[str, Any]) -> str:
    """The message prefix a doc-matrix row carries (word-boundary
    trimmed, interpolation holes stripped at the cut)."""
    msg = site["message"]
    if len(msg) <= _KEY_LEN:
        return msg
    cut = msg[:_KEY_LEN]
    cut = cut[:cut.rfind(" ")] if " " in cut else cut
    return cut.rstrip(" {")


def render_doc_table(art: dict[str, Any]) -> str:
    """The consolidated composition matrix as a markdown table, one row
    per composition-rejection site."""
    lines = [
        "| enforced at | rejected composition (message key) |",
        "|---|---|",
    ]
    for s in art["sites"]:
        if not s["composition"]:
            continue
        where = (f"`{s['file'].removeprefix('dopt_torch/')}` · "
                 f"`{s['scope']}`")
        lines.append(f"| {where} | `{doc_key(s)}` |")
    return "\n".join(lines)


def parse_doc_rows(doc_text: str) -> list[str] | None:
    """Message keys from the marker-delimited doc table (the backticked
    cell of each data row); None when the markers are absent."""
    try:
        start = doc_text.index(DOC_BEGIN) + len(DOC_BEGIN)
        end = doc_text.index(DOC_END, start)
    except ValueError:
        return None
    keys: list[str] = []
    for line in doc_text[start:end].splitlines():
        line = line.strip()
        if not line.startswith("|") or set(line) <= {"|", "-", " "}:
            continue
        cells = [c.strip() for c in line.strip("|").split("|")]
        if not cells or cells[-1] in ("rejected composition (message key)",):
            continue
        m = re.findall(r"`([^`]+)`", cells[-1])
        if m:
            keys.append(m[-1])
    return keys


def update_doc(doc_path: Path, art: dict[str, Any]) -> None:
    text = doc_path.read_text()
    if DOC_BEGIN not in text or DOC_END not in text:
        raise ValueError(
            f"{doc_path}: missing {DOC_BEGIN}/{DOC_END} markers")
    head, rest = text.split(DOC_BEGIN, 1)
    _, tail = rest.split(DOC_END, 1)
    table = render_doc_table(art)
    doc_path.write_text(
        f"{head}{DOC_BEGIN}\n{table}\n{DOC_END}{tail}")


def cross_check(art: dict[str, Any], committed: dict[str, Any] | None,
                doc_keys: list[str] | None,
                artifact_path: str, doc_path: str) -> list[Finding]:
    """Both drift directions for both projections (artifact and doc)."""
    findings: list[Finding] = []
    if committed is None:
        findings.append(Finding(
            "artifact-missing", artifact_path, 0,
            "no committed eligibility artifact — run `python -m "
            "dopt_torch.analysis.eligibility --write` and commit it"))
    else:
        have = {site_key(s): s for s in committed.get("sites", ())}
        want = {site_key(s): s for s in art["sites"]}
        for k in sorted(set(want) - set(have)):
            s = want[k]
            findings.append(Finding(
                "artifact-stale", s["file"], s["line"],
                f"rejection not in {artifact_path} (run --write): "
                f"{doc_key(s)!r}"))
        for k in sorted(set(have) - set(want)):
            s = have[k]
            findings.append(Finding(
                "artifact-stale", artifact_path, 0,
                f"committed rejection no longer in the code "
                f"({s['file']}:{s['scope']}): {doc_key(s)!r}"))
    if doc_keys is None:
        findings.append(Finding(
            "doc-missing", doc_path, 0,
            f"no {DOC_BEGIN} table in the doc — add the markers and "
            "run `python -m dopt_torch.analysis.eligibility "
            "--update-doc`"))
        return findings
    messages = [s["message"] for s in art["sites"]]
    for key in doc_keys:
        if not any(key in m for m in messages):
            findings.append(Finding(
                "doc-without-code", doc_path, 0,
                f"doc matrix row matches no code rejection: {key!r}"))
    for s in art["sites"]:
        if not s["composition"]:
            continue
        if not any(key in s["message"] for key in doc_keys):
            findings.append(Finding(
                "code-without-doc", s["file"], s["line"],
                f"composition rejection has no doc matrix row "
                f"(run --update-doc): {doc_key(s)!r}"))
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dopt_torch.analysis.eligibility",
        description="Harvest construction-time eligibility rejections "
                    "and cross-check code / artifact / doc.")
    ap.add_argument("roots", nargs="*", metavar="PATH",
                    help=f"harvest roots (default: {' '.join(DEFAULT_ROOTS)})")
    ap.add_argument("--artifact", default=DEFAULT_ARTIFACT,
                    help=f"committed JSON artifact (default: "
                         f"{DEFAULT_ARTIFACT})")
    ap.add_argument("--doc", default=DEFAULT_DOC,
                    help=f"doc carrying the matrix table (default: "
                         f"{DEFAULT_DOC})")
    ap.add_argument("--write", action="store_true",
                    help="(re)write the artifact instead of checking it")
    ap.add_argument("--update-doc", action="store_true",
                    help="regenerate the doc table between the markers")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)
    roots = args.roots or list(DEFAULT_ROOTS)
    missing = [r for r in roots if not Path(r).exists()]
    if missing:
        print(f"no such path(s): {', '.join(missing)}", file=sys.stderr)
        return EXIT_USAGE

    art = harvest(roots)
    wrote = []
    if args.write:
        out = Path(args.artifact)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(art, indent=1, sort_keys=True) + "\n")
        wrote.append(args.artifact)
    if args.update_doc:
        try:
            update_doc(Path(args.doc), art)
        except (OSError, ValueError) as e:
            print(str(e), file=sys.stderr)
            return EXIT_USAGE
        wrote.append(args.doc)

    committed: dict[str, Any] | None = None
    try:
        committed = json.loads(Path(args.artifact).read_text())
    except (OSError, ValueError):
        pass
    doc_keys: list[str] | None = None
    try:
        doc_keys = parse_doc_rows(Path(args.doc).read_text())
    except OSError:
        pass
    findings = cross_check(art, committed, doc_keys,
                           args.artifact, args.doc)
    extra = {"counts": art["counts"], "wrote": wrote}
    return emit_report(findings, as_json=args.json,
                       tool="dopt_torch.analysis.eligibility",
                       checked=art["counts"]["sites"], unit="site",
                       extra=extra)


if __name__ == "__main__":
    raise SystemExit(main())
