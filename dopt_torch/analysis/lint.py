"""Trace-safety & determinism linter: ``python -m dopt_torch.analysis.lint dopt_torch/``.

The port's copy of dopt's linter (dopt/analysis/lint.py): a
stdlib-``ast`` pass over library code enforcing the determinism
contract the engines are built on (stateless per-round draws, one
captured program per kind of round, telemetry that cannot perturb
replay), with dopt's four rules:

``wallclock``
    Wall-clock reads (``time.time``/``monotonic``/``perf_counter``,
    ``datetime.now``) in library code.  Deterministic paths must not
    consult the clock; span timing and telemetry timestamps are the
    audited exceptions (pragma).

``unseeded-rng``
    Global-state RNG: the legacy ``np.random.*`` module-level API,
    stdlib ``random.*`` module functions, seedless
    ``np.random.default_rng()`` / ``random.Random()``.  Library draws
    come from explicit seeded generators
    (``dopt_torch.utils.prng.host_rng``) so fault traces, cohorts and
    batch plans replay from the config alone.

``trace-hazard``
    Host syncs and data-dependent shapes inside code that is captured
    into a CUDA graph or vmapped — the port's counterparts of dopt's
    jit reachability.  The roots are the round body handed to
    ``RoundGraphs`` (captured into a CUDA graph and replayed,
    ``dopt_torch/engine/graphs.py``), every call under ``with
    torch.cuda.graph(...)``, and the functions handed to
    ``torch.func.vmap``; the rule follows the local call graph from
    them (local names, and ``self.<method>`` within the class).  It
    flags ``.item()``, ``.tolist()`` and ``.cpu()`` (each a device→host
    sync, which breaks a capture or serialises the replay),
    ``int()``/``float()``/``bool()`` of a parameter (a sync when it is a
    tensor), and ``nonzero``/``unique``/``masked_select``/``argwhere``
    (a data-dependent output shape, which a captured graph cannot
    replay).

``nondet-event``
    Emission of non-``DETERMINISTIC_KINDS`` telemetry outside
    ``dopt_torch/obs`` — the canonical-stream guarantee says engine code
    emits only ``round``/``fault``/``gauge``/``control`` (plus the
    ``run`` header); ``alert``/``checkpoint``/``resource``/``compile``
    sites in engine code are deliberate exceptions and carry pragmas.

Suppression: ``# dopt: allow-<rule> -- <justification>`` on any line
of the flagged statement (multi-line calls included) or the line
directly above it.  The justification is mandatory; a bare pragma or an
unknown rule name is itself a finding (rule ``pragma``, not
suppressible).  Exit codes: 0 clean, 1 findings, 2 usage error;
``--json`` prints the machine-readable report.
"""

from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path

from dopt_torch.analysis.common import (EXIT_USAGE, Finding, emit_report,
                                        iter_py_files, parse_pragmas,
                                        pragma_for)
from dopt_torch.obs.events import DETERMINISTIC_KINDS

RULES = ("wallclock", "unseeded-rng", "trace-hazard", "nondet-event")

# time.* attributes that read a clock.
_CLOCK_ATTRS = {"time", "time_ns", "monotonic", "monotonic_ns",
                "perf_counter", "perf_counter_ns", "localtime", "gmtime"}
# datetime.* / datetime.datetime.* constructors that read a clock.
_DATETIME_NOW = {"now", "utcnow", "today"}
# Legacy numpy global-state RNG API (np.random.<fn> mutates or draws
# from the hidden global RandomState).
_NP_GLOBAL_RNG = {
    "seed", "rand", "randn", "randint", "random", "random_sample",
    "ranf", "sample", "choice", "permutation", "shuffle", "normal",
    "uniform", "standard_normal", "binomial", "poisson", "beta",
    "gamma", "exponential", "bytes", "get_state", "set_state",
}
# stdlib random module-level functions (the hidden global Random()).
_PY_GLOBAL_RNG = {
    "seed", "random", "randint", "randrange", "choice", "choices",
    "shuffle", "sample", "uniform", "gauss", "normalvariate",
    "getrandbits", "betavariate", "expovariate", "triangular",
}
# Calls whose function-valued arguments are captured or vmapped.
_ROOT_CALLS = {"RoundGraphs", "vmap"}
# Device→host syncs.
_SYNCS = {"item", "tolist", "cpu"}
# Data-dependent output shapes.
_SHAPE_POLY = {"nonzero", "unique", "masked_select", "argwhere"}

# Kinds engine code may emit directly; everything else is the obs
# subsystem's job (or a pragma'd, documented exception).
_ALLOWED_KINDS = set(DETERMINISTIC_KINDS) | {"run"}


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _self_attr(node: ast.AST) -> str | None:
    """``X`` for ``self.X``, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _FuncInfo:
    """One lexical scope (module / class / function / lambda)."""

    def __init__(self, node: ast.AST | None, qualname: str,
                 parent: "_FuncInfo | None") -> None:
        self.node = node
        self.qualname = qualname
        self.parent = parent
        self.children: dict[str, "_FuncInfo"] = {}
        self.calls: set[str] = set()          # locally-called names
        self.self_calls: set[str] = set()     # self.<method>(...) calls
        self.params: set[str] = set()
        self.is_class = isinstance(node, ast.ClassDef)
        self.is_function = isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        if self.is_function:
            a = node.args
            self.params = {p.arg for p in (a.posonlyargs + a.args
                                           + a.kwonlyargs)} - {"self"}
            if a.vararg:
                self.params.add(a.vararg.arg)
            if a.kwarg:
                self.params.add(a.kwarg.arg)


class _Analyzer(ast.NodeVisitor):
    """One pass per module: builds the scope tree, records the capture
    and vmap roots and the local call edges, and collects rule hits
    (trace hazards held back until reachability is known)."""

    def __init__(self, path: str, source: str) -> None:
        self.path = path
        # dopt_torch/obs IS the telemetry subsystem — the sanctioned
        # producer of the non-deterministic kinds.
        self.in_obs = "dopt_torch/obs" in Path(path).as_posix()
        self.imports: dict[str, str] = {}
        self.root = _FuncInfo(None, "<module>", None)
        self.scope = self.root
        self.roots: set[_FuncInfo] = set()
        # Functions handed to a root call and names called under ``with
        # torch.cuda.graph(...)``, resolved once the whole module is
        # seen, from the scope they appear in: (scope, name, is_self).
        self.root_refs: list[tuple[_FuncInfo, str, bool]] = []
        self.capture_depth = 0
        self.findings: list[Finding] = []
        # (line, end_line, message, scope, names, captured) — names, when
        # non-None, must intersect the scope's params; captured hazards
        # sit under a capture and need no reachability.
        self.deferred: list[tuple[int, int | None, str, _FuncInfo,
                                  set[str] | None, bool]] = []
        self.pragmas = parse_pragmas(source)

    # -- scope handling -------------------------------------------------
    def _enter(self, node: ast.AST, name: str) -> _FuncInfo:
        qn = (name if self.scope is self.root
              else f"{self.scope.qualname}.{name}")
        info = _FuncInfo(node, qn, self.scope)
        self.scope.children[name] = info
        self.scope = info
        return info

    def _exit(self) -> None:
        assert self.scope.parent is not None
        self.scope = self.scope.parent

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter(node, node.name)
        self.generic_visit(node)
        self._exit()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._enter(node, node.name)
        self.generic_visit(node)
        self._exit()

    def visit_Lambda(self, node: ast.Lambda) -> None:
        info = self._enter(node, f"<lambda:{node.lineno}>")
        if getattr(node, "_dopt_root", False):
            self.roots.add(info)
        self.generic_visit(node)
        self._exit()

    def visit_With(self, node: ast.With) -> None:
        captured = any(
            isinstance(item.context_expr, ast.Call)
            and self._canonical(_dotted(item.context_expr.func) or "")
            in ("torch.cuda.graph", "torch.cuda.graphs.graph")
            for item in node.items)
        for item in node.items:
            self.visit(item)
        self.capture_depth += captured
        for stmt in node.body:
            self.visit(stmt)
        self.capture_depth -= captured

    def _resolve(self, name: str,
                 scope: "_FuncInfo") -> "_FuncInfo | None":
        s: _FuncInfo | None = scope
        while s is not None:
            if name in s.children:
                return s.children[name]
            s = s.parent
        return None

    def _resolve_self(self, name: str,
                      scope: "_FuncInfo") -> "_FuncInfo | None":
        """``self.<name>`` from ``scope``: the method of the nearest
        enclosing class."""
        s: _FuncInfo | None = scope
        while s is not None and not s.is_class:
            s = s.parent
        return s.children.get(name) if s is not None else None

    # -- imports --------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.asname:
                self.imports[a.asname] = a.name
            else:
                # `import numpy.random` binds the top-level name `numpy`;
                # references spell the full dotted path themselves.
                head = a.name.split(".")[0]
                self.imports[head] = head

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module is not None:
            for a in node.names:
                self.imports[a.asname or a.name] = \
                    f"{node.module}.{a.name}"

    def _canonical(self, dotted: str) -> str:
        head, _, rest = dotted.partition(".")
        base = self.imports.get(head, head)
        return f"{base}.{rest}" if rest else base

    # -- the rules ------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Name):
            self.scope.calls.add(node.func.id)
            if self.capture_depth:
                self.root_refs.append((self.scope, node.func.id, False))
        elif _self_attr(node.func) is not None:
            self.scope.self_calls.add(node.func.attr)
            if self.capture_depth:
                self.root_refs.append((self.scope, node.func.attr, True))
        dotted = _dotted(node.func)
        canon = self._canonical(dotted) if dotted else None
        if canon is not None:
            self._check_wallclock(node, canon)
            self._check_unseeded_rng(node, canon)
        self._check_nondet_event(node, dotted)
        self._check_root_call(node, dotted)
        self._check_trace_hazard_call(node, canon)
        self.generic_visit(node)

    def _finding(self, rule: str, line: int, message: str,
                 end: int | None = None) -> None:
        # Any matching pragma suppresses the finding; a bare one still
        # fails through the justification sweep in lint_source.
        if pragma_for(self.pragmas, rule, line, end) is None:
            self.findings.append(Finding(rule, self.path, line, message))

    def _check_wallclock(self, node: ast.Call, canon: str) -> None:
        mod, _, attr = canon.rpartition(".")
        hit = ((mod == "time" and attr in _CLOCK_ATTRS)
               or (mod in ("datetime", "datetime.datetime",
                           "datetime.date") and attr in _DATETIME_NOW))
        if hit:
            self._finding(
                "wallclock", node.lineno,
                f"wall-clock read `{canon}()` in library code — "
                "deterministic paths must not consult the clock",
                end=node.end_lineno)

    def _check_unseeded_rng(self, node: ast.Call, canon: str) -> None:
        mod, _, attr = canon.rpartition(".")
        if mod == "numpy.random" and attr in _NP_GLOBAL_RNG:
            self._finding(
                "unseeded-rng", node.lineno,
                f"global-state RNG `np.random.{attr}()` — draw from an "
                "explicit seeded generator (dopt_torch.utils.prng."
                "host_rng)", end=node.end_lineno)
        elif canon == "numpy.random.default_rng" and not (
                node.args or node.keywords):
            self._finding(
                "unseeded-rng", node.lineno,
                "seedless `np.random.default_rng()` draws from OS "
                "entropy — pass an explicit seed", end=node.end_lineno)
        elif mod == "random" and attr in _PY_GLOBAL_RNG:
            self._finding(
                "unseeded-rng", node.lineno,
                f"stdlib global RNG `random.{attr}()` — use an explicit "
                "seeded generator", end=node.end_lineno)
        elif canon == "random.Random" and not (node.args or node.keywords):
            self._finding(
                "unseeded-rng", node.lineno,
                "seedless `random.Random()` — pass an explicit seed",
                end=node.end_lineno)

    def _check_nondet_event(self, node: ast.Call,
                            dotted: str | None) -> None:
        is_emit = (isinstance(node.func, ast.Attribute)
                   and node.func.attr == "emit")
        is_make = (dotted is not None
                   and dotted.split(".")[-1] == "make_event")
        if self.in_obs or not (is_emit or is_make):
            return
        kind = (node.args[0] if node.args
                else next((kw.value for kw in node.keywords
                           if kw.arg == "kind"), None))
        if (isinstance(kind, ast.Constant) and isinstance(kind.value, str)
                and kind.value not in _ALLOWED_KINDS):
            self._finding(
                "nondet-event", node.lineno,
                f"emission of non-deterministic kind {kind.value!r} "
                f"outside dopt_torch/obs — only {sorted(_ALLOWED_KINDS)} "
                "keep the canonical-stream guarantee",
                end=node.end_lineno)

    def _check_root_call(self, node: ast.Call, dotted: str | None) -> None:
        if dotted is None or dotted.split(".")[-1] not in _ROOT_CALLS:
            return
        for arg in node.args:
            if isinstance(arg, ast.Name):
                self.root_refs.append((self.scope, arg.id, False))
            elif _self_attr(arg) is not None:
                self.root_refs.append((self.scope, arg.attr, True))
            elif isinstance(arg, ast.Lambda):
                # Visited (after this call returns) as a child scope.
                arg._dopt_root = True  # type: ignore[attr-defined]

    def _enclosing_function(self) -> _FuncInfo | None:
        s: _FuncInfo | None = self.scope
        while s is not None and not s.is_function:
            s = s.parent
        return s

    def _check_trace_hazard_call(self, node: ast.Call,
                                 canon: str | None) -> None:
        scope = self._enclosing_function()
        if scope is None:
            return
        captured = bool(self.capture_depth)
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _SYNCS and not node.args:
                self.deferred.append((
                    node.lineno, node.end_lineno,
                    f"`.{node.func.attr}()` syncs with the host inside "
                    "captured or vmapped code", scope, None, captured))
            elif node.func.attr in _SHAPE_POLY:
                self.deferred.append((
                    node.lineno, node.end_lineno,
                    f"data-dependent output shape `{node.func.attr}` "
                    "inside captured or vmapped code — survivor counts "
                    "must stay data, not shapes", scope, None, captured))
        if canon in ("int", "float", "bool") and len(node.args) == 1:
            arg = node.args[0]
            names = {n.id for n in ast.walk(arg)
                     if isinstance(n, ast.Name)}
            if not isinstance(arg, ast.Constant) and names & scope.params:
                self.deferred.append((
                    node.lineno, node.end_lineno,
                    f"`{canon}()` of a parameter inside captured or "
                    "vmapped code syncs with the host when it is a tensor",
                    scope, names, captured))

    # -- resolution -----------------------------------------------------
    def resolve(self) -> list[Finding]:
        frontier = list(self.roots)
        for scope, name, is_self in self.root_refs:
            callee = (self._resolve_self(name, scope) if is_self
                      else self._resolve(name, scope))
            if callee is not None:
                frontier.append(callee)
        reachable: set[_FuncInfo] = set()
        while frontier:
            fn = frontier.pop()
            if fn in reachable:
                continue
            reachable.add(fn)
            for name in fn.calls:
                callee = self._resolve(name, fn)
                if callee is not None and callee not in reachable:
                    frontier.append(callee)
            for name in fn.self_calls:
                callee = self._resolve_self(name, fn)
                if callee is not None and callee not in reachable:
                    frontier.append(callee)
        for line, end, message, scope, names, captured in self.deferred:
            if names is not None and not names & scope.params:
                continue
            s: _FuncInfo | None = scope
            hit = captured
            while s is not None and not hit:
                hit = s in reachable
                s = s.parent
            if hit:
                self._finding("trace-hazard", line, message, end=end)
        return self.findings


def lint_source(source: str, path: str = "<string>",
                rules: tuple[str, ...] = RULES) -> list[Finding]:
    """Lint one module's source; returns the surviving findings."""
    tree = ast.parse(source, filename=path)
    an = _Analyzer(path, source)
    an.visit(tree)
    findings = an.resolve()
    known = set(RULES) | {"pragma"}
    for line, pragmas in an.pragmas.items():
        for p in pragmas:
            if p.rule not in known:
                findings.append(Finding(
                    "pragma", path, line,
                    f"unknown pragma rule `allow-{p.rule}` (rules: "
                    f"{', '.join(RULES)})"))
            elif not p.justification:
                # Unconditional: a bare pragma is a finding whether or
                # not it suppresses anything now.
                findings.append(Finding(
                    "pragma", path, line,
                    f"allow-{p.rule} pragma without a justification "
                    f"(write `# dopt: allow-{p.rule} -- <why>`)"))
    return [f for f in findings if f.rule == "pragma" or f.rule in rules]


def lint_paths(paths: list[str],
               rules: tuple[str, ...] = RULES) -> tuple[list[Finding], int]:
    findings: list[Finding] = []
    checked = 0
    for p in iter_py_files(paths):
        checked += 1
        try:
            src = p.read_text()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding("io", str(p), 0, str(e)))
            continue
        try:
            findings.extend(lint_source(src, str(p), rules))
        except SyntaxError as e:
            findings.append(Finding("io", str(p), e.lineno or 0,
                                    f"syntax error: {e.msg}"))
    return findings, checked


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dopt_torch.analysis.lint",
        description="Trace-safety & determinism linter for the port's "
                    "library code.")
    ap.add_argument("paths", nargs="*", metavar="PATH",
                    help="files/directories to lint (default: dopt_torch)")
    ap.add_argument("--rules", default=",".join(RULES),
                    help="comma-separated rule subset "
                         f"(default: {','.join(RULES)})")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)
    rules = tuple(r for r in args.rules.split(",") if r)
    unknown = set(rules) - set(RULES)
    if unknown:
        print(f"unknown rule(s): {', '.join(sorted(unknown))}; "
              f"valid: {', '.join(RULES)}", file=sys.stderr)
        return EXIT_USAGE
    paths = args.paths or ["dopt_torch"]
    missing = [p for p in paths if not Path(p).exists()]
    if missing:
        print(f"no such path(s): {', '.join(missing)}", file=sys.stderr)
        return EXIT_USAGE
    findings, checked = lint_paths(paths, rules)
    return emit_report(findings, as_json=args.json,
                       tool="dopt_torch.analysis.lint", checked=checked)


if __name__ == "__main__":
    raise SystemExit(main())
