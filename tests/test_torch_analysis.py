"""The port's static gates (``dopt_torch.analysis``) against dopt's.

Counterparts of tests/test_analysis.py, run against
``dopt_torch.analysis``: each lint rule's accept/reject cases (the
rules dopt and the port share give dopt's findings on the same
snippet; the trace-hazard cases use the port's roots — the body handed
to ``RoundGraphs``, ``with torch.cuda.graph(...)``, ``torch.func.vmap``),
the port's tree linting clean, the eligibility extractor's round trip
and the committed artifact and doc table in sync with the tree, the
port's composition rejections equal dopt's by message key, and the
fingerprint gate catching a flipped default knob (both fingerprints
computed in-process) with dopt's env gating and ``--bless`` rules."""

from __future__ import annotations

import dataclasses
import json
import textwrap
from collections import Counter
from pathlib import Path

import pytest

from dopt.analysis.eligibility import harvest as dopt_harvest
from dopt.analysis.lint import lint_source as dopt_lint_source
from dopt_torch.analysis.common import (EXIT_CLEAN, EXIT_FINDINGS,
                                        EXIT_USAGE, parse_pragmas)
from dopt_torch.analysis.eligibility import (cross_check, doc_key, harvest,
                                             parse_doc_rows,
                                             render_doc_table, site_key)
from dopt_torch.analysis.lint import lint_source

REPO = Path(__file__).resolve().parent.parent


def _rules(findings):
    return sorted(f.rule for f in findings)


def _lint(snippet: str, path: str = "dopt_torch/somelib.py"):
    return lint_source(textwrap.dedent(snippet), path)


def _both(snippet: str, path: str = "dopt_torch/somelib.py"):
    """The port's findings, after checking that dopt's linter finds the
    same rules on the same snippet at dopt's counterpart path."""
    got = _rules(_lint(snippet, path))
    want = _rules(dopt_lint_source(textwrap.dedent(snippet),
                                   path.replace("dopt_torch/", "dopt/")))
    assert got == want, (got, want)
    return got


# -- lint: wallclock ---------------------------------------------------
def test_wallclock_flagged():
    assert _both("""
        import time
        def f():
            return time.time()
    """) == ["wallclock"]


def test_wallclock_from_import_and_datetime():
    assert _both("""
        from time import perf_counter
        import datetime
        def f():
            return perf_counter() + datetime.datetime.now().year
    """) == ["wallclock", "wallclock"]


def test_wallclock_pragma_with_justification_suppresses():
    assert _both("""
        import time
        def f():
            return time.time()  # dopt: allow-wallclock -- span timing
    """) == []


def test_pragma_without_justification_is_a_finding():
    assert _both("""
        import time
        def f():
            return time.time()  # dopt: allow-wallclock
    """) == ["pragma"]


def test_unknown_pragma_rule_is_a_finding():
    assert _both("""
        x = 1  # dopt: allow-everything -- please
    """) == ["pragma"]


def test_pragma_on_line_above_covers_continuation():
    assert _both("""
        import time
        def f():
            # dopt: allow-wallclock -- span timing
            return time.time()
    """) == []


def test_pragma_on_statement_continuation_line_covers():
    """A multi-line statement's pragma at its natural end suppresses a
    finding anchored at its first line."""
    assert _both("""
        def report(tele):
            tele.emit("alert",
                      rule="x")  # dopt: allow-nondet-event -- documented
    """, path="dopt_torch/engine/something.py") == []


# -- lint: unseeded-rng ------------------------------------------------
def test_global_numpy_rng_flagged_seeded_generator_clean():
    assert _both("""
        import numpy as np
        def draw():
            a = np.random.rand(3)          # global state: flagged
            rng = np.random.default_rng(7)  # seeded: clean
            return a, rng.normal()
    """) == ["unseeded-rng"]


def test_seedless_default_rng_and_stdlib_random_flagged():
    assert _both("""
        import numpy as np
        import random
        def draw():
            return np.random.default_rng(), random.choice([1, 2])
    """) == ["unseeded-rng", "unseeded-rng"]


def test_submodule_import_still_canonicalizes():
    assert _both("""
        import numpy.random
        def draw():
            return numpy.random.seed(0)
    """) == ["unseeded-rng"]


def test_seeded_seed_sequence_clean():
    assert _both("""
        import numpy as np
        def draw(seed):
            return np.random.default_rng(np.random.SeedSequence([seed]))
    """) == []


# -- lint: trace-hazard (the port's roots) -----------------------------
def test_item_in_captured_round_body_flagged():
    """``.item()`` in the body handed to ``RoundGraphs`` (a bound
    method defined after the constructor that hands it over)."""
    assert _rules(_lint("""
        from dopt_torch.engine.graphs import RoundGraphs
        class Trainer:
            def __init__(self, slot):
                self.graphs = RoundGraphs(self._body, slot)
            def _body(self, statics, kind):
                return statics["loss"].item()
    """)) == ["trace-hazard"]


def test_item_outside_capture_clean():
    assert _lint("""
        def host_fetch(x):
            return x.item()
    """) == []


def test_coercion_of_param_in_vmapped_function_flagged():
    assert _rules(_lint("""
        import torch
        def one(p, x):
            n = int(x)
            return p * n
        def run(ps, xs):
            return torch.func.vmap(one)(ps, xs)
    """)) == ["trace-hazard"]


def test_coercion_of_closure_constant_clean():
    """``float()`` of a Python constant the body closes over reads no
    tensor: only a parameter's coercion is flagged (dopt's static-arg
    case)."""
    assert _lint("""
        import torch
        def run(ps, xs, lr):
            scale = float(lr)
            def one(p, x):
                return p * x * float(scale)
            return torch.func.vmap(one)(ps, xs)
    """) == []


@pytest.mark.parametrize("call", ["mask.nonzero()", "mask.unique()",
                                  "x.masked_select(mask)"])
def test_data_dependent_shape_under_graph_capture_flagged(call):
    assert _rules(_lint(f"""
        import torch
        def capture(graph, mask, x):
            with torch.cuda.graph(graph):
                return {call}
    """)) == ["trace-hazard"]


def test_reachability_through_local_helper():
    assert _rules(_lint("""
        from dopt_torch.engine.graphs import RoundGraphs
        def helper(x):
            return x.cpu()
        def step(statics, kind):
            return helper(statics["x"])
        graphs = RoundGraphs(step, None)
    """)) == ["trace-hazard"]


def test_reachability_through_self_methods_and_graph_body():
    """A method the captured body reaches through ``self`` is flagged;
    the same call in a method outside the capture is not."""
    assert [f.line for f in _lint("""
        import torch
        class Trainer:
            def capture(self, graph, statics):
                with torch.cuda.graph(graph):
                    self._round(statics)
            def _round(self, statics):
                return self._metrics(statics)
            def _metrics(self, statics):
                return statics["m"].tolist()
            def host(self, statics):
                return statics["m"].tolist()
    """)] == [10]


# -- lint: nondet-event ------------------------------------------------
def test_nondet_kind_outside_obs_flagged():
    assert _both("""
        def report(tele):
            tele.emit("alert", rule="x")
    """, path="dopt_torch/engine/something.py") == ["nondet-event"]


def test_deterministic_kinds_clean_everywhere():
    assert _both("""
        def report(tele):
            tele.emit("gauge", name="x", value=1.0)
            tele.emit("round", round=0)
            tele.emit("fault", worker=1)
            tele.emit("run", engine="gossip")
            tele.emit("control", op="leave")
    """, path="dopt_torch/engine/something.py") == []


def test_nondet_kind_as_keyword_argument_flagged():
    assert _both("""
        def report(tele):
            tele.emit(kind="resource", round=0)
    """, path="dopt_torch/engine/something.py") == ["nondet-event"]


def test_bare_pragma_without_live_finding_still_flagged():
    assert _both("""
        x = 1  # dopt: allow-wallclock
    """) == ["pragma"]


def test_obs_package_exempt_from_nondet_rule():
    assert _both("""
        def fire(tele):
            tele.emit("alert", rule="x")
    """, path="dopt_torch/obs/monitor.py") == []


def test_real_tree_lints_clean():
    """`python -m dopt_torch.analysis.lint dopt_torch/` exits 0, every
    pragma justified."""
    from dopt_torch.analysis.lint import main

    assert main([str(REPO / "dopt_torch")]) == EXIT_CLEAN


def test_lint_cli_exit_codes(tmp_path, capsys):
    from dopt_torch.analysis.lint import main

    bad = tmp_path / "mod.py"
    bad.write_text("import time\n\ndef f():\n    return time.time()\n")
    assert main([str(bad)]) == EXIT_FINDINGS
    assert main([str(bad), "--rules", "nonsense"]) == EXIT_USAGE
    assert main([str(tmp_path / "missing.py")]) == EXIT_USAGE
    capsys.readouterr()
    assert main([str(bad), "--json"]) == EXIT_FINDINGS
    doc = json.loads(capsys.readouterr().out)
    assert doc["tool"] == "dopt_torch.analysis.lint" and not doc["clean"]
    assert doc["findings"][0]["rule"] == "wallclock"


# -- eligibility ---------------------------------------------------------
_SYNTH = '''
class Config:
    def __init__(self, a, b):
        if a and b:
            raise ValueError(
                f"feature a={a} does not compose with feature b "
                "(pick one) — drop one of the two")
        if a < 0:
            raise ValueError("a must be >= 0")

def run(x):
    if x is None:
        raise ValueError("x required at call time")
'''


def test_eligibility_harvest_and_classification(tmp_path):
    mod = tmp_path / "synth.py"
    mod.write_text(_SYNTH)
    art = harvest([str(mod)])
    assert art["counts"] == {"sites": 3, "construction": 2,
                             "composition": 1}
    comp = [s for s in art["sites"] if s["composition"]]
    assert comp[0]["scope"] == "Config.__init__" and comp[0]["construction"]
    assert comp[0]["guard"] == "a and b"
    assert "{}" in comp[0]["message"]
    runtime = [s for s in art["sites"] if s["scope"] == "run"]
    assert runtime and not runtime[0]["construction"]
    assert art == dopt_harvest([str(mod)])


def test_eligibility_doc_table_roundtrip(tmp_path):
    mod = tmp_path / "synth.py"
    mod.write_text(_SYNTH)
    art = harvest([str(mod)])
    doc = (f"intro\n<!-- eligibility-matrix:begin -->\n"
           f"{render_doc_table(art)}\n<!-- eligibility-matrix:end -->\n")
    keys = parse_doc_rows(doc)
    assert keys == [doc_key(s) for s in art["sites"] if s["composition"]]
    assert cross_check(art, art, keys, "art.json", "doc.md") == []


def test_eligibility_detects_both_drift_directions(tmp_path):
    mod = tmp_path / "synth.py"
    mod.write_text(_SYNTH)
    art = harvest([str(mod)])
    keys = [doc_key(s) for s in art["sites"] if s["composition"]]
    mod.write_text(_SYNTH + '''
class Late:
    def __init__(self, c, d):
        if c and d:
            raise ValueError("feature c is incompatible with feature d")
''')
    f = cross_check(harvest([str(mod)]), art, keys, "art.json", "doc.md")
    assert "artifact-stale" in _rules(f) and "code-without-doc" in _rules(f)
    f = cross_check(art, art, keys + ["vanished feature pair"],
                    "art.json", "doc.md")
    assert _rules(f) == ["doc-without-code"]


def test_site_key_ignores_line_drift(tmp_path):
    mod = tmp_path / "synth.py"
    mod.write_text(_SYNTH)
    a = harvest([str(mod)])
    mod.write_text("# shifted\n\n" + _SYNTH)
    b = harvest([str(mod)])
    assert [site_key(s) for s in a["sites"]] == \
        [site_key(s) for s in b["sites"]]
    assert [s["line"] for s in a["sites"]] != [s["line"] for s in b["sites"]]


def test_committed_eligibility_artifacts_in_sync(monkeypatch, capsys):
    """dopt_torch/analysis/eligibility.json and dopt_torch/ELIGIBILITY.md
    match the tree (the gate, in-process)."""
    from dopt_torch.analysis.eligibility import main

    monkeypatch.chdir(REPO)
    assert main(["--json"]) == EXIT_CLEAN
    doc = json.loads(capsys.readouterr().out)
    assert doc["clean"] and doc["counts"]["composition"] >= 30


def test_composition_rejections_equal_dopts_by_message_key(monkeypatch):
    """The port refuses dopt's compositions in dopt's words: the two
    harvests' composition keys are the same set.  One count differs:
    dopt raises the serve-membership × population refusal in each engine
    (gossip.py:123, federated.py:86), the port in one function both
    engines call (``refuse_membership_population``)."""
    monkeypatch.chdir(REPO)

    def keys(art):
        return Counter(doc_key(s) for s in art["sites"] if s["composition"])

    port, dopt = keys(harvest()), keys(dopt_harvest())
    assert set(port) == set(dopt), (set(port) ^ set(dopt))
    shared = ("the serve membership overlay does not compose with the "
              "client")
    assert {k: (dopt[k], port[k]) for k in dopt if dopt[k] != port[k]} == {
        shared: (2, 1)}


# -- fingerprint ---------------------------------------------------------
@pytest.fixture(scope="module")
def b1_fingerprint():
    from dopt_torch.analysis.fingerprint import (canonical_matrix,
                                                 compute_fingerprints)

    return compute_fingerprints({"baseline1-tiny":
                                 canonical_matrix()["baseline1-tiny"]})


def test_fingerprint_unchanged_tree_green(b1_fingerprint):
    from dopt_torch.analysis.fingerprint import (canonical_matrix,
                                                 compute_fingerprints, diff)

    again = compute_fingerprints({"baseline1-tiny":
                                  canonical_matrix()["baseline1-tiny"]})
    assert again == b1_fingerprint
    assert diff(again, b1_fingerprint, "reg.json") == []


@pytest.mark.parametrize("flip", ["lr", "clip_norm", "fused_update"])
def test_fingerprint_catches_default_knob_flip(b1_fingerprint, flip):
    """A copy of the canonical config with one knob flipped: dopt's
    doubled learning rate (a changed constant), a clip norm (new ops),
    kernel 1's switch (another update op) — the gate fails."""
    from dopt_torch.analysis.fingerprint import (canonical_matrix,
                                                 compute_fingerprints, diff)

    base = canonical_matrix()["baseline1-tiny"]

    def sabotaged():
        cfg = base()
        value = {"lr": cfg.optim.lr * 2, "clip_norm": 1.0,
                 "fused_update": True}[flip]
        return cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                     **{flip: value}))

    findings = diff(compute_fingerprints({"baseline1-tiny": sabotaged}),
                    b1_fingerprint, "reg.json")
    assert _rules(findings) == ["fingerprint-mismatch"]
    assert "DEFAULT round program changed" in findings[0].message


def test_fingerprint_registry_env_gating(b1_fingerprint, tmp_path,
                                         monkeypatch, capsys):
    """Against a same-env registry the CLI compares (clean); with an env
    mismatch it skips (exit 0) unless --strict; a partial bless under a
    foreign env is refused."""
    from dopt_torch.analysis.fingerprint import (current_env, main,
                                                 write_registry)

    reg = tmp_path / "reg.json"
    monkeypatch.chdir(REPO)
    write_registry(reg, b1_fingerprint, current_env(), "test bless")
    assert main(["baseline1-tiny", "--registry", str(reg)]) == EXIT_CLEAN
    write_registry(reg, b1_fingerprint,
                   {"torch": "0.0.0", "device": "none", "threads": 0},
                   "stale env")
    capsys.readouterr()
    assert main(["baseline1-tiny", "--registry", str(reg),
                 "--json"]) == EXIT_CLEAN
    assert json.loads(capsys.readouterr().out)["status"] == "skipped"
    assert main(["baseline1-tiny", "--registry", str(reg)]) == EXIT_CLEAN
    out = capsys.readouterr().out
    assert "SKIPPED" in out and "environment mismatch" in out
    assert main(["baseline1-tiny", "--registry", str(reg),
                 "--strict"]) == EXIT_FINDINGS
    assert main(["baseline1-tiny", "--bless", "--reason", "x",
                 "--registry", str(reg)]) == EXIT_USAGE


def test_fingerprint_bless_requires_reason(capsys):
    from dopt_torch.analysis.fingerprint import main

    assert main(["--bless"]) == EXIT_USAGE
    assert main(["--bless", "--reason", "  "]) == EXIT_USAGE


def test_fingerprint_stream_holds_no_values_or_addresses():
    """The canonical op line: overload, argument dtypes and shapes and
    scalars; two tensors of one shape and different values, and objects
    whose repr holds an address, give the same line."""
    import torch

    from dopt_torch.analysis.fingerprint import op_stream

    def ops(seed):
        g = torch.Generator().manual_seed(seed)
        a = torch.rand(3, 4, generator=g)
        return op_stream(lambda: (a * 2.5).sum(1).normal_(generator=g))

    assert ops(0) == ops(1)
    assert ops(0)[0] == ("aten.mul.Tensor(float32[3, 4],2.5;)"
                         "->float32[3, 4]")
    assert "0x" not in "".join(ops(0)) and "Generator" in ops(0)[-1]


def test_committed_registry_is_the_port_matrix():
    """The committed registry holds the three canonical programs of both
    engines, blessed on the CPU with a reason."""
    from dopt_torch.analysis.fingerprint import (DEFAULT_REGISTRY,
                                                 canonical_matrix,
                                                 load_registry)

    reg = load_registry(REPO / DEFAULT_REGISTRY)
    assert set(reg["fingerprints"]) == set(canonical_matrix())
    assert reg["env"]["device"] == "cpu" and reg["bless"]["reason"]
    assert {(v["engine"], v["fn"]) for v in reg["fingerprints"].values()} \
        == {("gossip", "round"), ("federated", "full"),
            ("federated", "compact")}


# -- shared conventions ------------------------------------------------
def test_parse_pragmas_extracts_rule_and_justification():
    src = ("x = 1  # dopt: allow-wallclock -- because telemetry\n"
           "y = 2  # dopt: allow-unseeded-rng\n")
    pragmas = parse_pragmas(src)
    assert pragmas[1][0].rule == "wallclock"
    assert pragmas[1][0].justification == "because telemetry"
    assert pragmas[2][0].justification is None


def test_obs_check_json_convention(tmp_path, capsys):
    """dopt_torch.obs.check speaks the analysis CLIs' --json and
    exit-code contract."""
    from dopt_torch.obs.check import main

    good = tmp_path / "ok.jsonl"
    good.write_text(
        '{"v": 1, "kind": "run", "ts": 1.0, "engine": "gossip", '
        '"name": "x", "round": 0, "workers": 2}\n'
        '{"v": 1, "kind": "round", "ts": 2.0, "engine": "gossip", '
        '"round": 0, "metrics": {"loss": 1.5}}\n')
    assert main([str(good), "--json"]) == EXIT_CLEAN
    doc = json.loads(capsys.readouterr().out)
    assert doc["tool"] == "dopt_torch.obs.check" and doc["clean"]
    assert doc["files"][0]["ok"]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 1, "kind": "nope", "ts": 1.0}\n')
    assert main([str(bad), "--json"]) == EXIT_FINDINGS
    doc = json.loads(capsys.readouterr().out)
    assert not doc["clean"] and not doc["files"][0]["ok"]
