"""The port's stream tools, ledger, wire probe and schedule diagnostics
against dopt's, on the CPU.

* diff: ``first_divergence`` and ``diverge_canonical`` of both packages
  give equal reports on equal, truncated and seeded-divergent streams
  (events drawn from a numpy seed), both CLIs' ``--json`` reports are
  equal apart from their ``tool`` field, with equal exit codes; the
  port's own per-round and blocked streams of a tiny gossip run have no
  divergence.
* regress: dopt's cases (tests/test_monitor.py, tests/test_diagnostics.py)
  over ledgers written by each package: the files are equal byte for
  byte, ``check_regression`` results are equal, and both CLIs print the
  same report over the committed ``results/bench_history.jsonl``.
* watch: ``--once`` renders the same screen from both packages over the
  same stream or fleet dir, apart from the tool's name, with the same
  exit code.
* comm_bytes: ``python -m dopt_torch.analysis.comm_bytes`` (4 gloo
  ranks, dopt's defaults) against dopt's ``measure_comm_bytes`` run here
  on 4 of the suite's devices: its plan fields, its bytes by op and
  dtype (with the metrics' stated offsets) and ``wire_compression``
  within 1%; at 2 ranks, the figures chip_smoke.py phase 20d holds the
  card to.
* ``MixingMatrices``' diagnostics equal dopt's within 1e-12 on every
  topology and mode; ``run.build_trainer`` picks dopt's class.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import dopt.config as J
import dopt.obs.diff as jdiff
import dopt.obs.regress as jreg
import dopt.obs.watch as jwatch
import dopt.topology as JT
import dopt_torch.config as T
import dopt_torch.obs.diff as tdiff
import dopt_torch.obs.regress as treg
import dopt_torch.obs.watch as twatch
import dopt_torch.topology as TT
from dopt.obs import HealthMonitor as JHealthMonitor
from dopt.obs import make_event
from dopt_torch.engine import GossipTrainer
from dopt_torch.obs import MemorySink, Telemetry, attach

REPO = Path(__file__).resolve().parent.parent
LEDGER = REPO / "results" / "bench_history.jsonl"


def _write(path: Path, events) -> Path:
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    return path


def _stream(seed: int, rounds: int = 6) -> list[dict]:
    """A run header, then per round: fault rows, gauges and the round
    event, their values drawn from ``seed``; wall-clock ``ts`` too (the
    canonical form drops it)."""
    rng = np.random.default_rng(seed)
    evs = [make_event("run", engine="gossip", name="t", round=0, workers=8)]
    for t in range(rounds):
        for _ in range(int(rng.integers(0, 3))):
            evs.append(make_event("fault", round=t,
                                  worker=int(rng.integers(0, 8)),
                                  fault="crash", action="skipped"))
        for name in ("participating_lanes", "consensus_distance"):
            evs.append(make_event("gauge", round=t, name=name,
                                  value=float(rng.random()),
                                  engine="gossip"))
        evs.append(make_event("round", round=t, engine="gossip", metrics={
            "avg_train_loss": float(rng.random())}))
        evs.append(make_event("latency", round=t, name="boundary_tick",
                              seconds=float(rng.random())))
    return evs


def _mutated(evs, index_of_kind: str, nth: int) -> list[dict]:
    out = json.loads(json.dumps(evs))
    hits = [e for e in out if e["kind"] == index_of_kind]
    ev = hits[nth]
    if ev["kind"] == "gauge":
        ev["value"] += 1.0
    else:
        ev["metrics"]["avg_train_loss"] += 1.0
    return out


def _pairs(seed):
    a = _stream(seed)
    return {"equal": (a, _stream(seed)),
            "truncated-b": (a, a[:-4]),
            "truncated-a": (a[:-7], a),
            "gauge": (a, _mutated(a, "gauge", 5)),
            "round": (a, _mutated(a, "round", 3)),
            "other-seed": (a, _stream(seed + 1))}


# -------------------------------------------------------------------- diff
@pytest.mark.parametrize("case", ["equal", "truncated-b", "truncated-a",
                                  "gauge", "round", "other-seed"])
def test_first_divergence_equals_dopts(case):
    a, b = _pairs(7)[case]
    want = jdiff.first_divergence(a, b)
    assert tdiff.first_divergence(a, b) == want
    assert (want is None) == (case == "equal")
    from dopt.obs import canonical as jcanon
    from dopt_torch.obs import canonical as tcanon

    assert tcanon(a) == jcanon(a)
    assert tdiff.diverge_canonical(tcanon(a), tcanon(b)) == want


@pytest.mark.parametrize("flags", [[], ["--json"], ["--all-kinds", "--json"],
                                   ["--kinds", "round", "--json"],
                                   ["--kinds", "gauge,fault", "--json"]])
@pytest.mark.parametrize("case", ["equal", "truncated-b", "gauge"])
def test_diff_cli_equals_dopts(case, flags, tmp_path, capsys):
    a, b = _pairs(3)[case]
    pa, pb = _write(tmp_path / "a.jsonl", a), _write(tmp_path / "b.jsonl", b)
    args = [str(pa), str(pb), *flags]
    rj = jdiff.main(args)
    oj = capsys.readouterr()
    rt = tdiff.main(args)
    ot = capsys.readouterr()
    assert rt == rj
    if "--kinds" not in flags:
        assert rj == (0 if case == "equal" else 1)
    if "--json" in flags:
        want, got = json.loads(oj.out), json.loads(ot.out)
        assert want.pop("tool") == "dopt.obs.diff"
        assert got.pop("tool") == "dopt_torch.obs.diff"
        assert got == want
    else:
        assert (ot.out, ot.err) == (oj.out, oj.err)


def test_diff_cli_unreadable_and_usage(tmp_path, capsys):
    a = _write(tmp_path / "a.jsonl", _stream(1))
    missing = str(tmp_path / "nope.jsonl")
    assert tdiff.main([str(a), missing, "--json"]) == jdiff.main(
        [str(a), missing, "--json"]) == 1
    capsys.readouterr()
    for mod in (tdiff, jdiff):
        with pytest.raises(SystemExit) as e:
            mod.main([str(a), str(a), "--kinds", "nonsense"])
        assert e.value.code == 2


def _tiny_gossip():
    return T.ExperimentConfig(
        name="tools-gossip", seed=3,
        data=T.DataConfig(dataset="synthetic", num_users=4, iid=True,
                          synthetic_train_size=128,
                          synthetic_test_size=32),
        model=T.ModelConfig(model="mlp", input_shape=(28, 28, 1),
                            faithful=False),
        optim=T.OptimizerConfig(lr=0.1, momentum=0.5),
        gossip=T.GossipConfig(algorithm="dsgd", topology="circle",
                              mode="metropolis", rounds=4, local_ep=1,
                              local_bs=32, diagnostics="on"),
        faults=T.FaultConfig(crash=0.2, straggle=0.2, straggle_frac=0.5))


def _run_stream(block: int) -> list[dict]:
    tr = GossipTrainer(_tiny_gossip(), device="cpu")
    mem = MemorySink()
    attach(tr, Telemetry([mem]), fresh=True)
    tr.run(rounds=4, block=block)
    return mem.events


def test_port_streams_per_round_and_blocked_do_not_diverge():
    from dopt_torch.obs import first_divergence

    per, blk = _run_stream(1), _run_stream(2)
    assert any(e["kind"] == "gauge" for e in per)
    assert first_divergence(per, blk) is None
    bad = _mutated(blk, "gauge", 2)
    div = first_divergence(per, bad)
    want = [e for e in per if e["kind"] == "gauge"][2]
    assert (div["kind"], div["round"]) == ("gauge", want["round"])
    assert div["a"]["value"] + 1.0 == div["b"]["value"]


# ----------------------------------------------------------------- regress
def _ledgers(tmp_path, values, extra=None, tail=None, name="h"):
    """The same ledger written by each package's ``append_entry``:
    ``values`` as runs r0.., then ``tail`` (a list of (headline,
    run_id))."""
    paths = []
    for tag, mod in (("j", jreg), ("t", treg)):
        p = tmp_path / f"{name}-{tag}.jsonl"
        for i, v in enumerate(values):
            head = {"metric": "m", "value": v, "unit": "rounds/sec",
                    "device_kind": "cpu", **(extra or {})}
            mod.append_entry(p, head, run_id=f"r{i}", sha="0" * 40,
                             ts=1000.0 + i)
        for j, (head, rid) in enumerate(tail or ()):
            mod.append_entry(p, head, run_id=rid, sha="0" * 40,
                             ts=2000.0 + j)
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    return paths


REGRESS_CASES = {
    "slowdown-20pct": ([2.0] * 5, None,
                       [({"metric": "m", "value": 1.6, "device_kind": "cpu"},
                         "slow")], "regression"),
    "in-band": ([2.0] * 5, None,
                [({"metric": "m", "value": 1.94, "device_kind": "cpu"},
                  "ok")], "ok"),
    "improvement": ([2.0] * 5, None,
                    [({"metric": "m", "value": 3.0, "device_kind": "cpu"},
                      "fast")], "ok"),
    "widened-band": ([1.6, 2.0, 1.7, 2.2, 2.1], None,
                     [({"metric": "m", "value": 1.8, "device_kind": "cpu"},
                       "wobble")], "ok"),
    "other-device": ([2.0] * 5, None,
                     [({"metric": "m", "value": 0.1,
                        "device_kind": "NVIDIA H100 80GB HBM3"}, "h100")],
                     "no_baseline"),
    "lower-is-better": ([2.0] * 5, {"host_gap_pct": 5.0},
                        [({"metric": "m", "value": 2.0, "host_gap_pct": 25.0,
                           "device_kind": "cpu"}, "gap")], "regression"),
    "first-seen-metric": ([2.0] * 5, None,
                          [({"metric": "m", "value": 2.0, "fused_speedup": 1.2,
                             "device_kind": "cpu"}, "new")], "ok"),
}


@pytest.mark.parametrize("case", sorted(REGRESS_CASES))
def test_check_regression_equals_dopts(case, tmp_path):
    values, extra, tail, status = REGRESS_CASES[case]
    pj, pt = _ledgers(tmp_path, values, extra, tail)
    want = jreg.check_regression(jreg.read_ledger(pj))
    got = treg.check_regression(treg.read_ledger(pt))
    assert got == want and got["status"] == status
    assert treg.format_report(got) == jreg.format_report(want)


def test_ledger_dedupe_multi_metric_and_torn_line(tmp_path):
    paths = []
    for tag, mod in (("j", jreg), ("t", treg)):
        p = tmp_path / f"l-{tag}.jsonl"
        for i, (metric, v, rid) in enumerate([
                ("m", 1.0, "r1"), ("m", 2.0, "r2"), ("m", 9.0, "r1"),
                ("gossip", 2.0, "r7"), ("seqlm", 900.0, "r7"),
                ("seqlm", 950.0, "r7")]):
            mod.append_entry(p, {"metric": metric, "value": v},
                             run_id=rid, sha="s", ts=float(i))
        with open(p, "a") as f:
            f.write('{"bench": {"metric": "m", "va')
        mod.append_entry(p, {"metric": "m", "value": 3.0}, run_id="r3",
                         sha="s", ts=9.0)
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    got = [(e["run_id"], e["bench"]["metric"], e["bench"]["value"])
           for e in treg.read_ledger(paths[1])]
    assert got == [("r2", "m", 2.0), ("r1", "m", 9.0), ("r7", "gossip", 2.0),
                   ("r7", "seqlm", 950.0), ("r3", "m", 3.0)]


def test_regress_cli_on_committed_ledger(tmp_path, capsys):
    entries = treg.read_ledger(LEDGER)
    assert entries == jreg.read_ledger(LEDGER)
    headline = [e for e in entries if e["bench"]["metric"]
                == "gossip_rounds_per_sec_dsgd_mnist_6workers_model1_bf16"]
    from dopt_torch.utils.metrics import trimmed_stats

    slow = dict(headline[-1]["bench"])
    slow["value"] = round(0.8 * trimmed_stats(
        [e["bench"]["value"] for e in headline])[0], 4)
    cand = tmp_path / "cand.json"
    cand.write_text(json.dumps(treg.make_entry(slow, run_id="synthetic-20")))
    for args in ([str(LEDGER)],
                 [str(LEDGER), "--candidate", str(cand)],
                 [str(LEDGER), "--candidate", str(cand), "--advisory"],
                 [str(LEDGER), "--window", "3", "--min-band", "1"],
                 [str(tmp_path / "missing.jsonl")]):
        rj = jreg.main(args + ["--json", str(tmp_path / "j.json")])
        oj = capsys.readouterr()
        rt = treg.main(args + ["--json", str(tmp_path / "t.json")])
        ot = capsys.readouterr()
        assert rt == rj and ot.out == oj.out, args
        assert ot.err.replace("dopt_torch", "dopt") == oj.err
        if rj != 2:
            assert json.loads((tmp_path / "t.json").read_text()) == \
                json.loads((tmp_path / "j.json").read_text())
    assert rj == 2 and rt == 2


def test_card_entries_never_judged_against_tpu_rows(tmp_path):
    """A port entry keyed by the card's name: no baseline against the
    committed TPU rows, then a verdict once three card entries exist."""
    led = tmp_path / "ledger.jsonl"
    led.write_bytes(LEDGER.read_bytes())
    metric = "gossip_rounds_per_sec_dsgd_mnist_6workers_model1_bf16"
    card = "NVIDIA H100 80GB HBM3"
    for i, v in enumerate((0.52, 0.53, 0.51)):
        treg.append_entry(led, {"metric": metric, "value": v,
                                "device_kind": card}, run_id=f"c{i}",
                          sha=None, ts=float(i))
        res = treg.check_regression(treg.read_ledger(led))
        assert res["status"] == "no_baseline" and res["n_baseline"] == i
        assert res["key"] == [metric, card]
    treg.append_entry(led, {"metric": metric, "value": 0.8 * 0.52,
                            "device_kind": card}, run_id="slow", sha=None,
                      ts=9.0)
    res = treg.check_regression(treg.read_ledger(led))
    assert res["status"] == "regression"
    assert res["checks"][0]["n_baseline"] == 3


# ------------------------------------------------------------------- watch
def _clean(n):
    evs = [make_event("run", engine="gossip", name="synthetic", round=0,
                      workers=8)]
    return evs + [make_event("round", round=t, engine="gossip",
                             metrics={"avg_train_loss": 0.5 - 0.01 * t})
                  for t in range(n)]


def _diverging(n=12, at=8):
    evs = [make_event("run", engine="gossip", name="synthetic", round=0,
                      workers=8)]
    return evs + [make_event("round", round=t, engine="gossip", metrics={
        "avg_train_loss": 0.5 if t < at else 100.0 * (t - at + 1)})
        for t in range(n)]


def _watch_streams():
    embedded = JHealthMonitor().feed(_diverging())
    return {
        "clean": _clean(5) + [
            make_event("gauge", round=4, name="quarantine_active",
                       value=2.0, engine="gossip"),
            make_event("fault", round=4, worker=0, fault="straggle",
                       action="skipped"),
            make_event("resource", round=4, engine="gossip",
                       live_bytes=1 << 30, peak_bytes=2 << 30,
                       source="device"),
            make_event("compile", round=4, fn="round", count=1, total=1,
                       seconds=0.2)],
        "diverging": _clean(5) + _diverging(),
        "embedded-alert": _clean(4) + [make_event(
            "alert", round=3, rule="custom_slo", severity="critical",
            message="producer-side rule fired")],
        "rederived-alerts": _diverging() + embedded,
    }


def _same_screen(jmain, tmain, args, capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 2e9)
    rj = jmain(args)
    oj = capsys.readouterr().out
    rt = tmain(args)
    ot = capsys.readouterr().out
    assert rt == rj
    assert ot == oj.replace("dopt watch", "dopt_torch watch").replace(
        "dopt fleet watch", "dopt_torch fleet watch")
    return rt, ot


@pytest.mark.parametrize("case", ["clean", "diverging", "embedded-alert",
                                  "rederived-alerts"])
@pytest.mark.parametrize("gauges", [None, "quarantine_active"])
def test_watch_once_equals_dopts(case, gauges, tmp_path, capsys,
                                 monkeypatch):
    p = _write(tmp_path / "m.jsonl", _watch_streams()[case])
    args = [str(p), "--once"] + (["--gauges", gauges] if gauges else [])
    rc, out = _same_screen(jwatch.main, twatch.main, args, capsys,
                           monkeypatch)
    assert rc == (0 if case == "clean" else 1)
    if case == "clean":
        assert "round 4" in out and "HEALTHY" in out
        assert "quarantine_active=2" in out and "straggle=1" in out
    if case == "rederived-alerts":
        assert "(1 alerts" in out and out.count("ALERT") == 1


def _fleet(tmp_path, mutate=None):
    hdr = make_event("run", engine="gossip", name="t", round=0, workers=8)

    def bundle(t, latency):
        return [make_event("gauge", round=t, name="participating_lanes",
                           value=8.0, engine="gossip"),
                make_event("round", round=t, engine="gossip",
                           metrics={"avg_train_loss": 1.0 - 0.01 * t}),
                make_event("latency", round=t, name="boundary_tick",
                           seconds=latency)]
    a = [hdr] + [e for t in range(5) for e in bundle(t, 0.01)]
    b = [hdr] + [e for t in range(5) for e in bundle(t, 0.03)]
    if mutate is not None:
        mutate(b)
    _write(tmp_path / "metrics.jsonl", a)
    _write(tmp_path / "metrics-p1.jsonl", b)
    (tmp_path / "serve.json").write_text(json.dumps(
        {"status": "serving", "admin_port": 12345, "num_processes": 2}))
    return tmp_path


def _alert(b):
    b.append(make_event("alert", round=4, rule="drop_rate", severity="warn",
                        message="x"))


def _diverge(b):
    for e in b:
        if e["kind"] == "round" and e["round"] == 3:
            e["metrics"]["avg_train_loss"] = 9.0


@pytest.mark.parametrize("case", ["consistent", "alert", "diverged"])
def test_watch_fleet_once_equals_dopts(case, tmp_path, capsys, monkeypatch):
    d = _fleet(tmp_path, {"consistent": None, "alert": _alert,
                          "diverged": _diverge}[case])
    rc, out = _same_screen(jwatch.main, twatch.main,
                           ["--state-dir", str(d), "--once"], capsys,
                           monkeypatch)
    assert rc == (1 if case == "diverged" else 0)
    assert "p0" in out and "p1" in out and "admin :12345" in out
    if case == "alert":
        assert "ALERT [warn] p1 drop_rate @ round 4" in out


# -------------------------------------------------------------- comm_bytes
# Where the two wires part, and why.  The port gathers each round's
# per-lane metrics (8 f32 a lane, 8 lanes) with the wire's all-gather:
# 256 f32 bytes more under all-gather in every mode.  dopt's round
# programs sum their metrics with one 16-byte f32 all-reduce instead,
# which the port does not make.
METRICS_GATHER = 256
METRICS_ALL_REDUCE = 16
OFFSET = {"all-gather": METRICS_GATHER, "all-reduce": -METRICS_ALL_REDUCE}
HLO_OPS = ("all-gather", "all-reduce", "reduce-scatter",
           "collective-permute", "all-to-all")


def _start_comm_runs() -> dict:
    """The CLI on gloo CPU ranks at 4 (dopt's defaults) and at 2
    (chip_smoke.py's phase 20d), started at once."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return {r: subprocess.Popen(
        [sys.executable, "-m", "dopt_torch.analysis.comm_bytes", "--ranks",
         str(r), "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (4, 2)}


def _comm_results(procs: dict) -> dict:
    """Each run's JSON object, under its own timeout; a run still going
    when this returns or raises is killed."""
    out = {}
    try:
        for r, p in procs.items():
            so, se = p.communicate(timeout=240)
            assert p.returncode == 0, se[-3000:]
            out[r] = json.loads(so.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _dopt_comm_bytes(monkeypatch) -> dict:
    """dopt's ``measure_comm_bytes`` at its CLI's defaults: 4 forced CPU
    devices, so its mesh is cut to 4 of the suite's 8."""
    import dopt.analysis.comm_bytes as JB

    cfg = JB.comm_modes_config
    monkeypatch.setattr(JB, "comm_modes_config", lambda *a, **k: (
        dataclasses.replace(cfg(*a, **k), mesh_devices=4)))
    return JB.measure_comm_bytes()


def test_comm_bytes_cli_equals_dopts(devices, monkeypatch):
    """One run of the CLI at 4 gloo ranks against dopt's compiled-HLO
    figures on the same inputs, and at 2 against chip_smoke.py's (which
    phase 20d holds the card to)."""
    from chip_smoke import WIRE_2_RANKS

    procs = _start_comm_runs()
    try:
        want = _dopt_comm_bytes(monkeypatch)
    finally:
        runs = _comm_results(procs)
    got = runs[4]
    assert (got["ranks"], got["backend"]) == (4, "gloo")
    # The plan: equal to dopt's.
    for k in ("budget_bytes", "plan_kinds", "plan_chunk", "plan_dense_bytes",
              "plan_wire_bytes", "plan_compression"):
        assert got[k] == want[k], k
    for mode in ("dense", "scatter", "codec"):
        g, w = got[mode], want[mode]
        # dopt's metrics sum, the one op the port lacks.
        assert w["by_op_dtype"]["all-reduce"] == {"f32": METRICS_ALL_REDUCE}
        for op in HLO_OPS:
            assert g[op] == w[op] + OFFSET.get(op, 0), (mode, op)
        assert g["total"] == w["total"] + METRICS_GATHER - METRICS_ALL_REDUCE
        # The dtype split: dopt's, with the metrics' f32 moved from its
        # all-reduce to the all-gather.
        split = {op: dict(d) for op, d in w["by_op_dtype"].items()
                 if op != "all-reduce"}
        gather = split.setdefault("all-gather", {})
        gather["f32"] = gather.get("f32", 0) + METRICS_GATHER
        assert g["by_op_dtype"] == split, mode
        assert g["by_kind"]["all_gather/metrics"] == METRICS_GATHER
    # The payloads alone: dopt's all-gathers, u8 and f32, byte for byte;
    # the scatter leg's reduce-scatter is reported, not put in a ratio.
    assert (got["dense"]["by_kind"]["all_gather/dense"]
            == want["dense"]["by_op_dtype"]["all-gather"]["f32"])
    assert {k: got["codec"]["by_kind"][f"all_gather/{k}"]
            for k in ("q4", "q4-scale")} == {
        "q4": want["codec"]["by_op_dtype"]["all-gather"]["u8"],
        "q4-scale": want["codec"]["by_op_dtype"]["all-gather"]["f32"]}
    assert got["wire_compression"] == pytest.approx(want["wire_compression"],
                                                    rel=0.01)
    assert got["wire_compression"] == round(
        got["dense"]["total"] / got["codec"]["total"], 3)
    # 2 ranks: chip_smoke.py's figures; only the fold's pad differs.
    two = runs[2]
    assert (two["ranks"], two["device"]) == (2, "cpu")
    assert {k: two[k] for k in WIRE_2_RANKS} == WIRE_2_RANKS
    assert two["plan_dense_bytes"] + 8 == got["plan_dense_bytes"]
    assert (two["dense"], two["codec"]) == (got["dense"], got["codec"])


def test_comm_bytes_refuses_ranks_that_do_not_fold(capsys):
    from dopt_torch.analysis.comm_bytes import main

    with pytest.raises(SystemExit) as e:
        main(["--ranks", "3"])
    assert e.value.code == 2
    assert "8 workers do not fold onto 3 ranks" in capsys.readouterr().err


# --------------------------------------------- schedule diagnostics, engines
TOPOLOGIES = ("circle", "ring", "star", "complete", "compelete", "dynamic",
              "random", "torus", "hierarchical", "one_peer_exp")
MODES = ("stochastic", "double_stochastic", "ones", "metropolis", "uniform")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_schedule_diagnostics_equal_dopts(topology, mode):
    assert TT._TOPOLOGIES == JT._TOPOLOGIES == TOPOLOGIES
    assert TT._MODES == JT._MODES == MODES
    n = 8
    try:
        jm = JT.build_mixing_matrices(topology, mode, n, seed=5)
    except ValueError:
        # An infeasible schedule (the zero-diagonal star under Sinkhorn):
        # the port refuses it too.
        with pytest.raises(ValueError, match="Sinkhorn failed"):
            TT.build_mixing_matrices(topology, mode, n, seed=5)
        return
    tm = TT.build_mixing_matrices(topology, mode, n, seed=5)
    np.testing.assert_array_equal(tm.stacked(), jm.stacked())
    for tol in (1e-9, 1e-3):
        assert tm.is_row_stochastic(tol) == jm.is_row_stochastic(tol)
        assert tm.is_doubly_stochastic(tol) == jm.is_doubly_stochastic(tol)
    for kind in ("product", "mean"):
        assert abs(tm.spectral_gap(kind) - jm.spectral_gap(kind)) <= 1e-12
    with pytest.raises(ValueError) as te:
        tm.spectral_gap("median")
    with pytest.raises(ValueError) as je:
        jm.spectral_gap("median")
    assert str(te.value) == str(je.value)


def _engine_cfgs(mod):
    data = mod.DataConfig(dataset="synthetic", num_users=4, iid=True,
                          synthetic_train_size=64, synthetic_test_size=16)
    model = mod.ModelConfig(model="mlp", input_shape=(28, 28, 1),
                            faithful=False)
    return {
        "gossip": mod.ExperimentConfig(name="g", data=data, model=model,
                                       gossip=mod.GossipConfig(rounds=1)),
        "federated": mod.ExperimentConfig(
            name="f", data=data, model=model, gossip=None,
            federated=mod.FederatedConfig(rounds=1)),
    }


@pytest.mark.parametrize("engine", ["gossip", "federated", "seqlm"])
def test_build_trainer_picks_dopts_class(engine, monkeypatch):
    import dopt.engine
    from dopt.presets import get_preset as jpreset
    from dopt.run import build_trainer as jbuild
    from dopt_torch.presets import get_preset as tpreset
    from dopt_torch.run import build_trainer

    # dopt's pick, read off stand-ins for its engines (building them
    # compiles nothing the pick depends on).
    for name in ("GossipTrainer", "FederatedTrainer", "SeqLMTrainer"):
        monkeypatch.setattr(dopt.engine, name,
                            type(name, (), {"__init__": lambda s, c: None}))

    if engine == "seqlm":
        jc, tc = jpreset("seqlm"), tpreset("seqlm")
        jc = dataclasses.replace(jc, seqlm=dataclasses.replace(
            jc.seqlm, batch=1, seq_len=16, vocab=32, dim=16, depth=1,
            heads=2, steps=1), mesh_devices=1)
        tc = dataclasses.replace(tc, seqlm=dataclasses.replace(
            tc.seqlm, batch=1, seq_len=16, vocab=32, dim=16, depth=1,
            heads=2, steps=1))
    else:
        jc, tc = _engine_cfgs(J)[engine], _engine_cfgs(T)[engine]
        jc = dataclasses.replace(jc, mesh_devices=1)
    got = build_trainer(tc, device="cpu")
    assert type(got).__name__ == type(jbuild(jc)).__name__
    assert str(got.device) == "cpu"
    # backend="torch" picks the oracle (dopt_torch.engine.torch_backend)
    # under dopt's class name, or refuses seqlm in dopt's words.
    if engine == "seqlm":
        with pytest.raises(ValueError) as te:
            build_trainer(dataclasses.replace(tc, backend="torch"),
                          device="cpu")
        with pytest.raises(ValueError) as je:
            jbuild(dataclasses.replace(jc, backend="torch"))
        assert str(te.value) == str(je.value)
    else:
        got = build_trainer(dataclasses.replace(tc, backend="torch"),
                            device="cpu")
        want = jbuild(dataclasses.replace(jc, backend="torch"))
        assert type(got).__name__ == type(want).__name__
    with pytest.raises(ValueError) as te:
        build_trainer(dataclasses.replace(tc, backend="mxnet"))
    with pytest.raises(ValueError) as je:
        jbuild(dataclasses.replace(jc, backend="mxnet"))
    assert str(te.value) == str(je.value)
