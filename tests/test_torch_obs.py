"""The port's telemetry (dopt_torch.obs) against dopt's (dopt.obs).

* The schema: every event kind, and each of tests/test_obs.py's and
  tests/test_diagnostics.py's malformed events, is accepted or refused
  by both packages alike, with the same message.
* The sinks: the JSONL round trip, ``repair_tail`` and the resume
  watermark; the ring; the Prometheus text, equal to dopt's for the same
  events; the span export; the ``obs.check`` CLI; ``merge_resumed``.
* The engines' streams against dopt's per-round streams on the CPU, one
  config from dopt's init: the gossip push-sum cocktail and the
  federated chaos cocktail (tests/test_obs.py's configs, 3 rounds).
  The event kinds, their order, the rounds, the fault rows and the
  gauge names are equal exactly; round metrics within slice 1's limits
  (losses 1e-3, accuracies 1e-4 absolute), gauges within 1e-4 relative
  (the multi-round params bound), the host-mirror gauges exactly.
  (dopt's own federated blocked stream does not reproduce its per-round
  stream — ROADMAP queue 3 — so the port is held to dopt's per-round
  run, and the port's blocked stream to its own per-round stream, bit
  for bit.)
* Off path: a run with telemetry attached trains exactly as one
  without (History, ledger, params bit for bit), and a killed and
  resumed run streams one gapless JSONL file.
"""

from __future__ import annotations

import json
import math

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt.obs as jobs
import dopt_torch.config as T
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.obs import (JsonlSink, MemorySink, PrometheusSink,
                            SpanTracer, Telemetry, attach, canonical,
                            check_stream, make_event, validate_event)
from dopt_torch.utils.metrics import History
from dopt_torch.utils.profiling import PhaseTimers

ROUNDS = 3
LOSS_TOL, ACC_TOL, GAUGE_REL = 1e-3, 1e-4, 1e-4
# Gauges the host mirrors set: equal exactly.
HOST_GAUGES = {"quarantine_active", "screen_streak_max",
               "participating_lanes", "stale_pending", "stale_weight_total"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- the schema
GOOD = {
    "run": dict(engine="federated", name="x", round=0, workers=8),
    "round": dict(round=0, engine="federated",
                  metrics={"round": 0, "test_acc": 0.5, "note": "s",
                           "skipped": None}),
    "gauge": dict(round=0, name="quarantine_active", value=1.0),
    "fault": dict(round=0, worker=3, fault="crash",
                  action="dropped_from_round"),
    "fault-fleet": dict(round=0, worker=-1, fault="cohort",
                        action="sampled_64_of_1000"),
    "phase": dict(round=4, fractions={"conv": 0.5, "comm": 0.3,
                                      "update": 0.1, "other": 0.1}),
    "bench": dict(metrics={"value": 2.5, "unit": "rounds/sec",
                           "quick": True, "na": None}),
    "warning": dict(message="profiler reduction failed", source="x"),
    "alert": dict(round=2, rule="grad_explosion", severity="warn",
                  message="m", value=3.0),
    "checkpoint": dict(round=4, consensus_distance=0.5),
    "resource": dict(round=3, engine="gossip", live_bytes=1 << 20,
                     peak_bytes=2 << 20, source="device"),
    "compile": dict(round=0, fn="block_fn", count=1, total=2, seconds=0.5),
    "control": dict(round=1, cmd="config", key="optim.lr", value=0.1,
                    id="q1"),
    "latency": dict(round=1, name="checkpoint_save", seconds=0.2),
}


@pytest.mark.parametrize("case", sorted(GOOD))
def test_every_event_kind_validates_in_both(case):
    kind = case.split("-")[0]
    ev = make_event(kind, **GOOD[case])
    assert validate_event(ev) is ev
    jobs.validate_event(ev)
    want = jobs.make_event(kind, **GOOD[case])
    assert {k: v for k, v in ev.items() if k != "ts"} == {
        k: v for k, v in want.items() if k != "ts"}


BAD = [
    "not-an-object",
    {"v": 99, "kind": "round", "ts": 0.0},
    {"v": 1, "kind": "nope", "ts": 0.0},
    {"v": 1, "kind": "round", "ts": 0.0},
    {"v": 1, "kind": "round", "ts": 0.0, "round": 0, "engine": "g",
     "metrics": {"x": float("nan")}},
    {"v": 1, "kind": "gauge", "ts": 0.0, "round": 0, "name": "",
     "value": 1.0},
    {"v": 1, "kind": "fault", "ts": 0.0, "round": 0, "worker": -2,
     "fault": "crash", "action": "x"},
    {"v": 1, "kind": "phase", "ts": 0.0, "fractions": {"conv": 1.5}},
    # tests/test_diagnostics.py's resource and compile cases
    {"v": 1, "kind": "resource", "ts": 0.0, "round": 0},
    {"v": 1, "kind": "resource", "ts": 0.0, "round": 0,
     "peak_bytes": float("inf")},
    {"v": 1, "kind": "resource", "ts": 0.0, "round": 0, "peak_bytes": -1},
    {"v": 1, "kind": "compile", "ts": 0.0, "round": 0, "fn": "f",
     "count": 0, "seconds": 0.1},
    {"v": 1, "kind": "compile", "ts": 0.0, "round": 0, "fn": "",
     "count": 1, "seconds": 0.1},
    {"v": 1, "kind": "compile", "ts": 0.0, "round": 0, "fn": "f",
     "count": 1, "seconds": float("nan")},
]


@pytest.mark.parametrize("bad", BAD)
def test_malformed_events_rejected_alike(bad):
    with pytest.raises(ValueError) as want:
        jobs.validate_event(bad)
    with pytest.raises(ValueError) as got:
        validate_event(bad)
    assert str(got.value) == str(want.value)


def test_round_continuity_enforced():
    evs = [make_event("run", engine="g", name="x", round=0),
           make_event("round", round=0, engine="g", metrics={}),
           make_event("round", round=2, engine="g", metrics={})]
    with pytest.raises(ValueError, match="round sequence broken"):
        check_stream(evs)
    evs = [make_event("run", engine="g", name="x", round=0),
           make_event("round", round=0, engine="g", metrics={}),
           make_event("run", engine="f", name="y", round=0),
           make_event("round", round=0, engine="f", metrics={})]
    assert check_stream(evs)["segments"] == 2
    assert check_stream(evs) == jobs.check_stream(evs)


# --------------------------------------------------------------- the sinks
def test_jsonl_roundtrip_watermark_and_truncation(tmp_path):
    p = tmp_path / "m.jsonl"
    t = Telemetry.to_jsonl(p)
    t.emit("run", engine="g", name="x", round=0)
    t.emit_round_bundle(0, engine="g", metrics={"a": 1.0},
                        faults=[{"round": 0, "worker": 1, "kind": "crash",
                                 "action": "skipped_round"}],
                        gauges={"g1": 2.0})
    t.emit_round_bundle(1, engine="g", metrics={"a": 0.5})
    t.close()
    assert JsonlSink.scan_watermark(p) == 1
    assert JsonlSink.read(p) == jobs.JsonlSink.read(p)
    with open(p, "a") as f:
        f.write('{"v": 1, "kind": "round", "ro')
    evs = JsonlSink.read(p)
    assert [e["round"] for e in evs if e["kind"] == "round"] == [0, 1]
    t2 = Telemetry.to_jsonl(p, resume=True)
    assert t2.watermark == 2
    assert not t2.emit_round_bundle(1, engine="g", metrics={})
    assert t2.emit_round_bundle(2, engine="g", metrics={})
    t2.close()
    check_stream(JsonlSink.read(p))


@pytest.mark.parametrize("tear", ["orphaned_fault", "unterminated_line"])
def test_repair_tail_as_dopt(tear, tmp_path):
    """What a kill leaves, repaired by both packages to the same bytes:
    an orphaned fault line of an unsealed round and a torn round event
    (both dropped), or an event whose newline was torn (healed)."""
    p = tmp_path / "port.jsonl"
    t = Telemetry.to_jsonl(p)
    t.emit("run", engine="g", name="x", round=0)
    t.emit_round_bundle(0, engine="g", metrics={"a": 1.0},
                        faults=[{"round": 0, "worker": 1, "kind": "crash",
                                 "action": "skipped_round"}])
    t.close()
    if tear == "orphaned_fault":
        with open(p, "a") as f:
            f.write(json.dumps(make_event(
                "fault", round=1, worker=2, fault="crash",
                action="skipped_round")) + "\n")
            f.write('{"v": 1, "kind": "round", "ro')
    else:
        p.write_bytes(p.read_bytes()[:-1])
    files = [p, tmp_path / "dopt.jsonl"]
    files[1].write_bytes(p.read_bytes())
    JsonlSink.repair_tail(files[0])
    jobs.JsonlSink.repair_tail(files[1])
    assert files[0].read_bytes() == files[1].read_bytes()
    t2 = Telemetry.to_jsonl(files[0], resume=True)
    assert t2.watermark == 1
    t2.emit_round_bundle(1, engine="g", metrics={"a": 0.5})
    t2.close()
    merged = JsonlSink.read(files[0])
    check_stream(merged)
    assert [e["round"] for e in merged if e["kind"] == "round"] == [0, 1]
    assert len([e for e in merged if e["kind"] == "fault"]) == 1


def test_memory_ring_capacity():
    mem = MemorySink(capacity=3)
    for i in range(10):
        mem.emit(make_event("gauge", round=i, name="x", value=float(i)))
    assert len(mem) == 3 and [e["round"] for e in mem.events] == [7, 8, 9]


def _prometheus_events() -> list[dict]:
    evs = [make_event("round", round=0, engine="f",
                      metrics={"test_acc": 0.25, "round": 0, "s": "x"}),
           make_event("round", round=1, engine="f",
                      metrics={"test_acc": 0.75, "round": 1}),
           make_event("round", round=1, engine="g",
                      metrics={"avg_test_acc": 0.5}),
           make_event("gauge", round=1, name="host.gap-pct", value=2.0,
                      engine="f"),
           make_event("gauge", round=1, name="stale_pending", value=2.0,
                      engine="f"),
           make_event("resource", round=1, engine="g", live_bytes=10,
                      peak_bytes=20),
           make_event("compile", round=0, fn="block_fn", count=2, total=2,
                      seconds=0.5),
           make_event("alert", round=1, rule="r", severity="critical",
                      message="m")]
    evs += [make_event("fault", round=0, worker=i, fault=k, action="x")
            for i, k in enumerate(["crash", "crash", 'we"ird'])]
    evs += [make_event("latency", round=1, name="checkpoint_save",
                       seconds=s) for s in (0.0004, 0.2, 0.2, 500.0)]
    return evs


def test_prometheus_text_equals_dopts(tmp_path):
    ours, theirs = (PrometheusSink(tmp_path / "a.txt"),
                    jobs.PrometheusSink(tmp_path / "b.txt"))
    for ev in _prometheus_events():
        ours.emit(ev)
        theirs.emit(ev)
    assert ours.render() == theirs.render()
    assert 'dopt_test_acc{engine_kind="f"} 0.75' in ours.render()
    ours.close()
    theirs.close()
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def test_span_tracer_nesting_and_chrome_export(tmp_path):
    tr = SpanTracer()
    with tr.span("block"):
        with tr.span("eval"):
            pass
        with tr.span("checkpoint"):
            pass
    chrome = tr.to_chrome()
    assert [e["name"] for e in chrome] == ["block", "eval", "checkpoint"]
    for inner in chrome[1:]:
        assert chrome[0]["ts"] <= inner["ts"]
        assert (inner["ts"] + inner["dur"]
                <= chrome[0]["ts"] + chrome[0]["dur"] + 1e-3)
    payload = json.loads(tr.write_chrome(tmp_path / "t.json").read_text())
    assert len(payload["traceEvents"]) == 3
    assert set(tr.totals()) == {"block", "eval", "checkpoint"}


def test_phase_timers_tracer_hook():
    tr = SpanTracer()
    timers = PhaseTimers(tracer=tr)
    with timers.phase("host_batch_plan"):
        pass
    with timers.phase("round_step"):
        pass
    assert timers.counts["host_batch_plan"] == 1
    assert sorted(s["name"] for s in tr.spans) == ["host_batch_plan",
                                                   "round_step"]


def test_check_cli(tmp_path, capsys):
    from dopt_torch.obs.check import main

    good = tmp_path / "good.jsonl"
    t = Telemetry.to_jsonl(good)
    t.emit("run", engine="g", name="x", round=0)
    t.emit_round_bundle(0, engine="g", metrics={"a": 1.0},
                        gauges={"g": 1.0})
    t.close()
    assert main([str(good), "--summary"]) == 0
    assert "1 rounds, 1 segment(s)" in capsys.readouterr().out
    bad = tmp_path / "bad.jsonl"
    bad.write_text(good.read_text() + json.dumps(
        make_event("round", round=5, engine="g", metrics={})) + "\n")
    assert main([str(bad)]) == 1
    assert main([str(tmp_path / "absent.jsonl")]) == 1
    capsys.readouterr()
    assert main([str(good), str(bad), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert [f["ok"] for f in report["files"]] == [True, False]


def test_history_merge_resumed_watermark():
    h = History("m")
    h.append(round=0, loss=1.0)
    h.append(round=1, loss=0.9)
    resumed = [{"round": r, "loss": 1.0 - 0.1 * r} for r in range(4)]
    assert h.merge_resumed(resumed) == 2
    assert [r["round"] for r in h.rows] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="round gap"):
        h.merge_resumed([{"round": 6, "loss": 0.1}])
    with pytest.raises(ValueError, match="without an int"):
        h.merge_resumed([{"loss": 0.1}])


def test_attach_header_uses_trainer_round():
    class _Tr:
        round = 7
        engine_kind = "federated"
        num_workers = 4
        timers = PhaseTimers()

    mem = MemorySink()
    tele = attach(_Tr(), Telemetry([mem]))
    assert tele.watermark == 7
    tele.emit_round_bundle(7, engine="federated", metrics={"a": 1.0})
    check_stream(mem.events)
    assert [e["round"] for e in mem.events if e["kind"] == "run"] == [7]


# ------------------------------------------------ the engines' streams
_DATA = dict(dataset="synthetic", num_users=8, iid=True,
             synthetic_train_size=256, synthetic_test_size=64)


def _gossip_cfg(mod, **top):
    """tests/test_obs.py's gossip cocktail: push-sum with drops, delays,
    crash, stragglers and churn."""
    return mod.ExperimentConfig(
        name="obs-gossip", seed=11, data=mod.DataConfig(**_DATA),
        model=mod.ModelConfig(model="mlp", input_shape=(28, 28, 1),
                              faithful=False),
        optim=mod.OptimizerConfig(lr=0.1, momentum=0.5),
        gossip=mod.GossipConfig(algorithm="dsgd", topology="circle",
                                mode="metropolis", rounds=ROUNDS,
                                local_ep=1, local_bs=32,
                                correction="push_sum"),
        faults=mod.FaultConfig(crash=0.1, straggle=0.2, straggle_frac=0.5,
                               msg_drop=0.2, msg_delay=0.2, msg_delay_max=2,
                               churn=0.05, churn_span=2), **top)


def _fed_cfg(mod, **top):
    """tests/test_obs.py's federated cocktail: the staleness buffer,
    nan liars, a drop deadline, over-selection, delayed uplinks."""
    return mod.ExperimentConfig(
        name="obs-fed", seed=11, data=mod.DataConfig(**_DATA),
        model=mod.ModelConfig(model="mlp", input_shape=(28, 28, 1),
                              faithful=False),
        optim=mod.OptimizerConfig(lr=0.1, momentum=0.5),
        federated=mod.FederatedConfig(algorithm="fedavg", frac=0.5,
                                      rounds=ROUNDS, local_ep=1,
                                      local_bs=32, staleness_max=2,
                                      staleness_decay=0.5),
        faults=mod.FaultConfig(crash=0.1, straggle=0.4, straggle_frac=0.5,
                               straggler_policy="drop", over_select=0.3,
                               corrupt=0.2, corrupt_mode="nan",
                               msg_delay=0.2, msg_delay_max=2), **top)


CASES = {"gossip": (_gossip_cfg, JaxGossipTrainer, GossipTrainer),
         "federated": (_fed_cfg, JaxFederatedTrainer, FederatedTrainer)}


def _close_streams(want: list, got: list, gauge_rel: float) -> None:
    """Canonical streams: kinds, order, rounds, fault rows and gauge
    names equal; metric values within slice 1's limits, gauge values
    within ``gauge_rel`` (the host-mirror gauges exactly)."""
    want, got = canonical(want), canonical(got)
    assert [(e["kind"], e["round"]) for e in got] == [
        (e["kind"], e["round"]) for e in want]
    for a, b in zip(want, got):
        if a["kind"] == "fault":
            assert a == b
        elif a["kind"] == "gauge":
            assert (a["name"], a["engine"]) == (b["name"], b["engine"])
            tol = 0.0 if a["name"] in HOST_GAUGES else gauge_rel
            assert abs(a["value"] - b["value"]) <= tol * max(
                abs(a["value"]), 1e-3), (a, b)
        else:
            assert a["metrics"].keys() == b["metrics"].keys()
            for k, v in a["metrics"].items():
                if isinstance(v, float) and math.isfinite(v):
                    tol = ACC_TOL if "acc" in k else LOSS_TOL
                    assert abs(v - b["metrics"][k]) <= tol, (k, a, b)
                else:
                    assert v == b["metrics"][k], k


def _streamed(tr, rounds=ROUNDS, **run):
    mem = MemorySink()
    attach(tr, Telemetry([mem]), fresh=True)
    tr.run(rounds=rounds, **run)
    return mem.events


def _init(engine, jt):
    return jax.device_get(jt._theta_single() if engine == "federated"
                          else jax.tree.map(lambda x: x[0], jt.params))


@pytest.mark.parametrize("engine", sorted(CASES))
def test_stream_matches_dopts_per_round_stream(engine, devices):
    mk, jcls, tcls = CASES[engine]
    jt = jcls(mk(J, mesh_devices=1))
    tt = tcls(mk(T), device="cpu", init_params=_init(engine, jt))
    want, got = _streamed(jt), _streamed(tt)
    check_stream(got)
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    assert [e for e in got if e["kind"] == "run"][0]["engine"] == engine
    _close_streams(want, got, GAUGE_REL)
    assert any(e["kind"] == "fault" for e in got), "the cocktail drew none"
    names = {e["name"] for e in got if e["kind"] == "gauge"}
    assert {"quarantine_active", "consensus_distance"} <= names


@pytest.mark.parametrize("engine", sorted(CASES))
def test_blocked_stream_and_off_path(engine):
    """Blocked ≡ per-round streams (the federated cocktail runs the
    chaos round), and telemetry attached trains bit for bit as without."""
    mk, _, tcls = CASES[engine]
    per = tcls(mk(T), device="cpu")
    stream = _streamed(per)
    blk = tcls(mk(T), device="cpu")
    assert canonical(_streamed(blk, block=2)) == canonical(stream)
    plain = tcls(mk(T), device="cpu")
    plain.run(rounds=ROUNDS)
    for a, b in ((per, plain), (blk, plain)):
        assert a.history.rows == b.history.rows
        assert a.history.faults == b.history.faults
        wa, wb = a.worker_params(), b.worker_params()
        for k in wa:
            np.testing.assert_array_equal(wa[k], wb[k])


def test_kill_resume_stream_watermark(tmp_path):
    """The federated cocktail killed after round 1's checkpoint: the
    resumed run appends to the dead run's JSONL, the merged stream has
    every round once, passes ``obs.check``, and its rounds and faults
    equal the continuous stream's; the host phases are spans."""
    from dopt_torch.obs.check import main

    cont = FederatedTrainer(_fed_cfg(T), device="cpu")
    stream = _streamed(cont)
    mpath, ck = tmp_path / "m.jsonl", tmp_path / "ck"
    part = FederatedTrainer(_fed_cfg(T), device="cpu")
    t1 = Telemetry.to_jsonl(mpath)
    attach(part, t1)
    part.run(rounds=1, checkpoint_every=1, checkpoint_path=ck)
    t1.close()
    assert {"host_batch_plan", "round_step", "checkpoint"} <= {
        s["name"] for s in t1.tracer.spans}
    res = FederatedTrainer(_fed_cfg(T), device="cpu")
    res.restore(ck)
    t2 = Telemetry.to_jsonl(mpath, resume=True)
    assert t2.watermark == 1
    attach(res, t2)
    res.run(rounds=ROUNDS - 1)
    t2.close()
    merged = JsonlSink.read(mpath)
    check_stream(merged)
    assert main([str(mpath)]) == 0
    assert [e["round"] for e in merged if e["kind"] == "round"] == list(
        range(ROUNDS))
    assert (canonical(merged, kinds=("round", "fault"))
            == canonical(stream, kinds=("round", "fault")))
    assert [e["kind"] for e in merged].count("checkpoint") == 1
    h = History("m")
    h.rows = [dict(r) for r in cont.history.rows[:1]]
    assert h.merge_resumed(res.history.rows) == ROUNDS - 1
    assert h.rows == cont.history.rows


def test_run_cli_metrics_and_trace_out(tmp_path, capsys):
    """``--metrics-out``, ``--trace-out`` and ``--diagnostics on`` on the
    CPU, then ``--resume`` appending to the same stream."""
    from dopt_torch.obs.check import main as check
    from dopt_torch.run import main

    shrink = ["--device", "cpu", "--set", "data.num_users=2", "--set",
              "data.synthetic_train_size=40", "--set",
              "data.synthetic_test_size=8", "--set", "gossip.local_ep=1",
              "--set", "gossip.local_bs=20"]
    m, tr, ck = tmp_path / "m.jsonl", tmp_path / "t.json", tmp_path / "ck"
    assert main(["--preset", "baseline1", "--rounds", "1",
                 *shrink, "--diagnostics", "on", "--metrics-out", str(m),
                 "--trace-out", str(tr), "--checkpoint", str(ck)]) == 0
    assert main(["--preset", "baseline1", "--rounds", "1",
                 *shrink, "--diagnostics", "on", "--metrics-out", str(m),
                 "--resume", str(ck)]) == 0
    assert check([str(m)]) == 0
    evs = JsonlSink.read(m)
    assert [e["round"] for e in evs if e["kind"] == "round"] == [0, 1]
    assert {"update_norm", "consensus_distance"} <= {
        e["name"] for e in evs if e["kind"] == "gauge"}
    assert {"host_batch_plan", "round_step"} <= {
        e["name"] for e in json.loads(tr.read_text())["traceEvents"]}
