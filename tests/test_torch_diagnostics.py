"""On-card diagnostics (``diagnostics="on"``) in both port engines,
against dopt's (the port's counterpart of tests/test_diagnostics.py).

The six gauges of a round — update, momentum and param norms, the
lane-loss mean and spread, and the consensus distance (gossip) or lane
dispersion (federated) — are computed on the device from the round's
carried state and travel last in the round's packed metric vector.
Against dopt on the CPU, one round from dopt's init (the MLP on the
synthetic set, 8 workers, 256 train / 64 test, batch 32): the same
gauge names in the same order, each value within 1e-5 relative (the
single-round standard), over the paths that compute them differently
(dense, fused, async, crash-repaired, push-sum, the holdout's epoch
rows; federated full width, compact, fused, SCAFFOLD and the staleness
cocktail).  Within the port, bit for bit: the streams of per-round,
blocked, prefetched and killed-and-resumed runs are canonically equal
gauges included, and turning diagnostics on changes no param, no
History row, no ledger row and no kernel call.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt.obs as jobs
import dopt_torch.config as T
import dopt_torch.engine.federated as tfed
import dopt_torch.engine.gossip as tgossip
import dopt_torch.engine.local as tlocal
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.obs import (JsonlSink, MemorySink, Telemetry, attach,
                            canonical, check_stream, make_event,
                            validate_event)
from dopt_torch.obs.events import DETERMINISTIC_KINDS, DIAG_GAUGES, KINDS
from dopt_torch.utils.profiling import (CompileWatcher, PhaseTimers,
                                        device_memory_stats,
                                        emit_device_resource)

GAUGE_REL = 1e-5     # one round from one state: the single-round standard
ROUNDS = 4
GOSSIP_DIAG = DIAG_GAUGES + ("consensus_distance",)
FED_DIAG = DIAG_GAUGES + ("lane_dispersion",)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _common(mod, holdout, faults):
    return dict(
        seed=7,
        data=mod.DataConfig(dataset="synthetic", num_users=8, iid=False,
                            shards=2, synthetic_train_size=256,
                            synthetic_test_size=64, local_holdout=holdout,
                            holdout_mode="deterministic"),
        model=mod.ModelConfig(model="mlp", input_shape=(28, 28, 1),
                              faithful=False),
        faults=None if faults is None else mod.FaultConfig(**faults))


def _gossip_cfg(mod, *, fused=False, k1=False, faults=None, holdout=0.0,
                diagnostics="on", **g):
    """``fused``: both fused switches; ``k1``: kernel 1 only
    (``optim.fused_update``)."""
    kw = dict(algorithm="dsgd", topology="circle", mode="metropolis",
              rounds=ROUNDS, local_ep=1, local_bs=32,
              fused_update="on" if fused else "off",
              diagnostics=diagnostics)
    kw.update(g)
    return mod.ExperimentConfig(
        name="diag-gossip", **_common(mod, holdout, faults),
        optim=mod.OptimizerConfig(lr=0.1, momentum=0.5,
                                  fused_update=fused or k1),
        gossip=mod.GossipConfig(**kw))


def _fed_cfg(mod, *, fused=False, k1=False, faults=None, holdout=0.0,
             diagnostics="on", **f):
    kw = dict(algorithm="fedavg", frac=0.5, rounds=ROUNDS, local_ep=1,
              local_bs=32, fused_update="on" if fused else "off",
              diagnostics=diagnostics)
    kw.update(f)
    return mod.ExperimentConfig(
        name="diag-fed", **_common(mod, holdout, faults),
        optim=mod.OptimizerConfig(lr=0.1, momentum=0.5, rho=0.1,
                                  fused_update=fused or k1),
        federated=mod.FederatedConfig(**kw))


COCKTAIL = dict(crash=0.1, straggle=0.4, straggle_frac=0.5,
                straggler_policy="drop", over_select=0.3, corrupt=0.2,
                corrupt_mode="nan", msg_delay=0.2, msg_delay_max=2)
GOSSIP = {
    "dense": {},
    "fused": dict(fused=True),
    "async": dict(topology="one_peer_exp", mixing="async"),
    "crash": dict(faults=dict(crash=0.3, straggle=0.3, straggle_frac=0.5)),
    "push_sum": dict(correction="push_sum", faults=dict(msg_drop=0.2)),
    "holdout": dict(holdout=0.1, local_ep=2),
}
FED = {
    "full": dict(compact=False),
    "compact": {},
    "fused": dict(fused=True),
    "scaffold": dict(algorithm="scaffold", compact=False),
    "staleness": dict(faults=COCKTAIL, staleness_max=2, staleness_decay=0.5),
}


def _streamed(tr, rounds, **run):
    mem = MemorySink()
    attach(tr, Telemetry([mem]), fresh=True)
    tr.run(rounds=rounds, **run)
    return mem.events


def _gauges(events, t=0) -> list[tuple[str, float]]:
    return [(e["name"], e["value"]) for e in events
            if e["kind"] == "gauge" and e["round"] == t]


def _check_against_dopt(jt, tt, keys):
    want, got = _gauges(_streamed(jt, 1)), _gauges(_streamed(tt, 1))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert set(keys) <= {n for n, _ in got}
    for (name, a), (_, b) in zip(want, got):
        assert abs(a - b) <= GAUGE_REL * abs(a), (name, a, b)


@pytest.mark.parametrize("case", sorted(GOSSIP))
def test_gossip_gauges_match_dopt(case, devices):
    kw = GOSSIP[case]
    jt = JaxGossipTrainer(_gossip_cfg(J, **kw).replace(mesh_devices=1))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    tt = GossipTrainer(_gossip_cfg(T, **kw), device="cpu", init_params=init)
    _check_against_dopt(jt, tt, GOSSIP_DIAG)


@pytest.mark.parametrize("case", sorted(FED))
def test_federated_gauges_match_dopt(case, devices):
    kw = FED[case]
    jt = JaxFederatedTrainer(_fed_cfg(J, **kw).replace(mesh_devices=1))
    tt = FederatedTrainer(_fed_cfg(T, **kw), device="cpu",
                          init_params=jax.device_get(jt._theta_single()))
    _check_against_dopt(jt, tt, FED_DIAG)


ENGINES = {"gossip": (GossipTrainer, _gossip_cfg, GOSSIP_DIAG, {}),
           "federated": (FederatedTrainer, _fed_cfg, FED_DIAG,
                         FED["staleness"])}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_streams_equal_across_paths(engine):
    """Per-round calls, one blocked run and a prefetched blocked run
    stream canonically equal events, the gauges included; every round
    carries all six; the end-of-run consensus gauge is suppressed."""
    cls, mk, keys, kw = ENGINES[engine]
    per = cls(mk(T, **kw), device="cpu")
    mem = MemorySink()
    attach(per, Telemetry([mem]), fresh=True)
    for _ in range(ROUNDS):
        per.run(rounds=1)
    stream = mem.events
    s = check_stream(stream)
    assert s["rounds"] == ROUNDS and s["kinds"]["resource"] == ROUNDS
    for t in range(ROUNDS):
        assert set(keys) <= {n for n, _ in _gauges(stream, t)}
    assert [n for e in stream if e["kind"] == "gauge"
            for n in [e["name"]]].count(keys[-1]) == ROUNDS
    blk = _streamed(cls(mk(T, **kw), device="cpu"), ROUNDS, block=2)
    pf = _streamed(cls(mk(T, prefetch="on", **kw), device="cpu"), ROUNDS,
                   block=3)
    assert canonical(blk) == canonical(stream)
    assert canonical(pf) == canonical(stream)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_kill_resume_stream_equality(engine, tmp_path):
    """Killed after round 2's checkpoint and resumed into the same JSONL
    file: one gapless stream that ``obs.check`` accepts, canonically
    equal to the continuous run's, gauges included."""
    from dopt_torch.obs.check import main

    cls, mk, _, kw = ENGINES[engine]
    stream = _streamed(cls(mk(T, **kw), device="cpu"), ROUNDS, block=2)
    mpath, ck = tmp_path / "m.jsonl", tmp_path / "ck"
    part = cls(mk(T, **kw), device="cpu")
    t1 = Telemetry.to_jsonl(mpath)
    attach(part, t1)
    part.run(rounds=2, block=2, checkpoint_every=2, checkpoint_path=ck)
    t1.close()
    res = cls(mk(T, **kw), device="cpu")
    res.restore(ck)
    t2 = Telemetry.to_jsonl(mpath, resume=True)
    attach(res, t2)
    res.run(rounds=ROUNDS - 2, block=2)
    t2.close()
    merged = JsonlSink.read(mpath)
    check_stream(merged)
    assert main([str(mpath)]) == 0
    assert canonical(merged) == canonical(stream)


def _counted(monkeypatch) -> dict[str, int]:
    """Count the kernel wrappers' calls (on the CPU they run the plain
    versions; on the card each call is a launch)."""
    calls = {"fused_sgd_momentum": 0, "fused_mix_update": 0}

    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    wrap(tlocal, "fused_sgd_momentum")
    wrap(tgossip, "fused_mix_update")
    wrap(tfed, "fused_mix_update")
    return calls


UNCHANGED = {
    "gossip-fused": (GossipTrainer, _gossip_cfg, dict(fused=True)),
    "gossip-async": (GossipTrainer, _gossip_cfg,
                     dict(GOSSIP["async"], k1=True)),
    "gossip-crash": (GossipTrainer, _gossip_cfg,
                     dict(GOSSIP["crash"], k1=True)),
    "federated-fused": (FederatedTrainer, _fed_cfg, dict(fused=True)),
    "federated-staleness": (FederatedTrainer, _fed_cfg,
                            dict(FED["staleness"], k1=True)),
}


@pytest.mark.parametrize("case", sorted(UNCHANGED))
def test_diagnostics_leave_training_unchanged(case, monkeypatch):
    """dopt's invariant (tests/test_diagnostics.py:181), bit for bit in
    the port: the same params, History, ledger and kernel calls with
    diagnostics on as off, per-round and blocked."""
    cls, mk, kw = UNCHANGED[case]
    calls = _counted(monkeypatch)
    runs = {}
    for diag in ("off", "on"):
        for block in (1, 2):
            before = dict(calls)
            tr = cls(mk(T, diagnostics=diag, **kw), device="cpu")
            tr.run(rounds=3, block=block)
            runs[diag, block] = (tr.history.rows, tr.history.faults,
                                 tr.worker_params(),
                                 {k: calls[k] - before[k] for k in calls})
    for block in (1, 2):
        off, on = runs["off", block], runs["on", block]
        assert on[0] == off[0] and on[1] == off[1] and on[3] == off[3]
        for k in off[2]:
            np.testing.assert_array_equal(on[2][k], off[2][k], err_msg=k)
    assert sum(runs["on", 1][3].values()) > 0


def test_bad_diagnostics_value_refused_in_dopts_words(devices):
    for mk, jcls, tcls in ((_gossip_cfg, JaxGossipTrainer, GossipTrainer),
                           (_fed_cfg, JaxFederatedTrainer,
                            FederatedTrainer)):
        with pytest.raises(ValueError) as want:
            jcls(mk(J, diagnostics="sometimes").replace(mesh_devices=1))
        with pytest.raises(ValueError) as got:
            tcls(mk(T, diagnostics="sometimes"), device="cpu")
        assert str(got.value) == str(want.value)


def test_resource_and_compile_kinds():
    """Both stay outside the canonical comparison, as in dopt."""
    for kinds in (KINDS, jobs.KINDS):
        assert "resource" in kinds and "compile" in kinds
    for det in (DETERMINISTIC_KINDS, jobs.DETERMINISTIC_KINDS):
        assert "resource" not in det and "compile" not in det


def test_resource_and_compile_events_validate():
    """A ``resource`` sample (on the CPU dopt's host-RSS fallback) and a
    ``compile`` event per new round-graph capture, each valid in both
    packages; a later sample without a new capture emits none."""
    stats = device_memory_stats(torch.device("cpu"))
    assert stats["source"] == "host_rss"
    assert 0 < stats["live_bytes"] and 0 < stats["peak_bytes"]

    class _Graphs:
        captures = {}

    class _Tr:
        engine_kind, device, _diag = "gossip", torch.device("cpu"), True
        timers, graphs = PhaseTimers(), _Graphs()
        _compile_watch, _last_step_total = CompileWatcher(), 0.0

    tr, mem = _Tr(), MemorySink()
    tr.telemetry = Telemetry([mem])
    with tr.timers.phase("round_step"):
        tr.graphs.captures = {True: {}, False: {}}
    emit_device_resource(tr, 3, "block_fn")
    emit_device_resource(tr, 5, "block_fn")
    kinds = [e["kind"] for e in mem.events]
    assert kinds == ["compile", "resource", "resource"]
    comp = mem.events[0]
    assert (comp["count"], comp["total"], comp["fn"]) == (2, 2, "block_fn")
    for ev in mem.events:
        validate_event(ev)
        jobs.validate_event(ev)
    validate_event(make_event("resource", round=0, peak_bytes=0))


def test_cpu_run_emits_valid_resource_events():
    tr = GossipTrainer(_gossip_cfg(T), device="cpu")
    evs = _streamed(tr, 2, block=2)
    res = [e for e in evs if e["kind"] == "resource"]
    assert len(res) == 1 and res[0]["round"] == 1
    for ev in res:
        jobs.validate_event(ev)
