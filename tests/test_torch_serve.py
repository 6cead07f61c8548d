"""The port's resident trainer (``dopt_torch.serve``) against dopt's
(``dopt.serve``), on the CPU.

Control plane: the same commands — valid, malformed and unwhitelisted —
validate, queue, ledger and replay to the same results in both packages.
Daemon: dopt's command schedule runs through both daemons on the gossip
and the federated engine, each from dopt's init (a test-side wrapper of
``build_serve_trainer`` hands the port's trainers dopt's params tree);
the ``control`` and ``churn`` fault-ledger rows and the applied ledger
are equal apart from the wall-clock ``ts``, the canonical ``control`` and
``fault`` events are equal, and the History rows are within slice 1's
2-round bound (1e-3 train loss, 1e-4 test accuracy) round by round.
Within the port, bit for bit: a restart and resume ≡ the uninterrupted
run, the config rebuild ≡ a restore from its checkpoint, an armed
profile ≡ none, and a served blocked run with prefetch ≡ the per-round
one.  Also: the drop-rate auto-pause, the decoupled liveness leave and
rejoin, the admin endpoints on port 0, ``python -m dopt_torch.serve
--device cpu`` under a real SIGTERM (re-exec and resume), and a
2-process SPMD fleet over gloo that drains.

Every test that starts a daemon restores SIGTERM and SIGINT after it
(``ServeDaemon.start`` installs its own handlers).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt.serve as jserve
import dopt.serve.control as jcontrol
import dopt.serve.daemon as jdaemon
import dopt_torch.config as T
import dopt_torch.serve as tserve
import dopt_torch.serve.control as tcontrol
import dopt_torch.serve.daemon as tdaemon
from dopt.obs import JsonlSink as JJsonlSink
from dopt.obs import canonical as jcanonical
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.obs import JsonlSink, canonical, check_stream

REPO = Path(__file__).resolve().parent.parent
LOSS_TOL, ACC_TOL = 1e-3, 1e-4
ROUNDS = 6


@pytest.fixture(autouse=True)
def _restore_signals_one_thread():
    """A daemon's SIGTERM/SIGINT handlers must not outlive its test (an
    xdist worker runs many tests), and the CPU trainers run on one
    thread."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    for s, h in saved.items():
        signal.signal(s, h)


def tiny_cfg(mod, engine: str = "gossip", **section):
    """dopt's ``tiny_gossip_cfg`` (MLP, 8 workers) at 8×8 inputs, or its
    federated twin; ``section`` edits the engine section."""
    kw = dict(
        name="serve-test", seed=5,
        data=mod.DataConfig(dataset="synthetic", num_users=8, iid=True,
                            synthetic_train_size=256,
                            synthetic_test_size=64),
        model=mod.ModelConfig(model="mlp", input_shape=(8, 8, 1),
                              faithful=False),
        optim=mod.OptimizerConfig(lr=0.1, momentum=0.5))
    if engine == "gossip":
        kw["gossip"] = mod.GossipConfig(
            algorithm="dsgd", topology="circle", mode="metropolis",
            rounds=4, local_ep=1, local_bs=32, **section)
    else:
        kw["federated"] = mod.FederatedConfig(
            algorithm="fedavg", frac=0.5, rounds=4, local_ep=1,
            local_bs=32, **section)
    cfg = mod.ExperimentConfig(**kw)
    return cfg.replace(mesh_devices=1) if mod is J else cfg


def dopt_init(engine: str):
    """One worker's dopt init tree for the tiny config (it depends on the
    model and the seed only)."""
    from dopt.engine import FederatedTrainer as JF
    from dopt.engine import GossipTrainer as JG

    cfg = tiny_cfg(J, engine)
    if engine == "gossip":
        jt = JG(cfg)
        return jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    return jax.device_get(JF(cfg)._theta_single())


@pytest.fixture
def port_from(monkeypatch):
    """Route the port's daemon through a test-side
    ``build_serve_trainer`` that builds on the CPU from ``init`` (dopt's
    init tree, or None for the port's own)."""
    def use(init):
        monkeypatch.setattr(tdaemon, "build_serve_trainer",
                            _builder(tdaemon.build_serve_trainer, init))
    return use


def seed_commands(mod, state_dir: Path) -> None:
    """dopt's ``_seed_commands`` (tests/test_serve.py:240-249)."""
    q = mod.CommandQueue(Path(state_dir) / "commands.jsonl")
    q.submit(mod.make_command("membership", worker=3, action="leave",
                              at_round=1, id="m1"))
    q.submit(mod.make_command("config", key="optim.lr", value=0.05,
                              at_round=2, id="lr1"))
    q.submit(mod.make_command("membership", worker=3, action="join",
                              at_round=4, id="m2"))
    q.submit(mod.make_command("checkpoint", at_round=3, id="ck"))


def _term_at(cls):
    class TermAt(cls):
        """SIGTERM-equivalent at an exact boundary."""

        def __init__(self, *a, term_at=None, **kw):
            super().__init__(*a, **kw)
            self._term_at = term_at

        def boundary(self, trainer):
            if self._term_at is not None and trainer.round == self._term_at:
                self._term = True
                self._term_signal = self.on_term
            return super().boundary(trainer)
    return TermAt


def _applied(state: Path) -> list[dict]:
    """The applied ledger without the enqueue stamp."""
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in tcontrol.ControlLedger.replay(state / "applied.jsonl")]


def _leg(mod, state: Path, cfg, *, term_at=None, profile=None,
         max_rounds=ROUNDS, seed=True, **kw) -> dict:
    """One served leg: the schedule, a daemon to ``max_rounds`` (a
    SIGTERM-equivalent at ``term_at`` then a fresh daemon resuming),
    and its artifacts."""
    if seed:
        seed_commands(mod, state)
    daemon = mod.ServeDaemon
    legs = []
    d = _term_at(daemon)(cfg, state, checkpoint_every=2,
                         max_rounds=max_rounds, admin_port=None,
                         term_at=term_at, **kw).start()
    if profile is not None:
        d.request_profile(profile)
    legs.append(d.serve())
    if term_at is not None:
        d = daemon(cfg, state, checkpoint_every=2, max_rounds=max_rounds,
                   admin_port=None, **kw).start()
        assert d._resumed and d.trainer.round == term_at
        legs.append(d.serve())
    sink = JJsonlSink if mod is jserve else JsonlSink
    events = sink.read(state / "metrics.jsonl")
    return {"rcs": legs, "rows": d.trainer.history.rows,
            "faults": d.trainer.history.faults, "events": events,
            "applied": _applied(state), "daemon": d,
            "final": json.loads((state / "final.json").read_text())}


def _canon_kinds(events, kinds=("control", "fault")):
    canon = jcanonical(events)
    return [e for e in canon if e["kind"] in kinds]


# ------------------------------------------------------- control plane

COMMANDS = [
    {"v": 1, "cmd": "config", "key": "optim.lr", "value": 0.05,
     "at_round": 3, "id": "lr"},
    {"v": 1, "cmd": "membership", "worker": 3, "action": "leave"},
    {"v": 1, "cmd": "drain", "restart": True},
    {"v": 1, "cmd": "checkpoint"},
    {"v": 1, "cmd": "pause"},
    {"v": 1, "cmd": "resume", "ts": 5.0},
    {"v": 1, "cmd": "config", "key": "population.cohort", "value": 4},
    {"v": 1, "cmd": "config", "key": "checkpoint_every", "value": 3},
    {"v": 1, "cmd": "reboot"},
    {"v": 2, "cmd": "drain"},
    {"v": 1, "cmd": "config", "key": "gossip.topology", "value": 1},
    {"v": 1, "cmd": "config", "key": "population.cohort", "value": 3.5},
    {"v": 1, "cmd": "config", "key": "optim.lr", "value": 0.0},
    {"v": 1, "cmd": "membership", "worker": -1, "action": "leave"},
    {"v": 1, "cmd": "membership", "worker": 1, "action": "evict"},
    {"v": 1, "cmd": "checkpoint", "at_round": -2},
    {"v": 1, "cmd": "checkpoint", "id": ""},
    {"v": 1, "cmd": "checkpoint", "ts": -3},
    ["not", "an", "object"],
]


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("i", range(len(COMMANDS)))
def test_validate_command_equal(i):
    cmd = COMMANDS[i]
    want = _outcome(jcontrol.validate_command, json.loads(json.dumps(cmd)))
    got = _outcome(tcontrol.validate_command, json.loads(json.dumps(cmd)))
    assert got == want


def test_constants_equal():
    assert tcontrol.COMMANDS == jcontrol.COMMANDS
    assert {k: v.__name__ for k, v in tcontrol.CONFIG_WHITELIST.items()} \
        == {k: v.__name__ for k, v in jcontrol.CONFIG_WHITELIST.items()}
    assert tcontrol.MEMBERSHIP_ACTIONS == jcontrol.MEMBERSHIP_ACTIONS
    assert tserve.EX_RESTART == jserve.EX_RESTART
    rj, rt = jserve.serve_rules(), tserve.serve_rules()
    assert [(r.name, r.severity) for r in rt] == \
        [(r.name, r.severity) for r in rj]
    specs = [{"rule": "drop_rate", "max_rate": 0.3}]
    assert [r.name for r in tserve.serve_rules(specs=specs)] == \
        [r.name for r in jserve.serve_rules(specs=specs)]


def test_command_queue_and_ledger_equal(tmp_path):
    """The same raw queue file (valid, malformed, unwhitelisted and a
    torn tail) polls alike, incrementally and after a restart; the
    same ledger (with a superseding record and a torn line) replays to
    the same records and effects."""
    lines = [json.dumps(c) for c in COMMANDS if isinstance(c, dict)]
    lines += ["this is not json", '{"v": 1, "cmd": "checkpo']
    out = []
    for mod, d in ((jcontrol, tmp_path / "j"), (tcontrol, tmp_path / "t")):
        d.mkdir()
        qp = d / "commands.jsonl"
        qp.write_text("\n".join(lines[:5]) + "\n")
        q = mod.CommandQueue(qp)
        first = q.poll()
        with open(qp, "a") as f:
            f.write("\n".join(lines[5:]))
        second = q.poll()
        q.submit(mod.make_command("drain", id="d1", ts=1.0))
        third = q.poll()
        again = mod.CommandQueue(qp).poll()
        led = mod.ControlLedger(d / "applied.jsonl")
        for rec in ({"v": 1, "id": "m1", "cmd": "membership", "worker": 2,
                     "action": "leave", "status": "applied", "round": 3},
                    {"v": 1, "id": "lr", "cmd": "config",
                     "key": "optim.lr", "value": 0.05,
                     "status": "applied", "round": 5},
                    {"v": 1, "id": "bad", "cmd": None,
                     "status": "rejected", "round": 5, "reason": "nope"},
                    {"v": 1, "id": "p", "cmd": "pause",
                     "status": "applied", "round": 6},
                    {"v": 1, "id": "m1", "cmd": "membership", "worker": 2,
                     "action": "leave", "status": "applied", "round": 4}):
            led.append(rec)
        led.close()
        with open(d / "applied.jsonl", "a") as f:
            f.write('{"v": 1, "id": "torn", "cmd": "resu')
        led = mod.ControlLedger(d / "applied.jsonl")
        led.append({"v": 1, "id": "r", "cmd": "resume",
                    "status": "applied", "round": 7})
        led.close()
        recs = mod.ControlLedger.replay(d / "applied.jsonl")
        fx = [mod.replay_effects(recs, up_to_round=r) for r in (3, 5, 6, 9)]
        out.append(json.loads(json.dumps(
            (first, second, third, again, recs, fx), default=sorted)))
    assert out[1] == out[0]
    assert out[0][1][1]   # the malformed lines were rejected


@pytest.mark.parametrize("key,value", [
    ("optim.lr", 0.025), ("optim.lr", 3), ("checkpoint_every", 4),
    ("population.cohort", 6), ("seed", 1), ("optim.lr", "x")])
def test_apply_config_change_equal(key, value):
    def run(mod, cmod):
        cfg = tiny_cfg(mod)
        if key == "population.cohort":
            cfg = cfg.replace(population=mod.PopulationConfig(
                clients=16, cohort=8))
        try:
            out = cmod.apply_config_change(cfg, key, value)
        except SystemExit:
            # The daemon applies checkpoint_every itself: --set has no
            # such field in either package (the CLIs word it apart).
            return "SystemExit"
        except (ValueError, TypeError) as e:
            return type(e).__name__, str(e)
        d = dataclasses.asdict(out)
        d.pop("mesh_devices")
        return d

    assert run(T, tcontrol) == run(J, jcontrol)


@pytest.mark.parametrize("i", range(8))
def test_control_rows_equal(i):
    cmd = COMMANDS[i]
    for fn in (lambda m: m.control_ledger_row(cmd, 7),
               lambda m: m.control_event_fields(cmd, 7, auto=i % 2 == 0),
               lambda m: m.applied_record(cmd, status="applied",
                                          round_idx=7, auto=True),
               lambda m: m.applied_record(cmd, status="rejected",
                                          round_idx=7, reason="r")):
        assert fn(tcontrol) == fn(jcontrol)


# ------------------------------------------------------- engine hooks

@pytest.mark.parametrize("engine", ["gossip", "federated"])
def test_membership_population_refused_in_dopts_words(engine):
    from dopt.engine import FederatedTrainer as JF
    from dopt.engine import GossipTrainer as JG
    from dopt.faults import MembershipLog as JLog
    from dopt_torch.faults import MembershipLog as TLog

    msgs = []
    for mod, cls, log in ((J, JF if engine == "federated" else JG, JLog),
                          (T, FederatedTrainer if engine == "federated"
                           else GossipTrainer, TLog)):
        cfg = tiny_cfg(mod, engine).replace(
            population=mod.PopulationConfig(clients=16, cohort=8))
        kw = {} if mod is J else {"device": "cpu"}
        with pytest.raises(ValueError, match="does not compose") as ei:
            cls(cfg, membership=log(), **kw)
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def test_build_serve_trainer_refusals_in_dopts_words():
    from dopt_torch.presets import get_preset

    want = _outcome(jdaemon.build_serve_trainer,
                    tiny_cfg(J).replace(backend="torch"), None)
    assert "jax engines only" in want[1]
    assert _outcome(tdaemon.build_serve_trainer,
                    tiny_cfg(T).replace(backend="torch"), None) == want
    assert _outcome(tdaemon.build_serve_trainer, get_preset("seqlm"),
                    None) == want


@pytest.mark.parametrize("engine", ["gossip", "federated"])
def test_checkpoint_writer_and_run_served_hooks(tmp_path, engine):
    """``checkpoint_writer = False`` saves nothing (a fleet follower);
    ``run_served`` asks the controller before every round and emits the
    summary gauge only at a drain."""
    from dopt_torch.obs import MemorySink, Telemetry, attach

    cls = GossipTrainer if engine == "gossip" else FederatedTrainer
    tr = cls(tiny_cfg(T, engine), device="cpu")
    tr.checkpoint_writer = False
    tr.save(tmp_path / "ck")
    assert not (tmp_path / "ck").exists()
    mem = MemorySink()
    attach(tr, Telemetry([mem]))
    seen = []

    class Ctl:
        def __init__(self, stop):
            self.stop = stop

        def boundary(self, trainer):
            seen.append(trainer.round)
            return "run" if trainer.round < 2 else self.stop

    assert tr.run_served(Ctl("restart")) == "restart"
    assert seen == [0, 1, 2] and not tr._suppress_run_summary
    assert not any(e.get("name") == "consensus_distance"
                   for e in mem.events)
    assert tr.run_served(Ctl("drain")) == "drain"
    assert [e["round"] for e in mem.events
            if e.get("name") == "consensus_distance"] == [1]


# ---------------------------------------------------- the daemons vs dopt

VARIANTS = ("gossip", "federated", "gossip-fused", "federated-fused")


def variant_cfg(mod, variant: str):
    """The tiny config of ``variant``: an engine, with "-fused" both
    fused switches (the served headlines' kernels)."""
    engine, _, fused = variant.partition("-")
    if not fused:
        return tiny_cfg(mod, engine)
    cfg = tiny_cfg(mod, engine, fused_update="on")
    return cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                 fused_update=True))


class _Legs:
    """Served legs computed on first use and kept for the module: dopt's
    daemon over the schedule with one worker's init tree (``dopt``), and
    the port's uninterrupted leg from that init (``port``)."""

    def __init__(self, factory):
        self.factory = factory
        self.cache: dict = {}

    def _guarded(self, fn):
        saved = {s: signal.getsignal(s)
                 for s in (signal.SIGTERM, signal.SIGINT)}
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn()
        finally:
            torch.set_num_threads(n)
            for s, h in saved.items():
                signal.signal(s, h)

    def dopt(self, variant: str):
        key = ("dopt", variant)
        if key not in self.cache:
            def run():
                leg = _leg(jserve, self.factory.mktemp(f"dopt-{variant}"),
                           variant_cfg(J, variant))
                leg.pop("daemon")
                return leg, dopt_init(variant.partition("-")[0])
            self.cache[key] = self._guarded(run)
        return self.cache[key]

    def port(self, variant: str):
        key = ("port", variant)
        if key not in self.cache:
            init = self.dopt(variant)[1]

            def run():
                mp = pytest.MonkeyPatch()
                try:
                    mp.setattr(tdaemon, "build_serve_trainer",
                               _builder(tdaemon.build_serve_trainer, init))
                    return _leg(tserve,
                                self.factory.mktemp(f"port-{variant}"),
                                variant_cfg(T, variant))
                finally:
                    mp.undo()
            self.cache[key] = self._guarded(run)
        return self.cache[key]


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    return _Legs(tmp_path_factory)


def _builder(real, init):
    def build(cfg, membership, device=None):
        if cfg.backend != "jax" or cfg.seqlm is not None:
            return real(cfg, membership, device)
        cls = FederatedTrainer if cfg.federated is not None \
            else GossipTrainer
        return cls(cfg, membership=membership, device="cpu",
                   init_params=init)
    return build


def _rows_close(want, got):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k, tol in (("avg_train_loss", LOSS_TOL),
                       ("avg_test_acc", ACC_TOL)):
            if k in a:
                assert abs(a[k] - b[k]) <= tol, (k, a, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_daemon_matches_dopt(legs, variant):
    want, got = legs.dopt(variant)[0], legs.port(variant)
    assert got["rcs"] == want["rcs"] == [0]
    sel = ("control", "churn")
    assert [r for r in got["faults"] if r["kind"] in sel] == \
        [r for r in want["faults"] if r["kind"] in sel]
    assert got["faults"] == want["faults"]
    assert got["applied"] == want["applied"]
    assert [r["id"] for r in got["applied"]] == ["m1", "lr1", "ck", "m2"]
    assert _canon_kinds(got["events"]) == _canon_kinds(want["events"])
    _rows_close(want["rows"], got["rows"])
    check_stream(got["events"])
    for leg in (want, got):
        assert leg["final"]["report"]["verdict"] == "healthy"
        assert leg["final"]["round"] == ROUNDS
    # The wall-clock channel: present with dopt's schema, never equal.
    names = {e["name"] for e in got["events"] if e["kind"] == "latency"}
    assert names == {e["name"] for e in want["events"]
                     if e["kind"] == "latency"}
    assert got["daemon"].trainer.cfg.optim.lr == 0.05


# ----------------------------------------------- exactly, within the port

@pytest.mark.parametrize("variant,term_at", [
    ("gossip", 2), ("gossip", 3), ("federated", 3), ("gossip-fused", 2),
    ("federated-fused", 3)])
def test_restart_resume_bit_identity(tmp_path, legs, port_from, variant,
                                     term_at):
    """A SIGTERM-equivalent at ``term_at`` then a fresh daemon ≡ the
    uninterrupted leg, bit for bit.  At boundary 2 the restart lands on
    the config change: the rebuild of the uninterrupted leg ≡ a restore
    of its checkpoint in a new process."""
    port_from(legs.dopt(variant)[1])
    leg = _leg(tserve, tmp_path, variant_cfg(T, variant), term_at=term_at)
    ref = legs.port(variant)
    assert leg["rcs"] == [tserve.EX_RESTART, 0]
    assert leg["rows"] == ref["rows"]
    assert leg["faults"] == ref["faults"]
    assert canonical(leg["events"]) == canonical(ref["events"])
    assert leg["applied"] == ref["applied"]
    assert leg["final"]["restarts"] == 1
    check_stream(leg["events"])


def test_profile_armed_bit_identity(tmp_path, legs, port_from):
    """An armed ``torch.profiler`` capture writes one merged Chrome
    trace (the profiler's events and the host spans) and changes
    nothing else."""
    port_from(legs.dopt("gossip")[1])
    leg = _leg(tserve, tmp_path, tiny_cfg(T), profile=2)
    ref = legs.port("gossip")
    assert leg["rows"] == ref["rows"]
    assert leg["faults"] == ref["faults"]
    assert canonical(leg["events"]) == canonical(ref["events"])
    arts = leg["final"]["profiles"]
    assert len(arts) == 1 and arts[0].endswith("profile-r0-r2.trace.json")
    trace = json.loads(Path(arts[0]).read_text())["traceEvents"]
    assert any(e.get("pid") == 900_000 for e in trace)
    assert any(e.get("pid") != 900_000 for e in trace)
    with pytest.raises(ValueError, match="rounds"):
        leg["daemon"].request_profile(0)


def test_blocked_prefetch_membership_every_boundary(tmp_path, port_from):
    """A membership command at every boundary under ``block_rounds=3``
    and ``prefetch=on``: the trainer reads the live log each round (a
    served round runs ``run(rounds=1)``, so nothing is staged ahead of a
    boundary).  Against dopt's daemon on the same config; within the
    port, bit for bit the per-round served run."""
    def schedule(mod, state):
        q = mod.CommandQueue(state / "commands.jsonl")
        for t in range(1, 5):
            q.submit(mod.make_command(
                "membership", worker=t % 3 + 2,
                action="leave" if t % 2 else "join", at_round=t,
                id=f"m{t}"))
        q.submit(mod.make_command("membership", worker=6, action="leave",
                                  at_round=3, id="x"))

    blocked = dict(block_rounds=3, prefetch="on")
    jstate = tmp_path / "dopt"
    schedule(jserve, jstate)
    want = _leg(jserve, jstate, tiny_cfg(J, **blocked), seed=False)
    port_from(dopt_init("gossip"))
    legs = []
    for name, sec in (("blocked", blocked), ("round", {})):
        state = tmp_path / name
        schedule(tserve, state)
        legs.append(_leg(tserve, state, tiny_cfg(T, **sec), seed=False))
    got, per_round = legs
    assert got["faults"] == want["faults"]
    assert sum(r["kind"] == "churn" for r in got["faults"]) >= 5
    assert got["applied"] == want["applied"]
    assert _canon_kinds(got["events"]) == _canon_kinds(want["events"])
    _rows_close(want["rows"], got["rows"])
    assert got["rows"] == per_round["rows"]
    assert canonical(got["events"]) == canonical(per_round["events"])


def test_rejects_unwhitelisted_and_out_of_range(tmp_path, port_from):
    port_from(None)
    state = tmp_path / "s"
    state.mkdir()
    with open(state / "commands.jsonl", "w") as f:
        f.write(json.dumps({"v": 1, "cmd": "config", "key": "seed",
                            "value": 9, "id": "bad-key"}) + "\n")
        f.write(json.dumps(tserve.make_command(
            "membership", worker=99, action="leave",
            id="bad-worker")) + "\n")
    d = tserve.ServeDaemon(tiny_cfg(T), state, checkpoint_every=0,
                           max_rounds=2, admin_port=None).start()
    assert d.serve() == 0
    assert not any(r["kind"] == "control" for r in d.trainer.history.faults)
    recs = {r["id"]: r for r in _applied(state)}
    assert recs["bad-key"]["status"] == "rejected"
    assert "lane fleet" in recs["bad-worker"]["reason"]
    assert not any(e["kind"] == "control"
                   for e in JsonlSink.read(state / "metrics.jsonl"))


def test_auto_pause_on_drop_rate_critical_equal(tmp_path):
    """dopt's auto-pause sequence through both daemons' ``_decide`` and
    ``_execute``: the same directives, ledger rows and rejections."""
    out = []
    for mod, mon_mod in ((jserve, __import__("dopt.obs", fromlist=["x"])),
                         (tserve, __import__("dopt_torch.obs",
                                             fromlist=["x"]))):
        cfg = tiny_cfg(J if mod is jserve else T)
        state = tmp_path / mod.__name__
        d = mod.ServeDaemon(cfg, state, admin_port=None)
        d.monitor = mon_mod.HealthMonitor([])
        d.monitor.alerts = [{"kind": "alert", "rule": "drop_rate_critical",
                             "severity": "critical", "round": 2}]
        trainer = SimpleNamespace(num_workers=8, round=3,
                                  history=SimpleNamespace(faults=[]),
                                  save=lambda path: None)
        steps = [d._decide(3, trainer)]
        steps.append(d._execute(steps[0], trainer))
        d.queue.submit(mod.make_command("membership", worker=1,
                                        action="join", id="j1"))
        steps.append(d._decide(4, trainer))
        d._execute(steps[-1], trainer)
        d.queue.submit(mod.make_command("resume", id="r1"))
        d.queue.submit(mod.make_command("membership", worker=1,
                                        action="join", id="j2"))
        steps.append([c["id"] for c in d._decide(5, trainer)["apply"]])
        clean = json.loads(json.dumps(steps))
        for s in clean:
            if isinstance(s, dict):
                for c in s["apply"] + s["rejected"]:
                    c.pop("ts", None)
        out.append((clean, trainer.history.faults, d.paused,
                    [{k: v for k, v in r.items() if k != "ts"}
                     for r in mod.ControlLedger.replay(
                         state / "applied.jsonl")]))
    assert out[1] == out[0]
    assert out[0][0][3] == ["r1", "j2"]


def test_decoupled_liveness_leave_and_rejoin(tmp_path, port_from):
    """dopt's decoupled control plane, in the port: a drained peer's
    departure stamp turns its lanes into ledgered auto-leaves at the
    survivor's next boundary, and a fresh heartbeat turns them back
    into joins after the survivor resumes."""
    port_from(None)
    fleet = tmp_path
    common = dict(admin_port=None, fleet_size=2, fleet_dir=fleet,
                  peer_timeout_s=60.0)
    d1 = tserve.ServeDaemon(tiny_cfg(T), fleet / "p1", checkpoint_every=0,
                            max_rounds=2, fleet_rank=1, **common).start()
    assert d1.serve() == 0
    stamp = json.loads((fleet / "liveness-p1.json").read_text())
    assert stamp["status"] == "drained" and stamp["rank"] == 1
    d0 = tserve.ServeDaemon(tiny_cfg(T), fleet / "p0", checkpoint_every=2,
                            max_rounds=2, fleet_rank=0, **common).start()
    assert d0.serve() == 0
    recs = {r["id"]: r for r in _applied(fleet / "p0")}
    for i in (4, 5, 6, 7):
        rec = recs[f"auto-liveness-leave-r0-w{i}"]
        assert rec["status"] == "applied" and rec["auto"] is True
    assert list(np.nonzero(d0.membership.away_at(2, 8))[0]) == [4, 5, 6, 7]
    left = {r["worker"] for r in d0.trainer.history.faults
            if r["kind"] == "churn" and r["action"] == "left"}
    assert left == {4, 5, 6, 7}
    (fleet / "liveness-p1.json").write_text(json.dumps(
        {"pid": 999999, "rank": 1, "round": 2, "status": "serving",
         "ts": time.time()}))
    d0b = tserve.ServeDaemon(tiny_cfg(T), fleet / "p0", checkpoint_every=2,
                             max_rounds=4, fleet_rank=0, **common).start()
    assert d0b._resumed and d0b.trainer.round == 2
    assert d0b.serve() == 0
    recs = {r["id"]: r for r in _applied(fleet / "p0")}
    for i in (4, 5, 6, 7):
        assert recs[f"auto-liveness-join-r2-w{i}"]["status"] == "applied"
    assert not d0b.membership.away_at(4, 8).any()
    with pytest.raises(ValueError, match="mutually exclusive"):
        tserve.ServeDaemon(tiny_cfg(T), tmp_path, fleet_size=2,
                           num_processes=2)


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers


def test_admin_endpoints_port0(tmp_path, port_from):
    """The admin surface on an ephemeral port: the GETs, command POSTs
    queued and applied at their boundaries, a non-whitelisted key and a
    second profile arm refused with 400, drain to exit 0."""
    port_from(None)
    d = tserve.ServeDaemon(tiny_cfg(T), tmp_path, checkpoint_every=2,
                           max_rounds=3, admin_port=0).start()
    try:
        port = json.loads((tmp_path / "serve.json").read_text())["admin_port"]
        assert port == d.admin.port > 0
        url = f"http://127.0.0.1:{port}"
        code, body, _ = _http(url + "/healthz")
        assert code == 200 and json.loads(body)["verdict"] in (
            "healthy", "empty")
        code, body, _ = _http(url + "/metrics")
        assert code == 200   # empty until the first round lands
        code, body, _ = _http(url + "/admin/status")
        st = json.loads(body)
        assert code == 200 and st["status"] == "serving" \
            and st["workers"] == 8 and st["engine"] == "gossip"
        code, body, _ = _http(url + "/admin/config")
        assert json.loads(body) == {"checkpoint_every": 2, "paused": False,
                                    "optim.lr": 0.1}
        code, body, _ = _http(url + "/admin/membership",
                              {"worker": 3, "action": "leave",
                               "at_round": 1})
        assert code == 202
        code, body, _ = _http(url + "/admin/config",
                              {"key": "optim.lr", "value": 0.07,
                               "at_round": 2})
        assert code == 202
        code, body, _ = _http(url + "/admin/config",
                              {"key": "seed", "value": 1})
        assert code == 400 and "whitelisted" in body
        assert _http(url + "/admin/profile", {"rounds": 1})[0] == 202
        assert _http(url + "/admin/profile", {"rounds": 1})[0] == 400
        code, body, _ = _http(url + "/admin/membership")
        assert json.loads(body)["away"] == []
        assert _http(url + "/nope")[0] == 404
    except BaseException:
        d._finalize("drained")
        raise
    assert d.serve() == 0
    assert d.admin is None
    actions = [r["action"] for r in d.trainer.history.faults
               if r["kind"] == "control"]
    assert actions == ["applied_membership_leave",
                       "applied_config_optim.lr=0.07"]
    final = json.loads((tmp_path / "final.json").read_text())
    assert final["report"]["verdict"] == "healthy"
    assert len(final["profiles"]) == 1
    assert set(final["slo"]) >= {"boundary_tick", "checkpoint_save",
                                 "checkpoint_restore", "command_apply"}


# ------------------------------------------------------ the CLI, for real

CLI = [sys.executable, "-m", "dopt_torch.serve", "--preset", "baseline1",
       "--device", "cpu",
       "--set", "data.dataset=synthetic",
       "--set", "data.synthetic_train_size=256",
       "--set", "data.synthetic_test_size=64",
       "--set", "model.model=mlp", "--set", "model.faithful=false",
       "--set", "gossip.local_ep=1", "--set", "gossip.local_bs=32",
       "--num-users", "8"]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _wait_status(path: Path, pred, proc, deadline: float) -> dict:
    while time.time() < deadline:
        assert proc.poll() is None, proc.communicate()[0][-3000:]
        try:
            st = json.loads(path.read_text())
            if pred(st):
                return st
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting on {path}")


def test_cli_sigterm_reexec_resume_and_drain(tmp_path):
    """``python -m dopt_torch.serve --device cpu``: a real SIGTERM drains
    to a boundary, checkpoints and re-execs in place (the same pid),
    which resumes; a drain over the admin endpoint then exits 0 with a
    continuous history and a clean stream."""
    state = tmp_path / "sv"
    proc = subprocess.Popen(
        CLI + ["--state-dir", str(state), "--checkpoint-every", "3"],
        cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        st = _wait_status(state / "serve.json",
                          lambda s: s["status"] == "serving"
                          and s["round"] >= 2, proc, deadline)
        pid = st["pid"]
        assert pid == proc.pid
        os.kill(pid, signal.SIGTERM)
        st = _wait_status(state / "serve.json",
                          lambda s: s["restarts"] == 1
                          and s["status"] == "serving", proc, deadline)
        assert st["pid"] == pid   # re-exec'd in place
        code, _, _ = _http(f"http://127.0.0.1:{st['admin_port']}"
                           "/admin/drain", {})
        assert code == 202
        out = proc.communicate(timeout=120)[0]
        assert proc.returncode == 0, out[-3000:]
        assert "re-exec for rolling restart" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    final = json.loads((state / "final.json").read_text())
    assert final["restarts"] == 1
    assert final["report"]["verdict"] == "healthy"
    rows = final["history"]
    assert [r["round"] for r in rows] == list(range(len(rows)))
    assert check_stream(JsonlSink.read(state / "metrics.jsonl"))[
        "rounds"] == len(rows)
    assert [r["action"] for r in final["fault_ledger"]] == [
        "applied_drain"]


def test_cli_refuses_devices_per_proc_and_nccl_on_cpu(tmp_path):
    for extra, words in ((["--devices-per-proc", "4"],
                          "--num-processes 4"),
                         (["--collectives", "nccl"], "--collectives gloo")):
        r = subprocess.run(CLI + ["--state-dir", str(tmp_path / "x")]
                           + extra, cwd=tmp_path, env=_env(),
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 2 and words in r.stderr, r.stderr


def test_spmd_fleet_two_processes_gloo_drains(tmp_path):
    """A 2-process fleet over gloo on the CPU: the leader's directives
    replayed by the follower, a config rebuild at round 2, one
    checkpoint writer; it drains at round 4 and the two processes'
    deterministic streams are equal (``dopt_torch.obs.aggregate``)."""
    from dopt_torch.obs import aggregate

    state = tmp_path / "fleet"
    tcontrol.CommandQueue(state / "commands.jsonl").submit(
        tcontrol.make_command("config", key="optim.lr", value=0.05,
                              at_round=2, id="fleet-lr"))
    r = subprocess.run(
        CLI + ["--state-dir", str(state), "--max-rounds", "4",
               "--checkpoint-every", "2", "--num-processes", "2",
               "--fleet-port", "0"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=240)
    logs = "".join(p.read_text() for p in (state / "logs").glob("*.log"))
    assert r.returncode == 0, (r.stderr[-3000:], logs[-3000:])
    assert "fleet drained" in r.stderr
    final = json.loads((state / "final.json").read_text())
    assert final["round"] == 4 and final["report"]["verdict"] == "healthy"
    assert [x["action"] for x in final["fault_ledger"]
            if x["kind"] == "control"] == ["applied_config_optim.lr=0.05"]
    assert (state / "metrics-p1.jsonl").exists()
    assert aggregate.main(["--state-dir", str(state)]) == 0
    assert not (state / "fleet.json").exists()


@pytest.mark.slow
def test_spmd_fleet_rolling_restart(tmp_path):
    """A real SIGTERM to the follower of a 2-process gloo fleet: the
    fleet quiesces at the boundary, checkpoints once, respawns as the
    next generation and resumes to a healthy drain."""
    state = tmp_path / "fleet"
    sup = subprocess.Popen(
        CLI + ["--state-dir", str(state), "--max-rounds", "40",
               "--checkpoint-every", "5", "--no-admin",
               "--num-processes", "2"],
        cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 300
        killed = False
        while sup.poll() is None:
            assert time.time() < deadline, "fleet timed out"
            time.sleep(0.05)
            if killed:
                continue
            try:
                st = json.loads((state / "serve.json").read_text())
            except (OSError, ValueError):
                continue
            if st.get("status") == "serving" and 1 <= st["round"] <= 30:
                out = subprocess.run(
                    ["pgrep", "-f", f"state-dir {state}.*process-id 1"],
                    capture_output=True, text=True)
                pids = [int(p) for p in out.stdout.split()]
                if pids:
                    os.kill(pids[0], signal.SIGTERM)
                    killed = True
        log = sup.communicate()[0]
        assert sup.returncode == 0, log[-4000:]
        assert killed
        final = json.loads((state / "final.json").read_text())
        assert final["round"] == 40 and final["restarts"] >= 1
        assert final["report"]["verdict"] == "healthy"
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait()


def test_obs_serve_port0_statefile_sigterm(tmp_path):
    """``python -m dopt_torch.obs.serve --port 0``: the port announced on
    stdout and in --state-file, /healthz served, SIGTERM exits 0 and
    removes the state file."""
    from dopt_torch.obs import make_event

    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text("".join(json.dumps(e) + "\n" for e in [
        make_event("run", engine="gossip", name="t", round=0),
        make_event("round", round=0, engine="gossip",
                   metrics={"avg_train_loss": 1.0}),
        make_event("round", round=1, engine="gossip",
                   metrics={"avg_train_loss": 0.9})]))
    state = tmp_path / "endpoint.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dopt_torch.obs.serve", str(metrics),
         "--port", "0", "--state-file", str(state)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=tmp_path, env=_env())
    try:
        info = json.loads(proc.stdout.readline())
        assert info["port"] > 0 and info["pid"] == proc.pid
        deadline = time.time() + 30
        while not state.exists() and time.time() < deadline:
            time.sleep(0.05)
        assert json.loads(state.read_text())["port"] == info["port"]
        code, body, _ = _http(f"http://127.0.0.1:{info['port']}/healthz")
        assert code == 200 and json.loads(body)["rounds"] == 2
        os.kill(proc.pid, signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not state.exists()
    finally:
        proc.stdout.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
