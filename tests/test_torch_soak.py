"""The port's acceptance harnesses (``dopt_torch.scripts.chaos_soak`` and
``dopt_torch.scripts.serve_soak``) against dopt's ``scripts/``, on the CPU.

dopt's soaks are imported from their files, as ``tests/test_network.py``
imports the chaos soak.  The cocktail and every config are held to
dopt's field for field (floats bit for bit); each cocktail leg's
continuous 4-round run is held to dopt's from dopt's init: the fault
ledger row for row, every History row within ROADMAP's multi-round bound
(1e-3 train loss, 1e-4 test accuracy), and the canonical ``round`` and
``fault`` events equal in kind, round and worker.  The serve soak's
daemon argv, command schedule, rule set, SLO names, SIGTERM rounds and
``--min-seconds`` calibration are held to dopt's with the daemons
replaced by stand-ins, apart from the port's stated differences
(``--device``, a fleet rank's one device over gloo, no SIGTERM within
two boundaries of a scheduled command).  The harnesses themselves run
end to end with ``--device cpu`` (a real SIGKILLed child, real daemon
subprocesses and signals, a gloo fleet), and each is shown able to fail,
by monkeypatches here and no switch in the package.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import time
import types

import jax
import numpy as np
import pytest
import torch

from dopt_torch.scripts import chaos_soak as T
from dopt_torch.scripts import serve_soak as TS

REPO = pathlib.Path(__file__).resolve().parent.parent
LOSS_TOL, ACC_TOL = 1e-3, 1e-4
LEGS = ("gossip", "gossip-async", "gossip-codec", "federated")


def _load_dopt_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"dopt_scripts_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _load_dopt_script("chaos_soak")
JS = _load_dopt_script("serve_soak")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


# -- the cocktail and the configs --------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_cocktail_is_dopts_bit_for_bit(seed):
    want, got = J.cocktail(seed), T.cocktail(seed)
    assert len(got) == len(want) == 4
    for a, b in zip(want, got, strict=True):
        fa, fb = _fields(a), _fields(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            # Exact, types included: a float drawn from the same stream.
            assert type(fa[k]) is type(fb[k]) and fa[k] == fb[k], k


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("leg", LEGS)
def test_leg_configs_are_dopts(leg, prefetch):
    assert (_fields(T.build_cfg(leg, 3, 8, prefetch=prefetch))
            == _fields(J.build_cfg(leg, 3, 8, prefetch=prefetch)))


class _Recorder:
    """A trainer stand-in that records its config and trains nothing."""

    seen: list = []

    def __init__(self, cfg, **kw):
        type(self).seen.append(cfg)

    def run(self, rounds):
        return None


class _QuietMonitor:
    """A monitor stand-in whose report is a healthy empty run."""

    def __init__(self, *args, **kw):
        self.alerts = []

    def attach(self, telemetry):
        return self

    def report(self):
        return types.SimpleNamespace(alerts=0, verdict="healthy", ok=True,
                                     to_dict=dict)

    def canonical_alerts(self):
        return []


def _gate_configs(monkeypatch, engine_mod, obs_mod, gate, *args, **kw):
    _Recorder.seen = []
    monkeypatch.setattr(engine_mod, "GossipTrainer", _Recorder)
    monkeypatch.setattr(engine_mod, "FederatedTrainer", _Recorder)
    monkeypatch.setattr(obs_mod, "attach", lambda *a, **k: None)
    monkeypatch.setattr(obs_mod, "HealthMonitor", _QuietMonitor)
    try:
        gate(*args, **kw)
    except AssertionError:
        pass    # the divergence gate finds no alert in an empty run
    return list(_Recorder.seen)


def test_gate_configs_are_dopts(monkeypatch):
    """The clean gate's two preset-derived configs and the divergence
    bomb's config, captured at the trainers' constructors."""
    import dopt.engine
    import dopt.obs
    import dopt_torch.engine
    import dopt_torch.obs

    for name in ("clean_baseline_gate", "divergence_gate"):
        want = _gate_configs(monkeypatch, dopt.engine, dopt.obs,
                             getattr(J, name), 6)
        got = _gate_configs(monkeypatch, dopt_torch.engine, dopt_torch.obs,
                            getattr(T, name), 6, device="cpu")
        assert len(got) == len(want) == (2 if name.startswith("clean")
                                         else 1)
        for a, b in zip(want, got, strict=True):
            assert _fields(a) == _fields(b), name


# -- each leg against dopt ---------------------------------------------------
def _run_dopt(leg: str, rounds: int):
    from dopt.engine import FederatedTrainer, GossipTrainer
    from dopt.obs import MemorySink, Telemetry, attach

    cfg = J.build_cfg(leg, 0, rounds).replace(mesh_devices=1)
    tr = (GossipTrainer if leg.startswith("gossip")
          else FederatedTrainer)(cfg)
    init = (jax.tree.map(lambda x: x[0], tr.params)
            if leg.startswith("gossip") else tr._theta_single())
    mem = MemorySink()
    attach(tr, Telemetry([mem]), fresh=True)
    tr.run(rounds=rounds)
    return tr, jax.device_get(init), mem.events


def _canon(events, canonical):
    return [(e["kind"], e["round"], e.get("worker"))
            for e in canonical(events, kinds=("round", "fault"))]


@pytest.mark.parametrize("leg", LEGS)
def test_leg_matches_dopt(leg):
    """One continuous 4-round cocktail run from seed 0, the port from
    dopt's init: ledger row for row, History within 1e-3 train loss and
    1e-4 test accuracy, the canonical round and fault events equal."""
    import dopt.obs
    import dopt_torch.obs
    from dopt_torch.engine import FederatedTrainer, GossipTrainer
    from dopt_torch.obs import MemorySink, Telemetry, attach

    rounds = 4
    jt, init, j_events = _run_dopt(leg, rounds)
    cls = GossipTrainer if leg.startswith("gossip") else FederatedTrainer
    tr = cls(T.build_cfg(leg, 0, rounds), device="cpu", init_params=init)
    mem = MemorySink()
    attach(tr, Telemetry([mem]), fresh=True)
    tr.run(rounds=rounds)
    hj, ht = jt.history, tr.history
    assert hj.faults, "the storm drew no fault in 4 rounds"
    assert ht.faults == hj.faults
    key = T.loss_key(hj)
    acc = "avg_test_acc" if "avg_test_acc" in hj.rows[0] else "test_acc"
    worst_loss = worst_acc = 0.0
    for a, b in zip(hj.rows, ht.rows, strict=True):
        assert a.keys() == b.keys()
        worst_loss = max(worst_loss, abs(a[key] - b[key]))
        worst_acc = max(worst_acc, abs(a[acc] - b[acc]))
    print(f"{leg}: {len(hj.faults)} ledger rows equal; worst |d {key}| "
          f"{worst_loss:.3e} (bound {LOSS_TOL}), worst |d {acc}| "
          f"{worst_acc:.3e} (bound {ACC_TOL})")
    assert worst_loss <= LOSS_TOL and worst_acc <= ACC_TOL
    assert (_canon(mem.events, dopt_torch.obs.canonical)
            == _canon(j_events, dopt.obs.canonical))


# -- the chaos soak end to end -----------------------------------------------
@pytest.mark.parametrize("leg,extra", [
    ("gossip", ["--prefetch"]),
    ("gossip-async", ["--skip-gates"]),
    ("gossip-codec", ["--skip-gates"]),
    ("federated", ["--skip-gates"]),
])
def test_chaos_soak_main_passes(leg, extra, tmp_path, capsys):
    from dopt_torch.obs.check import main as check_main

    metrics, report = tmp_path / "m.jsonl", tmp_path / "r.json"
    rc = T.main(["--rounds", "4", "--seed", "0", "--engine", leg,
                 "--device", "cpu", "--ckpt-dir", str(tmp_path),
                 "--metrics-out", str(metrics), "--report-out", str(report),
                 *extra])
    out = capsys.readouterr().out
    assert rc == 0
    assert "chaos soak passed: convergence + ledger + checkpoint" in out
    assert check_main([str(metrics)]) == 0
    reports = json.loads(report.read_text())
    assert f"cocktail_{leg}" in reports
    if "--skip-gates" not in extra:
        assert {"clean_baseline1", "clean_baseline3",
                "divergence_bomb"} <= set(reports)
        assert "prefetch armed" in out


def test_chaos_soak_real_sigkill_resume(tmp_path, capsys,
                                        _one_thread_daemons):
    rc = T.main(["--rounds", "4", "--seed", "0", "--engine", "gossip",
                 "--kill", "--skip-gates", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[gossip] SIGKILL-and-resume bit-identical ok" in out


def test_chaos_soak_fails_on_a_skipped_ledger_row(monkeypatch, tmp_path):
    """A resumed trainer that loses one ledger row must fail the soak."""
    from dopt_torch.engine import GossipTrainer

    restore = GossipTrainer.restore

    def lossy_restore(self, path):
        out = restore(self, path)
        assert self.history.faults
        self.history.faults.pop(0)
        return out

    monkeypatch.setattr(GossipTrainer, "restore", lossy_restore)
    with pytest.raises(AssertionError,
                       match="resumed fault ledger diverged"):
        T.main(["--rounds", "4", "--seed", "0", "--engine", "gossip",
                "--skip-gates", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)])


def test_divergence_gate_fails_without_its_rule(monkeypatch):
    """The scale bomb against a stock rule set without loss_divergence
    must fail the divergence gate."""
    import dopt_torch.obs
    from dopt_torch.obs.rules import default_rules

    class NoDivergence(dopt_torch.obs.HealthMonitor):
        def __init__(self, rules=None, **kw):
            super().__init__(default_rules(loss_divergence=None)
                             if rules is None else rules, **kw)

    monkeypatch.setattr(dopt_torch.obs, "HealthMonitor", NoDivergence)
    with pytest.raises(AssertionError, match="did not fire loss_divergence"):
        T.divergence_gate(6, device="cpu")


# -- the serve soak against dopt's -------------------------------------------
@pytest.fixture
def _one_thread_daemons(monkeypatch):
    # The daemons and the SIGKILL child are subprocesses: one intra-op
    # thread each keeps them from oversubscribing the test workers' cores.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


class _Stop(Exception):
    """Raised by a stand-in once the harness has shown what it asks for."""


def _daemon_argv(cmd: list[str]) -> list[str]:
    """A daemon command without its interpreter, the port's module name
    read as dopt's, and the flags where the port differs by design
    (``--device``; a fleet rank's device count and collectives) taken
    out."""
    out, skip = [], False
    for a in cmd[1:]:
        if skip:
            skip = False
        elif a in ("--device", "--devices-per-proc", "--collectives"):
            skip = True
        else:
            out.append({"dopt_torch.serve": "dopt.serve"}.get(a, a))
    return out


def _flag(cmd: list[str], name: str):
    return cmd[cmd.index(name) + 1] if name in cmd else None


def _queued(state_dir: pathlib.Path) -> list[dict]:
    """The commands queued for a daemon, without the enqueue wall stamp."""
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in (state_dir / "commands.jsonl").read_text()
            .splitlines() if line]


def test_serve_soak_constants_are_dopts():
    assert TS.SENSITIZED_RULES == JS.SENSITIZED_RULES
    assert TS.SLO_CORE == JS.SLO_CORE


@pytest.mark.parametrize("rounds,seed,every", [
    (48, 11, 8), (16, 0, 4), (24, 5, 8), (400, 11, 12), (100000, 3, 8)])
@pytest.mark.parametrize("engine", ["gossip", "federated"])
def test_serve_args_are_dopts(engine, rounds, seed, every):
    assert (TS.serve_args(engine, rounds, seed, every)
            == JS.serve_args(engine, rounds, seed, every))


@pytest.mark.parametrize("rounds", [1, 2, 5, 16, 24, 40, 48, 400])
def test_seed_commands_are_dopts(rounds, tmp_path):
    want = JS.seed_commands(tmp_path / "dopt", rounds)
    got = TS.seed_commands(tmp_path / "port", rounds)
    assert got == want
    queued = _queued(tmp_path / "port")
    assert len(queued) == 3 and queued == _queued(tmp_path / "dopt")


def _main_legs(monkeypatch, mod, argv, elapsed) -> list[tuple]:
    """Run ``mod.main`` with ``run_leg`` stood in: each uninterrupted leg
    reports ``elapsed(rounds)`` seconds; the restarted leg stops the run.
    Returns each leg's (name, argv, on_term, kill_at)."""
    legs = []

    def run_leg(name, state_dir, argv_, *, on_term, kill_at=None,
                timeout_s=900.0):
        legs.append((name, list(argv_), on_term, kill_at))
        if name == "restarted":
            raise _Stop
        return {"_elapsed_s": elapsed(int(_flag(argv_, "--max-rounds")))}

    monkeypatch.setattr(mod, "run_leg", run_leg)
    with pytest.raises(_Stop):
        mod.main(argv)
    return legs


@pytest.mark.parametrize("engine,rounds,min_s,per_round", [
    ("gossip", 48, 0.0, 0.3), ("federated", 24, 0.0, 0.3),
    ("gossip", 16, 0.0, 0.3), ("gossip", 4, 0.0, 0.3),
    # --min-seconds 60: one rescale, then two.
    ("gossip", 48, 60.0, 0.05), ("federated", 24, 60.0, 0.01)])
def test_serve_soak_legs_are_dopts(engine, rounds, min_s, per_round,
                                   monkeypatch, tmp_path):
    """The single-host legs: the same daemon argv (the port's adds only
    ``--device``), the same ``on_term``, the same ``kill_at`` and, under
    ``--min-seconds``, the same rescaled round counts."""
    args = ["--engine", engine, "--rounds", str(rounds),
            "--min-seconds", str(min_s)]
    want = _main_legs(monkeypatch, JS, [*args, "--state-root",
                                        str(tmp_path / "dopt")],
                      lambda r: r * per_round)
    got = _main_legs(monkeypatch, TS, [*args, "--device", "cpu",
                                       "--state-root", str(tmp_path / "port")],
                     lambda r: r * per_round)
    assert len(got) == len(want) >= 2
    for (wn, wa, wt, wk), (gn, ga, gt, gk) in zip(want, got, strict=True):
        assert (gn, gt, gk) == (wn, wt, wk)
        assert ga == [*wa, "--device", "cpu"]
    if min_s:
        assert len(want) > 2, "the calibration never rescaled"


class _FakeDaemon:
    """A daemon stand-in: each ``wait`` or ``poll`` serves up to the next
    round of ``seen`` (default: every round to ``rounds``) and writes
    ``serve.json`` as the daemon does."""

    pid = 4242

    def __init__(self, state_dir: pathlib.Path, rounds: int, seen=None):
        self.status = state_dir / "serve.json"
        self.seen = list(seen or range(1, rounds + 1))
        self.round = 0

    def _serve(self) -> bool:
        if not self.seen:
            return False
        self.round = self.seen.pop(0)
        self.status.write_text(json.dumps({"status": "serving",
                                           "round": self.round}))
        return True

    def wait(self, timeout=None):
        if timeout is None:
            return 1    # a fleet's supervisor, once its loop is done
        if self._serve():
            raise subprocess.TimeoutExpired("daemon", timeout)
        return 0

    def poll(self):
        return None if self._serve() else 0


def _sigterm_round(monkeypatch, mod, state_dir, rounds, kill_at) -> int:
    """Drive ``mod.run_leg`` over a stand-in daemon that serves one round
    a poll; returns the round at which it sent its SIGTERM."""
    (state_dir / "final.json").write_text(json.dumps({"round": rounds,
                                                      "restarts": 1}))
    daemon = _FakeDaemon(state_dir, rounds)
    sent, cmds = [], []

    def popen(cmd, **kw):
        cmds.append(cmd)
        return daemon

    monkeypatch.setattr(mod, "subprocess", types.SimpleNamespace(
        Popen=popen, TimeoutExpired=subprocess.TimeoutExpired))
    monkeypatch.setattr(mod, "os", types.SimpleNamespace(
        kill=lambda pid, sig: sent.append(daemon.round),
        environ=os.environ))
    mod.run_leg("restarted", state_dir, ["--max-rounds", str(rounds)],
                on_term="restart", kill_at=kill_at)
    assert len(sent) == 1 and _daemon_argv(cmds[0]) == [
        "-m", "dopt.serve", "--max-rounds", str(rounds), "--state-dir",
        str(state_dir), "--on-term", "restart"]
    return sent[0]


@pytest.mark.parametrize("rounds", [4, 16, 24, 40, 48, 400])
def test_run_leg_sigterm_round_against_dopts(rounds, monkeypatch, tmp_path):
    """dopt's ``run_leg`` sends its SIGTERM at the first serving round
    >= ``kill_at``; the port's at the first such round with no scheduled
    command within two boundaries (a stated difference of the port).  At
    the soak's default 48 rounds and chip_smoke.py's 24 the two are the
    same round."""
    kill_at = max(3 * rounds // 8, 2)     # both mains' (held equal above)
    sent = {}
    for name, mod in (("dopt", JS), ("port", TS)):
        state = tmp_path / name
        marks = set(mod.seed_commands(state, rounds).values())
        sent[name] = _sigterm_round(monkeypatch, mod, state, rounds,
                                    kill_at)
    assert sent["dopt"] == kill_at
    assert sent["port"] == min(
        r for r in range(kill_at, rounds + 1)
        if not marks & {r, r + 1, r + 2})
    if rounds in (24, 48, 400):
        assert sent["port"] == sent["dopt"]


def _args(**kw):
    base = dict(engine="gossip", rounds=16, seed=11, checkpoint_every=8,
                device="cpu", slo_out=None, minutes=0.5, churn_period=20.0)
    return types.SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("engine,rounds,seen,n_sent", [
    ("gossip", 16, None, 1), ("gossip", 40, None, 1),
    ("federated", 24, None, 1), ("gossip", 6, None, 1),
    # Rounds 13 and 14 seen past the window's end (rounds - 4): none.
    ("gossip", 16, [1, 5, 13, 14, 16], 0)])
def test_fleet_leg_is_dopts(engine, rounds, seen, n_sent, monkeypatch,
                            tmp_path, capsys):
    """The fleet leg: the same schedule line, commands and rule file, the
    same daemon argv apart from one device a rank over gloo, and the
    follower's SIGTERM in the same round (none when the fleet is first
    seen past the window)."""
    legs = {}
    for name, mod in (("dopt", JS), ("port", TS)):
        root = tmp_path / name
        daemons, sent = [], []

        def popen(cmd, **kw):
            daemons.append((cmd, _FakeDaemon(root / "fleet", rounds,
                                             seen)))
            return daemons[-1][1]

        monkeypatch.setattr(mod, "subprocess",
                            types.SimpleNamespace(Popen=popen))
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=time.time, sleep=lambda s: None))
        monkeypatch.setattr(mod, "sigterm_child", lambda state, pid: (
            sent.append((pid, daemons[0][1].round)) or True))
        with pytest.raises(AssertionError, match="supervisor exited rc=1"):
            mod.run_fleet_soak(_args(engine=engine, rounds=rounds), root)
        line = [x for x in capsys.readouterr().out.splitlines()
                if x.startswith("[fleet] engine=")]
        cmd = daemons[0][0]
        legs[name] = (line, sent, _queued(root / "fleet"),
                      (root / "fleet-rules.json").read_text(),
                      [a.replace(str(root), "ROOT")
                       for a in _daemon_argv(cmd)])
        if name == "dopt":
            assert _flag(cmd, "--devices-per-proc") == "2"
        else:
            assert (_flag(cmd, "--devices-per-proc"),
                    _flag(cmd, "--collectives"), _flag(cmd, "--device")) \
                == ("1", "gloo", "cpu")
    assert legs["port"] == legs["dopt"]
    assert len(legs["port"][1]) == n_sent


def test_decoupled_and_long_legs_are_dopts(monkeypatch, tmp_path, capsys):
    """The decoupled leg's and the long soak's daemon argv (the port's
    adds only ``--device``), schedule lines and rule file."""
    for leg in ("run_decoupled_soak", "run_long_soak"):
        seen = {}
        for name, mod in (("dopt", JS), ("port", TS)):
            root = tmp_path / leg / name
            cmds = []

            def popen(cmd, **kw):
                cmds.append(cmd)
                raise _Stop

            monkeypatch.setattr(mod, "subprocess",
                                types.SimpleNamespace(Popen=popen))
            with pytest.raises(_Stop):
                getattr(mod, leg)(_args(), root)
            lines = [x for x in capsys.readouterr().out.splitlines()
                     if x.startswith(("[decoupled]", "[long]"))]
            rules = root / "long-rules.json"
            seen[name] = (lines, rules.read_text() if rules.exists()
                          else None,
                          [a.replace(str(root), "ROOT")
                           for a in _daemon_argv(cmds[0])])
            assert _flag(cmds[0], "--device") == (
                "cpu" if name == "port" else None)
        assert seen["port"] == seen["dopt"], leg


# -- the serve soak end to end -----------------------------------------------


@pytest.mark.parametrize("engine", ["gossip", "federated"])
def test_serve_soak_single_host(engine, tmp_path, capsys,
                                _one_thread_daemons):
    from dopt_torch.scripts import serve_soak

    report = tmp_path / "report.json"
    rc = serve_soak.main(["--engine", engine, "--rounds", "16",
                          "--checkpoint-every", "4", "--device", "cpu",
                          "--state-root", str(tmp_path / "root"),
                          "--report-out", str(report)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "serve soak passed: live membership + config change" in out
    doc = json.loads(report.read_text())
    assert doc["engine"] == engine and doc["rounds"] == 16
    assert doc["restarted"]["restarts"] >= 1


def test_serve_soak_fleet_and_decoupled(tmp_path, capsys,
                                        _one_thread_daemons):
    from dopt_torch.scripts import serve_soak

    slo = tmp_path / "slo.json"
    rc = serve_soak.main(["--fleet", "--rounds", "16", "--device", "cpu",
                          "--state-root", str(tmp_path / "root"),
                          "--slo-out", str(slo)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "fleet soak passed: 2-process fleet with rolling restart" in out
    assert "decoupled soak passed: one_peer_exp+async fleet" in out
    doc = json.loads(slo.read_text())
    assert doc["mode"] == "fleet" and doc["restarts"] >= 1
    for name in serve_soak.SLO_CORE + ("alert_latency",):
        assert np.isfinite(doc["slo"][name]["p99"]), name
    assert (tmp_path / "root" / "decoupled" / "decoupled-report.json").exists()


def test_serve_soak_long_mode(tmp_path, capsys, _one_thread_daemons):
    from dopt_torch.scripts import serve_soak

    slo = tmp_path / "slo.json"
    rc = serve_soak.main(["--minutes", "0.25", "--churn-period", "2",
                          "--device", "cpu",
                          "--state-root", str(tmp_path / "root"),
                          "--slo-out", str(slo)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "long soak passed: resident through randomized live" in out
    doc = json.loads(slo.read_text())
    assert doc["mode"] == "long" and doc["commands"] >= 1
