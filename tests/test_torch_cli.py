"""The port's CLI takes dopt's command lines, and the host helpers that
ride with it, against dopt on the CPU.

``python -m dopt_torch.run`` with dopt's ``--num-users``,
``--synthetic-scale`` (its floors: 8 train samples a worker, 64 test
samples) and ``--timers``; the config header on stderr is dopt's
``exp_details`` of the same config, character for character, and the
timer report has dopt's columns.  ``from_reference_args`` and
``time_to_target`` equal dopt's on the same inputs.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

import dopt.config as J
import dopt_torch.config as T
from dopt.presets import get_preset as jax_preset
from dopt.utils import metrics as jmetrics
from dopt.utils.profiling import PhaseTimers as JaxPhaseTimers
from dopt_torch.utils import metrics as tmetrics
from dopt_torch.utils.profiling import PhaseTimers

REPO = Path(__file__).resolve().parent.parent
TIMER_HEADER = "phase                total_s   count   mean_s"


def _dopt_cli_cfg(preset, *, num_users, scale, stage_sizes=None):
    """dopt's run.py applied to ``preset``: the model edit stands in for
    a ``--set`` (a tuple is not settable from either CLI), then
    ``--num-users`` and ``--synthetic-scale`` with their floors."""
    cfg = jax_preset(preset)
    if stage_sizes is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    stage_sizes=stage_sizes))
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_users=num_users))
    d = cfg.data
    return cfg.replace(data=dataclasses.replace(
        d, synthetic_train_size=max(int(d.synthetic_train_size * scale),
                                    d.num_users * 8),
        synthetic_test_size=max(int(d.synthetic_test_size * scale), 64)))


@pytest.mark.parametrize("scale", ["0.01", "0.0001"])
def test_cli_baseline1_takes_dopts_flags(scale):
    """``--preset baseline1 --device cpu --num-users 4 --synthetic-scale
    S --rounds 1 --timers`` exits 0 in a subprocess; stderr opens with
    dopt's header (at 0.0001 both floors bind: 32 train, 64 test
    samples) and ends with dopt's timer table."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "dopt_torch.run", "--preset", "baseline1",
         "--device", "cpu", "--num-users", "4", "--synthetic-scale", scale,
         "--rounds", "1", "--timers"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    want = J.exp_details(_dopt_cli_cfg("baseline1", num_users=4,
                                       scale=float(scale)))
    assert res.stderr.startswith(want + "\n")
    if scale == "0.0001":
        assert "synthetic_train_size: 32" in want
        assert "synthetic_test_size: 64" in want
    report = res.stderr[res.stderr.index(TIMER_HEADER):].splitlines()
    rows = {line.split()[0]: line.split()[1:] for line in report[1:]}
    assert rows["round_step"][1] == "1"
    assert len(res.stdout.strip().splitlines()) == 1


def test_cli_baseline5_reduced_depth(monkeypatch, capsys):
    """``--preset baseline5 --device cpu --num-users 2 --synthetic-scale
    0.001 --rounds 1`` in-process, with ``model.stage_sizes=(1, 1, 1,
    1)`` put in the preset (``--set`` reaches no tuple): exit 0, dopt's
    header, one finite round of 2 workers."""
    import json
    import math

    import dopt_torch.presets as presets
    from dopt_torch.run import main

    get = presets.get_preset
    monkeypatch.setattr(presets, "get_preset", lambda name: (
        lambda c: c.replace(model=dataclasses.replace(
            c.model, stage_sizes=(1, 1, 1, 1))))(get(name)))
    assert main(["--preset", "baseline5", "--device", "cpu", "--num-users",
                 "2", "--synthetic-scale", "0.001", "--rounds", "1",
                 "--timers"]) == 0
    out, err = capsys.readouterr()
    want = J.exp_details(_dopt_cli_cfg("baseline5", num_users=2, scale=0.001,
                                       stage_sizes=(1, 1, 1, 1)))
    assert err.startswith(want + "\n")
    assert TIMER_HEADER in err
    row = json.loads(out.strip().splitlines()[-1])
    assert row["round"] == 0 and math.isfinite(row["avg_train_loss"])


def test_exp_details_equals_dopts_on_every_section():
    """A config with every optional section set prints dopt's string."""
    kw = dict(faults="FaultConfig", robust="RobustConfig")
    want = J.ExperimentConfig(
        gossip=J.GossipConfig(), **{k: getattr(J, v)() for k, v in kw.items()})
    got = T.ExperimentConfig(
        gossip=T.GossipConfig(), **{k: getattr(T, v)() for k, v in kw.items()})
    assert T.exp_details(got) == J.exp_details(want)
    assert T.exp_details(T.ExperimentConfig()) == J.exp_details(
        J.ExperimentConfig())


REFERENCE_ARGS = [
    # P1 notebook form (federated), its unused keys None.
    {"num_users": 100, "frac": 0.1, "local_ep": 10, "local_bs": 50,
     "lr": 0.1, "rho": 0.1, "seed": 2022, "model": None, "dataset": "mnist",
     "iid": True, "topology": None, "mode": None, "rounds": 20},
    # P2 notebook form (gossip).
    {"num_users": 6, "local_ep": 4, "local_bs": 128, "lr": 0.01,
     "momentum": 0.5, "dataset": "mnist", "iid": False, "shards": 2,
     "topology": "circle", "mode": "stochastic", "rounds": 10, "seed": 2028,
     "algorithm": "fedlcon", "eps": 5},
    {"dataset": "cifar", "topology": "complete", "name": "c"},
    {"dataset": "cifar100", "algorithm": "fedprox"},
    {"dataset": "a9a", "algorithm": "fedadmm", "rho": 1.0},
    {"dataset": "synthetic", "input_shape": [8, 8, 1], "paradigm": "gossip"},
    {"dataset": "fmnist", "model": "MLP", "faithful": False,
     "data_dir": "raw"},
]


@pytest.mark.parametrize("args", REFERENCE_ARGS,
                         ids=[str(i) for i in range(len(REFERENCE_ARGS))])
def test_from_reference_args_equals_dopts(args):
    assert (dataclasses.asdict(T.from_reference_args(args))
            == dataclasses.asdict(J.from_reference_args(args)))


def test_from_reference_args_refuses_unequal_as_dopt():
    for mod in (J, T):
        with pytest.raises(ValueError, match="unequal splits"):
            mod.from_reference_args({"unequal": 1})


@pytest.mark.parametrize("target,rate,key", [
    (0.5, None, "avg_test_acc"), (0.5, 2.5, "avg_test_acc"),
    (0.99, 1.0, "avg_test_acc"), (0.3, 0.5, "test_acc")])
def test_time_to_target_equals_dopts(target, rate, key):
    """Rows without the key (eval-skipped rounds) are passed over; the
    result is dopt's for reached and unreached targets."""
    rows = [{"round": 0, "avg_test_acc": 0.2, "test_acc": 0.1},
            {"round": 1, "avg_train_loss": 1.0},
            {"round": 2, "avg_test_acc": 0.55, "test_acc": 0.35},
            {"round": 3, "avg_test_acc": 0.7}]
    hs = []
    for mod in (jmetrics, tmetrics):
        h = mod.History("h")
        for r in rows:
            h.append(**r)
        hs.append(h)
    want = jmetrics.time_to_target(hs[0], target=target, key=key,
                                   seconds_per_round=rate)
    assert tmetrics.time_to_target(hs[1], target=target, key=key,
                                   seconds_per_round=rate) == want


def test_phase_timers_report_equals_dopts():
    """Equal totals and counts print dopt's table, longest phase first."""
    a, b = JaxPhaseTimers(), PhaseTimers()
    for t in (a, b):
        t.totals.update({"round_step": 12.345678, "host_batch_plan": 0.25,
                         "checkpoint": 1.5})
        t.counts.update({"round_step": 7, "host_batch_plan": 7,
                         "checkpoint": 2})
    assert b.summary() == a.summary()
    assert b.report() == a.report()
    assert b.report().splitlines()[0] == TIMER_HEADER
