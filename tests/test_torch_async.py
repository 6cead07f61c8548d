"""Async (staleness-1) and one-peer mixing in the port's GossipTrainer,
against dopt's (the port's counterpart of tests/test_async_gossip.py).

Both packages run the same config from dopt's init on the CPU: the MLP
on the synthetic set, 8 workers, 512 train / 128 test, batch 32, one
local epoch, dsgd on the one-peer exponential schedule (dopt mixes it
on its shift path, the port on the dense one) or the complete graph.
Tolerances: one round 1e-5 max-relative params (the single-round
standard, PARITY.md); two rounds slice 1's multi-round limits — train
loss 1e-3 absolute, test accuracy 1e-4 absolute, params 1e-4
max-relative.  The port's own promises hold bit for bit: async round 0
equals sync round 0 (round −1's state is the shared init, and the
one-peer weights are dyadic), blocked ≡ per-round ≡ prefetched, killed
and resumed ≡ continuous.  Every composition dopt refuses the port
refuses in dopt's words.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt_torch.convert import params_to_jax
from dopt_torch.engine import GossipTrainer

REPO = pathlib.Path(__file__).resolve().parent.parent
# Slice 1's multi-round limits and the single-round standard.
LOSS_TOL, ACC_TOL, PARAM_TOL, ROUND_TOL = 1e-3, 1e-4, 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, *, faults=None, robust=None, users=8, top=None, **g_over):
    """``top``: top-level ExperimentConfig fields (dopt's
    ``mesh_devices=1``)."""
    g = dict(algorithm="dsgd", topology="one_peer_exp", mode="metropolis",
             rounds=4, local_ep=1, local_bs=32)
    g.update(g_over)
    return mod.ExperimentConfig(
        name="async", seed=7, **(top or {}),
        data=mod.DataConfig(dataset="synthetic", num_users=users, iid=True,
                            shards=2, synthetic_train_size=512,
                            synthetic_test_size=128),
        model=mod.ModelConfig(model="mlp", input_shape=(28, 28, 1),
                              faithful=False),
        optim=mod.OptimizerConfig(lr=0.1, momentum=0.5),
        faults=faults, robust=robust, gossip=mod.GossipConfig(**g))


def _state(tr) -> dict:
    out = {f"p.{k}": v for k, v in tr.worker_params().items()}
    out.update({f"m.{k}": v.detach().cpu().numpy()
                for k, v in zip(tr._names, tr.momentum)})
    if tr._async:
        out.update({f"prev.{k}": v.cpu().numpy()
                    for k, v in tr._async_prev.items()})
    return out


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _pair(faults=None, **kw):
    """dopt's trainer and the port's from dopt's init (``faults``: the
    FaultConfig fields)."""
    jt = JaxGossipTrainer(_cfg(J, top={"mesh_devices": 1},
                               faults=None if faults is None
                               else J.FaultConfig(**faults), **kw))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    return jt, GossipTrainer(
        _cfg(T, faults=None if faults is None else T.FaultConfig(**faults),
             **kw), device="cpu", init_params=init)


def _max_rel(jt, tt) -> float:
    want = jax.device_get(jt.worker_params())
    got = params_to_jax(tt.worker_params(), input_shape=(28, 28, 1))
    return max(float(np.abs(np.asarray(want[layer][k]) - got[layer][k]).max()
                   / np.abs(np.asarray(want[layer][k])).max())
               for layer in want for k in want[layer])


def _close_rows(want, got) -> None:
    for a, b in zip(want, got, strict=True):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        assert abs(a["avg_train_loss"] - b["avg_train_loss"]) <= LOSS_TOL
        assert abs(a["avg_test_acc"] - b["avg_test_acc"]) <= ACC_TOL


def test_async_round0_equals_sync_round0():
    """Round −1's prev buffer is the shared init: async round 0 mixes
    exactly what sync round 0 mixes."""
    s = GossipTrainer(_cfg(T), device="cpu")
    a = GossipTrainer(_cfg(T, mixing="async"), device="cpu")
    assert s.run(rounds=1).rows == a.run(rounds=1).rows
    _same({k: v for k, v in _state(s).items()},
          {k: v for k, v in _state(a).items() if not k.startswith("prev")})


@pytest.mark.parametrize("topology,mixing", [("one_peer_exp", "sync"),
                                             ("one_peer_exp", "async"),
                                             ("complete", "async")])
def test_matches_dopt(topology, mixing, devices):
    """One round within 1e-5, two within slice 1's limits, the History
    row keys equal; the one-peer schedule runs dense in the port."""
    jt, tt = _pair(topology=topology, mixing=mixing)
    jt.run(rounds=1)
    tt.run(rounds=1)
    assert _max_rel(jt, tt) <= ROUND_TOL
    jt.run(rounds=1)
    tt.run(rounds=1)
    _close_rows(jt.history.rows, tt.history.rows)
    assert _max_rel(jt, tt) <= PARAM_TOL


@pytest.mark.parametrize("mixing", ["sync", "async"])
def test_blocked_and_prefetched_equal_per_round(mixing):
    runs = []
    for block, prefetch in ((1, "off"), (2, "off"), (3, "on")):
        tr = GossipTrainer(_cfg(T, mixing=mixing, prefetch=prefetch),
                           device="cpu")
        runs.append((tr.run(rounds=4, block=block).rows, _state(tr)))
    for rows, st in runs[1:]:
        assert rows == runs[0][0]
        _same(runs[0][1], st)


def test_async_resume_bit_exact(tmp_path):
    """Killed after round 2's checkpoint, resumed by a fresh trainer, in
    blocks: the continuous run bit for bit, the prev buffer included."""
    cont = GossipTrainer(_cfg(T, mixing="async"), device="cpu")
    cont.run(rounds=4, block=2)
    part = GossipTrainer(_cfg(T, mixing="async"), device="cpu")
    part.run(rounds=2, block=2, checkpoint_every=2,
             checkpoint_path=tmp_path / "ck")
    res = GossipTrainer(_cfg(T, mixing="async"), device="cpu")
    res.restore(tmp_path / "ck")
    assert res.round == 2
    res.run(rounds=2, block=2)
    assert res.history.rows == cont.history.rows
    _same(_state(cont), _state(res))


def test_async_restore_requires_prev_buffer(tmp_path):
    sync = GossipTrainer(_cfg(T), device="cpu")
    sync.run(rounds=1, checkpoint_every=1, checkpoint_path=tmp_path / "ck")
    with pytest.raises(ValueError, match="mixing='async' trainer requires "
                       r"its previous-round state \('async_prev'\)"):
        GossipTrainer(_cfg(T, mixing="async"), device="cpu").restore(
            tmp_path / "ck")


def test_dopt_async_checkpoint_restores_into_port(tmp_path, monkeypatch,
                                                  devices):
    """dopt's npz checkpoint of an async run (its ``async_prev``
    included) continues in the port: the next round within 1e-5."""
    import dopt.utils.checkpoint as jckpt

    monkeypatch.setattr(jckpt, "HAVE_ORBAX", False)
    jcfg = _cfg(J, mixing="async", top={"mesh_devices": 1})
    jt = JaxGossipTrainer(jcfg)
    jt.run(rounds=2)
    jt.save(tmp_path / "dopt")
    jr = JaxGossipTrainer(jcfg)
    jr.restore(tmp_path / "dopt")
    jr.run(rounds=1)
    tt = GossipTrainer(_cfg(T, mixing="async"), device="cpu")
    tt.restore(tmp_path / "dopt")
    assert tt.round == 2 and tt.history.rows == jt.history.rows
    tt.run(rounds=1)
    assert _max_rel(jr, tt) <= ROUND_TOL
    a, b = jr.history.rows[-1], tt.history.rows[-1]
    assert abs(a["avg_train_loss"] - b["avg_train_loss"]) <= ROUND_TOL


def test_async_crash_and_churn(devices):
    """Crash and churn compose with async: the ledger is dopt's row for
    row, blocked ≡ per-round, the trajectory within slice 1's limits of
    dopt's, and a lane down for a round holds its state through it (its
    repaired row splits into diag 1 and a zero off-diagonal row, and its
    local work is discarded)."""
    fc = dict(crash=0.15, churn=0.1, churn_span=2)
    jt, tt = _pair(faults=fc, mixing="async")
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    jt.run(rounds=4)
    held = 0
    for t in range(4):
        before = tt.worker_params()
        tt.run(rounds=1)
        after = tt.worker_params()
        down = {r["worker"] for r in tt.history.faults
                if r["round"] == t and r["kind"] == "crash"}
        for i in down:
            for k in before:
                np.testing.assert_array_equal(before[k][i], after[k][i])
            held += 1
    assert held, "the draw crashed no lane: raise the rate"
    assert tt.history.faults == jt.history.faults
    _close_rows(jt.history.rows, tt.history.rows)
    assert _max_rel(jt, tt) <= PARAM_TOL
    bl = GossipTrainer(_cfg(T, faults=T.FaultConfig(**fc), mixing="async"),
                       device="cpu", init_params=init)
    bl.run(rounds=4, block=2)
    assert bl.history.rows == tt.history.rows
    assert bl.history.faults == tt.history.faults
    _same(_state(tt), _state(bl))


REFUSALS = {
    "unknown": dict(mixing="asink"),
    "fedlcon": dict(mixing="async", algorithm="fedlcon", eps=2),
    "gossip": dict(mixing="async", algorithm="gossip"),
    "nocons": dict(mixing="async", algorithm="nocons"),
    "push_sum": dict(mixing="async", correction="push_sum"),
    "msg_drop": dict(mixing="async", faults=dict(msg_drop=0.2)),
    "clip": dict(mixing="async", robust=dict(clip_radius=1.0)),
    "corrupt": dict(mixing="async", faults=dict(corrupt=0.2,
                                                corrupt_mode="scale")),
    "fused": dict(mixing="async", fused_update="on"),
    "one_peer_self_weight": dict(self_weight=True),
    "one_peer_not_power_of_two": dict(users=6),
}


def _refusal_cfg(mod, over):
    over = dict(over)
    faults = over.pop("faults", None)
    robust = over.pop("robust", None)
    return _cfg(mod, faults=None if faults is None else mod.FaultConfig(
        **faults), robust=None if robust is None else mod.RobustConfig(
        **robust), **over)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_in_dopts_words(case, devices):
    over = REFUSALS[case]
    with pytest.raises(ValueError) as want:
        JaxGossipTrainer(_refusal_cfg(J, {**over, "top": {"mesh_devices": 1}}))
    with pytest.raises(ValueError) as got:
        GossipTrainer(_refusal_cfg(T, over), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("over,match", [
    # Since the scatter slice: dopt's own refusal of async with scatter,
    # and async over an explicit shift path runs (match None).
    pytest.param(dict(mixing="async", update_sharding="scatter"),
                 "mixing='async' does not compose with "
                 "update_sharding='scatter'",
                 id="over0-'scatter and multi-GPU' slice"),
    pytest.param(dict(mixing="async", comm_impl="shift"), None,
                 id="over1-'scatter and multi-GPU'"),
])
def test_multi_gpu_refusals_name_their_slice(over, match):
    """Async with the scatter path is refused in dopt's words; async over
    an explicit shift path mixes through the shift collectives; on one
    GPU ``comm_impl='auto'`` is the dense path."""
    if match is None:
        tr = GossipTrainer(_cfg(T, **over), device="cpu")
        assert tr._async and tr._shift_ids is not None
        assert len(tr.run(rounds=1).rows) == 1
    else:
        with pytest.raises(ValueError, match=match):
            GossipTrainer(_cfg(T, **over), device="cpu")
    tr = GossipTrainer(_cfg(T, mixing="async", comm_impl="auto"),
                       device="cpu")
    assert tr._async and tr._shift_ids is None


def _bench():
    spec = importlib.util.spec_from_file_location("dopt_bench",
                                                  REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@pytest.mark.parametrize("topology,mixing", [("complete", "sync"),
                                             ("one_peer_exp", "sync"),
                                             ("one_peer_exp", "async")])
def test_bench_topology_presets_are_bench_legs(topology, mixing):
    """``bench-topo-*`` = bench.py's ``_topology_config`` at the sizes its
    full run passes (16,384 / 2,048), field for field."""
    from dopt_torch.presets import get_preset

    want = _bench()._topology_config(topology=topology, mixing=mixing,
                                     train_size=16_384, test_size=2_048)
    got = get_preset(f"bench-topo-{topology}-{mixing}")
    assert (got.name, got.seed) == (want.name, want.seed)
    for section in ("data", "model", "optim", "gossip"):
        assert (dataclasses.asdict(getattr(got, section))
                == dataclasses.asdict(getattr(want, section))), section
    assert got.faults is None and got.robust is None
