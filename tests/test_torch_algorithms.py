"""The reference study's gossip algorithms in the port, against dopt.

nocons, centralized, fedlcon (eps sweeps and ``faithful_bugs``),
pairwise gossip matching and ``eval_mode="sharded"``: each runs in dopt
and in the port from dopt's init on the synthetic set (4 workers, 128
train / 32 test, batch 16, 2 rounds; dopt's Pallas kernels in interpret
mode, the port's kernels through their plain versions).  Limits, as
tests/test_torch_gossip.py sets them: train loss 1e-3 absolute, test
accuracy 1e-4 absolute, final worker params 1e-4 max-relative; one
round from one restored state 1e-5; host numpy draws (the matchings,
the sharded eval plan) bit for bit.  Within the port, blocked,
prefetched, killed-and-resumed and per-round runs of the matching path
are held bit for bit, the matching stream included.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
from dopt.data import pipeline as jpipe
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt.engine.gossip import random_matching_matrix as jax_matching
from dopt.presets import get_preset as jax_preset
from dopt.utils.prng import host_rng as jax_host_rng
from dopt_torch.convert import params_to_jax
from dopt_torch.data import sharded_eval_batches
from dopt_torch.engine import GossipTrainer
from dopt_torch.presets import get_preset
from dopt_torch.topology import random_matching_matrix
from dopt_torch.utils.prng import host_rng

SHAPE = (8, 8, 1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, algorithm="dsgd", *, model="mlp", iid=False, fused=False,
         workers=4, test_size=32, prefetch="off", **gossip):
    return mod.ExperimentConfig(
        name="algorithms", seed=11,
        data=mod.DataConfig(dataset="synthetic", num_users=workers, iid=iid,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=test_size),
        model=mod.ModelConfig(model=model, input_shape=SHAPE,
                              faithful=model != "mlp"),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, fused_update=fused),
        gossip=mod.GossipConfig(algorithm=algorithm, topology="circle",
                                mode="stochastic", rounds=2, local_ep=1,
                                local_bs=16, prefetch=prefetch,
                                fused_update="on" if fused else "off",
                                **gossip),
        mesh_devices=1)


def _pair(mk, **kw):
    """dopt's trainer and the port's, from dopt's init."""
    jt = JaxGossipTrainer(mk(J, **kw))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    return jt, GossipTrainer(mk(T, **kw), device="cpu", init_params=init)


def _close_rows(want, got, loss_tol=1e-3, acc_tol=1e-4):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k, v in a.items():
            tol = acc_tol if "acc" in k else loss_tol
            assert abs(v - b[k]) <= tol, (k, a, b)


def _close_params(jt, tt, limit=1e-4):
    want = jax.device_get(jt.worker_params())
    got = params_to_jax(tt.worker_params(), input_shape=SHAPE)
    assert want.keys() == got.keys()
    for layer in want:
        for k in want[layer]:
            a, b = np.asarray(want[layer][k]), got[layer][k]
            assert a.shape == b.shape
            rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
            assert rel <= limit, f"{layer}.{k}: {rel:.3e}"


ALGORITHMS = {
    "nocons-iid": ("nocons", {"iid": True}),
    "nocons-noniid": ("nocons", {}),
    "fedlcon-eps1": ("fedlcon", {"eps": 1}),
    "fedlcon-eps3": ("fedlcon", {"eps": 3}),
    "fedlcon-faithful-bugs": ("fedlcon", {"eps": 3, "faithful_bugs": True}),
    "gossip": ("gossip", {}),
    "gossip-fused": ("gossip", {"fused": True}),
    "gossip-model1-fused": ("gossip", {"fused": True, "model": "model1"}),
}


@pytest.mark.parametrize("case", ALGORITHMS)
def test_algorithm_matches_dopt(case):
    algorithm, kw = ALGORITHMS[case]
    jt, tt = _pair(_cfg, algorithm=algorithm, **kw)
    _close_rows(jt.run(rounds=2).rows, tt.run(rounds=2).rows)
    _close_params(jt, tt)
    if algorithm == "gossip":
        assert (tt._matching_rng.bit_generator.state
                == jt._matching_rng.bit_generator.state)


def test_faithful_bugs_runs_one_sweep():
    """fedlcon with ``faithful_bugs`` is one sweep a round: dsgd's run."""
    a = GossipTrainer(_cfg(T, "fedlcon", eps=3, faithful_bugs=True),
                      device="cpu")
    b = GossipTrainer(_cfg(T, "dsgd"), device="cpu")
    assert a.run(rounds=2).rows == b.run(rounds=2).rows
    c = GossipTrainer(_cfg(T, "fedlcon", eps=3), device="cpu")
    assert c.run(rounds=2).rows != a.history.rows


def test_centralized_matches_dopt():
    """``centralized`` is dopt's rewritten config (one worker, IID, one
    local epoch, run as nocons): the trainer's config, its History and
    its params equal dopt's."""
    jt, tt = _pair(_cfg, algorithm="centralized")
    assert tt.cfg.data.num_users == jt.cfg.data.num_users == 1
    assert tt.cfg.data.iid and tt.cfg.gossip.local_ep == 1
    assert tt.cfg.gossip.algorithm == jt.cfg.gossip.algorithm == "nocons"
    assert tt.num_workers == 1 and tt.mixing is None
    _close_rows(jt.run(rounds=2).rows, tt.run(rounds=2).rows)
    _close_params(jt, tt)


@pytest.mark.parametrize("n", [5, 6])
def test_matching_matrices_bit_identical(n):
    """Ten rounds of matchings from the trainers' stream (seed, 60551)
    equal dopt's ``random_matching_matrix`` draws, and so do the port
    trainer's own draws."""
    jr, tr = jax_host_rng(7, 60551), host_rng(7, 60551)
    for _ in range(10):
        want, got = jax_matching(n, jr), random_matching_matrix(n, tr)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert np.allclose(got.sum(0), 1) and np.allclose(got.sum(1), 1)
    tt = GossipTrainer(_cfg(T, "gossip", workers=n), device="cpu")
    jr = jax_host_rng(11, 60551)
    for t in range(10):
        np.testing.assert_array_equal(tt._matrix_for_round(t),
                                      jax_matching(n, jr))


def test_sharded_eval_matches_dopt():
    """The sharded eval plans equal dopt's bit for bit, a sharded dsgd
    run's History (its in-training test metric) matches dopt's, and
    ``evaluate`` stays the full test set."""
    for n in (1, 7, 32, 257, 1000):
        for w in (1, 3, 4, 6, 16):
            if w > n:
                continue
            for bs in (4, 256):
                for a, b in zip(jpipe.sharded_eval_batches(n, w,
                                                           batch_size=bs),
                                sharded_eval_batches(n, w, batch_size=bs),
                                strict=True):
                    np.testing.assert_array_equal(b, a)
                    assert b.dtype == a.dtype
    jt, tt = _pair(_cfg, eval_mode="sharded")
    _close_rows(jt.run(rounds=2).rows, tt.run(rounds=2).rows)
    _close_params(jt, tt)
    want, got = jt.evaluate(), tt.evaluate()
    assert got["acc"].shape == (4,)
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1e-4)


def test_sharded_eval_needs_a_sample_a_worker():
    with pytest.raises(ValueError, match="at least one eval sample a worker"):
        sharded_eval_batches(3, 7, batch_size=4)
    with pytest.raises(ValueError, match="4 workers over an eval set of 3"):
        GossipTrainer(_cfg(T, eval_mode="sharded", test_size=3),
                      device="cpu")


# -- within the port: the stateful draw ---------------------------------

def _state(tr) -> dict:
    return {"rows": [dict(r) for r in tr.history.rows],
            "round": tr.round,
            "params": {k: v.copy() for k, v in tr.worker_params().items()},
            "momentum": [m.float().numpy().copy() for m in tr.momentum],
            "matching": tr._matching_rng.bit_generator.state}


def _assert_same(want, got):
    assert want.keys() == got.keys()
    for key in want:
        if key == "params":
            for k, v in want[key].items():
                np.testing.assert_array_equal(got[key][k], v, err_msg=k)
        elif key == "momentum":
            for a, b in zip(want[key], got[key], strict=True):
                np.testing.assert_array_equal(b, a)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("fused", [False, True])
def test_matching_blocked_prefetched_per_round_bit_identical(fused):
    """Blocks of 2 with prefetch off and on equal the per-round run bit
    for bit over 5 rounds, the matching stream included: the matchings
    are drawn on the main thread in round order."""
    runs = []
    for block, prefetch in ((1, "off"), (2, "off"), (2, "on")):
        tr = GossipTrainer(_cfg(T, "gossip", fused=fused, prefetch=prefetch),
                           device="cpu")
        tr.run(rounds=3, block=block)
        tr.run(rounds=2, block=block)
        runs.append(_state(tr))
    for other in runs[1:]:
        _assert_same(runs[0], other)


class Killed(Exception):
    """The simulated kill."""


@pytest.mark.parametrize("block,prefetch", [(1, "off"), (2, "on")])
def test_matching_kill_and_resume_equals_continuous(block, prefetch,
                                                    tmp_path, monkeypatch):
    """Checkpoints every 2 rounds, killed in round 3 (prefetch has then
    drawn nothing past the round-2 checkpoint): a fresh trainer restores
    round 2 and runs 3 more rounds, bit for bit the continuous run, the
    matching stream included."""
    cfg = _cfg(T, "gossip", fused=True, prefetch=prefetch)
    cont = GossipTrainer(cfg, device="cpu")
    cont.run(rounds=5)
    victim = GossipTrainer(cfg, device="cpu")
    record = victim._record

    def record_or_die(t, *a):
        if t == 3:
            raise Killed
        record(t, *a)

    monkeypatch.setattr(victim, "_record", record_or_die)
    with pytest.raises(Killed):
        victim.run(rounds=5, block=block, checkpoint_every=2,
                   checkpoint_path=tmp_path / "ck")
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["algorithm"] == "gossip" and meta["round"] == 2
    resumed = GossipTrainer(cfg, device="cpu")
    resumed.restore(tmp_path / "ck")
    assert resumed._matching_rng.bit_generator.state == meta[
        "matching_rng_state"]
    resumed.run(rounds=3, block=block)
    _assert_same(_state(cont), _state(resumed))


def test_dopt_matching_checkpoint_restores_into_port(tmp_path, monkeypatch):
    """dopt runs 2 rounds of matching and saves (npz): the port restores
    it, continues dopt's matching stream, and its next round agrees with
    dopt's resumed round within 1e-5."""
    import dopt.utils.checkpoint as jckpt

    monkeypatch.setattr(jckpt, "HAVE_ORBAX", False)
    jt = JaxGossipTrainer(_cfg(J, "gossip", fused=True))
    jt.run(rounds=2)
    jt.save(tmp_path / "dopt")
    jr = JaxGossipTrainer(_cfg(J, "gossip", fused=True))
    jr.restore(tmp_path / "dopt")
    tt = GossipTrainer(_cfg(T, "gossip", fused=True), device="cpu")
    tt.restore(tmp_path / "dopt")
    assert tt.round == 2 and tt.history.rows == jt.history.rows
    assert (tt._matching_rng.bit_generator.state
            == jr._matching_rng.bit_generator.state)
    jr.run(rounds=1)
    tt.run(rounds=1)
    _close_rows(jr.history.rows[2:], tt.history.rows[2:], 1e-5, 1e-5)
    _close_params(jr, tt, 1e-5)
    assert (tt._matching_rng.bit_generator.state
            == jr._matching_rng.bit_generator.state)


# -- dopt's refusals -------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["nocons", "centralized", "fedlcon"])
def test_fused_refused_without_a_single_sweep(algorithm):
    for mod, make in ((J, JaxGossipTrainer),
                      (T, lambda c: GossipTrainer(c, device="cpu"))):
        with pytest.raises(ValueError, match="has no such sweep to fuse"):
            make(_cfg(mod, algorithm, fused=True))


def test_run_eps_refused_for_fedlcon():
    tr = GossipTrainer(_cfg(T, "fedlcon", eps=3), device="cpu")
    with pytest.raises(ValueError, match="set eps in GossipConfig"):
        tr.run(rounds=1, eps=2)
    tr.run(rounds=1, eps=3)
    GossipTrainer(_cfg(T, "dsgd"), device="cpu").run(rounds=1, eps=2)


def test_restore_refuses_another_algorithm(tmp_path):
    """dopt's check and words: a nocons checkpoint (a centralized
    trainer's too, whose config is rewritten to nocons) does not restore
    into a matching trainer."""
    src = GossipTrainer(_cfg(T, "centralized"), device="cpu")
    src.run(rounds=1)
    src.save(tmp_path / "ck")
    with pytest.raises(ValueError, match="checkpoint is for algorithm "
                       "'nocons', trainer runs 'gossip'"):
        GossipTrainer(_cfg(T, "gossip"), device="cpu").restore(tmp_path /
                                                               "ck")
    GossipTrainer(_cfg(T, "centralized"), device="cpu").restore(
        tmp_path / "ck")


NEW_PRESETS = ["reference-centralized", "reference-nocons-iid",
               "reference-nocons-noniid", "reference-fedlcon",
               "reference-gossip", "baseline1", "baseline2", "baseline4"]


def _fields(cfg) -> dict:
    return {f.name: (_fields(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(cfg)
            for v in (getattr(cfg, f.name),)}


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_preset_equals_dopts(name):
    assert _fields(get_preset(name)) == _fields(jax_preset(name))


def test_cli_reference_gossip_on_cpu(capsys):
    from dopt_torch.run import main

    assert main(["--preset", "reference-gossip", "--device", "cpu",
                 "--rounds", "1", "--set", "data.synthetic_train_size=240",
                 "--set", "data.synthetic_test_size=24", "--set",
                 "gossip.local_ep=1", "--set", "gossip.local_bs=20"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    row = json.loads(out[-1])
    assert row["round"] == 0 and np.isfinite(row["avg_train_loss"])
