"""The port's robust layer against dopt's: the Byzantine sends, the
screens, clipped gossip, quarantine, and the gossip engine under
corrupt faults with and without the defenses.

Device functions run on seeded numpy inputs in both packages and agree
to 1e-6 (f32; the same ops, only summation order may differ); the
quarantine rule is host integer code and agrees exactly.  Engine runs:
2 rounds per-round from dopt's init, the fault ledger (the screened and
quarantine rows included) equal row for row, the History within 1e-3
train loss / 1e-4 test accuracy, final params within 1e-4 max-relative
(NaN where dopt's are NaN).  Inside the port, the device-side
quarantine's blocked and resumed runs equal the per-round run bit for
bit.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt.faults as jfaults
import dopt.robust as jrobust
import dopt_torch.config as T
import dopt_torch.faults as tfaults
import dopt_torch.robust as trobust
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt_torch.convert import params_to_jax
from dopt_torch.engine import GossipTrainer

LOSS_TOL, ACC_TOL, PARAM_REL_TOL = 1e-3, 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, w=5, poison=()):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((w, 7, 3)).astype(np.float32),
            "b": rng.standard_normal((w, 11)).astype(np.float32)}
    for lane, value in poison:
        tree["b"][lane, 2] = value
    return tree


def _jt(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _matrix(seed, w=5, zero_diag=False):
    rng = np.random.default_rng(seed)
    m = rng.random((w, w)) * (rng.random((w, w)) < 0.7)
    if zero_diag:
        np.fill_diagonal(m, 0.0)
    m = m + 1e-3 * np.eye(w)
    return (m / m.sum(1, keepdims=True)).astype(np.float32)


def _agree(got: dict, want, tol=1e-6):
    for k, v in want.items():
        a, b = np.asarray(v), got[k].numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        fin = np.isfinite(a)
        np.testing.assert_allclose(b[fin], a[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["nan", "inf", "scale", "signflip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corrupt_update_matches_dopt(mode, dtype):
    tree = _tree(0)
    mask = np.array([1, 0, 1, 0, 0], np.float32)
    want = jfaults.corrupt_update(
        {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()},
        jnp.asarray(mask), mode, 7.3)
    got = tfaults.corrupt_update(
        {k: torch.from_numpy(v).to(getattr(torch, dtype))
         for k, v in tree.items()}, torch.from_numpy(mask), mode, 7.3)
    for k, v in want.items():
        a = np.asarray(v.astype(jnp.float32))
        b = got[k].float().numpy()
        assert np.array_equal(a, b, equal_nan=True), k
    with pytest.raises(ValueError, match="federated"):
        tfaults.corrupt_update(_tt(tree), torch.from_numpy(mask), "stale",
                               1.0)


@pytest.mark.parametrize("poison", [(), ((1, np.nan),), ((0, np.inf),
                                                          (3, -np.inf))])
def test_screens_match_dopt(poison):
    tree = _tree(1, poison=poison)
    np.testing.assert_array_equal(
        trobust.finite_lane_mask(_tt(tree)).numpy(),
        np.asarray(jrobust.finite_lane_mask(_jt(tree))))
    a = np.asarray(jrobust.lane_sq_norms(_jt(tree)))
    b = trobust.lane_sq_norms(_tt(tree)).numpy()
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6)


@pytest.mark.parametrize("seed,poison", [(2, ()), (3, ((1, np.nan),)),
                                         (4, ((0, np.inf), (4, np.nan)))])
def test_byzantine_mix_matches_dopt(seed, poison):
    x = _tree(seed)
    xs = _tree(seed + 10, poison=poison)
    w = _matrix(seed)
    want = jrobust.byzantine_mix(_jt(x), _jt(xs), jnp.asarray(w))
    got = trobust.byzantine_mix(_tt(x), _tt(xs), torch.from_numpy(w))
    _agree(got, want)
    honest = trobust.byzantine_mix(_tt(x), _tt(x), torch.from_numpy(w))
    from dopt_torch.parallel.collectives import mix_dense

    dense = mix_dense(_tt(x), torch.from_numpy(w))
    for k in honest:
        torch.testing.assert_close(honest[k], dense[k], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("tau", [0.5, 3.0, 100.0])
@pytest.mark.parametrize("poison", [(), ((2, np.nan),)])
def test_clipped_gossip_mix_matches_dopt(tau, poison):
    x = _tree(5)
    xs = _tree(6, poison=poison)
    xs["a"][0] *= 20.0          # one loud liar
    w = _matrix(7, zero_diag=True)
    want, want_s = jrobust.clipped_gossip_mix(_jt(x), _jt(xs),
                                              jnp.asarray(w), tau)
    got, got_s = trobust.clipped_gossip_mix(_tt(x), _tt(xs),
                                            torch.from_numpy(w), tau)
    _agree(got, want, tol=1e-5)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quarantine_step_and_validation_match_dopt():
    rng = np.random.default_rng(8)
    js, ju = np.zeros(6, np.int64), np.zeros(6, np.int64)
    ts, tu = js.copy(), ju.copy()
    for t in range(20):
        ids = np.sort(rng.choice(6, 4, replace=False))
        flags = (rng.random(4) < 0.6).astype(np.float32)
        a = jrobust.quarantine_step(js, ju, ids, flags, t, after=2, rounds=3)
        b = trobust.quarantine_step(ts, tu, ids, flags, t, after=2, rounds=3)
        assert a == b
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tu, ju)
    for kw in (dict(aggregator="mode"), dict(trim_frac=0.5),
               dict(krum_f=-1), dict(multi_krum_m=-1),
               dict(clip_radius=-1.0), dict(quarantine_after=-1),
               dict(quarantine_rounds=0)):
        with pytest.raises(ValueError) as want:
            jrobust.validate_robust_config(J.RobustConfig(**kw))
        with pytest.raises(ValueError) as got:
            trobust.validate_robust_config(T.RobustConfig(**kw))
        assert str(got.value) == str(want.value)


# -- the engine --------------------------------------------------------------
def _cfg(mod, *, faults=None, robust=None, algorithm="dsgd", **gossip):
    return mod.ExperimentConfig(
        name="robust", seed=11,
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=32),
        model=mod.ModelConfig(model="model1", input_shape=(8, 8, 1)),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5),
        gossip=mod.GossipConfig(algorithm=algorithm, topology="circle",
                                mode="metropolis", rounds=2, local_ep=1,
                                local_bs=16, **gossip),
        faults=None if faults is None else mod.FaultConfig(**faults),
        robust=None if robust is None else mod.RobustConfig(**robust))


def _pair(rounds=2, **kw):
    jt = JaxGossipTrainer(_cfg(J, **kw).replace(mesh_devices=1))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    tt = GossipTrainer(_cfg(T, **kw), device="cpu", init_params=init)
    jt.run(rounds=rounds)
    tt.run(rounds=rounds)
    return jt, tt


def _close(jt, tt):
    assert tt.history.faults == jt.history.faults
    for a, b in zip(jt.history.rows, tt.history.rows, strict=True):
        assert a.keys() == b.keys()
        for k, tol in (("avg_train_loss", LOSS_TOL),
                       ("avg_test_acc", ACC_TOL)):
            assert (np.isnan(a[k]) and np.isnan(b[k])) or \
                abs(a[k] - b[k]) <= tol, (k, a, b)
    np.testing.assert_array_equal(tt._screen_streak, jt._screen_streak)
    np.testing.assert_array_equal(tt._quarantine_until, jt._quarantine_until)
    want = jax.device_get(jt.worker_params())
    got = params_to_jax(tt.worker_params(), input_shape=(8, 8, 1))
    for layer in want:
        for k in want[layer]:
            a, b = np.asarray(want[layer][k], np.float64), got[layer][k]
            assert np.array_equal(np.isnan(a), np.isnan(b)), (layer, k)
            fin = np.isfinite(a)
            if fin.any():
                rel = (np.abs(a[fin] - b[fin]).max()
                       / max(np.abs(a[fin]).max(), 1e-12))
                assert rel <= PARAM_REL_TOL, f"{layer}.{k}: {rel:.3e}"


# An undefended scale lie blows the receivers' state up round after
# round; at ×10 on this fleet the trajectory diverges within two rounds
# and f32 reordering noise outgrows the fixed bounds (measured: Model1's
# near-zero biases 8e-4 max-relative apart, the MLP's exploded loss 4e-3
# apart), in dopt against itself as much as against the port.  The
# undefended case lies by ×2; the clipped case keeps ×10, which the
# defense bounds.
CORRUPT = {f"{mode}{'-clip' if clip else ''}": dict(
    faults=dict(corrupt=0.4, corrupt_mode=mode,
                corrupt_scale=10.0 if clip else 2.0),
    robust=dict(clip_radius=1.0) if clip else None)
    for mode in ("nan", "inf", "scale", "signflip") for clip in (False, True)}
CORRUPT.update({
    "quarantine-clip": dict(
        faults=dict(corrupt=1.0, corrupt_max=1, corrupt_mode="scale",
                    corrupt_scale=50.0),
        robust=dict(clip_radius=1.0, quarantine_after=1,
                    quarantine_rounds=1)),
    "quarantine-nan": dict(
        faults=dict(corrupt=0.5, corrupt_mode="nan", crash=0.2),
        robust=dict(quarantine_after=1, quarantine_rounds=2)),
    "fedlcon-clip": dict(
        faults=dict(corrupt=0.4, corrupt_mode="signflip"),
        robust=dict(clip_radius=0.5), algorithm="fedlcon", eps=2),
    "matching-byzantine": dict(
        faults=dict(corrupt=0.4, corrupt_mode="scale", corrupt_scale=2.0),
        algorithm="gossip"),
})


@pytest.mark.parametrize("case", list(CORRUPT))
def test_engine_corrupt_modes_match_dopt(case):
    rounds = 3 if case.startswith("quarantine") else 2
    jt, tt = _pair(rounds=rounds, **CORRUPT[case])
    assert any(r["kind"] == "corrupt" for r in jt.history.faults)
    if case.startswith("quarantine"):
        kinds = [r["action"] for r in jt.history.faults
                 if r["kind"] == "quarantine"]
        assert any(a.startswith("quarantined_until") for a in kinds)
    _close(jt, tt)


@pytest.mark.parametrize("case", ["quarantine-clip", "quarantine-nan",
                                  "nan-clip"])
def test_device_quarantine_blocked_and_resumed(case, tmp_path):
    """The fused quarantine's counters live on the device; blocked runs
    replay the ledger after each block's fetch, resumed runs reload the
    counters: all bit-identical to the per-round run, and the host
    mirrors equal the device counters."""
    cfg = _cfg(T, **CORRUPT[case])
    ref = GossipTrainer(cfg, device="cpu")
    ref.run(rounds=6)
    assert ref._fused_quar == case.startswith("quarantine")
    rows = ref.history.faults

    def same(tr, what):
        assert tr.history.rows == ref.history.rows or all(
            (a == b) or np.isnan(list(a.values())).any()
            for a, b in zip(tr.history.rows, ref.history.rows)), what
        assert tr.history.faults == rows, what
        for a, b in zip(tr.worker_params().values(),
                        ref.worker_params().values()):
            assert np.array_equal(a, b, equal_nan=True), what
        np.testing.assert_array_equal(tr._screen_streak, ref._screen_streak)
        np.testing.assert_array_equal(tr._quarantine_until,
                                      ref._quarantine_until)
        if tr._fused_quar:
            np.testing.assert_array_equal(tr._dev_until.numpy(),
                                          ref._quarantine_until)

    b = GossipTrainer(cfg, device="cpu")
    b.run(rounds=6, block=4)
    same(b, "blocked")
    k = GossipTrainer(cfg, device="cpu")
    k.run(rounds=4, block=2, checkpoint_every=2,
          checkpoint_path=tmp_path / "ck")
    for block in (1, 2):
        c = GossipTrainer(cfg, device="cpu")
        c.restore(tmp_path / "ck")
        c.run(rounds=2, block=block)
        same(c, f"resumed, block {block}")


def test_quarantine_fires_and_readmits_on_schedule():
    """baseline1-byzantine's rule at a tiny size: the pinned liar is
    screened every round, benched after quarantine_after strikes and
    readmitted quarantine_rounds later, and while benched it is neither
    a liar in the ledger nor screened."""
    cfg = _cfg(T, faults=dict(corrupt=1.0, corrupt_max=1,
                              corrupt_mode="scale", corrupt_scale=50.0),
               robust=dict(clip_radius=1.0, quarantine_after=2,
                           quarantine_rounds=2))
    tr = GossipTrainer(cfg, device="cpu")
    tr.run(rounds=8)
    by_round = {}
    for r in tr.history.faults:
        assert r["worker"] == 0
        by_round.setdefault(r["round"], []).append(r["action"])
    assert by_round[1][-1] == "quarantined_until_4"
    assert 2 not in by_round and 3 not in by_round
    assert by_round[4][0] == "readmitted"
    assert by_round[5][-1] == "quarantined_until_8"


def test_byzantine_preset_runs_small():
    from dopt_torch.presets import get_preset

    cfg = get_preset("baseline1-byzantine")
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, synthetic_train_size=400, synthetic_test_size=64),
        gossip=dataclasses.replace(cfg.gossip, local_ep=1))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        tr = GossipTrainer(cfg, device="cpu")
        tr.run(rounds=4, block=2)
    assert tr._fused_quar and tr.history.faults
    assert all(np.isfinite(r["avg_train_loss"]) for r in tr.history.rows)
