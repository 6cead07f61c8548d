"""The port's fault model against dopt's: the host draws, the ledger,
the native planner, the straggler gate and the gossip engine under
crash, straggle, partition and churn.

Host draws (``FaultPlan``, the spec parsers, ``churn_ledger_rows``,
``reassign_shards``, the native plans) are numpy or the same C++ source
in both packages and must be equal bit for bit.  Trajectories: both
trainers run one config from dopt's init (``params_from_jax``) for 2
rounds, per-round, on 4 workers of an 8×8 set; the fault ledger must be
equal row for row, the History within ROADMAP's f32 bounds (train loss
1e-3, test accuracy 1e-4) and the final params within 1e-4
max-relative.  Inside the port, blocked ≡ per-round and resumed ≡
continuous bit for bit.
"""

import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt.faults as jfaults
import dopt_torch.config as T
import dopt_torch.faults as tfaults
from dopt.data.partition import reassign_shards as jreassign
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt_torch.convert import params_to_jax
from dopt_torch.data import make_batch_plan
from dopt_torch.data.partition import reassign_shards as treassign
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.ops.fused_update import (fused_sgd_momentum,
                                         gated_sgd_momentum_reference,
                                         sgd_momentum_reference)

LOSS_TOL, ACC_TOL, PARAM_REL_TOL = 1e-3, 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, *, faults=None, robust=None, holdout=0.0, local_ep=1,
         fused=False, algorithm="dsgd", model="model1", **gossip):
    return mod.ExperimentConfig(
        name="faults", seed=11,
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=32, local_holdout=holdout,
                            holdout_mode="random"),
        model=mod.ModelConfig(model=model, input_shape=(8, 8, 1),
                              faithful=model == "model1"),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, fused_update=fused),
        gossip=mod.GossipConfig(algorithm=algorithm, topology="circle",
                                mode="metropolis", rounds=2,
                                local_ep=local_ep, local_bs=16,
                                fused_update="on" if fused else "off",
                                **gossip),
        faults=None if faults is None else mod.FaultConfig(**faults),
        robust=None if robust is None else mod.RobustConfig(**robust))


def _pair(rounds=2, **kw):
    """dopt's and the port's trainers on one config, from dopt's init,
    each run ``rounds`` rounds per-round."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jt = JaxGossipTrainer(_cfg(J, **kw).replace(mesh_devices=1))
        init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
        tt = GossipTrainer(_cfg(T, **kw), device="cpu", init_params=init)
    jt.run(rounds=rounds)
    tt.run(rounds=rounds)
    return jt, tt


def _close(jt, tt):
    """The ledger exactly, History and client rows within the bounds,
    the final (de-biased) params within 1e-4 max-relative; NaN where
    dopt has NaN."""
    assert tt.history.faults == jt.history.faults
    for a, b in zip(jt.history.rows, tt.history.rows, strict=True):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k, tol in (("avg_train_loss", LOSS_TOL),
                       ("avg_test_acc", ACC_TOL)):
            if k in a:
                assert (np.isnan(a[k]) and np.isnan(b[k])) or \
                    abs(a[k] - b[k]) <= tol, (k, a, b)
    for a, b in zip(jt.client_history.rows, tt.client_history.rows,
                    strict=True):
        for k, v in a.items():
            assert abs(v - b[k]) <= LOSS_TOL, (k, a, b)
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


def _state(tr) -> dict:
    out = {"rows": tr.history.rows, "ledger": tr.history.faults,
           "client": tr.client_history.rows,
           "params": tr.worker_params(),
           "momentum": [m.numpy().copy() for m in tr.momentum],
           "mirrors": [tr._screen_streak.tolist(),
                       tr._quarantine_until.tolist()]}
    for name in ("_mass", "_link_buf_mass", "_dev_streak", "_dev_until",
                 "_q", "_fbuf"):
        if getattr(tr, name, None) is not None:
            out[name] = getattr(tr, name).numpy().copy()
    if tr._link_buf is not None:
        out["link_buf"] = {k: v.numpy().copy()
                           for k, v in tr._link_buf.items()}
    return out


def _same(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b, equal_nan=True), path
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def blocked_and_resumed(cfg, tmp_path, rounds=5):
    """The port's per-round run against blocks of 2, prefetched blocks,
    and runs killed after round 3 and resumed per-round and blocked, bit
    for bit."""
    ref = GossipTrainer(cfg, device="cpu")
    ref.run(rounds=rounds)
    want = _state(ref)
    b = GossipTrainer(cfg, device="cpu")
    b.run(rounds=rounds, block=2)
    _same(want, _state(b), "blocked")
    pre = cfg.replace(gossip=dataclasses.replace(cfg.gossip, prefetch="on"))
    b = GossipTrainer(pre, device="cpu")
    b.run(rounds=rounds, block=2)
    _same(want, _state(b), "prefetched")
    kill = GossipTrainer(cfg, device="cpu")
    kill.run(rounds=3, block=2, checkpoint_every=3,
             checkpoint_path=tmp_path / "ck")
    for block in (1, 2):
        c = GossipTrainer(cfg, device="cpu")
        c.restore(tmp_path / "ck")
        assert c.round == 3
        c.run(rounds=rounds - 3, block=block)
        _same(want, _state(c), f"resumed, block {block}")
    return ref


# -- host draws ----------------------------------------------------------
PLANS = [
    dict(crash=0.3),
    dict(straggle=0.4, straggle_frac=0.25, crash=0.2),
    dict(partition=0.3, partition_span=3, partition_groups=3),
    dict(corrupt=0.5, corrupt_max=2, corrupt_mode="signflip"),
    dict(msg_drop=0.3, msg_delay=0.4, msg_delay_max=3),
    dict(churn=0.2, churn_span=3, crash=0.1),
    dict(crash=0.1, straggle=0.2, partition=0.1, corrupt=0.2, msg_drop=0.1,
         msg_delay=0.1, churn=0.1, seed=7),
]


@pytest.mark.parametrize("fc", PLANS, ids=range(len(PLANS)))
def test_fault_plan_draws_bit_identical(fc):
    w = 6
    jp = jfaults.FaultPlan(w, J.FaultConfig(**fc), seed=5)
    tp = tfaults.FaultPlan(w, T.FaultConfig(**fc), seed=5)
    for flag in ("active", "may_straggle", "has_corrupt", "affects_matrix",
                 "has_link", "has_churn", "delay_max"):
        assert getattr(tp, flag) == getattr(jp, flag), flag
    train = np.arange(w * 10).reshape(w, 10)
    for t in range(12):
        a, b = jp.for_round(t), tp.for_round(t)
        for f in ("crashed", "straggler", "epoch_frac", "corrupt"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert (a.partition is None) == (b.partition is None)
        if a.partition is not None:
            np.testing.assert_array_equal(b.partition, a.partition)
        assert a.any_fault == b.any_fault
        for x, y in zip(jp.link_for_round(t), tp.link_for_round(t)):
            np.testing.assert_array_equal(y, x)
        for x, y in zip(jp.uplink_for_round(t), tp.uplink_for_round(t)):
            np.testing.assert_array_equal(y, x)
        np.testing.assert_array_equal(tp.straggler_lateness(t, 3),
                                      jp.straggler_lateness(t, 3))
        away = jp.away_for_round(t)
        np.testing.assert_array_equal(tp.away_for_round(t), away)
        assert (tfaults.churn_ledger_rows(tp, t, away)
                == jfaults.churn_ledger_rows(jp, t, away))
        assert tp.adopters_for(away) == jp.adopters_for(away)
        np.testing.assert_array_equal(tp.plan_matrix_for(t, train),
                                      jp.plan_matrix_for(t, train))
        for units in (1, 7, 40):
            np.testing.assert_array_equal(
                tfaults.FaultPlan.limits_for(b, units),
                jfaults.FaultPlan.limits_for(a, units))


def test_membership_log_and_dropout_alias():
    events = [(0, 1, False), (2, 1, True), (3, 0, False)]
    jm, tm = jfaults.MembershipLog(events), tfaults.MembershipLog(events)
    for t in range(5):
        np.testing.assert_array_equal(tm.away_at(t, 3), jm.away_at(t, 3))
    assert tm.to_json() == jm.to_json()
    with pytest.raises(ValueError, match="round order"):
        tm.add(1, 0, True)
    with pytest.warns(DeprecationWarning):
        tp = tfaults.FaultPlan(4, None, seed=3, dropout=0.25)
    with pytest.warns(DeprecationWarning):
        jp = jfaults.FaultPlan(4, None, seed=3, dropout=0.25)
    for t in range(6):
        np.testing.assert_array_equal(tp.for_round(t).crashed,
                                      jp.for_round(t).crashed)
    with pytest.raises(ValueError, match="not both"):
        tfaults.FaultPlan(4, T.FaultConfig(crash=0.1), dropout=0.1)


SPECS = ["crash=0.1,straggle=0.2,straggle_frac=0.5,partition=0.05",
         "msg_drop=0.1,msg_delay=0.2,msg_delay_max=2,churn=0.02,churn_span=4",
         "corrupt=0.3,corrupt_mode=scale,corrupt_scale=7,seed=3",
         " crash = 0.2 ,", "nope=1", "crash=abc", "crash=2", "msg_drop=1.0",
         "straggle=0.1,straggle_frac=0"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_spec_matches_dopt(spec):
    try:
        want = jfaults.parse_fault_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfaults.parse_fault_spec(spec)
        assert str(got.value) == str(e)
        return
    assert (dataclasses.asdict(tfaults.parse_fault_spec(spec))
            == dataclasses.asdict(want))


CORRUPT_SPECS = [("0.25", None), ("mode=nan", None),
                 ("p=0.5,mode=signflip,scale=50,max=2", {"crash": 0.1}),
                 ("mode=scale", {"corrupt": 0.2}), ("max=x", None),
                 ("q=1", None), ("lie", None), ("mode=bogus", None)]


@pytest.mark.parametrize("spec,base", CORRUPT_SPECS,
                         ids=[s for s, _ in CORRUPT_SPECS])
def test_parse_corrupt_spec_matches_dopt(spec, base):
    jb = J.FaultConfig(**base) if base else None
    tb = T.FaultConfig(**base) if base else None
    try:
        want = jfaults.parse_corrupt_spec(spec, base=jb)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfaults.parse_corrupt_spec(spec, base=tb)
        assert str(got.value) == str(e)
        return
    assert (dataclasses.asdict(tfaults.parse_corrupt_spec(spec, base=tb))
            == dataclasses.asdict(want))


@pytest.mark.parametrize("field,value", [
    ("crash", -0.1), ("straggle_frac", 1.5), ("straggler_policy", "wait"),
    ("over_select", -1.0), ("partition_span", 0), ("partition_groups", 1),
    ("corrupt", 1.1), ("corrupt_mode", "lie"), ("corrupt_scale", 0.0),
    ("corrupt_max", -1), ("msg_delay_max", 0), ("churn_span", 0)])
def test_validate_fault_config_matches_dopt(field, value):
    with pytest.raises(ValueError) as want:
        jfaults.validate_fault_config(J.FaultConfig(**{field: value}))
    with pytest.raises(ValueError) as got:
        tfaults.validate_fault_config(T.FaultConfig(**{field: value}))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("adopters", [{}, {1: 2}, {0: 3, 1: 3, 2: 3},
                                      {3: 0, 1: 2}])
def test_reassign_shards_bit_identical(adopters):
    m = np.random.default_rng(0).integers(0, 999, (4, 13))
    np.testing.assert_array_equal(treassign(m, adopters),
                                  jreassign(m, adopters))


# -- the native planner --------------------------------------------------
@pytest.mark.parametrize("w,l,bs,ep,workers", [
    (4, 37, 8, 2, None), (3, 64, 16, 1, None), (6, 5, 8, 3, None),
    (6, 50, 7, 2, [5, 0, 3])])
def test_native_plan_bit_identical_to_dopt(w, l, bs, ep, workers):
    from dopt.data.pipeline import make_batch_plan as jplan
    from dopt.native import native_available

    if not native_available():
        pytest.fail("dopt's native planner did not build (g++ is needed)")
    im = np.random.default_rng(1).permutation(w * l).reshape(w, l)
    sel = None if workers is None else np.asarray(workers)
    for t in (0, 3):
        a = jplan(im, batch_size=bs, local_ep=ep, seed=9, round_idx=t,
                  impl="native", workers=sel)
        b = make_batch_plan(im, batch_size=bs, local_ep=ep, seed=9,
                            round_idx=t, impl="native", workers=sel)
        np.testing.assert_array_equal(b.idx, a.idx)
        np.testing.assert_array_equal(b.weight, a.weight)
    numpy_plan = make_batch_plan(im, batch_size=bs, local_ep=ep, seed=9,
                                 round_idx=3, workers=sel)
    assert numpy_plan.idx.shape == b.idx.shape


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No g++ (or a failed build) raises; nothing falls back to numpy."""
    import dopt_torch.native as native

    native.load_native.cache_clear()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "x" / native.LIB_NAME)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    try:
        with pytest.raises(RuntimeError, match="needs g\\+\\+"):
            make_batch_plan(np.arange(8).reshape(2, 4), batch_size=2,
                            impl="native")
        monkeypatch.setattr(native.shutil, "which", lambda name: "/bin/false")
        with pytest.raises(RuntimeError, match="failed"):
            make_batch_plan(np.arange(8).reshape(2, 4), batch_size=2,
                            impl="native")
    finally:
        native.load_native.cache_clear()
    with pytest.raises(ValueError, match="unknown plan_impl"):
        make_batch_plan(np.arange(8).reshape(2, 4), batch_size=2,
                        impl="rust")


def test_native_plans_run_both_engines():
    """plan_impl='native' trains on dopt's native plans: the port's
    gossip run equals dopt's, and the federated engine takes it too."""
    cfgs = {m: _cfg(m) for m in (J, T)}
    cfgs = {m: c.replace(data=dataclasses.replace(c.data, plan_impl="native"))
            for m, c in cfgs.items()}
    jt = JaxGossipTrainer(cfgs[J].replace(mesh_devices=1))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    tt = GossipTrainer(cfgs[T], device="cpu", init_params=init)
    jt.run(rounds=2)
    tt.run(rounds=2)
    _close(jt, tt)
    fed = cfgs[T].replace(gossip=None, federated=T.FederatedConfig(
        frac=0.5, local_ep=1, local_bs=16))
    FederatedTrainer(fed, device="cpu").run(rounds=1)


# -- the straggler gate --------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_kernel_1_plain_version(dtype):
    """The gated wrapper on CPU tensors is ``torch.where`` over the
    ungated plain step (bit for bit), gated-off lanes keep their bits,
    and the step where every lane is on is the ungated step."""
    g = torch.Generator().manual_seed(0)
    shapes = [(5, 3, 7), (5, 10), (5,)]
    p = [torch.randn(*s, generator=g).to(dtype) for s in shapes]
    m = [torch.randn(*s, generator=g).to(dtype) for s in shapes]
    gr = [torch.randn(*s, generator=g).to(dtype) for s in shapes]
    limit = torch.tensor([0, 3, 1, 5, 2], dtype=torch.int32)
    for step in (0, 1, 2, 4, 5):
        pk, mk = [t.clone() for t in p], [t.clone() for t in m]
        fused_sgd_momentum(pk, mk, gr, lr=0.1, mu=0.5, limit=limit,
                           step=step)
        pu, mu_ = [t.clone() for t in p], [t.clone() for t in m]
        sgd_momentum_reference(pu, mu_, gr, lr=0.1, momentum=0.5)
        on = step < limit
        for a, u, o in zip(pk + mk, pu + mu_, p + m):
            want = torch.where(on.reshape((-1,) + (1,) * (o.dim() - 1)),
                               u, o)
            assert torch.equal(a, want)
            assert torch.equal(a[~on], o[~on])
        pr, mr = [t.clone() for t in p], [t.clone() for t in m]
        gated_sgd_momentum_reference(pr, mr, gr, lr=0.1, momentum=0.5,
                                     limit=limit, step=step)
        assert all(torch.equal(a, b) for a, b in zip(pk + mk, pr + mr))
    full = torch.full((5,), 9, dtype=torch.int32)
    pk, mk = [t.clone() for t in p], [t.clone() for t in m]
    fused_sgd_momentum(pk, mk, gr, lr=0.1, mu=0.5, limit=full, step=0)
    fused_sgd_momentum(p, m, gr, lr=0.1, mu=0.5)
    assert all(torch.equal(a, b) for a, b in zip(pk + mk, p + m))
    with pytest.raises(ValueError, match="int32"):
        fused_sgd_momentum(p, m, gr, lr=0.1, mu=0.5, limit=limit.long())
    with pytest.raises(ValueError, match="lanes"):
        fused_sgd_momentum(p, m, gr, lr=0.1, mu=0.5, limit=limit[:4])


@pytest.mark.parametrize("fused", [False, True])
def test_gated_step_matches_dopt_update_then_select(fused):
    """One gated momentum step against dopt's update (its Pallas kernel
    in interpret mode, or the jnp update) followed by ``_gate_tree``."""
    import jax.numpy as jnp

    from dopt.engine.local import _apply_update, _gate_tree

    rng = np.random.default_rng(3)
    p = {"a": rng.standard_normal((4, 33)).astype(np.float32),
         "b": rng.standard_normal((4, 6, 5)).astype(np.float32)}
    m = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    limit = np.array([2, 0, 5, 1], np.int32)
    step = 1
    jp, jm = _apply_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, m),
        jax.tree.map(jnp.asarray, g), lr=0.1, momentum=0.5,
        update_impl="pallas" if fused else "jnp")
    gate = jnp.asarray(step < limit)
    jp = _gate_tree(gate, jp, jax.tree.map(jnp.asarray, p))
    jm = _gate_tree(gate, jm, jax.tree.map(jnp.asarray, m))
    tp = [torch.from_numpy(p[k].copy()) for k in sorted(p)]
    tm = [torch.from_numpy(m[k].copy()) for k in sorted(p)]
    tg = [torch.from_numpy(g[k]) for k in sorted(p)]
    if fused:
        fused_sgd_momentum(tp, tm, tg, lr=0.1, mu=0.5,
                           limit=torch.from_numpy(limit), step=step)
    else:
        from dopt_torch.optim import sgd_step

        old = [t.clone() for t in tp + tm]
        sgd_step(tp, tm, tg, lr=0.1, momentum=0.5)
        on = torch.from_numpy(step < limit)
        for t, o in zip(tp + tm, old):
            t.copy_(torch.where(on.reshape((-1,) + (1,) * (t.dim() - 1)),
                                t, o))
    for i, k in enumerate(sorted(p)):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tm[i].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6, atol=1e-7)


# -- the engine ------------------------------------------------------------
ENGINE = {
    "crash": dict(faults=dict(crash=0.3)),
    "dropout-alias": dict(dropout=0.3),
    "straggle": dict(faults=dict(straggle=0.5, straggle_frac=0.5)),
    "straggle-holdout": dict(faults=dict(straggle=0.5, straggle_frac=0.5),
                             holdout=0.1, local_ep=2),
    "crash-holdout": dict(faults=dict(crash=0.3), holdout=0.1, local_ep=2),
    "partition": dict(faults=dict(partition=0.5, partition_span=2)),
    "churn": dict(faults=dict(churn=0.3, churn_span=2)),
    "crash-straggle-partition-fused": dict(
        faults=dict(crash=0.3, straggle=0.3, partition=0.3), fused=True),
    "straggle-kernel-1": dict(faults=dict(straggle=0.6, straggle_frac=0.25),
                              fused=True),
    "mixed-mlp": dict(faults=dict(crash=0.3, straggle=0.4,
                                  straggle_frac=0.5, partition=0.3,
                                  partition_span=2), model="mlp"),
    "nocons-crash": dict(faults=dict(crash=0.3, partition=0.4),
                         algorithm="nocons"),
    "fedlcon-churn": dict(faults=dict(churn=0.3), algorithm="fedlcon",
                          eps=2),
    "matching-crash": dict(faults=dict(crash=0.3, straggle=0.3),
                           algorithm="gossip"),
}


@pytest.mark.parametrize("case", list(ENGINE))
def test_engine_fault_modes_match_dopt(case):
    jt, tt = _pair(**ENGINE[case])
    if case != "straggle-kernel-1":
        assert jt.history.faults, "the config drew no fault in 2 rounds"
    _close(jt, tt)


@pytest.mark.parametrize("case", ["crash", "straggle-holdout", "churn",
                                  "crash-straggle-partition-fused"])
def test_blocked_and_resumed_bit_identical(case, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cfg = _cfg(T, **ENGINE[case])
    ref = blocked_and_resumed(cfg, tmp_path)
    assert ref.history.faults


@pytest.mark.parametrize("case", ["crash", "crash-straggle-partition-fused",
                                  "churn"])
def test_dopt_checkpoint_continues_in_port(case, tmp_path, monkeypatch):
    """A dopt npz checkpoint of a faulty run, restored into the port,
    continues as dopt's restored run does: the ledger and mirrors
    exactly, the next round within the bounds."""
    import dopt.utils.checkpoint as jckpt

    monkeypatch.setattr(jckpt, "HAVE_ORBAX", False)
    jcfg = _cfg(J, **ENGINE[case]).replace(mesh_devices=1)
    jt = JaxGossipTrainer(jcfg)
    jt.run(rounds=2)
    jt.save(tmp_path / "dopt")
    jr = JaxGossipTrainer(jcfg)
    jr.restore(tmp_path / "dopt")
    jr.run(rounds=1)
    tt = GossipTrainer(_cfg(T, **ENGINE[case]), device="cpu")
    tt.restore(tmp_path / "dopt")
    assert tt.round == 2 and tt.history.faults == jt.history.faults
    tt.run(rounds=1)
    _close(jr, tt)


def test_ledger_survives_checkpoint_and_json(tmp_path):
    tt = GossipTrainer(_cfg(T, **ENGINE["churn"]), device="cpu")
    tt.run(rounds=3)
    tt.save(tmp_path / "ck")
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["fault_ledger"] == tt.history.faults
    assert meta["screen_streak"] == [0] * 4
    tt.history.faults_to_json(tmp_path / "l.json")
    assert json.loads((tmp_path / "l.json").read_text()) == tt.history.faults


# -- refusals ---------------------------------------------------------------
REFUSED = {
    "faults-and-dropout": dict(faults=dict(crash=0.1), dropout=0.1),
    "stale": dict(faults=dict(corrupt=0.2, corrupt_mode="stale")),
    "corrupt-nocons": dict(faults=dict(corrupt=0.2), algorithm="nocons"),
    "clip-nocons": dict(robust=dict(clip_radius=1.0), algorithm="nocons"),
    "quarantine-nocons": dict(robust=dict(quarantine_after=2),
                              algorithm="nocons"),
    "aggregator": dict(robust=dict(aggregator="median")),
    "link-fedlcon": dict(faults=dict(msg_drop=0.1), algorithm="fedlcon"),
    "push-sum-nocons": dict(correction="push_sum", algorithm="nocons"),
    "link-clip": dict(faults=dict(msg_drop=0.1), robust=dict(clip_radius=1.0)),
    "link-nan": dict(faults=dict(msg_delay=0.1, corrupt=0.2)),
    "fused-robust": dict(faults=dict(corrupt=0.2, corrupt_mode="scale"),
                         fused=True),
    "fused-link": dict(correction="push_sum", fused=True),
    "shift-robust": dict(robust=dict(clip_radius=1.0), comm_impl="shift"),
    "shift-link": dict(faults=dict(msg_drop=0.1), comm_impl="shift"),
    "bad-correction": dict(correction="ratio"),
    "bad-trim": dict(robust=dict(trim_frac=0.5)),
    "bad-quarantine-rounds": dict(robust=dict(quarantine_rounds=0)),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_match_dopt(case):
    """Every refusal dopt makes of the gossip fault model, the port
    makes too (message for message where both speak of the same
    thing)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError) as want:
            JaxGossipTrainer(_cfg(J, **REFUSED[case]).replace(mesh_devices=1))
        with pytest.raises(ValueError) as got:
            GossipTrainer(_cfg(T, **REFUSED[case]), device="cpu")
    if case not in ("shift-robust", "shift-link"):
        assert str(got.value) == str(want.value)
    else:
        assert "comm_impl='shift' is incompatible" in str(got.value)


def test_federated_engine_refuses_faults_naming_its_slice():
    """The federated engine runs the fault model now, in population mode
    too since the population slice, and over several ranks since the
    multi-GPU engines slice: without a process group more than one GPU
    names the launch it needs.  ``cfg.comm`` (the
    scatter path's wire dtype) runs under the robust layer's clip since
    the scatter slice."""
    fed = _cfg(T).replace(gossip=None, federated=T.FederatedConfig(
        frac=0.5, local_ep=1, local_bs=16))
    with pytest.raises(ValueError, match="torch.distributed.run "
                       "--nproc-per-node 2"):
        FederatedTrainer(fed.replace(faults=T.FaultConfig(crash=0.1),
                                     mesh_devices=2), device="cpu")
    pop = FederatedTrainer(fed.replace(
        faults=T.FaultConfig(crash=0.1),
        population=T.PopulationConfig(clients=20, cohort=6)), device="cpu")
    assert len(pop.run(rounds=1).rows) == 1
    scatter = fed.replace(federated=dataclasses.replace(
        fed.federated, update_sharding="scatter"))
    tr = FederatedTrainer(scatter.replace(
        robust=T.RobustConfig(clip_radius=1.0),
        comm=T.CommConfig(wire_dtype="bfloat16")), device="cpu")
    assert len(tr.run(rounds=1).rows) == 1


# -- presets and the CLI ------------------------------------------------------
@pytest.mark.parametrize("name", ["baseline1-faulty", "baseline1-byzantine",
                                  "baseline1-lossy"])
def test_fault_presets_are_dopts(name):
    from dopt.presets import get_preset as jget
    from dopt_torch.presets import get_preset as tget

    a, b = tget(name), jget(name)
    for section in ("data", "model", "optim", "gossip", "faults", "robust"):
        x, y = getattr(a, section), getattr(b, section)
        assert (x is None) == (y is None), section
        if x is not None:
            assert dataclasses.asdict(x) == dataclasses.asdict(y), section
    assert (a.name, a.seed) == (b.name, b.seed)


def test_chaos_and_faulty_headline_presets():
    """bench-chaos-baseline1-lossy = bench.py _chaos_config at MNIST's
    sizes; headline-dsgd-model1-faulty = the headline with
    baseline1-faulty's faults."""
    import importlib.util
    import pathlib

    from dopt_torch.presets import get_preset

    path = pathlib.Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("dopt_bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    want = bench._chaos_config(train_size=60_000, test_size=10_000)
    got = get_preset("bench-chaos-baseline1-lossy")
    assert (got.name, got.seed) == (want.name, want.seed)
    for section in ("data", "model", "optim", "gossip", "faults", "robust"):
        assert (dataclasses.asdict(getattr(got, section))
                == dataclasses.asdict(getattr(want, section))), section
    head, faulty = get_preset("headline-dsgd-model1"), get_preset(
        "headline-dsgd-model1-faulty")
    assert faulty.faults == get_preset("baseline1-faulty").faults
    assert faulty.replace(name=head.name, faults=None) == head


def test_cli_fault_flags(tmp_path, capsys):
    from dopt_torch.run import main

    out = tmp_path / "ledger.json"
    assert main(["--preset", "baseline1-faulty", "--device", "cpu",
                 "--rounds", "2", "--set", "data.synthetic_train_size=200",
                 "--set", "data.synthetic_test_size=40",
                 "--set", "gossip.local_ep=1",
                 "--faults", "crash=0.3,straggle=0.3,churn=0.2",
                 "--corrupt", "p=0.3,mode=signflip",
                 "--faults-json", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert rows and {r["kind"] for r in rows} <= set(tfaults.KINDS)
    assert any(r["kind"] == "corrupt" for r in rows)
    with pytest.raises(SystemExit, match="unknown field"):
        main(["--preset", "baseline1", "--device", "cpu", "--faults",
              "explode=1"])
    from dopt_torch.presets import get_preset
    from dopt_torch.run import apply_override

    cfg = apply_override(get_preset("baseline1-faulty"), "faults.crash=0.4")
    assert cfg.faults.crash == 0.4
    cfg = apply_override(get_preset("baseline1-byzantine"),
                         "robust.clip_radius=2")
    assert cfg.robust.clip_radius == 2.0


def test_fault_model_imports_nothing_of_jax_or_dopt(tmp_path):
    """A fresh interpreter runs the port's fault model — the native
    planner, crash/straggle/partition/churn with both fused switches,
    corrupt sends with clipped gossip and the device quarantine, and
    push-sum over delayed links — blocked, checkpointed and restored,
    and the CLI's fault flags; neither jax, flax, orbax nor dopt may be
    loaded."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    code = (
        "import sys\n"
        f"ck = {str(tmp_path)!r}\n"
        "import dopt_torch\n"
        "from dopt_torch import config as C\n"
        "base = C.ExperimentConfig(seed=3, data=C.DataConfig("
        "dataset='synthetic', num_users=4, synthetic_train_size=128, "
        "synthetic_test_size=16, plan_impl='native'),"
        " model=C.ModelConfig(model='mlp', input_shape=(8, 8, 1)),"
        " optim=C.OptimizerConfig(fused_update=True),"
        " gossip=C.GossipConfig(local_ep=1, local_bs=16))\n"
        "G = lambda **kw: C.GossipConfig(local_ep=1, local_bs=16, **kw)\n"
        "cases = [base.replace(gossip=G(fused_update='on'), faults="
        "C.FaultConfig(crash=0.3, straggle=0.4, partition=0.3, churn=0.2)),"
        " base.replace(faults=C.FaultConfig(corrupt=0.5, corrupt_mode="
        "'scale'), robust=C.RobustConfig(clip_radius=1.0,"
        " quarantine_after=1)),"
        " base.replace(gossip=G(correction='push_sum'), faults="
        "C.FaultConfig(msg_drop=0.2, msg_delay=0.3))]\n"
        "for i, cfg in enumerate(cases):\n"
        "    tr = dopt_torch.GossipTrainer(cfg, device='cpu')\n"
        "    tr.run(rounds=3, block=2, checkpoint_every=2,"
        " checkpoint_path=ck + f'/{i}')\n"
        "    dopt_torch.GossipTrainer(cfg, device='cpu').restore("
        "ck + f'/{i}')\n"
        "from dopt_torch.run import main\n"
        "main(['--preset', 'baseline1-lossy', '--device', 'cpu', '--rounds',"
        " '1', '--set', 'data.synthetic_train_size=200', '--set',"
        " 'data.synthetic_test_size=20', '--faults', 'msg_drop=0.3',"
        " '--corrupt', 'p=0.5,mode=signflip', '--faults-json',"
        " ck + '/l.json'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'dopt'))\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout
