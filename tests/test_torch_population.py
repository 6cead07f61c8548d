"""The port's client population against dopt's (``dopt.population``).

Host side, bit for bit: the shard assignment (both modes), the orphan
adopters, the digest, the binding, the stateless sampler over
eligibility masks, the churn rows, the registry's screen feedback and
its state (and its refusals), the client-keyed batch plans (numpy and
native), and the federated engine's participation chain over 20 rounds
of each fault kind, ledger rows in order.

Trajectories: both packages train one config from dopt's init
(``params_from_jax``) on 8 shards of an 8×8 synthetic set (the MLP, 256
train and 32 test samples, batch 16, one local epoch); dopt on a
one-device mesh, the port on the CPU.  One round within 1e-5 relative;
two rounds within ROADMAP's slice-1 bounds (losses 1e-3, test accuracy
1e-4, theta 1e-4 max-relative) with the ledger equal row for row.
Inside the port: the cohort-vs-flat pin (dopt's own
``test_cohort_vs_flat_parity`` bounds), prefetched and killed-and-resumed
runs equal to the continuous one bit for bit, a dopt population
checkpoint continued in the port, the gossip binding (per-round ≡
blocked), dopt's refusals in dopt's words, the CLI flags and the preset.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
from dopt.data.partition import assign_client_shards as j_assign
from dopt.data.partition import orphan_shard_adopters as j_orphans
from dopt.data.pipeline import make_batch_plan as j_plan
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt.population import ClientRegistry as JRegistry
from dopt.population import CohortBinding as JBinding
from dopt.population import cohort_digest as j_digest
from dopt_torch.convert import params_to_jax
from dopt_torch.data import (assign_client_shards, make_batch_plan,
                             orphan_shard_adopters)
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.population import ClientRegistry, CohortBinding, cohort_digest

pytestmark = pytest.mark.population

LOSS_TOL, ACC_TOL, PARAM_REL_TOL = 1e-3, 1e-4, 1e-4
SHAPE = (8, 8, 1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, *, clients=50, cohort=20, lanes=8, pop_seed=None,
         algorithm="fedavg", faults=None, robust=None, users=8,
         momentum=0.5, dtype="float32", **fed):
    return mod.ExperimentConfig(
        name="population", seed=11,
        data=mod.DataConfig(dataset="synthetic", num_users=users, iid=False,
                            shards=2, synthetic_train_size=32 * users,
                            synthetic_test_size=32),
        model=mod.ModelConfig(model="mlp", input_shape=SHAPE,
                              faithful=False, compute_dtype=dtype,
                              param_dtype=dtype),
        optim=mod.OptimizerConfig(lr=0.05, momentum=momentum, rho=0.1),
        federated=mod.FederatedConfig(algorithm=algorithm, frac=0.5,
                                      rounds=2, local_ep=1, local_bs=16,
                                      **fed),
        faults=None if faults is None else mod.FaultConfig(**faults),
        robust=None if robust is None else mod.RobustConfig(**robust),
        population=mod.PopulationConfig(clients=clients, cohort=cohort,
                                        lanes=lanes, seed=pop_seed))


def _pair(**kw):
    """dopt's trainer on a one-device mesh and the port's on the CPU,
    from dopt's init."""
    jt = JaxFederatedTrainer(_cfg(J, **kw).replace(mesh_devices=1))
    init = jax.device_get(jt._theta_single())
    return jt, FederatedTrainer(_cfg(T, **kw), device="cpu",
                                init_params=init)


def _theta_rel(jt, tt) -> float:
    want = jax.device_get(jt._theta_single())
    got = params_to_jax(tt.global_params(), input_shape=SHAPE)
    return max(float(np.abs(np.asarray(want[layer][k]) - got[layer][k]).max()
                     / max(np.abs(np.asarray(want[layer][k])).max(), 1e-12))
               for layer in want for k in want[layer])


def _close(jt, tt, *, loss=LOSS_TOL, acc=ACC_TOL, rel=PARAM_REL_TOL):
    assert tt.history.faults == jt.history.faults
    for a, b in zip(jt.history.rows, tt.history.rows, strict=True):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k, v in a.items():
            tol = acc if k == "test_acc" else loss
            assert abs(v - b[k]) <= tol, (k, a, b)
    r = _theta_rel(jt, tt)
    assert r <= rel, f"theta max-relative {r:.3e}"


def _same_registry(a, b):
    for name in ("participation", "last_sampled", "screen_streak",
                 "quarantine_until", "shard_of"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
        assert getattr(a, name).dtype == getattr(b, name).dtype, name


# -- the registry's pieces ------------------------------------------------
@pytest.mark.parametrize("mode", ["round_robin", "random"])
@pytest.mark.parametrize("population,shards,seed", [
    (1, 1, 0), (50, 8, 11), (1000, 16, 2022), (10_000, 16, 7), (7, 12, 3)])
def test_assign_client_shards_bit_identical(mode, population, shards, seed):
    a = j_assign(population, shards, seed=seed, mode=mode)
    b = assign_client_shards(population, shards, seed=seed, mode=mode)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype == np.int32


def test_assign_client_shards_refusals_are_dopts():
    for args, kw in (((0, 4), {}), ((4, 0), {}), ((4, 2), {"mode": "x"})):
        with pytest.raises(ValueError) as want:
            j_assign(*args, **kw)
        with pytest.raises(ValueError) as got:
            assign_client_shards(*args, **kw)
        assert str(got.value) == str(want.value)


def test_orphan_shard_adopters_bit_identical():
    rng = np.random.default_rng(5)
    for trial in range(40):
        shards = int(rng.integers(1, 12))
        clients = int(rng.integers(1, 60))
        assign = j_assign(clients, shards, seed=trial, mode="random")
        alive = rng.random(clients) < rng.random()
        assert (orphan_shard_adopters(assign, alive, shards)
                == j_orphans(assign, alive, shards))


def test_cohort_digest_and_binding_bit_identical():
    rng = np.random.default_rng(9)
    for lanes, waves in ((8, 3), (16, 4), (5, 1), (3, 7)):
        for n in (0, 1, lanes, lanes * waves - 1, lanes * waves):
            ids = rng.choice(1000, n, replace=False)
            cohort = np.concatenate([ids, rng.choice(1000, 3)])
            a = JBinding(4, cohort, np.sort(ids), lanes, waves)
            b = CohortBinding(4, cohort, np.sort(ids), lanes, waves)
            for k in ("lane_ids", "valid", "survivors", "cohort"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
                assert getattr(a, k).dtype == getattr(b, k).dtype, k
            assert a.ledger_row(1000) == b.ledger_row(1000)
            assert cohort_digest(ids) == j_digest(ids)
    with pytest.raises(ValueError) as want:
        JBinding(0, np.arange(9), np.arange(9), 4, 2)
    with pytest.raises(ValueError) as got:
        CohortBinding(0, np.arange(9), np.arange(9), 4, 2)
    assert str(got.value) == str(want.value)


def _registries(pop, faults=None, robust=None, **kw):
    jr = JRegistry(J.PopulationConfig(**pop), seed=11,
                   faults=None if faults is None else J.FaultConfig(**faults),
                   robust=None if robust is None else J.RobustConfig(**robust),
                   **kw)
    tr = ClientRegistry(T.PopulationConfig(**pop), seed=11,
                        faults=None if faults is None
                        else T.FaultConfig(**faults),
                        robust=None if robust is None
                        else T.RobustConfig(**robust), **kw)
    return jr, tr


@pytest.mark.parametrize("pop,n_draws", [
    (dict(clients=1000, cohort=64), (None, 80, 2000)),
    (dict(clients=50, cohort=20, seed=3, lanes=6), (None, 1, 50)),
    (dict(clients=10_000, cohort=256, lanes=16), (None, 300))])
def test_sample_cohort_over_eligibility_masks(pop, n_draws):
    """The draw order, over the full population, random eligibility
    masks and an empty one, with and without an over-selected count."""
    jr, tr = _registries(pop, num_shards=16)
    rng = np.random.default_rng(1)
    p = pop["clients"]
    masks = [None, rng.random(p) < 0.3, rng.random(p) < 0.9,
             np.zeros(p, bool)]
    for t in (0, 1, 17):
        for mask in masks:
            for n in n_draws:
                a = jr.sample_cohort(t, n_draw=n, eligible=mask)
                b = tr.sample_cohort(t, n_draw=n, eligible=mask)
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        bind_a = jr.bind(t, a, a[: len(a) // 2])
        bind_b = tr.bind(t, b, b[: len(b) // 2])
        np.testing.assert_array_equal(bind_a.lane_ids, bind_b.lane_ids)
        assert bind_a.ledger_row(p) == bind_b.ledger_row(p)
    assert (jr.lanes, jr.waves) == (tr.lanes, tr.waves)


def test_registry_churn_rows_eligibility_and_plan_matrix():
    """Churn at population scale: the leave/rejoin and shard-adoption
    rows, the eligibility mask, the readmissions, the staleness and the
    churn-adopted plan matrix, 30 rounds."""
    faults = dict(churn=0.3, churn_span=3, crash=0.1)
    pop = dict(clients=40, cohort=12, lanes=4)
    jr, tr = _registries(pop, faults, dict(quarantine_after=1,
                                           quarantine_rounds=2),
                         num_shards=4)
    m = np.random.default_rng(2).integers(0, 999, (4, 9)).astype(np.int32)
    flags = np.random.default_rng(4)
    rows_a, rows_b = [], []
    for t in range(30):
        rows_a += jr.begin_round(t)
        rows_b += tr.begin_round(t)
        away = jr.faults.away_for_round(t)
        np.testing.assert_array_equal(away, tr.faults.away_for_round(t))
        rows_a += jr.churn_ledger_rows(t, away)
        rows_b += tr.churn_ledger_rows(t, away)
        np.testing.assert_array_equal(jr.eligible(t), tr.eligible(t))
        np.testing.assert_array_equal(jr.plan_matrix_for(t, m),
                                      tr.plan_matrix_for(t, m))
        ids = jr.sample_cohort(t)
        jr.record_participation(t, ids)
        tr.record_participation(t, ids)
        f = (flags.random(len(ids)) < 0.3).astype(np.float32)
        jr.apply_screen_feedback(t, ids, f, rows_a)
        tr.apply_screen_feedback(t, ids, f, rows_b)
        np.testing.assert_array_equal(jr.staleness(t), tr.staleness(t))
    assert rows_a == rows_b
    assert {r["kind"] for r in rows_a} >= {"churn", "corrupt", "quarantine"}
    assert any(r["action"].startswith("shard_") for r in rows_a)
    _same_registry(jr, tr)


def test_registry_state_round_trip_and_refusals():
    """``state_dict`` is dopt's key for key; each package loads the
    other's; the three mismatch refusals and the shard integrity check
    are dopt's words."""
    pop = dict(clients=30, cohort=10, lanes=5)
    jr, tr = _registries(pop, num_shards=4)
    for t in range(4):
        ids = tr.sample_cohort(t)
        jr.record_participation(t, ids)
        tr.record_participation(t, ids)
        f = (np.arange(len(ids)) % 3 == 0).astype(np.float32)
        jr.apply_screen_feedback(t, ids, f, [])
        tr.apply_screen_feedback(t, ids, f, [])
    assert tr.state_dict() == jr.state_dict()
    assert json.loads(json.dumps(tr.state_dict())) == tr.state_dict()
    fresh_j, fresh_t = _registries(pop, num_shards=4)
    fresh_j.load_state(tr.state_dict())
    fresh_t.load_state(jr.state_dict())
    _same_registry(fresh_j, fresh_t)
    _same_registry(fresh_t, tr)
    bad = [dict(tr.state_dict(), clients=31), dict(tr.state_dict(), cohort=9),
           dict(tr.state_dict(), lanes=4),
           dict(tr.state_dict(), shard_of=[0] * 30)]
    for state in bad:
        with pytest.raises(ValueError) as want:
            fresh_j.load_state(state)
        with pytest.raises(ValueError) as got:
            fresh_t.load_state(state)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("impl", ["numpy", "native"])
def test_batch_plan_rows_keyed_by_client_id(impl):
    """``rows=`` gathers shard rows under client-id keys up to 10,000,
    bit for bit dopt's, numpy and native; ``rows`` without ``workers``
    is dopt's refusal."""
    if impl == "native":
        from dopt.native import native_available

        if not native_available():
            pytest.fail("dopt's native planner did not build (g++ is "
                        "needed)")
    im = np.random.default_rng(3).permutation(16 * 37).reshape(16, 37)
    ids = np.array([9_999, 0, 4_321, 16, 17, 9_999, 5], np.int32)
    rows = assign_client_shards(10_000, 16, seed=4, mode="random")[ids]
    for t in (0, 5):
        a = j_plan(im, batch_size=8, local_ep=2, seed=9, round_idx=t,
                   impl=impl, workers=ids, rows=rows)
        b = make_batch_plan(im, batch_size=8, local_ep=2, seed=9,
                            round_idx=t, impl=impl, workers=ids, rows=rows)
        np.testing.assert_array_equal(a.idx, b.idx)
        np.testing.assert_array_equal(a.weight, b.weight)
    same = make_batch_plan(im, batch_size=8, local_ep=2, seed=9, round_idx=0,
                           impl=impl, workers=np.arange(16),
                           rows=np.arange(16))
    full = make_batch_plan(im, batch_size=8, local_ep=2, seed=9, round_idx=0,
                           impl=impl)
    np.testing.assert_array_equal(same.idx, full.idx)
    with pytest.raises(ValueError) as want:
        j_plan(im, batch_size=8, rows=rows)
    with pytest.raises(ValueError) as got:
        make_batch_plan(im, batch_size=8, rows=rows)
    assert str(got.value) == str(want.value)


# -- the federated participation chain -----------------------------------
HOST = {
    "fault-free": dict(),
    "crash": dict(faults=dict(crash=0.3)),
    "partial": dict(faults=dict(straggle=0.4, straggle_frac=0.25)),
    "drop": dict(faults=dict(straggle=0.4, straggler_policy="drop")),
    "uplink": dict(faults=dict(msg_drop=0.2, msg_delay=0.3,
                               msg_delay_max=2)),
    "partition": dict(faults=dict(partition=0.3, partition_span=3,
                                  partition_groups=3)),
    "over-select": dict(faults=dict(crash=0.3, over_select=0.6)),
    "corrupt": dict(faults=dict(corrupt=0.3, corrupt_mode="nan",
                                corrupt_max=4)),
    "churn": dict(faults=dict(churn=0.2, churn_span=3)),
    "cocktail": dict(faults=dict(crash=0.1, straggle=0.3,
                                 straggler_policy="drop", over_select=0.5,
                                 churn=0.1, churn_span=2, msg_drop=0.1,
                                 msg_delay=0.2, msg_delay_max=2,
                                 corrupt=1.0, corrupt_max=6,
                                 corrupt_mode="nan", seed=5),
                     robust=dict(quarantine_after=1, quarantine_rounds=2)),
}


@pytest.mark.parametrize("case", HOST)
def test_cohort_participation_bit_identical(case):
    """20 rounds of the chain with seeded screen flags fed back: the
    binding, the ``[K, lanes]`` limits and corrupt mask, the rows in
    order, then the registry's arrays."""
    kw = HOST[case]
    jt = JaxFederatedTrainer(_cfg(J, **kw).replace(mesh_devices=1))
    tt = FederatedTrainer(_cfg(T, **kw), device="cpu")
    flags = np.random.default_rng(3)
    for t in range(20):
        jb, jlim, jc, jrows = jt._cohort_participation(t)
        tb, tlim, tc, trows = tt._cohort_participation(t)
        for k in ("lane_ids", "valid", "survivors", "cohort"):
            np.testing.assert_array_equal(getattr(jb, k), getattr(tb, k))
        for a, b in ((jlim, tlim), (jc, tc)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert trows == jrows, t
        n = len(tb.survivors)
        scr = (flags.random(n) < 0.4).astype(np.float32)
        jt._registry.record_participation(t, jb.survivors)
        tt._registry.record_participation(t, tb.survivors)
        jt._registry.apply_screen_feedback(t, jb.survivors, scr, jrows)
        tt._registry.apply_screen_feedback(t, tb.survivors, scr, trows)
        assert trows == jrows, t
    _same_registry(jt._registry, tt._registry)


# -- trajectories against dopt -------------------------------------------
def test_one_round_within_1e5():
    jt, tt = _pair()
    jt.run(rounds=1)
    tt.run(rounds=1)
    _close(jt, tt, loss=1e-5, acc=1e-5, rel=1e-5)


ENGINE = {
    "fedavg-lanes8": dict(),
    "fedavg-lanes-ne-users": dict(lanes=6),
    "fedprox-lanes4": dict(algorithm="fedprox", lanes=4),
    "fedprox-lanes-default": dict(algorithm="fedprox", lanes=None,
                                  cohort=16, clients=30),
    "empty-round": dict(faults=dict(crash=1.0)),
    "pop-seed": dict(pop_seed=99, clients=200, cohort=24),
}


@pytest.mark.parametrize("case", ENGINE)
def test_two_rounds_match_dopt(case):
    jt, tt = _pair(**ENGINE[case])
    jt.run(rounds=2)
    tt.run(rounds=2)
    _close(jt, tt)
    _same_registry(jt._registry, tt._registry)
    if case == "empty-round":
        want = tt.history.rows[0]
        assert want["cohort"] == 0 and want["local_loss"] == 0.0
        init = FederatedTrainer(_cfg(T, **ENGINE[case]), device="cpu",
                                init_params=jax.device_get(
                                    jt._theta_single()))
        for k, v in init.global_params().items():
            np.testing.assert_array_equal(v, tt.global_params()[k])


FAULTED = dict(
    clients=40, cohort=12, lanes=4,
    faults=dict(crash=0.1, straggle=0.3, straggler_policy="drop",
                msg_drop=0.1, over_select=1.0, churn=0.1, churn_span=2,
                corrupt=1.0, corrupt_max=5, corrupt_mode="nan", seed=3),
    robust=dict(clip_radius=0.5, quarantine_after=1, quarantine_rounds=2))


def test_faulted_run_matches_dopt():
    """Crash, deadline drops, uplink loss, over-selection, nan liars,
    the ball clip, the client quarantine and churn, 4 rounds: the ledger
    in content and order, the registry, the History and theta."""
    jt, tt = _pair(**FAULTED)
    jt.run(rounds=4)
    tt.run(rounds=4)
    kinds = {r["kind"] for r in tt.history.faults}
    assert kinds >= {"cohort", "crash", "corrupt", "quarantine", "churn",
                     "overselect"}, kinds
    _close(jt, tt)
    _same_registry(jt._registry, tt._registry)
    assert all(np.isfinite(v).all() for v in tt.global_params().values())


def test_partial_stragglers_match_dopt():
    jt, tt = _pair(faults=dict(straggle=0.5, straggle_frac=0.3, crash=0.1))
    jt.run(rounds=2)
    tt.run(rounds=2)
    assert any(r["action"].startswith("truncated_to_")
               for r in tt.history.faults)
    _close(jt, tt)


def test_bf16_storage_within_dopts_bf16_distance():
    """bf16 compute and storage with clipped nan liars: the lanes train
    in bf16, the accumulator stays f32 and theta is cast once.  The
    ledger is dopt's exactly; theta within dopt's own bf16-vs-f32
    distance, the losses within it or 1e-3 (ROADMAP: two bf16
    realizations drift apart)."""
    kw = dict(faults=dict(corrupt=0.3, corrupt_mode="nan"),
              robust=dict(clip_radius=0.5))
    j16 = JaxFederatedTrainer(_cfg(J, dtype="bfloat16",
                                   **kw).replace(mesh_devices=1))
    j32 = JaxFederatedTrainer(_cfg(J, **kw).replace(mesh_devices=1))
    tt = FederatedTrainer(_cfg(T, dtype="bfloat16", **kw), device="cpu",
                          init_params=jax.device_get(j16._theta_single()))
    for tr in (j16, j32, tt):
        tr.run(rounds=2)
    assert tt.history.faults == j16.history.faults == j32.history.faults
    assert all(v.dtype == torch.bfloat16 for v in tt.theta.values())

    def flat(tree):
        return np.concatenate([np.asarray(tree[layer][k], np.float64).ravel()
                               for layer in sorted(tree)
                               for k in sorted(tree[layer])])

    want = flat(jax.device_get(j16._theta_single()))
    ref = np.linalg.norm(want - flat(jax.device_get(j32._theta_single())))
    got = np.linalg.norm(want - flat(params_to_jax(tt.global_params(),
                                                   input_shape=SHAPE)))
    assert got <= ref, (got, ref)
    for k in ("train_loss", "local_loss", "test_acc"):
        gk = max(abs(a[k] - b[k]) for a, b in zip(j16.history.rows,
                                                   tt.history.rows))
        rk = max(abs(a[k] - b[k]) for a, b in zip(j16.history.rows,
                                                   j32.history.rows))
        assert gk <= (rk if k == "test_acc" else max(rk, 1e-3)), (k, gk, rk)


def test_cohort_vs_flat_parity():
    """dopt's pin, in the port: a full-population cohort (64 clients ==
    64 shards) on 8 lanes × 8 waves equals the 64-lane flat run
    (momentum 0: the flat run then carries nothing between rounds
    either) to rtol 2e-5, atol 2e-6 — the waves change the summation
    order, not the math."""
    base = dict(
        name="parity", seed=11,
        data=T.DataConfig(dataset="synthetic", num_users=64, iid=True,
                          synthetic_train_size=320, synthetic_test_size=64),
        model=T.ModelConfig(model="mlp", input_shape=SHAPE, faithful=False),
        optim=T.OptimizerConfig(lr=0.05, momentum=0.0),
        federated=T.FederatedConfig(algorithm="fedavg", frac=1.0, rounds=2,
                                    local_ep=1, local_bs=8))
    flat = FederatedTrainer(T.ExperimentConfig(**base), device="cpu",
                            eval_train=False)
    hf = flat.run(rounds=2)
    pop = FederatedTrainer(T.ExperimentConfig(
        **base, population=T.PopulationConfig(clients=64, cohort=64,
                                              lanes=8)), device="cpu",
        eval_train=False)
    hp = pop.run(rounds=2)
    assert pop._registry.waves == 8
    for k, v in flat.global_params().items():
        np.testing.assert_allclose(v, pop.global_params()[k], rtol=2e-5,
                                   atol=2e-6)
    for rf, rp in zip(hf.rows, hp.rows, strict=True):
        assert rf["test_acc"] == pytest.approx(rp["test_acc"], abs=1e-6)


# -- the port's own promises ---------------------------------------------
def _state(tr) -> dict:
    return {"theta": {k: v.copy() for k, v in tr.global_params().items()},
            "rows": list(tr.history.rows), "ledger": list(tr.history.faults),
            "registry": tr._registry.state_dict()}


def _same(a: dict, b: dict) -> None:
    assert a["rows"] == b["rows"] and a["ledger"] == b["ledger"]
    assert a["registry"] == b["registry"]
    for k, v in a["theta"].items():
        np.testing.assert_array_equal(v, b["theta"][k])


RESUME = {
    "fault-free": dict(),
    "faulted-quarantine": FAULTED,
    "prefetch-faulted": dict(FAULTED, robust=dict(clip_radius=0.5),
                             prefetch="on"),
}


@pytest.mark.parametrize("case", RESUME)
def test_prefetched_and_resumed_runs_equal_continuous(case, tmp_path):
    """Per-round (no prefetch) is the reference; a prefetched run, a run
    killed after round 1 (``checkpoint_every=1``) and resumed into a
    fresh trainer, and a resume across prefetch on/off all equal it bit
    for bit: theta, History, ledger and registry."""
    kw = dict(RESUME[case])
    plain = dict(kw, prefetch="off")
    cont = FederatedTrainer(_cfg(T, **plain), device="cpu")
    cont.run(rounds=3)
    want = _state(cont)
    if kw.get("prefetch") == "on":
        pre = FederatedTrainer(_cfg(T, **kw), device="cpu")
        pre.run(rounds=3)
        _same(want, _state(pre))
    victim = FederatedTrainer(_cfg(T, **kw), device="cpu")
    victim.run(rounds=1, checkpoint_every=1, checkpoint_path=tmp_path / "c")
    resumed = FederatedTrainer(_cfg(T, **kw), device="cpu")
    resumed.restore(tmp_path / "c")
    assert resumed.round == 1
    resumed.run(rounds=2)
    _same(want, _state(resumed))


def test_dopt_population_checkpoint_continues_in_the_port(tmp_path,
                                                          monkeypatch):
    """dopt saves after 2 faulted rounds (its npz layout); the port
    restores it and both run round 2: the registry state, the ledger and
    the next round within the one-round 1e-5."""
    import dopt.utils.checkpoint as jckpt

    monkeypatch.setattr(jckpt, "HAVE_ORBAX", False)
    kw = dict(FAULTED, robust=dict(clip_radius=0.5, quarantine_after=1,
                                   quarantine_rounds=3))
    jt = JaxFederatedTrainer(_cfg(J, **kw).replace(mesh_devices=1))
    jt.run(rounds=2)
    jt.save(tmp_path / "dopt")
    tt = FederatedTrainer(_cfg(T, **kw), device="cpu")
    tt.restore(tmp_path / "dopt")
    assert tt.round == 2
    assert tt._registry.state_dict() == jt._registry.state_dict()
    jt.run(rounds=1)
    tt.run(rounds=1)
    _close(jt, tt, loss=1e-5, acc=1e-5, rel=1e-5)


def test_lane_engine_checkpoint_refused_in_dopts_words(tmp_path):
    plain = FederatedTrainer(_cfg(T).replace(population=None), device="cpu")
    plain.save(tmp_path / "c")
    with pytest.raises(ValueError, match="population_registry") as got:
        FederatedTrainer(_cfg(T), device="cpu").restore(tmp_path / "c")
    assert "this checkpoint is from a lane-engine run" in str(got.value)


def test_population_gauges_and_history_columns():
    from dopt_torch.obs import MemorySink, Telemetry, attach

    tr = FederatedTrainer(_cfg(T, **FAULTED), device="cpu")
    sink = MemorySink()
    attach(tr, Telemetry([sink]))
    tr.run(rounds=2)
    gauges = {(e["round"], e["name"]): e["value"] for e in sink.events
              if e["kind"] == "gauge"}
    reg = tr._registry
    assert gauges[(1, "cohort_size")] == 12.0
    assert gauges[(1, "population_size")] == 40.0
    assert gauges[(1, "population_sampled_total")] == float(
        (reg.participation > 0).sum())
    assert gauges[(1, "population_quarantined")] == float(
        (reg.quarantine_until > 1).sum())
    assert [r["population"] for r in tr.history.rows] == [40, 40]
    assert all(0 <= r["cohort"] <= 12 for r in tr.history.rows)


# -- the gossip binding ---------------------------------------------------
def _gcfg(mod, **pop):
    return mod.ExperimentConfig(
        name="gpop", seed=5,
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=True,
                            synthetic_train_size=256,
                            synthetic_test_size=64),
        model=mod.ModelConfig(model="mlp", input_shape=SHAPE,
                              faithful=False),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5),
        gossip=mod.GossipConfig(algorithm="dsgd", topology="circle",
                                mode="metropolis", rounds=3, local_ep=1,
                                local_bs=32),
        population=mod.PopulationConfig(**(pop or dict(clients=24,
                                                       cohort=4))))


def test_gossip_binding_matches_dopt_and_blocks(tmp_path):
    """Two rounds against dopt (History within the bounds, the cohort
    rows exactly, params 1e-4); per-round ≡ blocked ≡ killed-and-resumed
    bit for bit, the registry included; the gauges."""
    from dopt_torch.obs import MemorySink, Telemetry, attach

    jt = JaxGossipTrainer(_gcfg(J).replace(mesh_devices=1))
    init = {layer: {k: np.asarray(v)[0] for k, v in d.items()}
            for layer, d in jax.device_get(jt.params).items()}
    tt = GossipTrainer(_gcfg(T), device="cpu", init_params=init)
    sink = MemorySink()
    attach(tt, Telemetry([sink]))
    jt.run(rounds=2)
    tt.run(rounds=2)
    assert tt.history.faults == jt.history.faults
    assert [r["kind"] for r in tt.history.faults] == ["cohort"] * 2
    for a, b in zip(jt.history.rows, tt.history.rows, strict=True):
        for k, v in a.items():
            tol = ACC_TOL if k.endswith("acc") else LOSS_TOL
            assert abs(v - b[k]) <= tol, (k, a, b)
    want = jax.device_get(jt.params)
    got = params_to_jax(tt.worker_params(), input_shape=SHAPE)
    for layer in want:
        for k in want[layer]:
            a = np.asarray(want[layer][k])
            assert (np.abs(a - got[layer][k]).max()
                    / np.abs(a).max()) <= PARAM_REL_TOL
    _same_registry(jt._registry, tt._registry)
    gauges = {e["name"]: e["value"] for e in sink.events
              if e["kind"] == "gauge" and e["round"] == 1}
    assert gauges["cohort_size"] == 4.0 and gauges["population_size"] == 24.0
    blocked = GossipTrainer(_gcfg(T), device="cpu", init_params=init)
    blocked.run(rounds=2, block=2)
    victim = GossipTrainer(_gcfg(T), device="cpu", init_params=init)
    victim.run(rounds=1, checkpoint_every=1, checkpoint_path=tmp_path / "g")
    resumed = GossipTrainer(_gcfg(T), device="cpu", init_params=init)
    resumed.restore(tmp_path / "g")
    resumed.run(rounds=1)
    for other in (blocked, resumed):
        assert other.history.faults == tt.history.faults
        assert other.history.rows == tt.history.rows
        assert other._registry.state_dict() == tt._registry.state_dict()
        for k, v in tt.worker_params().items():
            np.testing.assert_array_equal(v, other.worker_params()[k])
    plain = GossipTrainer(_gcfg(T).replace(population=None), device="cpu")
    plain.save(tmp_path / "lane")
    with pytest.raises(ValueError, match="from a lane-engine run"):
        GossipTrainer(_gcfg(T), device="cpu").restore(tmp_path / "lane")


# -- dopt's refusals, in dopt's words -------------------------------------
def _edit(cfg, section, **kw):
    sub = getattr(cfg, section)
    return cfg.replace(**{section: dataclasses.replace(sub, **kw)})


FED_REFUSED = {
    "fedadmm": lambda m, c: _edit(c, "federated", algorithm="fedadmm"),
    "scaffold": lambda m, c: _edit(c, "federated", algorithm="scaffold"),
    "holdout": lambda m, c: _edit(c, "data", local_holdout=0.1),
    "compact": lambda m, c: _edit(c, "federated", compact=True),
    "staleness": lambda m, c: _edit(c, "federated", staleness_max=2),
    "comm_dtype": lambda m, c: _edit(c, "federated", comm_dtype="bfloat16"),
    "scatter": lambda m, c: _edit(c, "federated", update_sharding="scatter"),
    "aggregator": lambda m, c: c.replace(robust=m.RobustConfig(
        aggregator="median")),
    "mesh_hosts": lambda m, c: c.replace(mesh_hosts=1),
    "stale-corrupt": lambda m, c: c.replace(faults=m.FaultConfig(
        corrupt=0.5, corrupt_mode="stale")),
    "diagnostics": lambda m, c: _edit(c, "federated", diagnostics="on"),
    "prefetch-quarantine": lambda m, c: _edit(c, "federated",
                                              prefetch="on").replace(
        robust=m.RobustConfig(quarantine_after=1)),
    "fused": lambda m, c: _edit(_edit(c, "federated", fused_update="on"),
                                "optim", fused_update=True),
    "cohort-over-clients": lambda m, c: c.replace(
        population=m.PopulationConfig(clients=10, cohort=11)),
    "zero-lanes": lambda m, c: c.replace(
        population=m.PopulationConfig(clients=10, cohort=4, lanes=0)),
}
GOSSIP_REFUSED = {
    "cohort": lambda m, c: c.replace(population=m.PopulationConfig(
        clients=24, cohort=8)),
    "lanes": lambda m, c: c.replace(population=m.PopulationConfig(
        clients=24, cohort=4, lanes=2)),
    "faults": lambda m, c: c.replace(faults=m.FaultConfig(crash=0.1)),
    "dropout": lambda m, c: _edit(c, "gossip", dropout=0.1),
    "clip": lambda m, c: c.replace(robust=m.RobustConfig(clip_radius=1.0)),
    "quarantine": lambda m, c: c.replace(robust=m.RobustConfig(
        quarantine_after=1)),
    "holdout": lambda m, c: _edit(c, "data", local_holdout=0.1),
    "diagnostics": lambda m, c: _edit(c, "gossip", diagnostics="on"),
    "prefetch": lambda m, c: _edit(c, "gossip", prefetch="on"),
    "codec": lambda m, c: _edit(c, "gossip", update_sharding="scatter"
                                ).replace(comm=m.CommConfig(codec="qsgd")),
    "async": lambda m, c: _edit(c, "gossip", mixing="async"),
    "fused": lambda m, c: _edit(c, "gossip", fused_update="on"),
}


@pytest.mark.parametrize("engine,case", [
    *(("federated", k) for k in FED_REFUSED),
    *(("gossip", k) for k in GOSSIP_REFUSED)])
def test_population_refusals_are_dopts(engine, case):
    """Each refusal the two engines make of population mode, raised by
    the port's constructor with dopt's message.  (dopt's "lanes must
    divide the mesh" cannot fire on one rank.)"""
    if engine == "federated":
        edit, mk = FED_REFUSED[case], _cfg
        jcls, tcls = JaxFederatedTrainer, FederatedTrainer
    else:
        edit, mk = GOSSIP_REFUSED[case], _gcfg
        jcls, tcls = JaxGossipTrainer, GossipTrainer
    jcfg = edit(J, mk(J))
    if case != "mesh_hosts":
        jcfg = jcfg.replace(mesh_devices=1)
    with pytest.raises(ValueError) as want:
        jcls(jcfg)
    with pytest.raises(ValueError) as got:
        tcls(edit(T, mk(T)), device="cpu")
    assert str(got.value) == str(want.value)


def test_population_config_is_dopts():
    jf = {f.name: f.default for f in dataclasses.fields(J.PopulationConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(T.PopulationConfig)}
    assert tf == jf == {"clients": 1000, "cohort": 64, "seed": None,
                        "lanes": None}
    with pytest.raises(ValueError, match="cfg.population must be a "
                                         "dopt_torch.config.PopulationConfig"):
        FederatedTrainer(_cfg(T).replace(population=J.PopulationConfig()),
                         device="cpu")


# -- the preset and the CLI -----------------------------------------------
def test_xclients_preset_is_dopts():
    from dopt.presets import get_preset as jget
    from dopt_torch.config import exp_details
    from dopt_torch.presets import get_preset as tget

    a, b = jget("baseline3-xclients"), tget("baseline3-xclients")
    assert b.name == "baseline3-fedavg-xclients-1k"
    assert dataclasses.asdict(b.population) == dataclasses.asdict(
        a.population)
    assert exp_details(b) == J.exp_details(a)
    tr = FederatedTrainer(b.replace(data=dataclasses.replace(
        b.data, dataset="synthetic", synthetic_train_size=640,
        synthetic_test_size=64), model=T.ModelConfig(
            model="mlp", input_shape=SHAPE, faithful=False)), device="cpu")
    assert (tr._registry.clients, tr._registry.cohort_size,
            tr._registry.lanes, tr._registry.waves) == (1000, 64, 16, 4)


@pytest.mark.parametrize("argv,match", [
    (["--preset", "baseline3", "--cohort", "32"], "--clients"),
    (["--preset", "baseline3", "--cohort-seed", "3"], "--clients"),
    (["--preset", "baseline3", "--clients", "10", "--cohort", "64"],
     "cohort"),
    (["--preset", "baseline3-xclients", "--clients", "0"], "clients"),
])
def test_cli_population_refusals_are_dopts(argv, match):
    from dopt.run import main as jmain
    from dopt_torch.run import main

    with pytest.raises(SystemExit, match=match) as want:
        jmain(argv)
    with pytest.raises(SystemExit) as got:
        main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_cli_runs_the_population_on_the_cpu(tmp_path, capsys):
    """``--clients/--cohort/--cohort-seed`` on ``baseline3-xclients``
    shrunk to the MLP: rows with dopt's columns, the ledger's cohort
    rows, a checkpoint that resumes."""
    from dopt_torch.run import main

    ledger = tmp_path / "l.json"
    args = ["--preset", "baseline3-xclients", "--device", "cpu",
            "--num-users", "4", "--synthetic-scale", "0.004", "--set",
            "model.model=mlp", "--set", "model.faithful=false", "--set",
            "federated.local_ep=1", "--clients", "300", "--cohort", "10",
            "--cohort-seed", "7", "--set", "population.lanes=4"]
    assert main(args + ["--rounds", "2", "--faults-json", str(ledger),
                        "--checkpoint", str(tmp_path / "c")]) == 0
    rows = [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["cohort"] for r in rows] == [10, 10]
    assert all(r["population"] == 300 for r in rows)
    cohort_rows = [r for r in json.loads(ledger.read_text())
                   if r["kind"] == "cohort"]
    assert [r["action"].split("_digest_")[0] for r in cohort_rows] == [
        "sampled_10_of_300"] * 2
    assert all(r["action"].endswith("_waves_3") for r in cohort_rows)
    assert main(args + ["--rounds", "1", "--resume",
                        str(tmp_path / "c")]) == 0
    assert json.loads(capsys.readouterr().out.strip())["round"] == 2
