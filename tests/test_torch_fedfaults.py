"""The port's federated fault model against dopt's.

Host participation (``_round_participation``, ``_participation_static``,
the screen feedback and the staleness schedule) is numpy in both
packages and must be equal bit for bit over 20 rounds of each fault
kind: survivors, limits, corrupt mask, capture, admission weights, the
ledger rows in order, and the client-sampling stream's state after.

Trajectories: both trainers run one config from dopt's init
(``params_from_jax``) per-round on 8 clients of an 8×8 synthetic set
(the MLP, 256/32 samples, batch 16, frac 0.5, one local epoch); dopt on
a one-device mesh, the port on the CPU.  The ledger must be equal row
for row, the History within ROADMAP's f32 bounds (losses 1e-3, test
accuracy 1e-4) and theta and the clients' params within 1e-4
max-relative.  Inside the port, blocked (the plain block and the chaos
block) ≡ per-round and resumed ≡ continuous, bit for bit; a dopt npz
checkpoint of a faulty run continues in the port; and every refusal
dopt makes, the port makes in dopt's words.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt_torch.convert import params_to_jax
from dopt_torch.engine import FederatedTrainer

LOSS_TOL, ACC_TOL, PARAM_REL_TOL = 1e-3, 1e-4, 1e-4
SHAPE = (8, 8, 1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, *, algorithm="fedavg", faults=None, robust=None, compact=None,
         fused=False, holdout=0.0, users=8, model="mlp", dtype="float32",
         **fed):
    return mod.ExperimentConfig(
        name="fedfaults", seed=11,
        data=mod.DataConfig(dataset="synthetic", num_users=users, iid=False,
                            shards=2, synthetic_train_size=32 * users,
                            synthetic_test_size=32, local_holdout=holdout,
                            holdout_mode="deterministic"),
        model=mod.ModelConfig(model=model, input_shape=SHAPE,
                              faithful=model == "model1",
                              compute_dtype=dtype, param_dtype=dtype),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, rho=0.1,
                                  fused_update=fused),
        federated=mod.FederatedConfig(
            algorithm=algorithm, frac=0.5, rounds=2, local_ep=1, local_bs=16,
            compact=compact, fused_update="on" if fused else "off", **fed),
        faults=None if faults is None else mod.FaultConfig(**faults),
        robust=None if robust is None else mod.RobustConfig(**robust))


# -- host participation --------------------------------------------------
CRASHY = dict(crash=0.2, straggle=0.3, straggle_frac=0.5)
HOST = {
    "crash": dict(faults=dict(crash=0.3)),
    "partial": dict(faults=dict(straggle=0.4, straggle_frac=0.25)),
    "drop": dict(faults=dict(straggle=0.4, straggler_policy="drop")),
    "over-select": dict(faults=dict(crash=0.3, over_select=0.6)),
    "partition": dict(faults=dict(partition=0.3, partition_span=3,
                                  partition_groups=3)),
    "churn": dict(faults=dict(churn=0.15, churn_span=3)),
    "uplink-drop": dict(faults=dict(msg_drop=0.3)),
    "uplink-delay": dict(faults=dict(msg_delay=0.4, msg_delay_max=3)),
    "delay-stale": dict(faults=dict(msg_delay=0.4, msg_delay_max=3),
                        staleness_max=2),
    "drop-stale": dict(faults=dict(straggle=0.4, straggler_policy="drop",
                                   msg_drop=0.1), staleness_max=3),
    "corrupt": dict(faults=dict(corrupt=0.4, corrupt_mode="signflip",
                                crash=0.1)),
    "quarantine": dict(faults=dict(corrupt=0.5, corrupt_mode="nan"),
                       robust=dict(quarantine_after=2, quarantine_rounds=3)),
    "cocktail": dict(faults=dict(crash=0.1, straggle=0.3,
                                 straggler_policy="drop", over_select=0.5,
                                 partition=0.1, churn=0.05, msg_drop=0.1,
                                 msg_delay=0.2, msg_delay_max=2,
                                 corrupt=0.3, corrupt_mode="stale", seed=5),
                     robust=dict(quarantine_after=1, quarantine_rounds=2),
                     staleness_max=2),
}


@pytest.mark.parametrize("case", HOST)
def test_round_participation_bit_identical(case):
    """20 rounds of participation; the screen's flags come from a seeded
    stream and go through both packages' feedback, so the quarantine
    benches, readmits and drops pending admissions as dopt's does."""
    kw = dict(HOST[case])
    jt = JaxFederatedTrainer(_cfg(J, **kw).replace(mesh_devices=1))
    tt = FederatedTrainer(_cfg(T, **kw), device="cpu")
    flags = np.random.default_rng(3)
    jrows, trows = [], []
    for t in range(20):
        want = jt._round_participation(t, 0.5)
        got = tt._round_participation(t)
        for a, b in zip(want, got, strict=True):
            if isinstance(a, list):
                assert a == b, t
            else:
                np.testing.assert_array_equal(a, b, err_msg=str(t))
                assert a.dtype == b.dtype
        scr = (flags.random(len(want[0])) < 0.4).astype(np.float32)
        jt._apply_screen_feedback(t, want[0], scr, want[3])
        tt._apply_screen_feedback(t, got[0], scr, got[3])
        jrows += want[3]
        trows += got[3]
    assert jrows == trows and jrows
    for name in ("_screen_streak", "_quarantine_until", "_stale_admit_round",
                 "_stale_weight", "_stale_origin"):
        np.testing.assert_array_equal(getattr(jt, name), getattr(tt, name))
    assert (jt._sample_rng.bit_generator.state
            == tt._sample_rng.bit_generator.state)


@pytest.mark.parametrize("case", ["over-select", "cocktail"])
def test_participation_static_bit_identical(case):
    """The chaos block's pre-drawn candidates (draw order) and fault
    vectors are dopt's."""
    kw = dict(HOST[case])
    jt = JaxFederatedTrainer(_cfg(J, **kw).replace(mesh_devices=1))
    tt = FederatedTrainer(_cfg(T, **kw), device="cpu")
    for t in range(10):
        want, got = jt._participation_static(t, 0.5), \
            tt._participation_static(t)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
            assert want[k].dtype == got[k].dtype, k


def test_fault_free_sample_is_the_sorted_draw():
    """Without faults the participation is ``_sample_indices``'s draw,
    so the sampling stream is the fault-free port's."""
    a = FederatedTrainer(_cfg(T), device="cpu")
    b = FederatedTrainer(_cfg(T), device="cpu")
    for t in range(10):
        sel, _, cmask, rows, cap, admit = a._round_participation(t)
        np.testing.assert_array_equal(sel, b._sample_indices())
        assert not rows and not cmask.any() and not cap.any() \
            and not admit.any()


def test_fixed_width_sel_matches_dopt():
    jt = JaxFederatedTrainer(_cfg(J, faults=CRASHY).replace(mesh_devices=1))
    tt = FederatedTrainer(_cfg(T, faults=CRASHY), device="cpu")
    for sel in ([0, 3], [], [1, 2, 5, 7], [6]):
        sel = np.asarray(sel, np.int32)
        for a, b in zip(jt._fixed_width_sel(sel, 0.5),
                        tt._fixed_width_sel(sel), strict=True):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# -- trajectories against dopt -------------------------------------------
ENGINE = {
    "crash-compact": dict(faults=dict(crash=0.3)),
    "crash-full": dict(faults=dict(crash=0.3), compact=False),
    "crash-fused": dict(faults=dict(crash=0.3), fused=True),
    "partial-compact": dict(faults=CRASHY),
    "partial-full": dict(faults=CRASHY, compact=False),
    "partial-fused": dict(faults=CRASHY, fused=True),
    "partial-holdout": dict(faults=CRASHY, holdout=0.1),
    "drop": dict(faults=dict(straggle=0.4, straggler_policy="drop")),
    "drop-full": dict(faults=dict(straggle=0.4, straggler_policy="drop"),
                      compact=False),
    "over-select-compact": dict(faults=dict(crash=0.3, over_select=0.6)),
    "over-select-full": dict(faults=dict(crash=0.3, over_select=0.6),
                             compact=False),
    "over-select-fused": dict(faults=dict(crash=0.3, over_select=0.6),
                              fused=True),
    "partition": dict(faults=dict(partition=0.5, partition_span=2)),
    "partition-fused": dict(faults=dict(partition=0.5, partition_span=2),
                            fused=True),
    "churn": dict(faults=dict(churn=0.2, churn_span=2)),
    "churn-fused": dict(faults=dict(churn=0.2, churn_span=2), fused=True),
    "uplink-drop": dict(faults=dict(msg_drop=0.3), compact=False),
    "uplink-drop-fused": dict(faults=dict(msg_drop=0.3, msg_delay=0.2,
                                          msg_delay_max=2), fused=True),
    "uplink-delay": dict(faults=dict(msg_delay=0.4, msg_delay_max=2)),
    "delay-stale": dict(faults=dict(msg_delay=0.5, msg_delay_max=2),
                        staleness_max=2),
    "drop-stale-clip": dict(faults=dict(straggle=0.5,
                                        straggler_policy="drop"),
                            staleness_max=2, robust=dict(clip_radius=0.5)),
    "corrupt-nan": dict(faults=dict(corrupt=0.4, corrupt_mode="nan")),
    "corrupt-inf-full": dict(faults=dict(corrupt=0.4, corrupt_mode="inf"),
                             compact=False),
    "corrupt-scale": dict(faults=dict(corrupt=0.3, corrupt_mode="scale",
                                      corrupt_scale=3.0)),
    "corrupt-signflip": dict(faults=dict(corrupt=0.3,
                                         corrupt_mode="signflip")),
    "corrupt-stale": dict(faults=dict(corrupt=0.4, corrupt_mode="stale"),
                          compact=False),
    "trimmed-mean": dict(faults=dict(corrupt=1.0, corrupt_max=1,
                                     corrupt_mode="signflip"),
                         robust=dict(aggregator="trimmed_mean",
                                     trim_frac=0.25), compact=False),
    "median-compact": dict(faults=dict(corrupt=1.0, corrupt_max=1,
                                       corrupt_mode="scale",
                                       corrupt_scale=10.0),
                           robust=dict(aggregator="median")),
    "krum": dict(faults=dict(corrupt=1.0, corrupt_max=1,
                             corrupt_mode="scale", corrupt_scale=10.0),
                 robust=dict(aggregator="krum", krum_f=1), compact=False),
    "multi-krum-compact": dict(faults=dict(crash=0.2, corrupt=1.0,
                                           corrupt_max=1,
                                           corrupt_mode="signflip"),
                               robust=dict(aggregator="multi_krum",
                                           krum_f=1)),
    "clip": dict(faults=dict(corrupt=1.0, corrupt_max=1,
                             corrupt_mode="scale", corrupt_scale=10.0),
                 robust=dict(clip_radius=0.5), compact=False),
    "quarantine-full": dict(faults=dict(corrupt=1.0, corrupt_max=1,
                                        corrupt_mode="nan"),
                            robust=dict(quarantine_after=1,
                                        quarantine_rounds=1),
                            compact=False),
    "quarantine-compact": dict(faults=dict(corrupt=1.0, corrupt_max=2,
                                           corrupt_mode="inf"),
                               robust=dict(quarantine_after=1,
                                           quarantine_rounds=2)),
    "fedadmm-faults": dict(algorithm="fedadmm",
                           faults=dict(CRASHY, corrupt=0.3,
                                       corrupt_mode="stale"),
                           compact=False),
    "scaffold-faults": dict(algorithm="scaffold",
                            faults=dict(CRASHY, corrupt=0.3,
                                        corrupt_mode="signflip")),
    "scaffold-holdout": dict(algorithm="scaffold", faults=CRASHY,
                             holdout=0.1, compact=False),
    "fedprox-median": dict(algorithm="fedprox",
                           faults=dict(crash=0.2, corrupt=0.3,
                                       corrupt_mode="nan"),
                           robust=dict(aggregator="median",
                                       quarantine_after=1)),
}
# Rounds a case runs: the staleness buffer admits from round 1 on and
# the quarantine readmits after its sentence.
ROUNDS = {"delay-stale": 4, "drop-stale-clip": 4, "quarantine-full": 4,
          "quarantine-compact": 4}


def _close(jt, tt):
    """The ledger exactly, History and client rows within the bounds,
    theta and the clients' params within 1e-4 max-relative."""
    assert tt.history.faults == jt.history.faults
    for a, b in zip(jt.history.rows, tt.history.rows, strict=True):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k, v in a.items():
            tol = ACC_TOL if k == "test_acc" else LOSS_TOL
            assert abs(v - b[k]) <= tol, (k, a, b)
    for a, b in zip(jt.client_history.rows, tt.client_history.rows,
                    strict=True):
        assert a.keys() == b.keys()
        for k, v in a.items():
            assert abs(v - b[k]) <= LOSS_TOL, (k, a, b)
    for want, got in ((jt._theta_single(), tt.global_params()),
                      (jt.params, tt.worker_params())):
        want = jax.device_get(want)
        got = params_to_jax(got, input_shape=SHAPE)
        for layer in want:
            for k in want[layer]:
                a, b = np.asarray(want[layer][k]), got[layer][k]
                assert a.shape == b.shape
                rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
                assert rel <= PARAM_REL_TOL, f"{layer}.{k}: {rel:.3e}"


@pytest.mark.parametrize("case", ENGINE)
def test_engine_fault_modes_match_dopt(case):
    kw = ENGINE[case]
    jt = JaxFederatedTrainer(_cfg(J, **kw).replace(mesh_devices=1))
    init = jax.device_get(jt._theta_single())
    tt = FederatedTrainer(_cfg(T, **kw), device="cpu", init_params=init)
    rounds = ROUNDS.get(case, 2)
    jt.run(rounds=rounds)
    tt.run(rounds=rounds)
    _close(jt, tt)
    if tt._has_stale:
        got = params_to_jax({k: v.numpy() for k, v in tt._stale_p.items()},
                            input_shape=SHAPE)
        for layer, leaves in jax.device_get(jt._stale_p).items():
            for k, a in leaves.items():
                a = np.asarray(a)
                rel = (np.abs(a - got[layer][k]).max()
                       / max(np.abs(a).max(), 1e-12))
                assert rel <= PARAM_REL_TOL, f"stale_p {layer}.{k}"


BF16 = {
    "stale-clip": dict(faults=dict(straggle=0.5, straggler_policy="drop",
                                   msg_delay=0.3, msg_delay_max=2),
                       staleness_max=2, robust=dict(clip_radius=0.5)),
    "trimmed-compact": dict(faults=dict(corrupt=1.0, corrupt_max=1,
                                        corrupt_mode="signflip", crash=0.2),
                            robust=dict(aggregator="trimmed_mean",
                                        trim_frac=0.25)),
}


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(tree[layer][k], np.float64).ravel()
                           for layer in sorted(tree)
                           for k in sorted(tree[layer])])


@pytest.mark.parametrize("case", BF16)
def test_bf16_storage_faults_within_dopts_bf16_distance(case):
    """bf16 compute and storage under faults (the clip's scale and the
    staleness weights cast to bf16, as dopt casts them): the ledger is
    dopt's exactly, the port's trajectory within dopt's own bf16-vs-f32
    distance (ROADMAP: two bf16 realizations drift apart; losses within
    that distance or 1e-3)."""
    kw = BF16[case]
    j16 = JaxFederatedTrainer(_cfg(J, dtype="bfloat16",
                                   **kw).replace(mesh_devices=1))
    j32 = JaxFederatedTrainer(_cfg(J, **kw).replace(mesh_devices=1))
    tt = FederatedTrainer(_cfg(T, dtype="bfloat16", **kw), device="cpu",
                          init_params=jax.device_get(j16._theta_single()))
    for tr in (j16, j32, tt):
        tr.run(rounds=3)
    assert tt.history.faults == j16.history.faults == j32.history.faults
    assert all(v.dtype == torch.bfloat16 for v in tt.params.values())
    if tt._stale_p is not None:
        assert all(v.dtype == torch.bfloat16
                   for v in tt._stale_p.values())

    def params(tr):
        if tr is tt:
            return [_flat(params_to_jax(p, input_shape=SHAPE))
                    for p in (tt.worker_params(), tt.global_params())]
        return [_flat(jax.device_get(p)) for p in (tr.params,
                                                   tr._theta_single())]

    def rel(a, b):
        return max(np.linalg.norm(x - y) / max(np.linalg.norm(x), 1e-12)
                   for x, y in zip(a, b))

    got, ref = rel(params(j16), params(tt)), rel(params(j16), params(j32))
    assert got <= ref, (got, ref)
    for k in ("train_loss", "local_loss", "test_acc"):
        gk = max(abs(a[k] - b[k]) for a, b in zip(j16.history.rows,
                                                   tt.history.rows))
        rk = max(abs(a[k] - b[k]) for a, b in zip(j16.history.rows,
                                                   j32.history.rows))
        assert gk <= (rk if k == "test_acc" else max(rk, 1e-3)), (k, gk, rk)


def test_quarantine_fires_and_readmits_on_dopts_schedule():
    """One pinned nan liar, quarantine after 1 screened round for 1
    round: screened and benched at round 0 until 2, excluded at round 1,
    readmitted at round 2 — the same rows dopt writes."""
    kw = ENGINE["quarantine-full"]
    tt = FederatedTrainer(_cfg(T, **kw), device="cpu")
    tt.run(rounds=4)
    rows = [(r["round"], r["worker"], r["kind"], r["action"])
            for r in tt.history.faults if r["worker"] == 0]
    assert (0, 0, "quarantine", "quarantined_until_2") in rows
    assert (2, 0, "quarantine", "readmitted") in rows
    assert not any(r[0] == 1 and r[2] == "corrupt" for r in rows)


# -- blocked, prefetched and resumed ≡ per-round, in the port -----------
def _state(tr) -> dict:
    out = {"rows": tr.history.rows, "ledger": tr.history.faults,
           "clients": tr.client_history.rows,
           "params": tr.worker_params(), "theta": tr.global_params(),
           "momentum": {k: v.numpy().copy() for k, v in tr.momentum.items()},
           "mirrors": [tr._screen_streak.tolist(),
                       tr._quarantine_until.tolist(),
                       tr._stale_admit_round.tolist(),
                       tr._stale_weight.tolist(),
                       tr._stale_origin.tolist()],
           "stream": tr._sample_rng.bit_generator.state}
    if tr._stale_p is not None:
        out["stale_p"] = {k: v.numpy().copy() for k, v in tr._stale_p.items()}
    for name in ("duals", "c_global"):
        if getattr(tr, name) is not None:
            out[name] = {k: v.numpy().copy()
                         for k, v in getattr(tr, name).items()}
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


BLOCKED = {
    "compact-fixed-width": dict(faults=dict(CRASHY, over_select=0.5,
                                            partition=0.2)),
    "full-median": dict(faults=dict(CRASHY, corrupt=0.3,
                                    corrupt_mode="scale",
                                    corrupt_scale=3.0),
                        robust=dict(aggregator="median"), compact=False),
    "fused": dict(faults=dict(CRASHY, over_select=0.3), fused=True),
    "chaos-quarantine": dict(faults=dict(corrupt=1.0, corrupt_max=1,
                                         corrupt_mode="nan", crash=0.1),
                             robust=dict(quarantine_after=1,
                                         quarantine_rounds=2),
                             compact=False),
    "chaos-staleness": dict(faults=dict(straggle=0.5,
                                        straggler_policy="drop",
                                        msg_drop=0.1, msg_delay=0.3,
                                        msg_delay_max=2, churn=0.1,
                                        churn_span=2), staleness_max=2),
    "chaos-both": dict(faults=dict(corrupt=1.0, corrupt_max=1,
                                   corrupt_mode="nan", msg_delay=0.4,
                                   msg_delay_max=2, over_select=0.3),
                       robust=dict(quarantine_after=1, quarantine_rounds=2,
                                   clip_radius=1.0), staleness_max=2),
    "scaffold-holdout": dict(algorithm="scaffold", faults=CRASHY,
                             holdout=0.1),
}


@pytest.mark.parametrize("case", BLOCKED)
def test_blocked_and_resumed_bit_identical(case, tmp_path):
    """Per-round against blocks of 2, prefetched blocks of 3, and a run
    killed after round 3 (its checkpoint) resumed per-round and
    blocked: History, ledger content and order, params, theta, the
    mirrors, the staleness buffer and the sampling stream, bit for bit.
    Under quarantine or staleness the blocks run the chaos round, whose
    device counters are checked against the host replay every round."""
    cfg = _cfg(T, **BLOCKED[case])
    ref = FederatedTrainer(cfg, device="cpu")
    ref.run(rounds=5)
    want = _state(ref)
    assert want["ledger"]
    for block, prefetch in ((2, "off"), (3, "on")):
        c = cfg.replace(federated=dataclasses.replace(cfg.federated,
                                                      prefetch=prefetch))
        b = FederatedTrainer(c, device="cpu")
        b.run(rounds=5, block=block)
        _same(want, _state(b), f"block {block}")
    kill = FederatedTrainer(cfg, device="cpu")
    kill.run(rounds=3, block=2, checkpoint_every=3,
             checkpoint_path=tmp_path / "ck")
    for block in (1, 2):
        c = FederatedTrainer(cfg, device="cpu")
        c.restore(tmp_path / "ck")
        assert c.round == 3
        c.run(rounds=2, block=block)
        _same(want, _state(c), f"resumed, block {block}")


def test_chaos_replay_divergence_raises():
    """A device counter that drifts from the host replay fails loudly."""
    cfg = _cfg(T, **BLOCKED["chaos-quarantine"])
    tr = FederatedTrainer(cfg, device="cpu")
    body = tr._chaos_round

    def drift(inp):
        out = body(inp)
        tr._dev_streak.add_(5)
        return out
    tr._chaos_round = drift
    with pytest.raises(RuntimeError, match="host replay diverged"):
        tr.run(rounds=2, block=2)


def test_compact_quarantine_runs_per_round_whatever_the_block():
    """dopt keeps compact sampling with the quarantine per-round (its
    gather depends on the quarantine state): block=2 equals block=1."""
    cfg = _cfg(T, **ENGINE["quarantine-compact"])
    a = FederatedTrainer(cfg, device="cpu")
    a.run(rounds=3)
    b = FederatedTrainer(cfg, device="cpu")
    b.run(rounds=3, block=2)
    assert not b.graphs.statics
    _same(_state(a), _state(b))


@pytest.mark.parametrize("case", ["chaos-both", "compact-fixed-width"])
def test_dopt_checkpoint_continues_in_port(case, tmp_path, monkeypatch):
    """dopt's npz checkpoint of a faulty run (its ledger, quarantine
    mirrors, admission schedule and staleness buffer) restored into the
    port continues as dopt's restored run does: the ledger and mirrors
    exactly, the next rounds within the bounds."""
    import dopt.utils.checkpoint as jckpt

    monkeypatch.setattr(jckpt, "HAVE_ORBAX", False)
    kw = BLOCKED[case]
    jcfg = _cfg(J, **kw).replace(mesh_devices=1)
    jt = JaxFederatedTrainer(jcfg)
    jt.run(rounds=2)
    jt.save(tmp_path / "dopt")
    jr = JaxFederatedTrainer(jcfg)
    jr.restore(tmp_path / "dopt")
    jr.run(rounds=2)
    tt = FederatedTrainer(_cfg(T, **kw), device="cpu")
    tt.restore(tmp_path / "dopt")
    assert tt.round == 2 and tt.history.faults == jt.history.faults
    meta = json.loads((tmp_path / "dopt" / "meta.json").read_text())
    assert tt._stale_weight.tolist() == meta["stale_weight"]
    tt.run(rounds=2)
    _close(jr, tt)


# -- refusals -------------------------------------------------------------
REFUSED = {
    "aggregator-comm-dtype": dict(robust=dict(aggregator="median"),
                                  comm_dtype="bfloat16"),
    "stale-scaffold": dict(algorithm="scaffold", staleness_max=2),
    "stale-aggregator": dict(staleness_max=2,
                             robust=dict(aggregator="krum")),
    "stale-comm-dtype": dict(staleness_max=2, comm_dtype="bfloat16"),
    "stale-negative": dict(staleness_max=-1),
    "stale-decay": dict(staleness_max=1, staleness_decay=1.5),
    "fused-scaffold": dict(algorithm="scaffold", fused=True),
    "fused-aggregator": dict(fused=True,
                             robust=dict(aggregator="trimmed_mean")),
    "fused-clip": dict(fused=True, robust=dict(clip_radius=1.0)),
    "fused-corrupt": dict(fused=True, faults=dict(corrupt=0.2)),
    "fused-stale": dict(fused=True, staleness_max=2),
    "fused-compact": dict(fused=True, compact=True),
    "bad-aggregator": dict(robust=dict(aggregator="mode")),
    "bad-trim": dict(robust=dict(aggregator="trimmed_mean",
                                 trim_frac=0.5)),
    "bad-fault": dict(faults=dict(straggler_policy="wait", straggle=0.1)),
}


@pytest.mark.parametrize("case", REFUSED)
def test_refusals_match_dopt(case):
    """Every refusal dopt makes of the federated fault model, the port
    makes, message for message."""
    with pytest.raises(ValueError) as want:
        JaxFederatedTrainer(_cfg(J, **REFUSED[case]).replace(mesh_devices=1))
    with pytest.raises(ValueError) as got:
        FederatedTrainer(_cfg(T, **REFUSED[case]), device="cpu")
    assert str(got.value) == str(want.value)


def test_compact_with_staleness_refused_as_dopt():
    """dopt refuses compact=True with a live staleness buffer when it
    picks the path (at run time); the port at construction, in dopt's
    words."""
    kw = dict(faults=dict(msg_delay=0.3, msg_delay_max=2), staleness_max=2,
              compact=True)
    with pytest.raises(ValueError) as want:
        JaxFederatedTrainer(_cfg(J, **kw).replace(mesh_devices=1)).run(
            rounds=1)
    with pytest.raises(ValueError) as got:
        FederatedTrainer(_cfg(T, **kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_population_stays_refused_naming_its_slice():
    """The population slice runs a ``PopulationConfig`` under faults
    (tests/test_torch_population.py); any other object in the section
    is refused by its type."""
    cfg = _cfg(T, faults=dict(crash=0.1)).replace(population=object())
    with pytest.raises(ValueError, match="cfg.population must be a "
                                         "dopt_torch.config.PopulationConfig"):
        FederatedTrainer(cfg, device="cpu")


# -- presets and the CLI --------------------------------------------------
@pytest.mark.parametrize("name", ["baseline3-faulty", "baseline3-byzantine",
                                  "baseline3-elastic"])
def test_federated_fault_presets_are_dopts(name):
    from dopt.presets import get_preset as jget
    from dopt_torch.presets import get_preset as tget

    a, b = tget(name), jget(name)
    for section in ("data", "model", "optim", "federated", "faults",
                    "robust"):
        x, y = getattr(a, section), getattr(b, section)
        assert (x is None) == (y is None), section
        if x is not None:
            ya = dataclasses.asdict(y)
            assert all(v == ya[k] for k, v in dataclasses.asdict(x).items()), \
                section
    assert (a.name, a.seed) == (b.name, b.seed)


def test_faulty_federated_headline_preset():
    """headline-fedavg-model1-faulty = the federated headline with
    baseline3-faulty's faults: a composition dopt runs as it stands."""
    from dopt_torch.presets import get_preset

    head, faulty = (get_preset("headline-fedavg-model1"),
                    get_preset("headline-fedavg-model1-faulty"))
    assert faulty == dataclasses.replace(
        head, name="headline-fedavg-model1-faulty",
        faults=get_preset("baseline3-faulty").faults)
    assert faulty.faults.over_select == 0.3 and \
        faulty.federated.fused_update == "on" and faulty.optim.fused_update


def test_cli_aggregator_and_faults_reach_the_federated_engine(tmp_path,
                                                              capsys):
    from dopt_torch.run import main

    ledger = tmp_path / "l.json"
    main(["--preset", "baseline3-byzantine", "--device", "cpu",
          "--rounds", "1", "--aggregator", "krum",
          "--set", "robust.krum_f=2", "--set", "data.dataset=synthetic",
          "--set", "data.synthetic_train_size=320",
          "--set", "data.synthetic_test_size=32",
          "--set", "federated.local_ep=1", "--set", "federated.local_bs=20",
          "--faults", "crash=0.3", "--corrupt", "p=1,mode=signflip,max=2",
          "--faults-json", str(ledger)])
    rows = json.loads(ledger.read_text())
    kinds = {r["kind"] for r in rows}
    assert {"crash", "corrupt"} <= kinds, rows
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])["round"] == 0
