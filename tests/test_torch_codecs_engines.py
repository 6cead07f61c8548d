"""choco and the narrowed wire in the port's trainers, against dopt's.

Both packages run the same config from dopt's init on the CPU: Model1
on the synthetic set (8×8, so its conv, Dense and HWC-order fc1 layouts
all differ from the port's), 4 workers, 128 train / 32 test, batch 16,
one local epoch, 2 rounds, with kernel 1 on (``optim.fused_update``)
and the fused epilogue off, as dopt requires with choco and
``comm_dtype``.  dopt runs with ``mesh_devices=1``.

Tolerances:

* choco with top-k or rand-k (ratio 0.25, γ = 0.2): slice 1's limits —
  train loss 1e-3, test accuracy 1e-4, params and ``x_hat`` 1e-4
  max-relative.  The draws are dopt's bit for bit.
* choco with QSGD (16 levels): slice 1's History limits; params and
  ``x_hat`` within 1e-4 max-relative except at most 1e-4 of their
  elements — the bucket norms sum in another order than XLA's, so a
  level can flip, which moves its element by one level.
* A narrowed wire (``comm_dtype="bfloat16"``) rounds every sent value
  to bf16: a 1e-7 difference between the packages becomes one bf16 step
  (2**-8 to 2**-7 of the value) wherever a value sits at a rounding
  boundary.  So params (and theta) are held to slice 1's 1e-4
  max-relative plus one bf16 step of the element on at most 1e-3 of all
  elements; History rows to slice 1's (slice 2's for federated) limits.

* bf16 compute and storage: slice 4's rule — params within dopt's own
  bf16-vs-f32 distance on the same run (relative L2), losses within
  that or 1e-3.

The port's own promises hold bit for bit: two runs agree, blocked ≡
per-round for choco (every compressor) and the narrowed wire, killed
and resumed ≡ continuous with ``x_hat``; under a crash a dead lane's
``x_hat`` freezes.  A dopt choco checkpoint restores into the port.
Every refusal dopt makes about these knobs the port makes in dopt's
words.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt_torch.convert import params_to_jax
from dopt_torch.engine import FederatedTrainer, GossipTrainer

REPO = Path(__file__).resolve().parent.parent
SHAPE = (8, 8, 1)
LOSS_TOL, ACC_TOL, PARAM_TOL, ROUND_TOL = 1e-3, 1e-4, 1e-4, 1e-5
CHOCO = dict(algorithm="choco", compression_ratio=0.25, choco_gamma=0.2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gcfg(mod, *, faults=None, top=None, **g_over):
    g = dict(algorithm="dsgd", topology="circle", mode="stochastic",
             rounds=2, local_ep=1, local_bs=16)
    g.update(g_over)
    return mod.ExperimentConfig(
        name="codecs", seed=11, **(top or {}),
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=32),
        model=mod.ModelConfig(model="model1", input_shape=SHAPE,
                              faithful=True),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, fused_update=True),
        faults=faults, gossip=mod.GossipConfig(**g))


def _fcfg(mod, *, top=None, compact=None, **f_over):
    f = dict(algorithm="fedavg", frac=0.5, rounds=2, local_ep=1,
             local_bs=16, compact=compact)
    f.update(f_over)
    return mod.ExperimentConfig(
        name="codecs", seed=11, **(top or {}),
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=32),
        model=mod.ModelConfig(model="model1", input_shape=SHAPE,
                              faithful=True),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, rho=0.1,
                                  fused_update=True),
        federated=mod.FederatedConfig(**f))


def _gpair(**g):
    jt = JaxGossipTrainer(_gcfg(J, top={"mesh_devices": 1}, **g))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    return jt, GossipTrainer(_gcfg(T, **g), device="cpu", init_params=init)


def _tree_dist(want: dict, got: dict) -> list[tuple[str, np.ndarray,
                                                     np.ndarray]]:
    out = []
    for layer in want:
        for k in want[layer]:
            a, b = np.asarray(want[layer][k], np.float32), got[layer][k]
            assert a.shape == b.shape, (layer, k)
            out.append((f"{layer}.{k}", a, b))
    return out


def _close(want: dict, got: dict, limit: float = PARAM_TOL) -> None:
    for name, a, b in _tree_dist(want, got):
        rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
        assert rel <= limit, f"{name}: {rel:.3e}"


def _close_but_a_few(want: dict, got: dict, *, extra, frac: float) -> None:
    """Within 1e-4 max-relative, except at most ``frac`` of all elements,
    which stay within ``extra(a)`` beyond it."""
    total = off = 0
    for name, a, b in _tree_dist(want, got):
        d = np.abs(a - b)
        base = PARAM_TOL * max(np.abs(a).max(), 1e-12)
        bad = d > base
        total += a.size
        off += int(bad.sum())
        assert (d[bad] <= base + extra(a[bad])).all(), name
    assert off <= frac * total, (off, total)


def _bf16_step(a: np.ndarray) -> np.ndarray:
    """One bf16 step at ``a``'s magnitude (at most 2**-7 of it)."""
    return 2.0**-7 * np.abs(a)


def _rows(want, got, keys=("avg_train_loss",), acc="avg_test_acc") -> None:
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k in keys:
            assert abs(a[k] - b[k]) <= LOSS_TOL, (k, a, b)
        assert abs(a[acc] - b[acc]) <= ACC_TOL, (a, b)


def _xhat_tree(tt) -> dict:
    return params_to_jax({k: v.float().numpy() for k, v in tt.x_hat.items()},
                         input_shape=SHAPE)


@pytest.mark.parametrize("compression", ["topk", "randk", "qsgd"])
def test_choco_matches_dopt(compression, devices):
    extra = {"qsgd_levels": 16, "compression_ratio": 1.0} \
        if compression == "qsgd" else {}
    jt, tt = _gpair(**{**CHOCO, "compression": compression, **extra})
    jt.run(rounds=1)
    tt.run(rounds=1)
    _close(jax.device_get(jt.worker_params()),
           params_to_jax(tt.worker_params(), input_shape=SHAPE), ROUND_TOL)
    jt.run(rounds=1)
    tt.run(rounds=1)
    _rows(jt.history.rows, tt.history.rows)
    pairs = [(jax.device_get(jt.worker_params()),
              params_to_jax(tt.worker_params(), input_shape=SHAPE)),
             (jax.device_get(jt.x_hat), _xhat_tree(tt))]
    for want, got in pairs:
        if compression == "qsgd":
            _close_but_a_few(want, got, frac=1e-4,
                             extra=lambda a: np.full_like(a, np.inf))
        else:
            _close(want, got)


def _rel_l2(want: dict, got: dict) -> float:
    a = np.concatenate([x.ravel() for _, x, _ in _tree_dist(want, got)])
    b = np.concatenate([y.ravel() for _, _, y in _tree_dist(want, got)])
    return float(np.linalg.norm(a.astype(np.float64) - b)
                 / np.linalg.norm(a.astype(np.float64)))


@pytest.mark.parametrize("compression", ["topk", "randk", "qsgd"])
def test_choco_bf16_within_dopts_own_distance(compression, devices):
    """bf16 compute and storage (slice 4's rule): after 2 rounds the
    port's params sit within dopt's own bf16-vs-f32 distance of dopt's
    bf16 run (relative L2; 0.13-0.16 of it when written), its losses
    within that distance or 1e-3, its test accuracy within 1e-4 or
    dopt's own gap."""
    g = dict(**CHOCO, compression=compression,
             qsgd_levels=16 if compression == "qsgd" else 0)

    def bf16(cfg):
        return cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16", param_dtype="bfloat16"))

    jt = JaxGossipTrainer(bf16(_gcfg(J, top={"mesh_devices": 1}, **g)))
    jf = JaxGossipTrainer(_gcfg(J, top={"mesh_devices": 1}, **g))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jf.params))
    tt = GossipTrainer(bf16(_gcfg(T, **g)), device="cpu", init_params=init)
    jh, fh, th = jt.run(rounds=2), jf.run(rounds=2), tt.run(rounds=2)
    want = jax.device_get(jt.worker_params())
    own = _rel_l2(want, jax.device_get(jf.worker_params()))
    got = _rel_l2(want, params_to_jax(tt.worker_params(), input_shape=SHAPE))
    print(f"choco {compression} bf16: port vs dopt {got:.3e}, dopt bf16 vs "
          f"f32 {own:.3e}")
    assert got <= own
    for a, b, f in zip(jh.rows, th.rows, fh.rows, strict=True):
        tol = max(abs(a["avg_train_loss"] - f["avg_train_loss"]), LOSS_TOL)
        assert abs(a["avg_train_loss"] - b["avg_train_loss"]) <= tol
        acc = max(abs(a["avg_test_acc"] - f["avg_test_acc"]), ACC_TOL)
        assert abs(a["avg_test_acc"] - b["avg_test_acc"]) <= acc


def test_choco_identity_equals_dsgd():
    """Q = identity and γ = 1 reduce CHOCO to D-SGD (dopt's
    tests/test_compression.py:59-74), on the port's own runs."""
    a = GossipTrainer(_gcfg(T, rounds=3), device="cpu")
    b = GossipTrainer(_gcfg(T, rounds=3, algorithm="choco",
                            compression="none", choco_gamma=1.0),
                      device="cpu")
    ha, hb = a.run(), b.run()
    for k, v in a.worker_params().items():
        np.testing.assert_allclose(v, b.worker_params()[k], atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose([r["avg_test_acc"] for r in ha.rows],
                               [r["avg_test_acc"] for r in hb.rows],
                               atol=1e-5)


@pytest.mark.parametrize("g", [
    dict(), dict(algorithm="fedlcon", eps=2, faithful_bugs=False),
    dict(mixing="async"), dict(**CHOCO, compression="randk"),
], ids=["dsgd", "fedlcon", "async", "choco"])
def test_gossip_wire_matches_dopt(g, devices):
    jt, tt = _gpair(**g, comm_dtype="bfloat16")
    jt.run(rounds=1)
    tt.run(rounds=1)
    _close(jax.device_get(jt.worker_params()),
           params_to_jax(tt.worker_params(), input_shape=SHAPE), ROUND_TOL)
    jt.run(rounds=1)
    tt.run(rounds=1)
    _rows(jt.history.rows, tt.history.rows)
    _close_but_a_few(jax.device_get(jt.worker_params()),
                     params_to_jax(tt.worker_params(), input_shape=SHAPE),
                     extra=_bf16_step, frac=1e-3)


@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox", "scaffold",
                                       "fedadmm"])
def test_federated_wire_matches_dopt(algorithm, devices):
    """The narrowed masked mean; ``comm_dtype`` forces the full width
    although frac = 0.5 would take the compact path."""
    jt = JaxFederatedTrainer(_fcfg(J, top={"mesh_devices": 1},
                                   algorithm=algorithm,
                                   comm_dtype="bfloat16"))
    tt = FederatedTrainer(_fcfg(T, algorithm=algorithm,
                                comm_dtype="bfloat16"), device="cpu",
                          init_params=jax.device_get(jt._theta_single()))
    assert not tt._use_compact()
    assert FederatedTrainer(_fcfg(T, algorithm=algorithm),
                            device="cpu")._use_compact()
    jh, th = jt.run(rounds=2), tt.run(rounds=2)
    _rows(jh.rows, th.rows, keys=("train_loss", "local_loss", "test_loss",
                                  "train_acc"), acc="test_acc")
    for want, got in ((jax.device_get(jt._theta_single()),
                       tt.global_params()),
                      (jax.device_get(jt.params), tt.worker_params())):
        _close_but_a_few(want, params_to_jax(got, input_shape=SHAPE),
                         extra=_bf16_step, frac=1e-3)


def test_federated_wire_refuses_explicit_compact(devices):
    """dopt refuses compact=True with comm_dtype at its first round; the
    port at construction, in dopt's words."""
    jt = JaxFederatedTrainer(_fcfg(J, top={"mesh_devices": 1},
                                   compact=True, comm_dtype="bfloat16"))
    with pytest.raises(ValueError) as want:
        jt.run(rounds=1)
    with pytest.raises(ValueError) as got:
        FederatedTrainer(_fcfg(T, compact=True, comm_dtype="bfloat16"),
                         device="cpu")
    assert str(got.value) == str(want.value)


# -- the port's own promises, bit for bit ---------------------------------
def _state(tr) -> dict:
    out = {f"p.{k}": v for k, v in tr.worker_params().items()}
    moms = (tr.momentum if isinstance(tr.momentum, dict)
            else dict(zip(tr._names, tr.momentum)))
    out.update({f"m.{k}": v.detach().float().cpu().numpy()
                for k, v in moms.items()})
    out.update({f"xh.{k}": v.float().cpu().numpy()
                for k, v in getattr(tr, "x_hat", {}).items()})
    if hasattr(tr, "theta"):
        out.update({f"th.{k}": np.asarray(v)
                    for k, v in tr.global_params().items()})
    return out


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


PROMISE_CASES = {
    "choco-topk": (GossipTrainer, _gcfg, dict(**CHOCO, compression="topk")),
    "choco-randk": (GossipTrainer, _gcfg, dict(**CHOCO, compression="randk")),
    "choco-qsgd": (GossipTrainer, _gcfg, dict(**CHOCO, compression="qsgd",
                                              qsgd_levels=16)),
    "choco-randk-wire": (GossipTrainer, _gcfg,
                         dict(**CHOCO, compression="randk",
                              comm_dtype="bfloat16")),
    "dsgd-wire": (GossipTrainer, _gcfg, dict(comm_dtype="bfloat16")),
    "fedavg-wire": (FederatedTrainer, _fcfg, dict(comm_dtype="bfloat16")),
}


@functools.lru_cache(maxsize=None)
def _per_round(case: str) -> tuple:
    cls, mk, kw = PROMISE_CASES[case]
    tr = cls(mk(T, **kw), device="cpu")
    rows = tr.run(rounds=4, block=1).rows
    return rows, _state(tr)


@pytest.mark.parametrize("case", PROMISE_CASES)
def test_blocked_equals_per_round(case):
    cls, mk, kw = PROMISE_CASES[case]
    tr = cls(mk(T, **kw, prefetch="on"), device="cpu")
    rows = tr.run(rounds=4, block=3).rows
    want_rows, want = _per_round(case)
    assert rows == want_rows
    _same(want, _state(tr))


@pytest.mark.parametrize("case", ["choco-randk", "dsgd-wire"])
def test_two_runs_equal(case):
    cls, mk, kw = PROMISE_CASES[case]
    tr = cls(mk(T, **kw), device="cpu")
    assert tr.run(rounds=4).rows == _per_round(case)[0]
    _same(_per_round(case)[1], _state(tr))


class Killed(Exception):
    """The simulated kill."""


@pytest.mark.parametrize("block", [1, 2])
@pytest.mark.parametrize("case", ["choco-randk", "choco-qsgd",
                                  "choco-randk-wire", "fedavg-wire"])
def test_kill_and_resume_equals_continuous(case, block, tmp_path,
                                           monkeypatch):
    cls, mk, kw = PROMISE_CASES[case]
    cfg = mk(T, **kw)
    victim = cls(cfg, device="cpu")
    record = victim._record

    def record_or_die(t, *a):
        if t == 3:
            raise Killed
        record(t, *a)

    monkeypatch.setattr(victim, "_record", record_or_die)
    with pytest.raises(Killed):
        victim.run(rounds=4, block=block, checkpoint_every=2,
                   checkpoint_path=tmp_path / "ck")
    resumed = cls(cfg, device="cpu")
    resumed.restore(tmp_path / "ck")
    assert resumed.round == 2
    resumed.run(rounds=2, block=block)
    want_rows, want = _per_round(case)
    assert resumed.history.rows == want_rows
    _same(want, _state(resumed))


def test_choco_checkpoint_without_x_hat_refused(tmp_path):
    tr = GossipTrainer(_gcfg(T, **CHOCO, compression="topk"), device="cpu")
    tr.run(rounds=1)
    tr.save(tmp_path / "ck")
    import dopt_torch.utils.checkpoint as ck

    arrays, meta = ck.load_checkpoint(tmp_path / "ck")
    del arrays["x_hat"]
    ck.save_checkpoint(tmp_path / "bad", arrays=arrays, meta=meta)
    with pytest.raises(ValueError, match=r"choco trainer requires its "
                       r"public-copy state \('x_hat'\) in the checkpoint"):
        GossipTrainer(_gcfg(T, **CHOCO, compression="topk"),
                      device="cpu").restore(tmp_path / "bad")


def test_choco_dead_lane_x_hat_freezes():
    """Under a crash a dead lane sends nothing: its x̂ is the one it
    entered the round with, while the live lanes' x̂ move."""
    faults = T.FaultConfig(crash=0.5)
    tr = GossipTrainer(_gcfg(T, faults=faults, **CHOCO, compression="randk"),
                       device="cpu")
    moved = frozen = 0
    for t in range(4):
        before = {k: v.clone() for k, v in tr.x_hat.items()}
        dead = tr.faults.for_round(t).crashed
        tr.run(rounds=1)
        for i in range(4):
            same = all(torch.equal(before[k][i], v[i])
                       for k, v in tr.x_hat.items())
            assert same == bool(dead[i]), (t, i)
            frozen += int(dead[i])
            moved += int(not dead[i])
    assert frozen and moved


@pytest.mark.parametrize("faults", [dict(crash=0.3), dict(straggle=0.5),
                                    dict(partition=0.5), dict(churn=0.3)],
                         ids=["crash", "straggle", "partition", "churn"])
def test_choco_under_faults_matches_dopt(faults, devices):
    """choco under the gossip fault modes dopt allows with it."""
    jt = JaxGossipTrainer(_gcfg(J, top={"mesh_devices": 1},
                                faults=J.FaultConfig(**faults), **CHOCO,
                                compression="randk"))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    tt = GossipTrainer(_gcfg(T, faults=T.FaultConfig(**faults), **CHOCO,
                             compression="randk"), device="cpu",
                       init_params=init)
    jh, th = jt.run(rounds=2), tt.run(rounds=2)
    _rows(jh.rows, th.rows)
    assert jh.faults == th.faults
    _close(jax.device_get(jt.worker_params()),
           params_to_jax(tt.worker_params(), input_shape=SHAPE))
    _close(jax.device_get(jt.x_hat), _xhat_tree(tt))


def test_choco_sharded_eval_matches_dopt(devices):
    """choco with each worker evaluating its own shard of the test set."""
    jt, tt = _gpair(**CHOCO, compression="randk", eval_mode="sharded")
    jh, th = jt.run(rounds=2), tt.run(rounds=2)
    _rows(jh.rows, th.rows)
    _close(jax.device_get(jt.worker_params()),
           params_to_jax(tt.worker_params(), input_shape=SHAPE))


@pytest.mark.parametrize("block", [1, 2])
def test_choco_diagnostics_leave_the_run_unchanged(block):
    """``diagnostics="on"`` adds gauges only: History and state equal the
    plain run's bit for bit, per-round and blocked, and each round
    streams its six finite gauges."""
    from dopt_torch.obs import MemorySink, Telemetry, attach

    g = dict(**CHOCO, compression="qsgd", qsgd_levels=16)
    plain = GossipTrainer(_gcfg(T, **g), device="cpu")
    diag = GossipTrainer(_gcfg(T, **g, diagnostics="on"), device="cpu")
    sink = MemorySink()
    attach(diag, Telemetry([sink]), fresh=True)
    assert plain.run(rounds=3, block=block).rows == \
        diag.run(rounds=3, block=block).rows
    _same(_state(plain), _state(diag))
    gauges = [e for e in sink.events if e.get("kind") == "gauge"
              and e.get("name") == "consensus_distance"]
    assert len(gauges) == 3 and all(np.isfinite(e["value"]) for e in gauges)


def test_dopt_choco_checkpoint_restores(tmp_path, monkeypatch, devices):
    """dopt's choco checkpoint (its npz layout, flax trees, x_hat among
    them) restores into the port; the next round stays within the
    single-round standard of dopt's next round."""
    import dopt.utils.checkpoint as jckpt

    monkeypatch.setattr(jckpt, "HAVE_ORBAX", False)
    g = dict(**CHOCO, compression="randk")
    jt = JaxGossipTrainer(_gcfg(J, top={"mesh_devices": 1}, **g))
    jt.run(rounds=2)
    jt.save(tmp_path / "dopt")
    jr = JaxGossipTrainer(_gcfg(J, top={"mesh_devices": 1}, **g))
    jr.restore(tmp_path / "dopt")
    jr.run(rounds=1)
    tt = GossipTrainer(_gcfg(T, **g), device="cpu")
    tt.restore(tmp_path / "dopt")
    assert tt.round == 2 and tt.history.rows == jt.history.rows
    _close(jax.device_get(jt.x_hat), _xhat_tree(tt), 0.0)
    tt.run(rounds=1)
    _rows(jr.history.rows, tt.history.rows)
    _close(jax.device_get(jr.worker_params()),
           params_to_jax(tt.worker_params(), input_shape=SHAPE), ROUND_TOL)
    _close(jax.device_get(jr.x_hat), _xhat_tree(tt), ROUND_TOL)


# -- refusals, in dopt's words -----------------------------------------
REFUSALS = {
    "robust+choco": (_gcfg, dict(**CHOCO, compression="topk"),
                     dict(robust=dict(clip_radius=1.0))),
    "robust+wire": (_gcfg, dict(comm_dtype="bfloat16"),
                    dict(robust=dict(clip_radius=1.0))),
    "link+wire": (_gcfg, dict(comm_dtype="bfloat16"),
                  dict(faults=dict(msg_drop=0.2))),
    "push_sum+wire": (_gcfg, dict(comm_dtype="bfloat16",
                                  correction="push_sum"), {}),
    "async+choco": (_gcfg, dict(**CHOCO, mixing="async"), {}),
    "fused+choco": (_gcfg, dict(**CHOCO, fused_update="on"), {}),
    "fused+wire": (_gcfg, dict(comm_dtype="bfloat16", fused_update="on"),
                   {}),
    "choco-bad-compressor": (_gcfg, dict(**CHOCO, compression="signsgd"),
                             {}),
    "choco-bad-ratio": (_gcfg, {**CHOCO, "compression": "randk",
                                "compression_ratio": 0.0}, {}),
    "choco-levels-topk": (_gcfg, dict(**CHOCO, compression="topk",
                                      qsgd_levels=4), {}),
    "fed-aggregator+wire": (_fcfg, dict(comm_dtype="bfloat16"),
                            dict(robust=dict(aggregator="median"))),
    "fed-staleness+wire": (_fcfg, dict(comm_dtype="bfloat16",
                                       staleness_max=2),
                           dict(faults=dict(straggle=0.3,
                                            straggler_policy="drop"))),
    "fed-fused+wire": (_fcfg, dict(comm_dtype="bfloat16",
                                   fused_update="on"), {}),
}


def _refusal_cfg(mod, case):
    mk, kw, extra = REFUSALS[case]
    cfg = mk(mod, **kw)
    if "robust" in extra:
        cfg = cfg.replace(robust=mod.RobustConfig(**extra["robust"]))
    if "faults" in extra:
        cfg = cfg.replace(faults=mod.FaultConfig(**extra["faults"]))
    return cfg


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_in_dopts_words(case, devices):
    jcls, tcls = ((JaxGossipTrainer, GossipTrainer)
                  if REFUSALS[case][0] is _gcfg
                  else (JaxFederatedTrainer, FederatedTrainer))
    with pytest.raises(ValueError) as want:
        jcls(_refusal_cfg(J, case).replace(mesh_devices=1))
    with pytest.raises(ValueError) as got:
        tcls(_refusal_cfg(T, case), device="cpu")
    assert str(got.value) == str(want.value)


def test_cfg_comm_still_refused_for_the_bucket_codec():
    """Since the scatter slice the bucket codec runs: ``cfg.comm`` takes a
    ``CommConfig`` (on the scatter path) and refuses anything else."""
    cfg = _gcfg(T).replace(comm=object())
    with pytest.raises(ValueError, match="cfg.comm must be a dopt_torch"):
        GossipTrainer(cfg, device="cpu")
    cfg = _gcfg(T, update_sharding="scatter").replace(
        comm=T.CommConfig(codec="qsgd"))
    tr = GossipTrainer(cfg, device="cpu")
    assert tr.codec_plan.any_codec
    assert len(tr.run(rounds=1).rows) == 1


def test_unknown_wire_dtype_refused():
    with pytest.raises(ValueError, match="unknown comm_dtype 'int3'"):
        GossipTrainer(_gcfg(T, comm_dtype="int3"), device="cpu")
    with pytest.raises(ValueError, match="unknown comm_dtype 'int3'"):
        FederatedTrainer(_fcfg(T, comm_dtype="int3"), device="cpu")


@pytest.mark.parametrize("g,warns", [
    (dict(algorithm="choco", compression="randk", compression_ratio=0.5,
          choco_gamma=1.0), True),
    (dict(algorithm="choco", compression="qsgd", compression_ratio=1.0,
          choco_gamma=1.5), True),
    (dict(algorithm="choco", compression="topk", compression_ratio=1.0,
          choco_gamma=1.0), False),
    (dict(algorithm="choco", compression="none", choco_gamma=1.0), False),
    (dict(algorithm="choco", compression="topk", compression_ratio=0.5,
          choco_gamma=0.5), False),
], ids=["randk-1.0", "qsgd-1.5", "topk-identity", "none", "gamma-0.5"])
def test_choco_gamma_warning(g, warns):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        GossipTrainer(_gcfg(T, **g), device="cpu")
    hits = [w for w in seen if "choco_gamma >= 1" in str(w.message)]
    assert bool(hits) == warns


# -- the CLI ----------------------------------------------------------------
@pytest.mark.parametrize("sets", [
    ["gossip.algorithm=choco", "gossip.compression=randk",
     "gossip.compression_ratio=0.1", "gossip.choco_gamma=0.1"],
    ["gossip.comm_dtype=bfloat16"],
], ids=["choco", "wire"])
def test_cli_runs_the_codecs(sets):
    """``python -m dopt_torch.run --preset baseline1 --device cpu
    --num-users 4 --synthetic-scale 0.01 --rounds 1`` with the knobs set:
    exit 0, one finite round, and the header is dopt's ``exp_details``
    of the same config."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = [sys.executable, "-m", "dopt_torch.run", "--preset", "baseline1",
            "--device", "cpu", "--num-users", "4", "--synthetic-scale",
            "0.01", "--rounds", "1"]
    for s in sets:
        args += ["--set", s]
    res = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    from dopt.presets import get_preset as jax_preset

    cfg = jax_preset("baseline1")
    d = dataclasses.replace(cfg.data, num_users=4)
    d = dataclasses.replace(
        d, synthetic_train_size=max(int(d.synthetic_train_size * 0.01), 32),
        synthetic_test_size=max(int(d.synthetic_test_size * 0.01), 64))
    over = {}
    for s in sets:
        key, val = s.split("=")
        field = key.split(".")[1]
        typ = type(getattr(cfg.gossip, field))
        over[field] = val if typ in (str, type(None)) else typ(val)
    cfg = cfg.replace(data=d, gossip=dataclasses.replace(cfg.gossip, **over))
    assert res.stderr.startswith(J.exp_details(cfg) + "\n")
    import json

    (row,) = [json.loads(line) for line in res.stdout.strip().splitlines()]
    assert row["round"] == 0 and np.isfinite(row["avg_train_loss"])
