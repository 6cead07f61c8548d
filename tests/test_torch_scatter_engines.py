"""The scatter path, the shift path and the bucket codec in the port's
trainers (one rank), against dopt's on a one-device mesh.

Both packages run the same config from dopt's init on the CPU: Model1 on
the synthetic set (8×8, so its conv, Dense and HWC-order fc1 layouts all
differ from the port's), 4 workers, 128 train / 32 test, batch 16, one
local epoch, 2 rounds, kernel 1 on (``optim.fused_update``) and the fused
epilogue off, as dopt requires with scatter.  dopt runs with
``mesh_devices=1``.  The buckets are 0.1 MiB (26,214 f32 a lane: 8
buckets of Model1's 188,810 entries at 8×8); the codec runs at dopt's
comm-modes settings (``chunk=64``, ``min_codec_bytes=256``).

Tolerances:

* f32 paths (scatter, shift, choco over scatter buckets, federated
  scatter): slice 1's multi-round limits — train loss 1e-3, test
  accuracy 1e-4, params 1e-4 max-relative after 2 rounds.
* The codec: the encodes are dopt's bit for bit (the scales and draws in
  dopt's element order), so slice 1's limits hold too, except that a
  1e-7 difference between the packages can move a level by one where
  v/scale + u sits at an integer: params within 1e-4 max-relative except
  at most 1e-3 of the elements, which stay within one level (the
  chunk's scale, at most max|v|/7 at q4) of dopt's.
* A narrowed partial (``comm_dtype``/``comm.wire_dtype`` bf16): one bf16
  step on at most 1e-3 of the elements, as in the codecs slice.
* One case against dopt's default 8-device mesh (8 workers), with dopt's
  own bounds (tests/test_update_sharding.py): params ``rtol=2e-5,
  atol=1e-6`` after one round, History floats within 5e-4.

The port's own promises hold bit for bit on the CPU: scatter and codec
blocked ≡ per-round, codec killed and resumed ≡ continuous (with
``comm_residual``), two runs equal, and ``update_sharding="off"`` with
``comm=None`` unchanged.  Every refusal dopt makes of these knobs the
port makes in dopt's words; ``mesh_devices > 1`` without launched ranks
names the launch it needs.
"""

import dataclasses

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

SHAPE = (8, 8, 1)
LOSS_TOL, ACC_TOL, PARAM_TOL = 1e-3, 1e-4, 1e-4
BUCKET_MB = 0.1
CODEC = dict(codec="qsgd", chunk=64, min_codec_bytes=256)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gcfg(mod, *, comm=None, faults=None, top=None, users=4, **g_over):
    g = dict(algorithm="dsgd", topology="circle", mode="stochastic",
             rounds=2, local_ep=1, local_bs=16, update_sharding="scatter",
             update_bucket_mb=BUCKET_MB)
    g.update(g_over)
    return mod.ExperimentConfig(
        name="scatter", seed=11, **(top or {}),
        data=mod.DataConfig(dataset="synthetic", num_users=users, iid=False,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=32),
        model=mod.ModelConfig(model="model1", input_shape=SHAPE,
                              faithful=True),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, fused_update=True),
        faults=faults, gossip=mod.GossipConfig(**g),
        comm=None if comm is None else mod.CommConfig(**comm))


def _fcfg(mod, *, comm=None, top=None, **f_over):
    f = dict(algorithm="fedavg", frac=0.5, rounds=2, local_ep=1,
             local_bs=16, update_sharding="scatter",
             update_bucket_mb=BUCKET_MB)
    f.update(f_over)
    return mod.ExperimentConfig(
        name="scatter", seed=11, **(top or {}),
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=32),
        model=mod.ModelConfig(model="model1", input_shape=SHAPE,
                              faithful=True),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, rho=0.1,
                                  fused_update=True),
        federated=mod.FederatedConfig(**f),
        comm=None if comm is None else mod.CommConfig(**comm))


def _gpair(jtop=None, **kw):
    jt = JaxGossipTrainer(_gcfg(
        J, top={"mesh_devices": 1} if jtop is None else jtop, **kw))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    return jt, GossipTrainer(_gcfg(T, **kw), device="cpu", init_params=init)


def _pairs(want: dict, got: dict):
    for layer in want:
        for k in want[layer]:
            a, b = np.asarray(want[layer][k], np.float32), got[layer][k]
            assert a.shape == b.shape, (layer, k)
            yield f"{layer}.{k}", a, b


def _close(want: dict, got: dict, limit: float = PARAM_TOL) -> None:
    for name, a, b in _pairs(want, got):
        rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
        assert rel <= limit, f"{name}: {rel:.3e}"


def _close_but_a_few(want: dict, got: dict, *, extra, frac: float) -> None:
    """Within 1e-4 max-relative except at most ``frac`` of all elements,
    which stay within ``extra(a)`` beyond it."""
    total = off = 0
    for name, a, b in _pairs(want, got):
        d = np.abs(a - b)
        base = PARAM_TOL * max(np.abs(a).max(), 1e-12)
        bad = d > base
        total += a.size
        off += int(bad.sum())
        assert (d[bad] <= base + extra(a[bad], np.abs(a).max())).all(), name
    assert off <= frac * total, (off, total)


def _bf16_step(a: np.ndarray, amax: float) -> np.ndarray:
    return 2.0**-7 * np.abs(a)


def _level(a: np.ndarray, amax: float) -> np.ndarray:
    """One q4 level of a chunk that holds ``a``: at most max|v|/7."""
    return np.full_like(a, 2.0 * amax / 7.0)


def _rows(want, got, acc="avg_test_acc",
          keys=("avg_train_loss", "avg_test_loss")) -> None:
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k in keys:
            if k in a:
                assert abs(a[k] - b[k]) <= LOSS_TOL, (k, a, b)
        assert abs(a[acc] - b[acc]) <= ACC_TOL, (a, b)


def _params(tt) -> dict:
    return params_to_jax(tt.worker_params(), input_shape=SHAPE)


GOSSIP_F32 = {
    "scatter": dict(),
    "scatter-fedlcon": dict(algorithm="fedlcon", eps=2),
    "scatter-matching": dict(algorithm="gossip"),
    "shift": dict(update_sharding="off", comm_impl="shift"),
    "scatter-shift": dict(comm_impl="shift"),
    "shift-crash": dict(update_sharding="off", comm_impl="shift",
                        faults=dict(crash=0.3)),
    "scatter-choco": dict(algorithm="choco", compression="topk",
                          compression_ratio=0.25, choco_gamma=0.2),
    "scatter-crash": dict(faults=dict(crash=0.3)),
}


@pytest.mark.parametrize("case", sorted(GOSSIP_F32))
def test_gossip_f32_paths_match_dopt(case, devices):
    kw = dict(GOSSIP_F32[case])
    faults = kw.pop("faults", None)
    jf = None if faults is None else J.FaultConfig(**faults)
    jt = JaxGossipTrainer(_gcfg(J, top={"mesh_devices": 1}, faults=jf, **kw))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    tf = None if faults is None else T.FaultConfig(**faults)
    tt = GossipTrainer(_gcfg(T, faults=tf, **kw), device="cpu",
                       init_params=init)
    assert (tt._shift_ids is not None) == ("shift" in case)
    assert tt._shift_ids == jt._shift_ids
    jt.run()
    tt.run()
    _rows(jt.history.rows, tt.history.rows)
    assert tt.history.faults == jt.history.faults
    _close(jax.device_get(jt.worker_params()), _params(tt))


CODEC_CASES = {
    "q8": dict(comm=CODEC),
    "q4-budget": dict(comm={**CODEC, "byte_budget_mb": 0.05}),
    "ef-off": dict(comm={**CODEC, "error_feedback": "off"}),
    "matching": dict(comm=CODEC, algorithm="gossip"),
    "crash": dict(comm=CODEC, faults=dict(crash=0.3)),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_matches_dopt(case, devices):
    kw = dict(CODEC_CASES[case])
    faults = kw.pop("faults", None)
    jt = JaxGossipTrainer(_gcfg(
        J, top={"mesh_devices": 1},
        faults=None if faults is None else J.FaultConfig(**faults), **kw))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    tt = GossipTrainer(_gcfg(
        T, faults=None if faults is None else T.FaultConfig(**faults), **kw),
        device="cpu", init_params=init)
    assert (dataclasses.astuple(tt.codec_plan)
            == dataclasses.astuple(jt._codec_plan))
    if case == "q4-budget":
        assert "q4" in tt.codec_plan.kinds
    tt_res0 = [r.clone() for r in tt._comm_res]
    assert all((r == 0).all() for r in tt_res0)
    jt.run()
    tt.run()
    _rows(jt.history.rows, tt.history.rows)
    _close_but_a_few(jax.device_get(jt.worker_params()), _params(tt),
                     extra=_level, frac=1e-3)
    for a, b in zip(jax.device_get(jt._comm_res), tt._comm_res):
        a, b = np.asarray(a), b.numpy()
        if case == "ef-off":
            assert not b.any()
        scale = max(np.abs(a).max(), 1e-12)
        assert (np.abs(a - b) > 1e-4 * scale).mean() <= 1e-3


@pytest.mark.parametrize("where", ["gossip", "comm"])
def test_narrowed_scatter_matches_dopt(where, devices):
    kw = (dict(comm_dtype="bfloat16") if where == "gossip"
          else dict(comm=dict(wire_dtype="bfloat16")))
    jt, tt = _gpair(**kw)
    assert tt._comm_dtype == torch.bfloat16
    jt.run()
    tt.run()
    _rows(jt.history.rows, tt.history.rows)
    _close_but_a_few(jax.device_get(jt.worker_params()), _params(tt),
                     extra=_bf16_step, frac=1e-3)


@pytest.mark.parametrize("wire", [None, "bfloat16"], ids=["f32", "bf16"])
def test_federated_scatter_matches_dopt(wire, devices):
    kw = {} if wire is None else dict(comm=dict(wire_dtype=wire))
    jt = JaxFederatedTrainer(_fcfg(J, top={"mesh_devices": 1}, **kw))
    tt = FederatedTrainer(_fcfg(T, **kw), device="cpu",
                          init_params=jax.device_get(jt._theta_single()))
    assert not tt._use_compact()
    jt.run()
    tt.run()
    _rows(jt.history.rows, tt.history.rows, acc="test_acc",
          keys=("test_loss", "train_loss", "local_loss"))
    for want, got in ((jax.device_get(jt._theta_single()),
                       tt.global_params()),
                      (jax.device_get(jt.params), tt.worker_params())):
        got = params_to_jax(got, input_shape=SHAPE)
        if wire is None:
            _close(want, got)
        else:
            _close_but_a_few(want, got, extra=_bf16_step, frac=1e-3)


def test_scatter_against_dopts_eight_device_mesh(devices):
    """dopt's default mesh (8 devices, fold 8, one worker a device)
    against the port's one rank, with dopt's own bounds after a round."""
    jt, tt = _gpair(jtop={}, users=8)
    assert jt.mesh.size == 8 and jt._scatter_spec.fold == 8
    jt.run(rounds=1)
    tt.run(rounds=1)
    for a, b in zip(jt.history.rows, tt.history.rows):
        for k in a:
            if isinstance(a[k], float):
                assert abs(a[k] - b[k]) < 5e-4, (k, a[k], b[k])
    for name, a, b in _pairs(jax.device_get(jt.worker_params()),
                             _params(tt)):
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-6, err_msg=name)


# -- the port's own promises, bit for bit ----------------------------------
def _state(tr) -> dict:
    out = {f"p.{k}": v for k, v in tr.worker_params().items()}
    moms = (tr.momentum if isinstance(tr.momentum, dict)
            else dict(zip(tr._names, tr.momentum)))
    out.update({f"m.{k}": v.detach().float().cpu().numpy()
                for k, v in moms.items()})
    for i, r in enumerate(getattr(tr, "_comm_res", [])):
        out[f"res.{i}"] = r.cpu().numpy()
    if getattr(tr, "theta", None) is not None:
        out.update({f"theta.{k}": v for k, v in tr.global_params().items()})
    return out


def _equal(a, b) -> None:
    assert a.history.rows == b.history.rows
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k


PROMISE = {
    "scatter": lambda: GossipTrainer(_gcfg(T, rounds=3), device="cpu"),
    "codec": lambda: GossipTrainer(_gcfg(T, rounds=3, comm=CODEC),
                                   device="cpu"),
    "codec-q4": lambda: GossipTrainer(_gcfg(
        T, rounds=3, comm={**CODEC, "byte_budget_mb": 0.05}), device="cpu"),
    "shift": lambda: GossipTrainer(_gcfg(T, rounds=3, comm_impl="shift"),
                                   device="cpu"),
    "federated": lambda: FederatedTrainer(
        _fcfg(T, rounds=3, comm=dict(wire_dtype="bfloat16")), device="cpu"),
}


@pytest.mark.parametrize("case", sorted(PROMISE))
def test_blocked_equals_per_round_and_repeats(case):
    a = PROMISE[case]()
    a.run(rounds=3)
    b = PROMISE[case]()
    b.run(rounds=3, block=2)
    _equal(a, b)
    c = PROMISE[case]()
    c.run(rounds=3)
    _equal(a, c)


@pytest.mark.parametrize("block", [1, 2])
def test_codec_resume_equals_continuous(block, tmp_path):
    cont = PROMISE["codec-q4"]()
    cont.run(rounds=3, block=block)
    part = PROMISE["codec-q4"]()
    part.run(rounds=1, checkpoint_every=1, checkpoint_path=tmp_path / "ck")
    assert any(r.abs().max() > 0 for r in part._comm_res)
    resumed = PROMISE["codec-q4"]()
    resumed.restore(tmp_path / "ck")
    resumed.run(rounds=2, block=block)
    _equal(cont, resumed)


def test_default_off_path_is_unchanged(monkeypatch):
    """``update_sharding="off"``, ``comm=None``, ``comm_impl="auto"``: no
    spec, plan, residual or shift set, and no new collective runs — the
    round is the dense one, equal bit for bit to ``comm_impl="dense"``."""
    import dopt_torch.engine.gossip as G

    def boom(*a, **k):
        raise AssertionError("a scatter/shift/codec function ran")

    for name in ("mix_update_scatter", "mix_shifts", "mix_codec_gather"):
        monkeypatch.setattr(G, name, boom)
    a = GossipTrainer(_gcfg(T, update_sharding="off"), device="cpu")
    assert (a.scatter_spec, a.codec_plan, a._shift_ids, a._comm_res) == (
        None, None, None, [])
    a.run()
    b = GossipTrainer(_gcfg(T, update_sharding="off", comm_impl="dense"),
                      device="cpu")
    b.run()
    _equal(a, b)
    f = FederatedTrainer(_fcfg(T, update_sharding="off"), device="cpu")
    assert f.scatter_spec is None and f._use_compact()


# -- refusals, in dopt's words ---------------------------------------------
GOSSIP_REFUSALS = {
    "comm-without-scatter": dict(update_sharding="off", comm={}),
    "two-wire-dtypes": dict(comm_dtype="bfloat16",
                            comm=dict(wire_dtype="float16")),
    "codec-fedlcon": dict(algorithm="fedlcon", comm=CODEC),
    "codec-choco": dict(algorithm="choco", comm=CODEC),
    "codec-shift": dict(comm_impl="shift", comm=CODEC),
    "bad-comm-impl": dict(comm_impl="ring"),
    "bad-update-sharding": dict(update_sharding="rows"),
    "shift-matching": dict(update_sharding="off", comm_impl="shift",
                           algorithm="gossip"),
    "scatter-nocons": dict(algorithm="nocons"),
    "scatter-robust": dict(robust=dict(clip_radius=1.0)),
    "scatter-link": dict(faults=dict(msg_drop=0.1)),
    "scatter-push-sum": dict(correction="push_sum"),
    "scatter-async": dict(mixing="async"),
    "scatter-fused": dict(fused_update="on"),
    "shift-fused": dict(update_sharding="off", comm_impl="shift",
                        fused_update="on"),
}


def _refusal_gcfg(mod, case):
    kw = dict(GOSSIP_REFUSALS[case])
    faults, robust = kw.pop("faults", None), kw.pop("robust", None)
    cfg = _gcfg(mod, **kw)
    return cfg.replace(
        faults=None if faults is None else mod.FaultConfig(**faults),
        robust=None if robust is None else mod.RobustConfig(**robust))


@pytest.mark.parametrize("case", sorted(GOSSIP_REFUSALS))
def test_gossip_refusals_in_dopts_words(case, devices):
    with pytest.raises(ValueError) as want:
        JaxGossipTrainer(_refusal_gcfg(J, case).replace(mesh_devices=1))
    with pytest.raises(ValueError) as got:
        GossipTrainer(_refusal_gcfg(T, case), device="cpu")
    assert str(got.value) == str(want.value)


FED_REFUSALS = {
    "scatter-median": dict(robust=dict(aggregator="median")),
    "scatter-staleness": dict(staleness_max=2),
    "scatter-compact": dict(compact=True),
    "comm-without-scatter": dict(update_sharding="off", comm={}),
    "codec": dict(comm=CODEC),
    "two-wire-dtypes": dict(comm_dtype="bfloat16",
                            comm=dict(wire_dtype="float16")),
    "scatter-fused": dict(fused_update="on"),
}


@pytest.mark.parametrize("case", sorted(FED_REFUSALS))
def test_federated_refusals_in_dopts_words(case, devices):
    def mk(mod):
        kw = dict(FED_REFUSALS[case])
        robust = kw.pop("robust", None)
        return _fcfg(mod, **kw).replace(
            robust=None if robust is None else mod.RobustConfig(**robust))

    with pytest.raises(ValueError) as want:
        JaxFederatedTrainer(mk(J).replace(mesh_devices=1))
    with pytest.raises(ValueError) as got:
        FederatedTrainer(mk(T), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knob", ["mesh_devices", "mesh_hosts"])
def test_more_than_one_gpu_names_the_multi_gpu_slice(knob):
    """Since the multi-GPU engines slice more than one GPU runs over the
    launched ranks (tests/test_torch_multigpu.py); without a process
    group the value names the launch it needs."""
    for cls, cfg in ((GossipTrainer, _gcfg(T)), (FederatedTrainer, _fcfg(T))):
        with pytest.raises(ValueError, match="torch.distributed.run "
                           "--nproc-per-node"):
            cls(cfg.replace(**{knob: 2}), device="cpu")


@pytest.mark.parametrize("codec", [True, False], ids=["codec", "plain"])
def test_restore_refuses_a_residual_mismatch(codec, tmp_path):
    """dopt's two refusals: a codec trainer needs ``comm_residual``, and a
    trainer without the codec refuses a checkpoint that carries one."""
    src = PROMISE["scatter" if codec else "codec"]()
    src.run(rounds=1)
    src.save(tmp_path / "ck")
    dst = PROMISE["codec" if codec else "scatter"]()
    with pytest.raises(ValueError, match="comm_residual"):
        dst.restore(tmp_path / "ck")
