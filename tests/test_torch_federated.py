"""The port's FederatedTrainer and its helpers against dopt's.

Both trainers run the same config from the same init (dopt's, carried
over with ``params_from_jax``): Model1 at 8×8 on the synthetic set,
4 clients, 128 train / 32 test, batch 16, frac 0.5, 2 rounds; dopt on a
one-device mesh with its Pallas kernels in interpret mode, the port on
the CPU (the kernels' plain versions).  Tolerances are slice 1's
(PARITY.md:90 — reordered float sums drift over dependent SGD steps
even inside dopt): train, local and test loss and train accuracy 1e-3
absolute, test accuracy 1e-4 absolute, final theta and worker params 1e-4 max-relative, client
history values 1e-3 absolute.  The helpers are held to 1e-6 (the same
f32 ops, only association may differ).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
from dopt import optim as jopt
from dopt import robust as jrobust
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt.ops import fused_mix_update as jax_fused_mix_update
from dopt.parallel import collectives as jcoll
from dopt_torch import optim as topt
from dopt_torch import robust as trobust
from dopt_torch.convert import params_to_jax
from dopt_torch.engine import FederatedTrainer
from dopt_torch.ops import fused_mix_update
from dopt_torch.parallel import collectives as tcoll

SHAPE = (8, 8, 1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, *, algorithm="fedavg", fused=False, compact=None, holdout=0.0,
         local_ep=1, weight_decay=0.0, **kw):
    return mod.ExperimentConfig(
        name="parity", seed=11,
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=32, local_holdout=holdout,
                            holdout_mode="deterministic"),
        model=mod.ModelConfig(model="model1", input_shape=SHAPE,
                              faithful=True),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, rho=0.1,
                                  weight_decay=weight_decay,
                                  fused_update=fused),
        federated=mod.FederatedConfig(
            algorithm=algorithm, frac=0.5, rounds=2, local_ep=local_ep,
            local_bs=16, compact=compact,
            fused_update="on" if fused else "off"),
        **kw)


def _close_tree(want, got, limit=1e-4):
    for layer in want:
        for k in want[layer]:
            a, b = np.asarray(want[layer][k]), got[layer][k]
            assert a.shape == b.shape
            rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
            assert rel <= limit, f"{layer}.{k}: {rel:.3e}"


@pytest.mark.parametrize("kw,path", [
    (dict(fused=True), "full"),                          # both switches on
    (dict(), "compact"),                                 # compact auto
    (dict(algorithm="fedprox", compact=False), "full"),  # full width, unfused
    (dict(algorithm="fedadmm", weight_decay=1e-3), "compact"),  # + ℓ2
    (dict(algorithm="scaffold"), "compact"),
    (dict(holdout=0.1, local_ep=2), "compact"),          # the P1 holdout
], ids=["fedavg-fused", "fedavg-compact", "fedprox-full", "fedadmm",
        "scaffold", "fedavg-holdout"])
def test_federated_matches_dopt(kw, path):
    jt = JaxFederatedTrainer(_cfg(J, mesh_devices=1, **kw))
    init = jax.device_get(jt._theta_single())
    tt = FederatedTrainer(_cfg(T, **kw), device="cpu", init_params=init)
    assert tt._use_compact() == (path == "compact")
    jh, th = jt.run(rounds=2), tt.run(rounds=2)
    assert len(jh.rows) == len(th.rows) == 2
    for a, b in zip(jh.rows, th.rows):
        assert a.keys() == b.keys()
        assert a["round"] == b["round"]
        for k in ("train_loss", "local_loss", "test_loss", "train_acc"):
            assert abs(a[k] - b[k]) <= 1e-3, (k, a, b)
        assert abs(a["test_acc"] - b["test_acc"]) <= 1e-4, (a, b)
    _close_tree(jax.device_get(jt._theta_single()),
                params_to_jax(tt.global_params(), input_shape=SHAPE))
    _close_tree(jax.device_get(jt.params),
                params_to_jax(tt.worker_params(), input_shape=SHAPE))
    jc, tc = jt.client_history.rows, tt.client_history.rows
    assert len(jc) == len(tc) == (2 * 2 * 2 if kw.get("holdout") else 0)
    for a, b in zip(jc, tc):
        assert a.keys() == b.keys()
        for k, v in a.items():
            assert abs(v - b[k]) <= 1e-3, (k, a, b)
    ev = tt.evaluate_global()
    assert abs(ev["acc"] - jt.evaluate_global()["acc"]) <= 1e-4


@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox", "fedadmm",
                                       "scaffold"])
def test_full_width_equals_compact(algorithm):
    """The two unfused paths are the same math up to float summation
    order (dopt's contract), with the holdout on."""
    runs = []
    for compact in (False, True):
        tr = FederatedTrainer(_cfg(T, algorithm=algorithm, compact=compact,
                                   holdout=0.1, local_ep=2), device="cpu")
        assert tr._use_compact() == compact
        runs.append((tr.run(rounds=2).rows, tr.client_history.rows,
                     tr.global_params(), tr.worker_params(), tr.duals))
    (ha, ca, ta, wa, da), (hb, cb, tb, wb, db) = runs
    for a, b in zip(ha + ca, hb + cb, strict=True):
        assert a.keys() == b.keys()
        for k, v in a.items():
            assert abs(v - b[k]) <= 1e-5, (k, a, b)
    for want, got in ((ta, tb), (wa, wb)) + (
            ((da, db),) if da is not None else ()):
        for k, v in want.items():
            v, g = np.asarray(v), np.asarray(got[k])
            assert np.abs(v - g).max() <= 1e-5 * max(np.abs(v).max(), 1.0)


def _trees(rng, n=3, w=5):
    """n random [W, ...] trees (flat dicts, dopt's tree form)."""
    return [{"a": rng.normal(size=(w, 3, 4)).astype(np.float32),
             "b": rng.normal(size=(w, 7)).astype(np.float32)}
            for _ in range(n)]


def _single(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}


def _tt(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _jt(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _same(want, got, tol=1e-6):
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("edit", ["prox", "admm", "dual", "scaffold_grad",
                                  "scaffold_control"])
def test_optim_edits_match_dopt(edit):
    rng = np.random.default_rng(0)
    g, p, a = _trees(rng)
    th, c = _single(rng), _single(rng)
    cases = {
        "prox": (lambda m, t: m.prox_grad_edit(t(g), t(p), t(th), 0.1)),
        "admm": (lambda m, t: m.admm_grad_edit(t(g), t(p), t(th), t(a), 0.1)),
        "dual": (lambda m, t: m.admm_dual_ascent(t(a), t(p), t(th), 0.1)),
        "scaffold_grad": (lambda m, t: m.scaffold_grad_edit(t(g), t(c),
                                                            t(a))),
        "scaffold_control": (lambda m, t: m.scaffold_control_update(
            t(a), t(c), t(th), t(p), lr=0.1, num_steps=7)),
    }
    _same(cases[edit](jopt, _jt), cases[edit](topt, _tt))


def test_screen_and_masked_means_match_dopt():
    rng = np.random.default_rng(1)
    x, y, _ = _trees(rng)
    x["a"][2, 1, 1] = np.nan
    x["b"][4, 0] = np.inf
    want = np.asarray(jrobust.finite_lane_mask(_jt(x)))
    got = trobust.finite_lane_mask(_tt(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 1, 0, 1, 0])
    for mask in (np.array([1, 0, 1, 1, 0], np.float32),
                 np.zeros(5, np.float32)):
        _same(jcoll.masked_average(_jt(y), jnp.asarray(mask)),
              tcoll.masked_average(_tt(y), torch.tensor(mask)))
        _same(jrobust.masked_mean(_jt(y), jnp.asarray(mask)),
              trobust.masked_mean(_tt(y), torch.tensor(mask)))
        wm = tcoll.mean_weight_matrix(torch.tensor(mask))
        assert wm.is_contiguous() and wm.dtype == torch.float32
        np.testing.assert_allclose(
            wm.numpy(), np.asarray(jcoll.mean_weight_matrix(mask)),
            rtol=1e-6, atol=1e-7)
        _same(jcoll.where_mask(jnp.asarray(mask), _jt(x), _jt(y)),
              tcoll.where_mask(torch.tensor(mask), _tt(x), _tt(y)), 0.0)
    assert not tcoll.mean_weight_matrix(torch.zeros(5)).any()


def test_federated_epilogue_lr_minus_one_matches_pallas():
    """θ'_b = M(mask)·disp + θ_b at n = 4 over two buckets: the port's
    flat-store epilogue (displacement store as p, slab as buf) against
    dopt's interpret-mode Pallas tree wrapper."""
    rng = np.random.default_rng(2)
    theta = _single(rng)
    slab = {k: np.broadcast_to(v, (4,) + v.shape).copy()
            for k, v in theta.items()}
    disp = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in slab.items()}
    mask = np.array([1, 0, 1, 1], np.float32)
    for v in disp.values():
        v[mask == 0] = 0.0
    jspec = jcoll.make_update_shard_spec(_jt(slab), fold=1, bucket_bytes=64)
    want = jax_fused_mix_update(_jt(disp), _jt(slab),
                                jcoll.mean_weight_matrix(mask), jspec,
                                lr=-1.0, interpret=True)
    spec = tcoll.make_update_shard_spec(_tt(slab), bucket_bytes=64)
    assert spec.num_buckets == jspec.num_buckets == 2
    fd, fs = tcoll.alloc_flat(4, spec), tcoll.alloc_flat(4, spec)
    for store, src in ((fd, disp), (fs, slab)):
        for k, v in tcoll.flat_views(store, spec).items():
            v.copy_(torch.as_tensor(src[k]))
    fused_mix_update(fd, fs, tcoll.mean_weight_matrix(torch.tensor(mask)),
                     spec, lr=-1.0)
    got = tcoll.flat_views(fd, spec)
    _same(want, {k: v.numpy() for k, v in got.items()})
    for k, v in got.items():   # every row is the new theta
        np.testing.assert_array_equal(v.numpy(), np.broadcast_to(
            v[0].numpy(), v.shape))


def _fed(cfg, **kw):
    return cfg.replace(federated=dataclasses.replace(cfg.federated, **kw))


def _opt(cfg, **kw):
    return cfg.replace(optim=dataclasses.replace(cfg.optim, **kw))


@pytest.mark.parametrize("edit,match", [
    (lambda c: _fed(c, staleness_max=2, compact=True).replace(
        faults=T.FaultConfig(msg_delay=0.2, msg_delay_max=2)),
     "incompatible with staleness-aware aggregation"),
    # Lifted by the scatter slice: the scatter reduce now runs, and
    # cfg.comm takes a CommConfig (match None).
    pytest.param(lambda c: _fed(c, update_sharding="scatter"), None,
                 id="<lambda>-'scatter and multi-GPU'"),
    # Lifted by the codecs slice: the narrowed wire now runs (match None).
    pytest.param(lambda c: _fed(c, comm_dtype="bfloat16"), None,
                 id="<lambda>-'codecs'0"),
    # Lifted by the telemetry slice: the option now runs (match None).
    pytest.param(lambda c: _fed(c, diagnostics="on"), None,
                 id="<lambda>-'telemetry'"),
    (lambda c: c.replace(model=dataclasses.replace(
        c.model, param_dtype="float16")), "unknown model.param_dtype"),
    (lambda c: c.replace(data=dataclasses.replace(
        c.data, plan_impl="rust")), "unknown plan_impl 'rust'"),
    # Lifted by the ResNet-18 slice: the model now runs (match None).
    pytest.param(lambda c: c.replace(model=dataclasses.replace(
        c.model, model="resnet18")), None, id="<lambda>-'ResNet-18'"),
    (lambda c: c.replace(faults=object()), "cfg.faults must be"),
    (lambda c: c.replace(robust=object()), "cfg.robust must be"),
    # The population slice runs PopulationConfig; another object is
    # refused by its type (the ids keep the old match strings).
    pytest.param(lambda c: c.replace(faults=T.FaultConfig(crash=0.1),
                                     population=object()),
                 "cfg.population must be a dopt_torch.config."
                 "PopulationConfig", id="<lambda>-'population' slice"),
    (lambda c: _fed(c, fused_update="on").replace(
        robust=T.RobustConfig(aggregator="median")),
     "only applies to the masked-mean"),
    pytest.param(lambda c: c.replace(population=object()),
                 "cfg.population must be a dopt_torch.config."
                 "PopulationConfig", id="<lambda>-'population'"),
    pytest.param(lambda c: c.replace(comm=object()),
                 "cfg.comm must be a dopt_torch.config.CommConfig",
                 id="<lambda>-'codecs'1"),
    (lambda c: _fed(c, algorithm="scaffold", fused_update="on"),
     "companion state"),
    (lambda c: _fed(c, fused_update="on", compact=True), "incompatible"),
    (lambda c: _fed(c, algorithm="fedsgd"), "unknown federated algorithm"),
    (lambda c: c.replace(federated=None), "cfg.federated must be set"),
])
def test_unsupported_configs_raise(edit, match):
    cfg = edit(_cfg(T))
    if match is None:
        assert len(FederatedTrainer(cfg, device="cpu").run(rounds=1).rows) == 1
        return
    with pytest.raises(ValueError, match=match):
        FederatedTrainer(cfg, device="cpu")


def test_no_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(_cfg(T))


def test_all_screened_round_keeps_theta():
    """A round whose every sampled lane goes non-finite keeps theta and
    the screened lanes' state, on both the full-width and fused paths."""
    for fused in (False, True):
        tr = FederatedTrainer(_cfg(T, fused=fused, compact=False,
                                   algorithm="fedprox"), device="cpu")
        before = tr.global_params()
        tr.cfg = _opt(tr.cfg, lr=float("nan"))
        tr.run(rounds=1)
        for k, v in tr.global_params().items():
            np.testing.assert_array_equal(v, before[k])
        row = tr.history.rows[-1]
        assert row["local_loss"] == 0.0 and np.isfinite(row["test_loss"])
        assert all(np.isfinite(v).all() for v in tr.worker_params().values())


def test_run_cli_federated_on_cpu(capsys):
    import json

    from dopt_torch.run import main

    # The rounds come from federated.rounds; the preset runs fused.
    assert main(["--preset", "headline-fedavg-model1", "--device", "cpu",
                 "--set", "data.num_users=2", "--set",
                 "data.synthetic_train_size=40", "--set",
                 "data.synthetic_test_size=8", "--set",
                 "federated.local_ep=1", "--set", "federated.local_bs=20",
                 "--set", "federated.rounds=1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["round"] == 0 and set(row) == {
        "round", "test_acc", "test_loss", "train_loss", "train_acc",
        "local_loss"}
