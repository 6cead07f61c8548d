"""The port's sequential reference oracle (``backend="torch"``) and
``stacked_impl="vmap"``, against dopt.

* The torch twins and the layout converters of
  ``dopt_torch.engine.oracle`` against dopt's ``dopt.engine.oracle`` on
  the same numpy-seeded inputs: the forward, ``local_update`` for sgd,
  fedprox, fedadmm and scaffold, the ADMM dual, SCAFFOLD's controls and
  consensus — bit for bit, since the same torch ops run in the same
  order on the same tensors.
* ``backend="torch"`` runs of the port against dopt's on tiny configs,
  from dopt's flax init: History (and client History) and params bit
  for bit, for the same reason.
* The port's oracle against the port's stacked engine, from one init,
  at dopt's bars for its engine against this oracle
  (tests/test_torch_backend.py): gossip test accuracy 1e-4, train loss
  1e-3 and params 1e-4 max-relative; federated test accuracy 1e-3,
  local loss 2e-3 and theta 5e-4 max-relative.
* The refusals in dopt's words, ``build_trainer``'s routing and the CLI
  through ``--set backend=torch``.
* ``stacked_impl="vmap"`` against dopt's vmapped ``model.apply`` and
  against the port's ``"auto"``: one step each, every gradient and
  updated tensor within 1e-5 relative L2, for Model1, the MLP and a
  tiny ResNet-18.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dopt
import dopt.engine.oracle as JO
import dopt.engine.torch_backend as JB
import dopt_torch
import dopt_torch.engine.oracle as TO
from dopt.models import build_model
from dopt_torch.convert import params_from_jax
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.engine.torch_backend import (OracleFederatedTrainer,
                                             OracleGossipTrainer,
                                             build_torch_trainer)
from dopt_torch.run import build_trainer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test (the suite runs in several processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_init(model: str, shape, seed: int, num_classes: int = 10,
               faithful: bool = True) -> dict:
    """dopt's init of one worker (the oracle's: ``init`` at ``key(seed)``)
    as numpy leaves."""
    m = build_model(model, num_classes=num_classes, faithful=faithful)
    p = m.init(jax.random.key(seed), jnp.zeros((1, *shape)))["params"]
    return jax.tree.map(np.asarray, jax.device_get(p))


def _twins(name: str, shape, faithful: bool, tree: dict):
    """dopt's twin and the port's, loaded with the same weights (dopt's
    through its converter, the port's through ``params_from_jax``)."""
    ncls = 2 if name == "logistic" else 10
    flat = int(np.prod(shape))
    if name in ("model1", "model3"):
        hidden = 512 if name == "model1" else 256
        args = (shape[-1], shape[0], hidden)
        kw = {"num_classes": ncls, "faithful": faithful}
        j, t = JO.torch_reference_cnn(*args, **kw), \
            TO.torch_reference_cnn(*args, **kw)
        j.load_state_dict(JO.flax_cnn_params_to_torch(tree, shape[0]))
    else:
        fn = "torch_mlp" if name == "mlp" else "torch_logistic"
        kw = {"num_classes": ncls, "faithful": faithful}
        j, t = getattr(JO, fn)(flat, **kw), getattr(TO, fn)(flat, **kw)
        j.load_state_dict(JO.flax_dense_params_to_torch(tree))
    t.load_state_dict(TO.port_to_twin(params_from_jax(tree,
                                                      input_shape=shape)))
    return j, t


MODELS = [("model1", (12, 12, 1), True), ("model3", (12, 12, 3), False),
          ("mlp", (8, 8, 1), False), ("logistic", (123,), True)]


@pytest.mark.parametrize("name,shape,faithful", MODELS,
                         ids=[m[0] for m in MODELS])
def test_twins_and_converters_match_dopts(name, shape, faithful):
    """The port's converters give dopt's state dict (the CNN's fc1 rows
    in the reference's CHW order), ``port_to_twin`` of the port's own
    layout gives the same, the inverse converters round-trip, and the
    twins' forwards are dopt's bit for bit."""
    tree = _flax_init(name, shape, 3, num_classes=2 if name == "logistic"
                      else 10, faithful=faithful)
    j, t = _twins(name, shape, faithful, tree)
    if name in ("model1", "model3"):
        mine = TO.flax_cnn_params_to_torch(tree, shape[0])
        back = TO.torch_cnn_params_to_flax(mine, shape[0])
        want = JO.torch_cnn_params_to_flax(mine, shape[0])
    else:
        mine = TO.flax_dense_params_to_torch(tree)
        back = TO.torch_dense_params_to_flax(mine)
        want = JO.torch_dense_params_to_flax(mine)
    for k, v in j.state_dict().items():
        assert torch.equal(mine[k], v) and torch.equal(t.state_dict()[k], v)
    for layer in tree:
        for leaf in tree[layer]:
            assert np.array_equal(back[layer][leaf], tree[layer][leaf])
            assert np.array_equal(want[layer][leaf], tree[layer][leaf])
    x = np.random.default_rng(0).normal(size=(5, *shape)).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(
        TO.nhwc_to_nchw(x) if len(shape) == 3 else x))
    with torch.no_grad():
        assert torch.equal(t(xt), j(xt))


def test_twin_init_is_explicit():
    """A twin draws from the generator it is given (flax's LeCun-normal
    weights, zero biases) and reads no global RNG; without one it is
    zero until a state is loaded."""
    torch.manual_seed(0)
    a = TO.torch_mlp(16, generator=torch.Generator().manual_seed(7))
    torch.manual_seed(1)
    b = TO.torch_mlp(16, generator=torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb)
        assert (va.abs().sum() > 0) == k.endswith("weight")
    assert all(not v.any() for v in TO.torch_logistic(8).state_dict()
               .values())


def _batches(shape, steps, bs, seed, classes=10):
    rng = np.random.default_rng(seed)
    bx = rng.normal(size=(steps, bs, *shape)).astype(np.float32)
    by = rng.integers(0, classes, size=(steps, bs)).astype(np.int32)
    bw = np.ones((steps, bs), np.float32)
    bw[-1, bs // 2:] = 0.0                 # a padded last batch
    return TO.nhwc_to_nchw(bx), by, bw


@pytest.mark.parametrize("algorithm", ["sgd", "fedprox", "fedadmm",
                                       "scaffold"])
def test_local_update_duals_controls_match_dopts(algorithm):
    """Two epochs of ``local_update`` (and ``local_update_epochs`` with a
    local-val stack), then the ADMM dual or SCAFFOLD's control refresh,
    on dopt's worker and the port's from one state: the losses, the rows
    and every tensor bit for bit."""
    shape = (12, 12, 1)
    tree = _flax_init("model1", shape, 5)
    j, t = _twins("model1", shape, True, tree)
    kw = dict(lr=0.05, momentum=0.5, rho=0.3, algorithm=algorithm, l2=1e-4)
    wj, wt = JO.OracleWorker(j, **kw), TO.OracleWorker(t, **kw)
    theta = {k: v.clone() + 0.01 for k, v in j.state_dict().items()}
    c = ({k: torch.full_like(v, 1e-3) for k, v in theta.items()}
         if algorithm == "scaffold" else None)
    bx, by, bw = _batches(shape, 4, 8, 1)
    vx, vy, vw = _batches(shape, 2, 8, 2)
    for w in (wj, wt):
        w.out = [w.local_update(bx, by, bw, theta=theta, c_global=c),
                 w.local_update_epochs(bx.reshape(2, 2, *bx.shape[1:]),
                                       by.reshape(2, 2, 8),
                                       bw.reshape(2, 2, 8), vx, vy, vw,
                                       theta=theta, c_global=c,
                                       val_flavor="sum"),
                 w.inference(vx, vy, vw)]
        if algorithm == "fedadmm":
            w.update_duals(theta)
            w.out.append(w.alpha)
        elif algorithm == "scaffold":
            w.out.append(w.update_controls(theta, c, 0.1, 4))
            w.out.append(w.control)
    assert wj.out[:3] == wt.out[:3]
    for dj, dt in zip(wj.out[3:], wt.out[3:]):
        assert all(torch.equal(dj[k], dt[k]) for k in dj)
    for (k, a), b in zip(wj.state().items(), wt.state().values()):
        assert torch.equal(a, b), k
    if algorithm == "scaffold":
        with pytest.raises(ValueError, match="requires c_global") as e:
            wt.local_update(bx, by, bw)
        with pytest.raises(ValueError) as ej:
            wj.local_update(bx, by, bw)
        assert str(e.value) == str(ej.value)


def test_consensus_matches_dopts():
    rng = np.random.default_rng(4)
    states = [{"a": torch.from_numpy(rng.normal(size=(3, 4))
                                     .astype(np.float32)),
               "b": torch.from_numpy(rng.normal(size=5).astype(np.float32))}
              for _ in range(3)]
    pairs = [(1 / 3, s) for s in states]
    got, want = TO.consensus(pairs), JO.consensus(pairs)
    assert all(torch.equal(got[k], want[k]) for k in want)


# -- backend="torch" trajectories against dopt's -------------------------
def _gossip(mod, backend="torch", algorithm="dsgd", holdout=0.0,
            model="mlp", **gkw):
    g = dict(algorithm=algorithm, topology="circle", mode="uniform",
             rounds=2, local_ep=1, local_bs=32)
    g.update(gkw)
    return mod.ExperimentConfig(
        name="tb", seed=11, backend=backend,
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                            shards=2, synthetic_train_size=256,
                            synthetic_test_size=64, local_holdout=holdout,
                            holdout_mode="random"),
        model=mod.ModelConfig(model=model, faithful=model != "mlp",
                              input_shape=(28, 28, 1)),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5),
        gossip=mod.GossipConfig(**g))


def _fed(mod, backend="torch", algorithm="fedavg", holdout=0.0, frac=0.5):
    return mod.ExperimentConfig(
        name="tb", seed=11, backend=backend,
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=True,
                            synthetic_train_size=256,
                            synthetic_test_size=64, local_holdout=holdout),
        model=mod.ModelConfig(model="mlp", faithful=False),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, rho=0.2),
        federated=mod.FederatedConfig(algorithm=algorithm, frac=frac,
                                      rounds=2, local_ep=2, local_bs=32))


def _same_run(jt, tt) -> None:
    assert jt.history.rows == tt.history.rows
    assert jt.client_history.rows == tt.client_history.rows
    pj, pt = jt.params_as_flax(), tt.params_as_flax()
    for layer in pj:
        for k in pj[layer]:
            assert np.array_equal(np.asarray(pj[layer][k]), pt[layer][k])


GOSSIP_RUNS = [("dsgd", {}, "mlp"), ("dsgd", {"holdout": 0.1, "local_ep": 2},
                                     "mlp"),
               ("nocons", {}, "mlp"), ("centralized", {}, "mlp"),
               ("fedlcon", {"eps": 2}, "mlp"), ("dsgd", {}, "model1")]


@pytest.mark.parametrize("algorithm,kw,model", GOSSIP_RUNS,
                         ids=["dsgd", "dsgd-holdout", "nocons",
                              "centralized", "fedlcon", "dsgd-model1"])
def test_gossip_oracle_matches_dopts_bit_for_bit(algorithm, kw, model):
    jt = JB.build_torch_trainer(_gossip(dopt, algorithm=algorithm,
                                        model=model, **kw))
    init = _flax_init(model, (28, 28, 1), 11, faithful=model != "mlp")
    tt = build_torch_trainer(_gossip(dopt_torch, algorithm=algorithm,
                                     model=model, **kw),
                             device="cpu", init_params=init)
    assert type(tt) is OracleGossipTrainer
    jt.run(), tt.run()
    _same_run(jt, tt)
    assert tt.num_workers == (1 if algorithm == "centralized" else 4)
    ej, et = jt.evaluate(), tt.evaluate()
    assert all(np.array_equal(ej[k], et[k]) for k in ej)


@pytest.mark.parametrize("algorithm,holdout", [
    ("fedavg", 0.0), ("fedprox", 0.0), ("fedadmm", 0.0), ("scaffold", 0.0),
    ("fedavg", 0.1)], ids=["fedavg", "fedprox", "fedadmm", "scaffold",
                           "fedavg-holdout"])
def test_federated_oracle_matches_dopts_bit_for_bit(algorithm, holdout):
    jt = JB.build_torch_trainer(_fed(dopt, algorithm=algorithm,
                                     holdout=holdout))
    init = _flax_init("mlp", (28, 28, 1), 11, faithful=False)
    tt = build_torch_trainer(_fed(dopt_torch, algorithm=algorithm,
                                  holdout=holdout),
                             device="cpu", init_params=init)
    assert type(tt) is OracleFederatedTrainer
    jt.run(), tt.run()
    _same_run(jt, tt)
    tj, tp = jt.theta_as_flax(), tt.theta_as_flax()
    assert all(np.array_equal(tj[l][k], tp[l][k]) for l in tj for k in tj[l])
    assert jt.evaluate_global() == tt.evaluate_global()


# -- the oracle against the port's stacked engine ------------------------
def _max_rel(want: dict, got: dict) -> float:
    return max(float(np.abs(got[k] - v).max() / max(np.abs(v).max(), 1e-9))
               for k, v in want.items())


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_gossip_oracle_matches_stacked_engine(fused):
    """dsgd from the port's own init (no ``init_params``: both draw it
    from the seed): 3 rounds with both fused switches off; 1 round with
    both on (the fused epilogue is the D-PSGD ordering, a documented
    variant of the default trajectory from round 1 on; its round 0 mixes
    and trains what the oracle's does)."""
    cfg = _gossip(dopt_torch, rounds=1 if fused else 3)
    oracle = build_trainer(cfg, device="cpu")
    stacked = GossipTrainer(cfg.replace(
        optim=dataclasses.replace(cfg.optim, fused_update=fused),
        gossip=dataclasses.replace(cfg.gossip,
                                   fused_update="on" if fused else "off")),
        device="cpu")
    for a, b in zip(oracle.run().rows, stacked.run().rows):
        assert abs(a["avg_test_acc"] - b["avg_test_acc"]) <= 1e-4
        assert abs(a["avg_train_loss"] - b["avg_train_loss"]) <= 1e-3
    assert _max_rel(oracle.worker_params(), stacked.worker_params()) < 1e-4


@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox", "fedadmm",
                                       "scaffold"])
def test_federated_oracle_matches_stacked_engine(algorithm):
    cfg = _fed(dopt_torch, algorithm=algorithm)
    oracle = build_trainer(cfg, device="cpu")
    stacked = FederatedTrainer(cfg, device="cpu")
    for a, b in zip(oracle.run().rows, stacked.run().rows):
        assert abs(a["test_acc"] - b["test_acc"]) <= 1e-3
        assert abs(a["local_loss"] - b["local_loss"]) <= 2e-3
    assert _max_rel(oracle.global_params(), stacked.global_params()) < 5e-4


# -- refusals, routing and the CLI ---------------------------------------
def _err(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_in_dopts_words(tmp_path):
    from dopt.run import build_trainer as jbuild

    def both(change, call=None):
        jc, tc = change(_gossip(dopt)), change(_gossip(dopt_torch))
        jf = (lambda: call(jbuild(jc))) if call else (lambda: jbuild(jc))
        tf = ((lambda: call(build_trainer(tc, device="cpu"))) if call
              else (lambda: build_trainer(tc, device="cpu")))
        return _err(jf), _err(tf)

    cases = {
        "algorithm": lambda c: c.replace(gossip=dataclasses.replace(
            c.gossip, algorithm="choco")),
        "dropout": lambda c: c.replace(gossip=dataclasses.replace(
            c.gossip, dropout=0.5)),
        "backend": lambda c: c.replace(backend="tensorflow"),
        "resnet": lambda c: c.replace(model=dataclasses.replace(
            c.model, model="resnet18")),
        "channels": lambda c: c.replace(model=dataclasses.replace(
            c.model, input_shape=(8, 8, 3))),
        "optimizer": lambda c: c.replace(optim=dataclasses.replace(
            c.optim, optimizer="adam")),
    }
    for name, change in cases.items():
        j, t = both(change)
        assert j == t, name
    j, t = both(lambda c: c, call=lambda tr: tr.save(tmp_path / "x"))
    assert j == t and "checkpoint" in t
    j, t = both(lambda c: c.replace(gossip=dataclasses.replace(
        c.gossip, algorithm="fedlcon", eps=2)),
        call=lambda tr: tr.run(rounds=1, eps=5))
    assert j == t and "GossipConfig" in t
    assert _err(lambda: JB.build_torch_trainer(dopt.ExperimentConfig(
        backend="torch", seqlm=dopt.SeqLMConfig()))) == _err(
        lambda: build_trainer(dopt_torch.ExperimentConfig(
            backend="torch", seqlm=dopt_torch.SeqLMConfig()), device="cpu"))
    f = _fed(dopt_torch)
    assert _err(lambda: build_trainer(f.replace(federated=dataclasses.replace(
        f.federated, algorithm="fedsgd")), device="cpu")) == _err(
        lambda: jbuild(_fed(dopt).replace(federated=dataclasses.replace(
            _fed(dopt).federated, algorithm="fedsgd"))))


def test_build_trainer_routes_backend_and_engines_accept_it():
    """``backend="torch"`` builds the oracle on the device asked for — the
    GPU when none is named, which raises on a machine without one — and
    the stacked engines take a config with either backend, as dopt's
    (they run themselves whatever it says)."""
    cfg = _gossip(dopt_torch)
    if torch.cuda.is_available():
        assert build_trainer(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_trainer(cfg)
    assert type(build_trainer(_fed(dopt_torch), device="cpu")) is \
        OracleFederatedTrainer
    for backend in ("jax", "torch"):
        assert GossipTrainer(_gossip(dopt_torch, backend=backend),
                             device="cpu").cfg.backend == backend
        FederatedTrainer(_fed(dopt_torch, backend=backend), device="cpu")
    for cls, cfg in ((GossipTrainer, _gossip(dopt_torch, backend="mxnet")),
                     (FederatedTrainer, _fed(dopt_torch, backend="mxnet"))):
        assert "unknown backend 'mxnet'" in _err(lambda: cls(cfg,
                                                             device="cpu"))


def test_cli_backend_torch(tmp_path, capsys):
    """dopt's CLI case (tests/test_torch_backend.py): ``--set
    backend=torch`` on baseline1 trains two rounds and writes the CSV;
    the oracle's CLI refusals are dopt's."""
    from dopt.run import main as jmain
    from dopt_torch.run import main

    assert main(["--preset", "baseline1", "--rounds", "2", "--device", "cpu",
                 "--synthetic-scale", "0.02", "--set", "backend=torch",
                 "--set", "gossip.local_ep=1",
                 "--csv", str(tmp_path / "h.csv")]) == 0
    assert (tmp_path / "h.csv").exists()
    out = capsys.readouterr()
    assert '"round": 1' in out.out and "OracleGossipTrainer" in out.err
    for extra in (["--faults", "crash=0.1"], ["--clients", "50"],
                  ["--metrics-out", str(tmp_path / "m.jsonl")],
                  ["--checkpoint", str(tmp_path / "c"),
                   "--checkpoint-every", "1"]):
        args = ["--preset", "baseline1", "--rounds", "1", "--synthetic-scale",
                "0.02", "--set", "backend=torch", *extra]
        with pytest.raises(SystemExit) as te:
            main([*args, "--device", "cpu"])
        with pytest.raises(SystemExit) as je:
            jmain(args)
        assert str(te.value) == str(je.value), extra


# -- stacked_impl="vmap" -------------------------------------------------
VMAP_MODELS = [("model1", (12, 12, 1), {}, True),
               ("mlp", (8, 8, 1), {}, False),
               ("resnet18", (8, 8, 3), {"stage_sizes": (1, 1)}, False)]


@pytest.mark.parametrize("name,shape,kw,faithful", VMAP_MODELS,
                         ids=[m[0] for m in VMAP_MODELS])
def test_vmap_step_matches_dopts_vmap_and_auto(name, shape, kw, faithful):
    """One SGD step of 3 workers from dopt's init with
    ``stacked_impl="vmap"``: its gradients against dopt's
    ``jax.vmap(model.apply)`` gradients and against the port's ``"auto"``
    step, every tensor within 1e-5 relative L2."""
    from dopt_torch.engine.local import stacked_step
    from dopt_torch.models import zoo

    w, b, lr = 3, 8, 0.05
    jm = build_model(name, faithful=faithful, **kw)
    p = jm.init(jax.random.key(2), jnp.zeros((1, *shape)))["params"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(w, b, *shape)).astype(np.float32)
    y = rng.integers(0, 10, size=(w, b)).astype(np.int32)
    stacked = jax.tree.map(lambda a: jnp.stack([a] * w), p)

    def loss(ps):
        out = jax.vmap(lambda q, xi: jm.apply({"params": q}, xi))(
            ps, jnp.asarray(x))
        logp = jax.nn.log_softmax(out, -1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(y)[..., None], -1)
        return nll[..., 0].mean(1).sum()

    jg = params_from_jax(jax.tree.map(np.asarray,
                                      jax.grad(loss)(stacked)),
                         input_shape=shape)
    p0 = params_from_jax(jax.tree.map(np.asarray, p), input_shape=shape)
    got = {}
    for impl in ("vmap", "auto"):
        params = {k: torch.from_numpy(np.stack([v] * w)).requires_grad_()
                  for k, v in p0.items()}
        moms = {k: torch.zeros_like(v) for k, v in params.items()}
        with zoo.full_f32(torch.device("cpu")):
            stacked_step(lambda z: zoo.stacked_forward(
                name, params, z, faithful=faithful, impl=impl), params,
                moms, torch.from_numpy(x), torch.from_numpy(y).long(),
                torch.ones(w, b), lr=lr, momentum=0.5, fused=False)
        got[impl] = {**{f"grad {k}": m.numpy() for k, m in moms.items()},
                     **{f"param {k}": v.detach().numpy()
                        for k, v in params.items()}}

    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)

    for k, g in jg.items():
        assert rel(g, got["vmap"][f"grad {k}"]) <= 1e-5, k
        assert rel(np.stack([p0[k]] * w) - lr * g,
                   got["vmap"][f"param {k}"]) <= 1e-5, k
    for k, v in got["auto"].items():
        assert rel(v, got["vmap"][k]) <= 1e-5, k


@pytest.mark.parametrize("engine", ["gossip", "federated"])
def test_engines_run_vmap_and_refuse_other_impls_in_dopts_words(engine):
    """Both engines accept ``stacked_impl="vmap"`` and run one round of
    it equal to ``"auto"``'s; any other value is refused as dopt's
    ``resolve_stacked_apply`` refuses it."""
    from dopt.models.zoo import resolve_stacked_apply

    mod_cfg = (lambda m: _gossip(m, backend="jax", model="model1")
               if engine == "gossip" else _fed(m, backend="jax"))
    cls = GossipTrainer if engine == "gossip" else FederatedTrainer
    base = mod_cfg(dopt_torch)

    def with_impl(impl):
        return base.replace(model=dataclasses.replace(base.model,
                                                      stacked_impl=impl))

    runs = {}
    for impl in ("vmap", "auto"):
        tr = cls(with_impl(impl), device="cpu")
        runs[impl] = (tr.run(rounds=1).rows, tr.worker_params())
    assert runs["vmap"][0] == runs["auto"][0]
    for k, v in runs["auto"][1].items():
        assert np.linalg.norm(v - runs["vmap"][1][k]) <= \
            1e-5 * np.linalg.norm(v)
    want = _err(lambda: resolve_stacked_apply(None, "pmap"))
    assert _err(lambda: cls(with_impl("pmap"), device="cpu")) == want


def test_rounded_linear_is_the_f64_sum_rounded_once(monkeypatch):
    """The card's f32 training hidden layer of the MLP
    (``_RoundedLinear``, run here on CPU tensors): its output is the f64
    ``baddbmm`` rounded once, bit for bit, vmapped too; its gradients
    are the library's within 1e-6 relative L2; and the engines' MLP step
    with its two hidden layers routed through it lands within 1e-5 of
    the library step."""
    from dopt_torch.engine.local import stacked_step
    from dopt_torch.models import zoo

    gen = torch.Generator().manual_seed(8)
    b, w, z = (torch.randn(3, 5, generator=gen),
               torch.randn(3, 5, 7, generator=gen),
               torch.randn(3, 7, 4, generator=gen))
    g = torch.randn(3, 5, 4, generator=gen)
    args = [t.clone().requires_grad_() for t in (b, w, z)]
    out = zoo._RoundedLinear.apply(*args)
    want = torch.baddbmm(b.double().unsqueeze(2), w.double(), z.double())
    torch.testing.assert_close(out, want.float(), rtol=0, atol=0)
    assert torch.equal(torch.func.vmap(zoo._RoundedLinear.apply)(
        b[:, None], w[:, None], z[:, None])[:, 0], out.detach())
    lib = [t.clone().requires_grad_() for t in (b, w, z)]
    ref = torch.autograd.grad(
        (torch.baddbmm(lib[0].unsqueeze(2), lib[1], lib[2]) * g).sum(), lib)
    for got, exp in zip(torch.autograd.grad((out * g).sum(), args), ref):
        assert (got - exp).norm() <= 1e-6 * exp.norm()

    calls = []

    def rounded(zt, weight, bias, dtype):   # the CUDA arm
        calls.append(weight.shape)
        return torch.relu(zoo._RoundedLinear.apply(bias.to(dtype),
                                                   weight.to(dtype), zt))

    p0 = zoo.init_worker_params("mlp", generator=torch.Generator()
                                .manual_seed(5))
    x = torch.rand(4, 16, 28, 28, 1, generator=gen)
    y = torch.randint(0, 10, (4, 16), generator=gen)
    got = {}
    for arm in ("library", "rounded"):
        if arm == "rounded":
            monkeypatch.setattr(zoo, "_mlp_hidden", rounded)
        params = {k: v.expand(4, *v.shape).clone().requires_grad_()
                  for k, v in p0.items()}
        moms = {k: torch.zeros_like(v) for k, v in params.items()}
        stacked_step(lambda q: zoo.stacked_forward("mlp", params, q,
                                                   faithful=False),
                     params, moms, x, y, torch.ones(4, 16), lr=0.05,
                     momentum=0.5, fused=False)
        got[arm] = {**{f"p {k}": v.detach() for k, v in params.items()},
                    **{f"g {k}": v for k, v in moms.items()}}
    assert calls == [(4, 200, 784), (4, 200, 200)]   # the hidden layers
    for k, v in got["library"].items():
        assert (got["rounded"][k] - v).norm() <= 1e-5 * v.norm(), k
