"""The dense models and the FMNIST/CIFAR/a9a loaders, against dopt.

Datasets: every array of the synthetic fallback and of raw files
written here (IDX, CIFAR pickles, LIBSVM text) bit for bit dopt's —
value, dtype and shape.  Models: the MLP and the logistic model's
forward and gradients against dopt's flax modules, one worker and a
fleet, in f32 within 1e-5 relative and in bf16 within a quarter of
dopt's own bf16-vs-f32 distance (relative L2, as
tests/test_torch_bf16.py holds the CNN).  Trainers: 2 rounds of the
``baseline1``, ``baseline4`` and ``baseline2`` shapes from dopt's init
(dopt's Pallas kernels in interpret mode, the port's through their
plain versions), within slice 1's limits: train loss 1e-3, test
accuracy 1e-4, final params 1e-4 max-relative.
"""

import gzip
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
from dopt.data import datasets as jds
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt.models import losses as jlosses
from dopt.models.zoo import build_model
from dopt_torch.convert import params_from_jax, params_to_jax
from dopt_torch.data import datasets as tds
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.models import (LAYERS, StackedModel, cross_entropy_stacked,
                               full_f32, param_shapes, stacked_forward)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_dataset(want, got):
    assert got.name == want.name
    for f in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(want, f), getattr(got, f)
        assert b.dtype == a.dtype and b.shape == a.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


# -- datasets ---------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [("fmnist", (28, 28, 1)),
                                        ("cifar10", (32, 32, 3)),
                                        ("cifar", (32, 32, 3)),
                                        ("cifar100", (32, 32, 3)),
                                        ("a9a", (123,))])
def test_synthetic_fallback_bit_identical(name, shape):
    kw = dict(train_size=120, test_size=30, seed=5)
    want, got = jds.load_dataset(name, **kw), tds.load_dataset(name, **kw)
    _same_dataset(want, got)
    assert got.input_shape == shape
    assert got.num_classes == want.num_classes


def _write_idx(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if path.suffix == ".gz" else open)(path, "wb") as f:
        f.write(head + arr.tobytes())


def test_raw_fashion_beside_digits(tmp_path_factory):
    """A ``fashion/`` IDX pair beside an ``mnist/`` one (the same file
    names): fmnist takes the fashion files with its (0.5, 0.5)
    normalisation, mnist the others, in both packages.  The data root
    comes from ``tmp_path_factory``: dopt's avoid rule reads the whole
    path, so a root whose own name mentions "fmnist" or "fashion" (as
    ``tmp_path`` under a test named so would) hides the MNIST files."""
    tmp_path = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(3)
    for folder in ("mnist", "fashion"):
        for stem, n in (("train", 30), ("t10k", 10)):
            _write_idx(tmp_path / folder / f"{stem}-images-idx3-ubyte.gz",
                       rng.integers(0, 256, (n, 28, 28)).astype(np.uint8))
            _write_idx(tmp_path / folder / f"{stem}-labels-idx1-ubyte",
                       rng.integers(0, 10, n).astype(np.uint8))
    for name in ("fmnist", "mnist"):
        want = jds.load_dataset(name, data_dir=tmp_path)
        got = tds.load_dataset(name, data_dir=tmp_path)
        _same_dataset(want, got)
        assert got.name == name and got.train_x.shape == (30, 28, 28, 1)
    f, m = (tds.load_dataset(n, data_dir=tmp_path) for n in ("fmnist", "mnist"))
    assert not np.array_equal(f.train_y, m.train_y)


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_raw_cifar_pickles(name, tmp_path):
    rng = np.random.default_rng(4)
    folder = tmp_path / ("cifar-10-batches-py" if name == "cifar10"
                         else "cifar-100-python")
    folder.mkdir()
    key = b"labels" if name == "cifar10" else b"fine_labels"
    files = ([f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
             if name == "cifar10" else ["train", "test"])
    for fname in files:
        n = 6
        with open(folder / fname, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072)).astype(
                np.uint8), key: rng.integers(0, 10, n).tolist()}, f)
    want = jds.load_dataset(name, data_dir=tmp_path)
    got = tds.load_dataset(name, data_dir=tmp_path)
    _same_dataset(want, got)
    assert got.name == name and got.train_x.shape[1:] == (32, 32, 3)


@pytest.mark.parametrize("with_test", [False, True])
def test_raw_a9a_libsvm(with_test, tmp_path):
    """LIBSVM text with and without ``a9a.t`` (then dopt's seeded 80/20
    cut of the shuffled rows)."""
    rng = np.random.default_rng(6)

    def write(path, n):
        lines = []
        for _ in range(n):
            feats = sorted(rng.choice(123, 14, replace=False) + 1)
            lines.append(" ".join([rng.choice(["-1", "+1"])]
                                  + [f"{j}:1" for j in feats]))
        path.write_text("\n".join(lines) + "\n\n")

    write(tmp_path / "a9a", 25)
    if with_test:
        write(tmp_path / "a9a.t", 9)
    want = jds.load_dataset("a9a", data_dir=tmp_path)
    got = tds.load_dataset("a9a", data_dir=tmp_path)
    _same_dataset(want, got)
    assert got.train_x.shape == ((25, 123) if with_test else (20, 123))


def test_synthetic_fallback_off_raises(tmp_path):
    for load in (jds.load_dataset, tds.load_dataset):
        with pytest.raises(FileNotFoundError,
                           match="synthetic_fallback is off"):
            load("fmnist", data_dir=tmp_path, synthetic_fallback=False)
    _same_dataset(jds.load_dataset("synthetic", synthetic_fallback=False,
                                   train_size=8, test_size=4),
                  tds.load_dataset("synthetic", synthetic_fallback=False,
                                   train_size=8, test_size=4))


# -- models -----------------------------------------------------------------

def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


DENSE = {"mlp": ((28, 28, 1), 10), "logistic": ((123,), 2)}


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("name", list(DENSE))
def test_dense_forward_and_grad_match_flax(name, faithful, workers):
    """The fleet forward and the gradients of the summed per-worker CE
    against dopt's flax module, vmapped over the workers: f32 within
    1e-5 relative, bf16 compute within a quarter of dopt's own
    bf16-vs-f32 distance."""
    shape, ncls = DENSE[name]
    b = 12
    keys = jax.random.split(jax.random.key(1), workers)
    model = build_model(name, num_classes=ncls, faithful=faithful)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        model.init(k, jnp.zeros((1, *shape)))["params"] for k in keys])
    rng = np.random.default_rng(9)
    x = rng.normal(size=(workers, b, *shape)).astype(np.float32)
    y = rng.integers(0, ncls, (workers, b)).astype(np.int32)
    wt = (rng.random((workers, b)) > 0.2).astype(np.float32)

    def dopt_run(dtype):
        m = build_model(name, num_classes=ncls, faithful=faithful,
                        dtype=dtype)

        def loss(p):
            out = jax.vmap(lambda q, xi: m.apply({"params": q}, xi))(
                p, jnp.asarray(x))
            return jlosses.cross_entropy_stacked(
                out, jnp.asarray(y), jnp.asarray(wt)).sum(), out

        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
        return (np.asarray(jnp.asarray(out, jnp.float32)),
                params_from_jax(jax.device_get(g)))

    tp = {k: torch.tensor(v).requires_grad_()
          for k, v in params_from_jax(jax.device_get(stacked)).items()}
    assert {k: tuple(v.shape[1:]) for k, v in tp.items()} == param_shapes(
        name, num_classes=ncls, input_shape=shape)

    def port_run(dtype):
        with full_f32(torch.device("cpu")):
            out = stacked_forward(name, tp, torch.tensor(x),
                                  faithful=faithful, dtype=dtype)
            loss = cross_entropy_stacked(out, torch.tensor(y).long(),
                                         torch.tensor(wt)).sum()
            grads = torch.autograd.grad(loss, list(tp.values()))
        assert out.dtype == torch.float32
        for g in grads:
            assert g.is_contiguous() and g.dtype == torch.float32
        return out.detach().numpy(), {k: g.numpy() for k, g in
                                      zip(tp, grads)}

    out32, g32 = dopt_run("float32")
    got_out, got_g = port_run(torch.float32)
    np.testing.assert_allclose(got_out, out32, rtol=1e-5, atol=1e-6)
    for k, v in g32.items():
        assert np.abs(got_g[k] - v).max() <= 1e-5 * max(np.abs(v).max(),
                                                          1e-6), k
    out16, g16 = dopt_run("bfloat16")
    got_out, got_g = port_run(torch.bfloat16)
    names = sorted(g16)
    cat = np.concatenate
    d_out, ref_out = _rel_l2(got_out, out16), _rel_l2(out16, out32)
    d_g = _rel_l2(cat([got_g[k].ravel() for k in names]),
                  cat([g16[k].ravel() for k in names]))
    ref_g = _rel_l2(cat([g16[k].ravel() for k in names]),
                    cat([g32[k].ravel() for k in names]))
    print(f"{name} faithful={faithful} W={workers}: output port vs dopt "
          f"bf16 {d_out:.2e}, dopt bf16 vs f32 {ref_out:.2e}; gradient "
          f"{d_g:.2e} vs {ref_g:.2e}")
    assert d_out <= ref_out / 4
    assert d_g <= ref_g / 4


def test_stacked_model_registers_layers_in_order():
    for name, layers in LAYERS.items():
        shape = (123,) if name == "logistic" else (28, 28, 1)
        p = {k: torch.zeros(2, *s) for k, s in param_shapes(
            name, input_shape=shape).items()}
        m = StackedModel(name, p, faithful=False)
        assert [k for k, _ in m.named_parameters()] == [
            f"{layer}.{kind}" for layer in layers
            for kind in ("weight", "bias")]


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("name", list(DENSE))
def test_convert_round_trip_dense(name, stacked):
    shape, ncls = DENSE[name]
    p = build_model(name, num_classes=ncls).init(
        jax.random.key(0), jnp.zeros((1, *shape)))["params"]
    tree = jax.device_get(p)
    if stacked:
        tree = jax.tree.map(lambda a: np.stack([a, a + 1, a * 2]), tree)
    port = params_from_jax(tree)
    want = {k: s if not stacked else (3, *s) for k, s in param_shapes(
        name, num_classes=ncls, input_shape=shape).items()}
    assert {k: v.shape for k, v in port.items()} == want
    back = params_to_jax(port)
    assert back.keys() == tree.keys()
    for layer in tree:
        for k in tree[layer]:
            np.testing.assert_array_equal(back[layer][k], tree[layer][k])
            assert back[layer][k].dtype == tree[layer][k].dtype
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      tree)
    for k, v in params_from_jax(bf).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(
            torch.tensor(v).to(torch.bfloat16).float().numpy(), v)


# -- trainers at the BASELINE shapes -----------------------------------------

def _close_rows(want, got):
    assert len(want) == len(got) == 2
    for a, b in zip(want, got):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k, v in a.items():
            assert abs(v - b[k]) <= (1e-4 if "acc" in k else 1e-3), (k, a, b)


def _close_tree(want, got, shape):
    got = params_to_jax(got, input_shape=shape)
    assert want.keys() == got.keys()
    for layer in want:
        for k in want[layer]:
            a, b = np.asarray(want[layer][k]), got[layer][k]
            assert a.shape == b.shape
            rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
            assert rel <= 1e-4, f"{layer}.{k}: {rel:.3e}"


def _baseline1(mod, fused):
    """``baseline1`` cut to 512/64 samples: MLP on the MNIST fallback,
    4 workers, metropolis ring, local_ep 2, batch 64."""
    return mod.ExperimentConfig(
        name="baseline1-shaped", seed=2028,
        data=mod.DataConfig(dataset="mnist", num_users=4, iid=False,
                            synthetic_train_size=512, synthetic_test_size=64),
        model=mod.ModelConfig(model="mlp", faithful=False),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, fused_update=fused),
        gossip=mod.GossipConfig(algorithm="dsgd", topology="circle",
                                mode="metropolis", rounds=2, local_ep=2,
                                local_bs=64,
                                fused_update="on" if fused else "off"),
        mesh_devices=1)


def _baseline2(mod):
    """``baseline2`` at 8×8×3 and 512/64 samples, both fused switches:
    Model3, 16 workers, doubly-stochastic ring — kernel 2's ring path
    (n = 16) at lr = +1."""
    return mod.ExperimentConfig(
        name="baseline2-shaped", seed=1,
        data=mod.DataConfig(dataset="synthetic", num_users=16, iid=False,
                            synthetic_train_size=512, synthetic_test_size=64),
        model=mod.ModelConfig(model="model3", faithful=False,
                              input_shape=(8, 8, 3)),
        optim=mod.OptimizerConfig(lr=0.01, momentum=0.5, fused_update=True),
        gossip=mod.GossipConfig(algorithm="dsgd", topology="circle",
                                mode="double_stochastic", rounds=2,
                                local_ep=1, local_bs=16, fused_update="on"),
        mesh_devices=1)


@pytest.mark.parametrize("cfg,shape", [
    (lambda m: _baseline1(m, False), (28, 28, 1)),
    (lambda m: _baseline1(m, True), (28, 28, 1)),
    (_baseline2, (8, 8, 3))], ids=["baseline1", "baseline1-fused",
                                   "baseline2-fused"])
def test_baseline_gossip_shapes_match_dopt(cfg, shape):
    jt = JaxGossipTrainer(cfg(J))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    tt = GossipTrainer(cfg(T), device="cpu", init_params=init)
    _close_rows(jt.run(rounds=2).rows, tt.run(rounds=2).rows)
    _close_tree(jax.device_get(jt.worker_params()), tt.worker_params(),
                shape)


def _baseline4(mod):
    """``baseline4`` cut to 512/128 samples: logistic regression on the
    a9a fallback, 16 workers, FedADMM (rho 1.0), weight decay 1e-4 as a
    loss term, momentum 0, all lanes, kernel 1 on."""
    return mod.ExperimentConfig(
        name="baseline4-shaped", seed=0,
        data=mod.DataConfig(dataset="a9a", num_users=16, iid=True,
                            synthetic_train_size=512,
                            synthetic_test_size=128),
        model=mod.ModelConfig(model="logistic", num_classes=2,
                              input_shape=(123,), faithful=False),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.0, rho=1.0,
                                  weight_decay=1e-4, fused_update=True),
        federated=mod.FederatedConfig(algorithm="fedadmm", frac=1.0,
                                      rounds=2, local_ep=2, local_bs=16),
        mesh_devices=1)


def test_baseline4_fedadmm_logistic_matches_dopt():
    jt = JaxFederatedTrainer(_baseline4(J))
    init = jax.device_get(jt._theta_single())
    tt = FederatedTrainer(_baseline4(T), device="cpu", init_params=init)
    assert not tt._use_compact() and tt.steps_per_round == 4
    _close_rows(jt.run(rounds=2).rows, tt.run(rounds=2).rows)
    _close_tree(jax.device_get(jt._theta_single()), tt.global_params(),
                (123,))
    _close_tree(jax.device_get(jt.params), tt.worker_params(), (123,))
