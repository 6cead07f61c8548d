"""dopt_torch's stacked Model1/Model3 against dopt's grouped stacked apply.

Both packages start from the same dopt params (three workers with
different inits), carried over with ``params_from_jax``.  Tolerances:
forward 1e-5 relative and gradients of the summed cross-entropy 1e-4
relative — the same math, with the convolution and dense sums taken in
another order by XLA and by PyTorch's CPU kernels; the layout carry-over
is bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dopt.models import losses as jlosses
from dopt.models.zoo import build_model, count_params, make_stacked_apply
from dopt_torch.convert import params_from_jax, params_to_jax
from dopt_torch.models import (StackedCNN, accuracy_stacked,
                               cross_entropy_stacked, full_f32,
                               init_worker_params, param_shapes,
                               stacked_cnn_forward)

W = 3


@pytest.fixture(autouse=True)
def _full_f32():
    with full_f32(torch.device("cpu")):
        yield


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once, and torch's default (all cores each) oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_fleet(name, faithful, shape, seed=0):
    model = build_model(name, faithful=faithful)
    keys = jax.random.split(jax.random.key(seed), W)
    ps = [model.init(k, jnp.zeros((1, *shape)))["params"] for k in keys]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *ps)
    return model, jax.device_get(stacked)


def _batch(shape, b=5, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(W, b, *shape)).astype(np.float32)
    y = rng.integers(0, 10, size=(W, b)).astype(np.int32)
    w = (rng.random((W, b)) > 0.2).astype(np.float32)
    return x, y, w


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("shape", [(8, 8, 1), (28, 28, 1)])
@pytest.mark.parametrize("faithful", [True, False])
def test_forward_and_grads_match_dopt(shape, faithful):
    model, jp = _jax_fleet("model1", faithful, shape)
    x, y, w = _batch(shape)
    apply = make_stacked_apply(model)

    def loss(p):
        return jlosses.cross_entropy_stacked(apply(p, jnp.asarray(x)),
                                             jnp.asarray(y),
                                             jnp.asarray(w)).sum()

    jout = np.asarray(apply(jp, jnp.asarray(x)))
    jgrad = params_from_jax(jax.device_get(jax.grad(loss)(jp)),
                            input_shape=shape)

    tp = {k: torch.tensor(v) for k, v in
          params_from_jax(jp, input_shape=shape).items()}
    net = StackedCNN(tp, faithful=faithful)
    out = net(torch.tensor(x))
    lw = cross_entropy_stacked(out, torch.tensor(y), torch.tensor(w))
    lw.sum().backward()
    assert _rel(out.detach().numpy(), jout) <= 1e-5
    np.testing.assert_allclose(
        lw.detach().numpy(),
        np.asarray(jlosses.cross_entropy_stacked(
            jnp.asarray(jout), jnp.asarray(y), jnp.asarray(w))), rtol=1e-5)
    np.testing.assert_array_equal(
        accuracy_stacked(out.detach(), torch.tensor(y),
                         torch.tensor(w)).numpy(),
        np.asarray(jlosses.accuracy_stacked(jnp.asarray(jout), jnp.asarray(y),
                                            jnp.asarray(w))))
    for name, prm in net.named_parameters():
        assert _rel(prm.grad.numpy(), jgrad[name]) <= 1e-4, name


@pytest.mark.parametrize("name,shape,count", [
    ("model1", (28, 28, 1), 1_663_370), ("model3", (32, 32, 3), 1_105_098),
    ("model1", (8, 8, 1), None)])
def test_param_count_and_layout_round_trip(name, shape, count):
    _, jp = _jax_fleet(name, True, shape)
    single = jax.tree.map(lambda a: a[0], jp)
    for tree in (jp, single):
        tp = params_from_jax(tree, input_shape=shape)
        back = params_to_jax(tp, input_shape=shape)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
    per_worker = {k: v.shape[1:] for k, v in
                  params_from_jax(jp, input_shape=shape).items()}
    assert per_worker == param_shapes(name, input_shape=shape)
    n = sum(int(np.prod(s)) for s in per_worker.values())
    assert n == count_params(single)
    if count is not None:
        assert n == count


def test_init_follows_flax_defaults():
    """LeCun-normal kernels (truncated at ±2σ, flax's variance scaling)
    and zero biases, drawn from a seeded generator."""
    p = init_worker_params("model1",
                           generator=torch.Generator().manual_seed(0))
    q = init_worker_params("model1",
                           generator=torch.Generator().manual_seed(0))
    for k, v in p.items():
        assert torch.equal(v, q[k])
        if k.endswith("bias"):
            assert not v.any()
            continue
        fan_in = int(np.prod(v.shape[1:]))
        sigma = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert v.abs().max() <= 2 * sigma + 1e-7
        if v.numel() > 10_000:
            assert abs(v.std().item() * np.sqrt(fan_in) - 1.0) < 0.02


def test_max_pool_ties_route_to_first_winner():
    """Zero-background inputs give exact 4-way ties in every pooling
    window of the no-ReLU faithful conv; the gradient must go to the
    first window element, as dopt's custom VJP (and torch MaxPool2d)
    route it — compared against dopt on such an input."""
    shape = (8, 8, 1)
    model, jp = _jax_fleet("model1", True, shape)
    x = np.zeros((W, 4, *shape), np.float32)
    x[:, :, 2, 3, 0] = 1.0          # one lit pixel; the rest ties
    y = np.zeros((W, 4), np.int32)
    w = np.ones((W, 4), np.float32)
    apply = make_stacked_apply(model)

    def loss(p):
        return jlosses.cross_entropy_stacked(
            apply(p, jnp.asarray(x)), jnp.asarray(y), jnp.asarray(w)).sum()

    jgrad = params_from_jax(jax.device_get(jax.grad(loss)(jp)),
                            input_shape=shape)
    tp = {k: torch.tensor(v).requires_grad_() for k, v in
          params_from_jax(jp, input_shape=shape).items()}
    lw = cross_entropy_stacked(
        stacked_cnn_forward(tp, torch.tensor(x), faithful=True),
        torch.tensor(y), torch.tensor(w))
    lw.sum().backward()
    for k, v in tp.items():
        assert _rel(v.grad.numpy(), jgrad[k]) <= 1e-4, k

    # The pool itself: a window of equal values sends all gradient to
    # its first element (row-major scan order).
    z = torch.zeros(1, 1, 2, 4, requires_grad=True)
    torch.nn.functional.max_pool2d(z, 2).sum().backward()
    np.testing.assert_array_equal(z.grad[0, 0].numpy(),
                                  [[1, 0, 1, 0], [0, 0, 0, 0]])
