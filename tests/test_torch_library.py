"""dopt's library surface in the port, against dopt, on the CPU.

The names a user calls when dopt is a library rather than
``python -m dopt.run``: ``build_model``'s one-worker zoo (forward at
full width, ResNet-18 small), the single-model losses, ``init_sgd`` and
``clip_by_global_norm``, ``fused_sgd_momentum_tree`` (dopt's in
interpret mode, the port's plain version on CPU tensors), ``mix_power``,
``masked_mean``, ``gather_batches``, ``timed_build``,
``TRIM_COMPUTE_DTYPE``, ``native_available``, ``DEFAULT_SPAN_CAPACITY``,
the names re-exported at dopt's paths and the top-level surface.  The
slice as a whole: three one-worker SGD steps of Model1 and a small
ResNet-18 through ``build_model`` + ``cross_entropy`` + ``init_sgd`` +
``fused_sgd_momentum_tree`` against dopt's ``build_model`` +
``jax.grad`` + its kernel.  Last, the premise of ``chip_smoke.py``'s
phase 22b: one ResNet-18 lane stepped alone equals lane 0 of a fleet's
step bit for bit.

Inputs are numpy draws from a seed; weights are dopt's flax inits,
carried over by ``load_jax_params``.  Yardsticks: outputs and single
steps within 1e-5 relative to each tensor's largest entry, losses
within 1e-6 relative, draws and gathers bit for bit.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dopt
import dopt.data as jdata
import dopt.models as jmodels
import dopt.optim as joptim
import dopt_torch
import dopt_torch.data as tdata
import dopt_torch.models as tmodels
import dopt_torch.optim as toptim
from dopt.engine.gossip import random_matching_matrix as jax_matching
from dopt.engine.local import validate_optimizer as jax_validate
from dopt.models import losses as jlosses
from dopt.models.zoo import ResidualBlock as JaxResidualBlock
from dopt.obs.spans import DEFAULT_SPAN_CAPACITY as JAX_SPAN_CAPACITY
from dopt.ops.fused_update import fused_sgd_momentum_tree as jax_tree_sgd
from dopt.parallel import collectives as jcoll
from dopt.parallel import multihost as jmultihost
from dopt.presets import TRIM_COMPUTE_DTYPE as JAX_TRIM
from dopt.presets import get_preset as jax_preset
from dopt.robust import masked_mean as jax_masked_mean
from dopt.utils.profiling import PhaseTimers as JaxPhaseTimers
from dopt_torch.convert import params_from_jax
from dopt_torch.engine.gossip import random_matching_matrix
from dopt_torch.engine.local import stacked_step, validate_optimizer
from dopt_torch.models import full_f32, stacked_forward
from dopt_torch.native import native_available
from dopt_torch.obs.spans import DEFAULT_SPAN_CAPACITY, SpanTracer
from dopt_torch.ops import fused_sgd_momentum_tree
from dopt_torch.parallel import multihost as tmultihost
from dopt_torch.parallel.collectives import mix_power
from dopt_torch.presets import TRIM_COMPUTE_DTYPE, get_preset
from dopt_torch.robust import masked_mean
from dopt_torch.utils.profiling import PhaseTimers

CPU = torch.device("cpu")
ZOO = ("model1", "model3", "mlp", "logistic", "resnet18", "transformer")
# Each case's width and input: the presets' full widths for the CNNs and
# the dense models, ResNet-18 at stage sizes (1, 1) on 8×8×3.
CASES = {"model1": ({}, (28, 28, 1)), "model3": ({}, (32, 32, 3)),
         "mlp": ({}, (28, 28, 1)), "logistic": ({}, (123,)),
         "resnet18-small": ({"stage_sizes": (1, 1)}, (8, 8, 3))}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-5):
    """Within ``tol`` of the largest |entry| of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _models(case, seed=0):
    """dopt's model with its flax init, and the port's with those
    weights loaded."""
    kw, shape = CASES[case]
    name = case.split("-")[0]
    jm = jmodels.build_model(name, **kw)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, *shape)))
    tm = dopt_torch.build_model(name, device="cpu", input_shape=shape, **kw)
    tm.load_jax_params(jax.device_get(params))
    return jm, params, tm, shape


# -- build_model -------------------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_build_model_faithful_default_and_class(name):
    """Every zoo name builds, with dopt's per-model ``faithful`` default
    and class name; an explicit ``faithful`` wins."""
    jm = jmodels.build_model(name)
    tm = dopt_torch.build_model(name, device="cpu")
    assert isinstance(tm, torch.nn.Module)
    assert tm.faithful == jm.faithful
    assert type(tm).__name__ == type(jm).__name__
    assert dopt_torch.build_model(name, device="cpu",
                                  faithful=not jm.faithful).faithful \
        == (not jm.faithful)
    assert all(p.device == CPU for p in tm.parameters())


def test_build_model_errors_in_dopts_words():
    """An unknown name and ``stage_sizes`` off ResNet-18 are refused
    with dopt's messages; the port's device rule refuses CUDA without a
    card."""
    for call in (lambda m: m.build_model("vgg"),
                 lambda m: m.build_model("mlp", stage_sizes=(1, 1))):
        with pytest.raises(ValueError) as want:
            call(jmodels)
        with pytest.raises(ValueError) as got:
            call(type("M", (), {"build_model": staticmethod(
                lambda *a, **k: dopt_torch.build_model(
                    *a, device="cpu", **k))}))
        assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dopt_torch.build_model("mlp")
    with pytest.raises(ValueError, match="unknown dtype"):
        dopt_torch.build_model("mlp", dtype="float16", device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_dopt(case):
    """The one-worker forward on dopt's flax init, f32, against dopt's
    ``model.apply``: within 1e-5 relative; in bf16 compute within a
    quarter of dopt's own bf16-vs-f32 distance; the weights come back
    through ``jax_params`` bit for bit."""
    jm, params, tm, shape = _models(case)
    x = np.random.default_rng(1).normal(size=(8, *shape)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad(), full_f32(CPU):
        got = tm(torch.tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got.numpy(), want)
    back = tm.jax_params()["params"]
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
    mine = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(mine)
    for path, leaf in flat:
        np.testing.assert_array_equal(mine[path[1:]], leaf)


def test_bf16_forward_within_dopts_distance():
    """Model3 in bf16 compute (dopt's ``dtype="bfloat16"``, params f32):
    within a quarter of dopt's bf16-vs-f32 distance of dopt's bf16."""
    jm, params, _, shape = _models("model3")
    x = np.random.default_rng(2).normal(size=(8, *shape)).astype(np.float32)
    j16 = jmodels.build_model("model3", dtype="bfloat16")
    w16 = np.asarray(j16.apply(params, jnp.asarray(x)), np.float64)
    w32 = np.asarray(jm.apply(params, jnp.asarray(x)), np.float64)
    t16 = dopt_torch.build_model("model3", dtype="bfloat16", device="cpu")
    t16.load_jax_params(jax.device_get(params))
    with torch.no_grad():
        got = t16(torch.tensor(x)).double().numpy()
    assert np.linalg.norm(got - w16) <= np.linalg.norm(w16 - w32) / 4


def test_residual_block_matches_dopt():
    """dopt's ``ResidualBlock`` alone (8 → 16 channels, stride 2, so
    with its projection) against the port's, NHWC in and out, within
    1e-5 relative."""
    jb = JaxResidualBlock(16, strides=2)
    x = np.random.default_rng(3).normal(size=(4, 8, 8, 8)).astype(
        np.float32)
    params = jb.init(jax.random.key(4), jnp.asarray(x))
    want = np.asarray(jb.apply(params, jnp.asarray(x)))
    tb = tmodels.ResidualBlock(16, 2, in_features=8, device="cpu")
    got_p = params_from_jax(jax.device_get(params)["params"])
    own = dict(tb.named_parameters())
    assert got_p.keys() == own.keys()
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(torch.from_numpy(got_p[k]))
        with full_f32(CPU):
            got = tb(torch.tensor(x))
    _close(got.numpy(), want)


def test_transformer_builds_dopts_lm():
    """``build_model("transformer")`` is dopt's TransformerLM at its
    defaults: its logits on dopt's init within 1e-5 relative."""
    jm = jmodels.build_model("transformer")
    tok = np.random.default_rng(5).integers(0, 10, (2, 12)).astype(np.int32)
    params = jm.init(jax.random.key(6), jnp.asarray(tok))
    want = np.asarray(jm.apply(params, jnp.asarray(tok)))
    tm = dopt_torch.build_model("transformer", device="cpu")
    conv = params_from_jax(jax.device_get(params)["params"])
    with torch.no_grad():
        for k, v in tm.named_parameters():
            v.copy_(torch.from_numpy(conv[k]))
        got = tm(torch.tensor(tok).long())
    _close(got.numpy(), want)


# -- losses, optimizer, the kernel's tree wrapper ----------------------------

@pytest.mark.parametrize("weighted", [False, True], ids=["mean", "weighted"])
def test_losses_match_dopt(weighted):
    """``cross_entropy``, ``accuracy`` (a tie in the argmax included)
    and ``l2_regulariser`` against dopt's on the same draws."""
    rng = np.random.default_rng(7)
    out = rng.normal(size=(16, 10)).astype(np.float32)
    out[0, 3] = out[0, 7] = 9.0
    y = rng.integers(0, 10, 16).astype(np.int32)
    w = (rng.random(16) > 0.3).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.tensor(w)
    np.testing.assert_allclose(
        _scalar32(tmodels.cross_entropy(torch.tensor(out),
                                           torch.tensor(y), tw)),
        float(jlosses.cross_entropy(jnp.asarray(out), jnp.asarray(y), jw)),
        rtol=1e-6)
    assert float(tmodels.accuracy(torch.tensor(out), torch.tensor(y), tw)) \
        == float(jlosses.accuracy(jnp.asarray(out), jnp.asarray(y), jw))
    params = {"a.weight": rng.normal(size=(5, 3)).astype(np.float32),
              "a.bias": rng.normal(size=5).astype(np.float32)}
    want = jlosses.l2_regulariser({"a": {"kernel": params["a.weight"].T,
                                         "bias": params["a.bias"]}}, 0.3)
    got = tmodels.l2_regulariser({k: torch.tensor(v)
                                  for k, v in params.items()}, 0.3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _scalar32(t: torch.Tensor) -> float:
    """A 0-d f32 tensor's value."""
    assert t.dtype == torch.float32 and t.dim() == 0
    return float(t)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "kept"])
def test_clip_and_init_sgd_match_dopt(max_norm):
    """``clip_by_global_norm`` against dopt's (a norm above and below
    the limit) and ``init_sgd``'s zero buffers, dopt's ``SGDState``."""
    rng = np.random.default_rng(8)
    g = {"a": rng.normal(size=(4, 6)).astype(np.float32),
         "b": rng.normal(size=9).astype(np.float32)}
    want = joptim.clip_by_global_norm({k: jnp.asarray(v)
                                       for k, v in g.items()}, max_norm)
    got = toptim.clip_by_global_norm({k: torch.tensor(v)
                                      for k, v in g.items()}, max_norm)
    for k in g:
        _close(got[k].numpy(), want[k], 1e-6)
    state = toptim.init_sgd({k: torch.tensor(v) for k, v in g.items()})
    assert isinstance(state, toptim.SGDState)
    assert toptim.SGDState._fields == joptim.SGDState._fields
    for k, v in state.momentum.items():
        assert v.shape == g[k].shape and not v.any() and v.is_contiguous()


def test_fused_sgd_momentum_tree_matches_dopts_interpret():
    """Kernel 1's tree wrapper on CPU tensors (its plain version) against
    dopt's Pallas kernel in interpret mode: within rtol 1e-6, atol 1e-7
    (tests/test_torch_ops.py's bar: XLA contracts p − lr·m into one
    rounding), in place, returning the same dicts; ``interpret=`` other
    than None and mismatched keys are refused."""
    rng = np.random.default_rng(9)
    shapes = {"w": (7, 5), "b": (7,), "c": (3, 3, 2)}
    p, m, g = ({k: rng.normal(size=s).astype(np.float32)
                for k, s in shapes.items()} for _ in range(3))
    jp, jm = jax_tree_sgd(*({k: jnp.asarray(v) for k, v in t.items()}
                            for t in (p, m, g)), lr=0.1, mu=0.9,
                          interpret=True)
    tp, tm, tg = ({k: torch.tensor(v) for k, v in t.items()}
                  for t in (p, m, g))
    ptrs = [v.data_ptr() for v in tp.values()]
    rp, rm = fused_sgd_momentum_tree(tp, tm, tg, lr=0.1, mu=0.9)
    assert rp is tp and rm is tm
    assert [v.data_ptr() for v in tp.values()] == ptrs
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="interpret"):
        fused_sgd_momentum_tree(tp, tm, tg, lr=0.1, mu=0.9, interpret=True)
    with pytest.raises(ValueError, match="same keys"):
        fused_sgd_momentum_tree(tp, tm, {"w": tg["w"]}, lr=0.1, mu=0.9)


# -- consensus, aggregation, data --------------------------------------------

@pytest.mark.parametrize("eps", [1, 3])
def test_mix_power_matches_dopt(eps):
    """``eps`` sweeps of ``mix_dense``, each on the previous output,
    against dopt's ``mix_power`` on a metropolis ring: within 1e-6."""
    rng = np.random.default_rng(10)
    w = dopt_torch.build_mixing_matrices("circle", "metropolis", 5,
                                         seed=0).for_round(0).astype(
                                             np.float32)
    x = {"a": rng.normal(size=(5, 4, 3)).astype(np.float32),
         "b": rng.normal(size=(5, 7)).astype(np.float32)}
    want = jcoll.mix_power({k: jnp.asarray(v) for k, v in x.items()},
                           jnp.asarray(w), eps)
    got = mix_power({k: torch.tensor(v) for k, v in x.items()},
                    torch.tensor(w), eps)
    for k in x:
        _close(got[k].numpy(), want[k], 1e-6)


def test_masked_mean_matches_dopt():
    """``masked_mean`` over 6 lanes with 2 masked out, against dopt's."""
    rng = np.random.default_rng(11)
    x = {"a": rng.normal(size=(6, 4)).astype(np.float32),
         "b": rng.normal(size=(6, 2, 3)).astype(np.float32)}
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    want = jax_masked_mean({k: jnp.asarray(v) for k, v in x.items()},
                           jnp.asarray(mask))
    got = masked_mean({k: torch.tensor(v) for k, v in x.items()},
                      torch.tensor(mask))
    for k in x:
        assert got[k].shape == x[k].shape[1:]
        _close(got[k].numpy(), want[k], 1e-6)


def test_gather_batches_bit_for_bit():
    """One round's plan gathered on the host: features, int32 labels and
    weights bit for bit dopt's (a padded last batch included)."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(50, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, 50).astype(np.int64)
    index = np.arange(48).reshape(3, 16)
    kw = dict(batch_size=5, local_ep=2, seed=3, round_idx=1)
    want = jdata.gather_batches(x, y, jdata.make_batch_plan(index, **kw))
    got = tdata.gather_batches(x, y, tdata.make_batch_plan(index, **kw))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_timed_build_accounts_as_dopts():
    """``timed_build`` returns the build's output and adds one count and
    its seconds to ``host_batch_plan``, as dopt's does."""
    out = {}
    for mod, timers in ((tdata, PhaseTimers()), (jdata, JaxPhaseTimers())):
        wrapped = mod.timed_build(lambda meta: meta * 2, timers)
        out[mod.__name__] = (wrapped(21), wrapped(4),
                             dict(timers.counts),
                             timers.totals["host_batch_plan"] >= 0.0)
    assert out["dopt_torch.data"] == out["dopt.data"]
    assert out["dopt_torch.data"][:3] == (42, 8, {"host_batch_plan": 2})


# -- constants and names -----------------------------------------------------

def test_constants_equal_dopts():
    """``TRIM_COMPUTE_DTYPE`` and ``DEFAULT_SPAN_CAPACITY`` are dopt's (the
    span ring's bound included); ``native_available`` says whether the
    planner builds here (g++ on PATH); ``HOST_AXIS``/``ICI_AXIS`` and
    ``random_matching_matrix`` sit at dopt's module paths and draw as
    dopt's."""
    assert TRIM_COMPUTE_DTYPE == JAX_TRIM
    assert DEFAULT_SPAN_CAPACITY == JAX_SPAN_CAPACITY
    assert SpanTracer()._ring.maxlen == DEFAULT_SPAN_CAPACITY
    assert native_available() is (shutil.which("g++") is not None)
    assert (tmultihost.HOST_AXIS, tmultihost.ICI_AXIS) == (
        jmultihost.HOST_AXIS, jmultihost.ICI_AXIS)
    for n in (5, 6):
        np.testing.assert_array_equal(
            random_matching_matrix(n, np.random.default_rng(13)),
            jax_matching(n, np.random.default_rng(13)))


def test_top_level_surface_covers_dopts():
    """``dir(dopt_torch)`` covers dopt's ``__all__``; each name resolves
    (``build_model`` lazily); the verify recipe's first drive runs."""
    missing = set(dopt.__all__) - set(dir(dopt_torch))
    assert not missing, missing
    for name in dopt.__all__:
        assert getattr(dopt_torch, name) is not None
    assert dopt_torch.build_model is tmodels.build_model
    mm = dopt_torch.build_mixing_matrices("circle", "stochastic", 6, seed=0)
    jm = dopt.build_mixing_matrices("circle", "stochastic", 6, seed=0)
    assert mm.is_row_stochastic() and jm.is_row_stochastic()
    np.testing.assert_array_equal(mm.stacked(), jm.stacked())
    with pytest.raises(AttributeError):
        dopt_torch.no_such_name  # noqa: B018


def test_validate_optimizer_is_dopts_one_check():
    """``validate_optimizer`` refuses any optimizer but 'sgd' with dopt's
    message, and every engine refuses through it."""
    def adam(cfg):
        return cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                     optimizer="adam"))

    with pytest.raises(ValueError) as want:
        jax_validate(adam(jax_preset("baseline1")))
    with pytest.raises(ValueError) as got:
        validate_optimizer(adam(get_preset("baseline1")))
    assert str(got.value) == str(want.value)
    validate_optimizer(get_preset("baseline1"))
    for trainer, preset in ((dopt_torch.GossipTrainer, "baseline1"),
                            (dopt_torch.FederatedTrainer, "baseline3")):
        with pytest.raises(ValueError) as got:
            trainer(adam(get_preset(preset)), device="cpu")
        assert str(got.value) == str(want.value)


# -- the slice as a whole ----------------------------------------------------

@pytest.mark.parametrize("case,batch", [("model1", 32),
                                        ("resnet18-small", 8)])
def test_three_sgd_steps_match_dopt(case, batch):
    """Three one-worker SGD steps (lr 0.01, momentum 0.5) through the
    library: ``build_model`` + ``cross_entropy`` + autograd +
    ``init_sgd`` + ``fused_sgd_momentum_tree`` against dopt's
    ``build_model`` + ``jax.grad`` + ``fused_sgd_momentum_tree``
    (interpret mode): each step's loss within 1e-6 relative, the params
    after each step within 1e-5 relative."""
    jm, params, tm, shape = _models(case, seed=14)
    rng = np.random.default_rng(15)
    xs = rng.normal(size=(3, batch, *shape)).astype(np.float32)
    ys = rng.integers(0, 10, (3, batch)).astype(np.int32)
    jp = params["params"]
    jmom = joptim.init_sgd(jp).momentum

    def jloss(p, x, y):
        return jlosses.cross_entropy(jm.apply({"params": p}, x), y)

    jgrad = jax.jit(jax.value_and_grad(jloss))
    tparams = dict(tm.named_parameters())
    state = toptim.init_sgd(tparams)
    for t in range(3):
        jl, jg = jgrad(jp, jnp.asarray(xs[t]), jnp.asarray(ys[t]))
        jp, jmom = jax_tree_sgd(jp, jmom, jg, lr=0.01, mu=0.5,
                                interpret=True)
        with full_f32(CPU):
            loss = tmodels.cross_entropy(tm(torch.tensor(xs[t])),
                                         torch.tensor(ys[t]))
            grads = dict(zip(tparams, torch.autograd.grad(
                loss, list(tparams.values()))))
        fused_sgd_momentum_tree(tparams, state.momentum, grads, lr=0.01,
                                mu=0.5)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
        want = params_from_jax(jax.device_get(jp),
                               input_shape=tm.input_shape)
        for k, v in want.items():
            _close(tparams[k].detach().numpy(), v)


@pytest.mark.parametrize("budget", ["one-chunk", "lane-by-lane"])
@pytest.mark.parametrize("conv", ["3x3", "3x3-stride2-uneven", "1x1-stride2",
                                  "3x3-long-wgrad"])
def test_rounded_resnet_conv_is_the_f64_conv_rounded_once(conv, budget,
                                                          monkeypatch):
    """ResNet-18's f32 training conv (``_RoundedResNetConv``: f64 GEMMs
    over lane-chunked im2col copies) against the library's f64 grouped
    conv of the same f32 operands: the output and, for a weight-gradient
    sum of ``WGRAD_F64_MIN`` terms or more, the weight gradient within
    one f32 rounding of the f64 result; a shorter weight gradient and
    the input gradient are the library's f32 ones exactly.  Chunked one
    lane at a time or all at once, and through its ``vmap`` rule, the
    same bits."""
    from dopt_torch.models import zoo

    b, k, stride, pre, hw = {
        "3x3": (4, 3, 1, False, 8), "3x3-stride2-uneven": (4, 3, 2, True, 8),
        "1x1-stride2": (4, 1, 2, False, 8),
        "3x3-long-wgrad": (64, 3, 1, False, 32)}[conv]
    if budget == "lane-by-lane":
        monkeypatch.setattr(zoo, "F64_COLS_BYTES", 1)
    g, c, co = 3, 2, 4
    rng = np.random.default_rng(21)
    z = torch.tensor(rng.normal(size=(b, g * c, hw, hw)).astype(np.float32),
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(g * co, c, k, k)).astype(np.float32),
                     requires_grad=True)
    pad = 0 if pre else ((k - 1) // 2,) * 2
    zz = torch.nn.functional.pad(z, (0, 1, 0, 1)) if pre else z
    out = zoo._RoundedResNetConv.apply(zz, w, stride, pad, g)
    want = torch.nn.functional.conv2d(zz.double(), w.double(), stride=stride,
                                      padding=pad, groups=g)
    one_rounding = dict(rtol=2.0 ** -23, atol=0.0)
    torch.testing.assert_close(out, want.float(), **one_rounding)
    grad = torch.tensor(rng.normal(size=out.shape).astype(np.float32))
    gz, gw = torch.autograd.grad(out, (z, w), grad)
    wz, ww = torch.autograd.grad(want, (z, w), grad.double())
    if b * out[0, 0].numel() >= zoo.WGRAD_F64_MIN:
        torch.testing.assert_close(gw, ww, **one_rounding)
    else:
        assert torch.equal(gw, torch.nn.grad.conv2d_weight(
            zz, w.shape, grad, stride=stride, padding=pad, groups=g))
    (lib_gz,) = torch.autograd.grad(torch.nn.functional.conv2d(
        zz, w, stride=stride, padding=pad, groups=g), z, grad)
    assert torch.equal(gz, lib_gz)
    lanes = torch.func.vmap(
        lambda zl, wl: zoo._RoundedResNetConv.apply(zl, wl, stride, pad, 1),
        in_dims=(1, 0), out_dims=1)(
            zz.detach().view(b, g, c, *zz.shape[2:]), w.detach().view(
                g, co, c, k, k))
    assert torch.equal(lanes.reshape(out.shape), out.detach())


def test_resnet_one_lane_equals_lane0_of_four_bit_for_bit():
    """The premise of phase 22b: on the CPU one ResNet-18 lane (full
    depth, 16×16×3, batch 4) stepped alone equals lane 0 of a 4-lane
    step from the same init bit for bit, gradients and updated params
    (the other lanes on other inits and data)."""
    rng = np.random.default_rng(16)
    x = torch.tensor(rng.normal(size=(4, 4, 16, 16, 3)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 10, (4, 4)))
    gen = torch.Generator().manual_seed(17)
    inits = [tmodels.init_worker_params("resnet18", input_shape=(16, 16, 3),
                                        generator=gen) for _ in range(4)]
    out = {}
    for n in (1, 4):
        params = {k: torch.stack([p[k] for p in inits[:n]])
                  .requires_grad_() for k in inits[0]}
        moms = {k: torch.zeros_like(v) for k, v in params.items()}
        with full_f32(CPU):
            stacked_step(lambda z: stacked_forward(
                "resnet18", params, z, faithful=False), params, moms,
                x[:n], y[:n], torch.ones(n, 4), lr=0.1, momentum=0.9,
                fused=False)
        out[n] = {**{f"grad {k}": m[0] for k, m in moms.items()},
                  **{f"param {k}": v[0].detach() for k, v in params.items()}}
    for k, v in out[1].items():
        assert torch.equal(v, out[4][k]), k
