"""bf16 compute, bf16 storage and the per-worker clip, against dopt.

Inputs come from seeded numpy; dopt runs on the CPU (its Pallas kernels
in interpret mode), the port on the CPU (the kernels' plain versions),
Model1 at 8×8 with 4 workers.  Tolerances, each with its reason:

* Element-wise arithmetic — dopt's unfused SGD update, the FedProx /
  FedADMM / SCAFFOLD edits, the masked means — bit for bit: the port
  rounds every op and every Python scalar to the storage dtype as jnp
  does.
* Kernel 1's plain version against the Pallas kernel in interpret mode:
  bit for bit at μ = 0.5; at μ = 0.9 XLA contracts ``μ·m + g`` and
  ``p − lr·m`` into FMAs on the CPU (one rounding fewer), so some
  elements differ, and numpy emulations of the two arithmetics (each
  op rounded; FMA) reproduce each side bit for bit.
* The clip: the per-worker squared norm is an f32 sum taken in another
  order, so its scale may differ in the last f32 bit; a clipped f32
  gradient within 2 ulps (that bit, then the product's rounding), a
  bf16 one within 1 ulp of bf16.
* The bf16 forward and gradient: at most 1/4 of dopt's own bf16-vs-f32
  distance on the same inputs (relative L2), printed beside it.
* Two-round trainer runs: within dopt's own bf16-vs-f32 distance on the
  same run (params relative L2, test accuracy), the train and local
  losses within that distance or slice 1's 1e-3, whichever is larger;
  both distances are printed.  Two bf16 realizations of one step
  already differ (the whole gradient by 0.06-0.08 of dopt's bf16-vs-f32
  gap, single bias vectors by up to 1.0: XLA sums the gradient of a
  broadcast bias add in bf16 on the CPU, the port in f32), and
  dependent steps amplify it: after 2 rounds the port sits at 0.50-0.57
  of the gap in params with bf16 compute and f32 storage (up to 2.1×
  in train loss, under 1e-3), and 0.15-0.28 with bf16 storage, whose
  rounding of the state dominates.
* f32 with the clip: slice 1's limits (1e-3 loss, 1e-4 accuracy, 1e-4
  max-relative params).
"""

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
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt.models import losses as jlosses
from dopt.models.zoo import build_model, make_stacked_apply
from dopt.ops import fused_sgd_momentum as jax_fused_sgd_momentum
from dopt.parallel import collectives as jcoll
from dopt_torch import optim as topt
from dopt_torch import robust as trobust
from dopt_torch.convert import params_from_jax, params_to_jax
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.models import (accuracy_stacked, cross_entropy_stacked,
                               full_f32, stacked_cnn_forward)
from dopt_torch.ops import sgd_momentum_reference
from dopt_torch.parallel import collectives as tcoll

SHAPE = (8, 8, 1)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(a) -> np.ndarray:
    """An array rounded to bf16 and held in f32 (numpy has no bf16)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _np(x) -> np.ndarray:
    """A jax array or a tensor as an f32 numpy array (exact for bf16)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- the SGD update: dopt's unfused arithmetic and kernel 1's ----------

def _sgd_inputs(n=200_000):
    rng = np.random.default_rng(0)
    return [_bf(rng.normal(size=n).astype(np.float32)) for _ in range(3)]


@pytest.mark.parametrize("lr,mu", [(0.01, 0.5), (0.05, 0.9)])
def test_unfused_bf16_sgd_is_dopts_bit_for_bit(lr, mu):
    """``optim.sgd_step`` in bf16 is dopt's jitted ``sgd_step`` in every
    element (μ = 0.9 meets the update as 0.8984375), and it is not
    kernel 1's arithmetic, which rounds once at the store."""
    p, m, g = _sgd_inputs()
    step = jax.jit(lambda p, m, g: jopt.sgd_step(
        p, jopt.SGDState(m), g, lr=lr, momentum=mu))
    jp, js = step(*(jnp.asarray(a, jnp.bfloat16) for a in (p, m, g)))
    tp, tm, tg = (torch.tensor(a).to(BF16) for a in (p, m, g))
    topt.sgd_step([tp], [tm], [tg], lr=lr, momentum=mu)
    assert tp.dtype == tm.dtype == BF16
    assert int((_np(tp) != _np(jp)).sum()) == 0
    assert int((_np(tm) != _np(js.momentum)).sum()) == 0
    kp, km = (torch.tensor(a).to(BF16) for a in (p, m))
    sgd_momentum_reference([kp], [km], [tg], lr=lr, momentum=mu)
    differ = int((_np(kp) != _np(tp)).sum())
    print(f"lr {lr} mu {mu}: unfused vs kernel 1's arithmetic differ in "
          f"{differ} of {p.size} bf16 params")
    assert differ > 0
    # In f32 the two arithmetics are one.
    fp, fm, gp, gm = (torch.tensor(a) for a in (p, m, p, m))
    topt.sgd_step([fp], [fm], [torch.tensor(g)], lr=lr, momentum=mu)
    sgd_momentum_reference([gp], [gm], [torch.tensor(g)], lr=lr,
                           momentum=mu)
    assert torch.equal(fp, gp) and torch.equal(fm, gm)


@pytest.mark.parametrize("lr,mu", [(0.01, 0.5), (0.05, 0.9)])
def test_kernel1_plain_bf16_is_pallas(lr, mu):
    p, m, g = _sgd_inputs()
    jp, jm = jax_fused_sgd_momentum(
        *(jnp.asarray(a, jnp.bfloat16) for a in (p, m, g)), lr=lr, mu=mu,
        interpret=True)
    tp, tm = (torch.tensor(a).to(BF16) for a in (p, m))
    sgd_momentum_reference([tp], [tm], [torch.tensor(g).to(BF16)], lr=lr,
                           momentum=mu)
    dp, dm = _np(tp) != _np(jp), _np(tm) != _np(jm)
    print(f"lr {lr} mu {mu}: plain vs Pallas differ in {int(dp.sum())} "
          f"params, {int(dm.sum())} momenta of {p.size}")
    if mu == 0.5:   # μ·m is exact, so an FMA cannot change a bit
        assert not dp.any() and not dm.any()
    # Both arithmetics in numpy: the plain version rounds each f32 op
    # (the CUDA kernel's arithmetic), and XLA's interpret mode contracts
    # μ·m + g and p − lr·buf into FMAs (an f64 product and sum, one
    # rounding to f32); each reproduces its side bit for bit.
    mu32, lr32 = np.float32(mu), np.float32(lr)
    buf = mu32 * m + g
    np.testing.assert_array_equal(_bf(buf), _np(tm))
    np.testing.assert_array_equal(_bf(p - lr32 * buf), _np(tp))
    f64 = np.float64
    buf = (f64(mu32) * m.astype(f64) + g).astype(np.float32)
    newp = (p.astype(f64) - f64(lr32) * buf.astype(f64)).astype(np.float32)
    np.testing.assert_array_equal(_bf(buf), _np(jm))
    np.testing.assert_array_equal(_bf(newp), _np(jp))


# -- the clip, the edits and the aggregation helpers in bf16 ------------

def _stacked(rng, dtype, w=4):
    """A [W, ...] gradient dict in dopt's leaf order, worker 0 far below
    norm 1 and the others above it."""
    scale = np.array([1e-3, 0.5, 2.0, 40.0], np.float32)[:w]
    out = {}
    for k, s in (("a", (w, 3, 5)), ("b", (w, 7)), ("c", (w, 2, 2, 2))):
        x = rng.normal(size=s).astype(np.float32)
        out[k] = x * scale.reshape((-1,) + (1,) * (len(s) - 1))
    return {k: (_bf(v) if dtype == "bfloat16" else v) for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_stacked_matches_dopt(dtype):
    g = _stacked(np.random.default_rng(3), dtype)
    want = jopt.clip_by_global_norm_stacked(
        {k: jnp.asarray(v, dtype) for k, v in g.items()}, 1.0)
    got = topt.clip_by_global_norm_stacked(
        {k: torch.tensor(v).to(getattr(torch, dtype)) for k, v in g.items()},
        1.0)
    # ulps of the gradient's dtype: bf16 keeps 16 fewer mantissa bits.
    ulp = 1 if dtype == "float32" else 2 ** 16
    limit = 2 if dtype == "float32" else 1
    for k in g:
        assert got[k].dtype == getattr(torch, dtype)
        a, b = _np(got[k]), _np(want[k])
        np.testing.assert_array_equal(a[0], g[k][0])   # below: untouched
        assert (np.abs(a - b) <= limit * ulp * np.spacing(np.abs(b))).all()
    norms = np.sqrt(sum((_np(got[k]).reshape(4, -1) ** 2).sum(1)
                        for k in g))
    assert norms[0] < 1e-2 and np.allclose(norms[1:], 1.0, rtol=1e-2)


def _trees(rng, n=3, w=5):
    return [{"a": _bf(rng.normal(size=(w, 3, 4))),
             "b": _bf(rng.normal(size=(w, 7)))} for _ in range(n)]


def _single(rng):
    return {"a": _bf(rng.normal(size=(3, 4))), "b": _bf(rng.normal(size=7))}


def _tt(tree):
    return {k: torch.tensor(v).to(BF16) for k, v in tree.items()}


def _jt(tree):
    return {k: jnp.asarray(v, jnp.bfloat16) for k, v in tree.items()}


def _same_bits(want, got):
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == BF16
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))


@pytest.mark.parametrize("edit", ["prox", "admm", "dual", "scaffold_grad",
                                  "scaffold_control"])
def test_bf16_edits_match_dopt_bit_for_bit(edit):
    """rho = 0.1 and 1/(K·lr) meet bf16 tensors rounded to bf16, as jnp's
    weak typing rounds them."""
    rng = np.random.default_rng(0)
    g, p, a = _trees(rng)
    th, c = _single(rng), _single(rng)
    cases = {
        "prox": lambda m, t: m.prox_grad_edit(t(g), t(p), t(th), 0.1),
        "admm": lambda m, t: m.admm_grad_edit(t(g), t(p), t(th), t(a), 0.1),
        "dual": lambda m, t: m.admm_dual_ascent(t(a), t(p), t(th), 0.1),
        "scaffold_grad": lambda m, t: m.scaffold_grad_edit(t(g), t(c), t(a)),
        "scaffold_control": lambda m, t: m.scaffold_control_update(
            t(a), t(c), t(th), t(p), lr=0.1 / 0.5, num_steps=7),
    }
    _same_bits(cases[edit](jopt, _jt), cases[edit](topt, _tt))


def test_bf16_aggregation_helpers_match_dopt():
    """The screen, the masked means, the compact path's plain mean and
    the lane select, on bf16 lanes, bit for bit; ``mix_dense`` casts W to
    bf16 as dopt does (one bf16 rounding step: the two matmuls sum in
    another order)."""
    rng = np.random.default_rng(1)
    x, y, _ = _trees(rng)
    x["a"][2, 1, 1] = np.nan
    x["b"][4, 0] = np.inf
    np.testing.assert_array_equal(
        trobust.finite_lane_mask(_tt(x)).numpy(),
        np.asarray(jrobust.finite_lane_mask(_jt(x))))
    for mask in (np.array([1, 0, 1, 1, 0], np.float32),
                 np.zeros(5, np.float32), np.ones(5, np.float32)):
        _same_bits(jcoll.masked_average(_jt(y), jnp.asarray(mask)),
                   tcoll.masked_average(_tt(y), torch.tensor(mask)))
        _same_bits(jrobust.masked_mean(_jt(y), jnp.asarray(mask)),
                   trobust.masked_mean(_tt(y), torch.tensor(mask)))
        _same_bits(jcoll.where_mask(jnp.asarray(mask), _jt(x), _jt(y)),
                   tcoll.where_mask(torch.tensor(mask), _tt(x), _tt(y)))
    _same_bits({k: v.mean(axis=0) for k, v in _jt(y).items()},
               {k: v.mean(0) for k, v in _tt(y).items()})
    w = rng.random((5, 5)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    want = jcoll.mix_dense(_jt(y), jnp.asarray(w))
    got = tcoll.mix_dense(_tt(y), torch.tensor(w))
    for k in want:
        assert got[k].dtype == BF16
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=2 ** -7,
                                   atol=2 ** -7)


def test_bf16_flat_store_plan_and_layout():
    """The bucket plan of a bf16 tree is dopt's, every bucket of every row
    of a bf16 store starts 16-byte aligned, and the flat round trip is
    bit-exact."""
    rng = np.random.default_rng(2)
    tree = {k: _bf(rng.normal(size=s)) for k, s in
            (("w1", (6, 33, 5)), ("b1", (6, 33)), ("w2", (6, 10, 129)))}
    kw = dict(bucket_bytes=512)
    jspec = jcoll.make_update_shard_spec(_jt(tree), fold=1, **kw)
    spec = tcoll.make_update_shard_spec(_tt(tree), **kw)
    assert spec.dtype == BF16 and spec.bounds == tuple(jspec.bounds)
    flat = tcoll.alloc_flat(6, spec)
    assert flat.dtype == BF16
    for bucket in tcoll.flat_buckets(flat, spec):
        for r in range(6):
            assert bucket[r].data_ptr() % 16 == 0
    back = tcoll.buckets_to_stacked(tcoll.stacked_to_buckets(_tt(tree), spec),
                                    spec)
    for k, v in _tt(tree).items():
        assert torch.equal(back[k], v)


def test_argmax_ties_take_the_first_index():
    """bf16 logits tie often; the port's accuracy takes the first index
    on ties, as ``jnp.argmax`` does."""
    rng = np.random.default_rng(4)
    out = _bf(rng.integers(0, 3, size=(4, 64, 10)).astype(np.float32))
    y = rng.integers(0, 10, size=(4, 64)).astype(np.int32)
    w = np.ones((4, 64), np.float32)
    want = jlosses.accuracy_stacked(jnp.asarray(out), jnp.asarray(y),
                                    jnp.asarray(w))
    got = accuracy_stacked(torch.tensor(out), torch.tensor(y).long(),
                           torch.tensor(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the forward and the gradient ---------------------------------------

def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("faithful", [True, False])
def test_bf16_forward_and_grad_match_dopt(faithful, storage):
    w, b = 4, 16
    model = build_model("model1", faithful=faithful)
    keys = jax.random.split(jax.random.key(0), w)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs).astype(storage),
                           *[model.init(k, jnp.zeros((1, *SHAPE)))["params"]
                             for k in keys])
    rng = np.random.default_rng(5)
    x = rng.random((w, b, *SHAPE)).astype(np.float32)
    y = rng.integers(0, 10, (w, b)).astype(np.int32)
    wt = (rng.random((w, b)) > 0.1).astype(np.float32)

    def dopt_run(dtype):
        apply = make_stacked_apply(build_model("model1", faithful=faithful,
                                               dtype=dtype))

        def loss(p):
            out = apply(p, jnp.asarray(x))
            return jlosses.cross_entropy_stacked(
                out, jnp.asarray(y), jnp.asarray(wt)).sum(), out

        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
        grads = params_from_jax(jax.device_get(g), input_shape=SHAPE)
        return np.asarray(out), grads

    out16, g16 = dopt_run("bfloat16")
    out32, g32 = dopt_run("float32")
    tp = {k: torch.tensor(v).to(getattr(torch, storage)).requires_grad_()
          for k, v in params_from_jax(jax.device_get(stacked),
                                      input_shape=SHAPE).items()}
    with full_f32(torch.device("cpu")):
        out = stacked_cnn_forward(tp, torch.tensor(x), faithful=faithful,
                                  dtype=BF16)
        loss = cross_entropy_stacked(out, torch.tensor(y).long(),
                                     torch.tensor(wt)).sum()
        grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    assert out.dtype == torch.float32
    names = sorted(g16)
    for k in names:
        assert grads[k].dtype == getattr(torch, storage)
        print(f"  grad {k}: port vs dopt bf16 "
              f"{_rel_l2(_np(grads[k]), g16[k]):.2e}, dopt bf16 vs f32 "
              f"{_rel_l2(g16[k], g32[k]):.2e}")
    cat = np.concatenate
    d_out, ref_out = (_rel_l2(out.detach().numpy(), out16),
                      _rel_l2(out16, out32))
    d_g = _rel_l2(cat([_np(grads[k]).ravel() for k in names]),
                  cat([g16[k].ravel() for k in names]))
    ref_g = _rel_l2(cat([g16[k].ravel() for k in names]),
                    cat([g32[k].ravel() for k in names]))
    print(f"faithful={faithful} storage={storage}: output port vs dopt bf16 "
          f"{d_out:.2e}, dopt bf16 vs f32 {ref_out:.2e}; gradient "
          f"{d_g:.2e} vs {ref_g:.2e}")
    assert d_out <= ref_out / 4
    assert d_g <= ref_g / 4


# -- trainer runs ---------------------------------------------------------

def _cfg(mod, engine, *, compute="bfloat16", param="float32", faithful=True,
         clip=0.0, fused=False, algorithm="fedavg", compact=None,
         holdout=0.0, **kw):
    sec = ({"gossip": mod.GossipConfig(
               algorithm="dsgd", topology="circle", mode="stochastic",
               rounds=2, local_ep=1, local_bs=16,
               fused_update="on" if fused else "off")}
           if engine == "gossip" else
           {"federated": mod.FederatedConfig(
               algorithm=algorithm, frac=0.5, rounds=2,
               local_ep=2 if holdout else 1, local_bs=16, compact=compact,
               fused_update="on" if fused else "off")})
    return mod.ExperimentConfig(
        name="parity", seed=11,
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=32, local_holdout=holdout,
                            holdout_mode="deterministic"),
        model=mod.ModelConfig(model="model1", input_shape=SHAPE,
                              faithful=faithful, compute_dtype=compute,
                              param_dtype=param),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, rho=0.1,
                                  clip_norm=clip, fused_update=fused),
        **sec, **kw)


def _flat(tree) -> np.ndarray:
    return np.concatenate([_np(tree[layer][k]).ravel()
                           for layer in sorted(tree)
                           for k in sorted(tree[layer])])


def _runs(engine, kw):
    """dopt's bf16 leg, dopt's f32 leg (same config in f32) and the
    port's bf16 leg from dopt's init; each as (History rows, [flat
    params...]): worker params, and theta for the federated engine."""
    jcls, tcls = ((JaxGossipTrainer, GossipTrainer) if engine == "gossip"
                  else (JaxFederatedTrainer, FederatedTrainer))
    f32 = {**kw, "compute": "float32", "param": "float32"}
    j16 = jcls(_cfg(J, engine, mesh_devices=1, **kw))
    j32 = jcls(_cfg(J, engine, mesh_devices=1, **f32))
    init = jax.device_get(
        jax.tree.map(lambda x: x[0], j16.params) if engine == "gossip"
        else j16._theta_single())
    port = tcls(_cfg(T, engine, **kw), device="cpu", init_params=init)
    out = {}
    for name, tr in (("dopt16", j16), ("dopt32", j32), ("port16", port)):
        rows = tr.run(rounds=2).rows
        if name == "port16":
            ps = [params_to_jax(tr.worker_params(), input_shape=SHAPE)]
            if engine == "federated":
                ps.append(params_to_jax(tr.global_params(),
                                        input_shape=SHAPE))
        else:
            ps = [jax.device_get(tr.worker_params() if engine == "gossip"
                                 else tr.params)]
            if engine == "federated":
                ps.append(jax.device_get(tr._theta_single()))
        out[name] = (rows, [_flat(p) for p in ps])
    return out, port


def _hold_to_dopt(runs, loss_keys, acc_key):
    def dist(a, b):
        (ra, pa), (rb, pb) = runs[a], runs[b]
        d = {k: max(abs(x[k] - y[k]) for x, y in zip(ra, rb, strict=True))
             for k in (*loss_keys, acc_key)}
        d["params"] = max(_rel_l2(x, y) for x, y in zip(pa, pb))
        return d

    got, ref = dist("port16", "dopt16"), dist("dopt16", "dopt32")
    for k in got:
        print(f"  {k}: port vs dopt bf16 {got[k]:.3e}, dopt bf16 vs f32 "
              f"{ref[k]:.3e}")
    for k in loss_keys:
        assert got[k] <= max(ref[k], 1e-3), k
    assert got[acc_key] <= ref[acc_key]
    assert got["params"] <= ref["params"]


@pytest.mark.parametrize("kw", [
    dict(fused=True),
    dict(faithful=False, clip=1.0, fused=True),
    dict(param="bfloat16", fused=True),
], ids=["faithful-bf16", "idiomatic-bf16-clip", "bf16-storage"])
def test_gossip_bf16_matches_dopt(kw):
    runs, port = _runs("gossip", kw)
    _hold_to_dopt(runs, ("avg_train_loss",), "avg_test_acc")
    pdt = getattr(torch, kw.get("param", "float32"))
    assert port._params[0].dtype == port.momentum[0].dtype == pdt
    assert port._q.dtype == port._fbuf.dtype == pdt


@pytest.mark.parametrize("kw,compact", [
    (dict(param="bfloat16", fused=True), False),
    (dict(param="bfloat16", algorithm="fedprox", clip=1.0, holdout=0.1),
     True),
], ids=["fedavg-fused-bf16-storage", "fedprox-compact-clip-holdout"])
def test_federated_bf16_matches_dopt(kw, compact):
    runs, port = _runs("federated", kw)
    assert port._use_compact() == compact
    _hold_to_dopt(runs, ("train_loss", "local_loss"), "test_acc")
    assert all(v.dtype == BF16 for v in (*port.params.values(),
                                         *port.momentum.values(),
                                         *port._theta().values()))


def test_bf16_storage_holds_every_federated_state_in_bf16():
    for algo, fused in (("fedadmm", False), ("scaffold", False),
                        ("fedprox", True)):
        tr = FederatedTrainer(_cfg(T, "federated", param="bfloat16",
                                   algorithm=algo, fused=fused), device="cpu")
        tr.run(rounds=1)
        states = [*tr.params.values(), *tr.momentum.values(),
                  *tr._theta().values()]
        if fused:
            states += [tr._theta_flat, tr._disp_flat]
        if tr.duals is not None:
            states += list(tr.duals.values())
        if tr.c_global is not None:
            states += list(tr.c_global.values())
        assert all(s.dtype == BF16 for s in states), algo
        assert all(np.isfinite(v).all() for v in tr.global_params().values())


@pytest.mark.parametrize("engine", ["gossip", "federated"])
def test_f32_clip_matches_dopt_at_slice1_limits(engine):
    """The clip does not depend on the dtype: with f32 compute and
    storage it holds to dopt as tightly as the unclipped f32 path, and it
    binds (the unclipped run ends elsewhere)."""
    kw = dict(compute="float32", faithful=False, clip=1.0)
    if engine == "federated":
        kw.update(algorithm="fedprox", holdout=0.1)
    runs, port = _runs(engine, kw)
    loss_keys = (("avg_train_loss",) if engine == "gossip"
                 else ("train_loss", "local_loss", "test_loss"))
    acc = "avg_test_acc" if engine == "gossip" else "test_acc"
    (rj, pj), (rt, pt) = runs["dopt32"], runs["port16"]
    for a, b in zip(rj, rt, strict=True):
        for k in loss_keys:
            assert abs(a[k] - b[k]) <= 1e-3, (k, a, b)
        assert abs(a[acc] - b[acc]) <= 1e-4, (a, b)
    for x, y in zip(pj, pt):
        assert np.abs(x - y).max() / np.abs(x).max() <= 1e-4
    cls = GossipTrainer if engine == "gossip" else FederatedTrainer
    free = cls(_cfg(T, engine, **{**kw, "clip": 0.0}), device="cpu")
    free.run(rounds=2)
    clipped = cls(_cfg(T, engine, **kw), device="cpu")
    clipped.run(rounds=2)
    a, b = free.worker_params(), clipped.worker_params()
    assert max(np.abs(a[k] - b[k]).max() for k in a) > 1e-4


# -- weights across the package boundary --------------------------------

def test_convert_round_trips_bf16_bit_for_bit():
    model = build_model("model1", faithful=True)
    keys = jax.random.split(jax.random.key(1), 3)
    tree = jax.device_get(jax.tree.map(
        lambda *xs: jnp.stack(xs).astype(jnp.bfloat16),
        *[model.init(k, jnp.zeros((1, *SHAPE)))["params"] for k in keys]))
    port = {k: torch.from_numpy(v).to(BF16)
            for k, v in params_from_jax(tree, input_shape=SHAPE).items()}
    back = params_to_jax(port, input_shape=SHAPE)
    for layer in tree:
        for k, v in tree[layer].items():
            assert back[layer][k].dtype == np.float32
            np.testing.assert_array_equal(back[layer][k], _np(v))
    again = {k: torch.from_numpy(v).to(BF16)
             for k, v in params_from_jax(back, input_shape=SHAPE).items()}
    for k, v in port.items():
        assert torch.equal(again[k], v)
        assert again[k].view(torch.int16).equal(v.view(torch.int16))
