"""dopt's keyed draws, choco's compressors and the narrowed wire in the
port, against dopt (the engines' runs are in test_torch_codecs_engines).

* Draws: ``dopt_torch.utils.prng`` computes jax's threefry2x32 keys and
  uniforms (partitionable mode) bit for bit — seeds, shapes past 2**20
  elements, chained ``fold_in``s, the per-lane fold of
  ``lane_fold_keys``, a round index folded in from device data.
* Compressors on a Model1 tree, f32 and bf16, in dopt's layout and in
  the port's (through ``dopt_flat_order``): top-k and rand-k bit for
  bit, whatever the dict's insertion order.  QSGD draws the same bits
  but sums its bucket norms in another order than XLA's, so it is held
  to: every element within 1e-6 relative of dopt's, except at most
  1e-4 of them, which differ by exactly one quantization level
  (‖bucket‖/s).  dopt's own statistical checks
  (tests/test_compression.py) run as cases of one test, and
  ``make_compressor`` refuses what dopt's refuses, in dopt's words.
* ``mix_dense`` and ``masked_average`` with ``comm_dtype`` equal dopt's
  one-device-mesh forms within 1e-6 relative, f32 and bf16 storage,
  and differ from the unnarrowed results.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dopt.ops.compression as JC
import dopt_torch.ops.compression as TC
from dopt.parallel.collectives import masked_average as j_masked_average
from dopt.parallel.collectives import mix_dense as j_mix_dense
from dopt_torch.convert import dopt_flat_order, params_to_jax
from dopt_torch.models.zoo import param_shapes
from dopt_torch.parallel.collectives import (masked_average, mix_dense,
                                             wire_dtype)
from dopt_torch.utils import prng

SHAPE = (8, 8, 1)     # Model1's every layout at a small fc1
FULL = (28, 28, 1)    # the headline's Model1: fc1 of 1,605,632 a worker
W = 4
SEED = 7 ^ 0x0C0C0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_jax_runs_threefry_partitionable():
    """The port copies jax's partitionable threefry; a change of jax's
    default would change dopt's draws, not the port's."""
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def _key_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, SEED, 2**31, 2**32 - 1, 2**32 + 5,
                                  -1, -2**31 - 1, 2**63 - 1, -2**63])
def test_key_and_fold_in_match_jax(seed):
    jk, tk = jax.random.key(seed), prng.jax_key(seed)
    np.testing.assert_array_equal(_key_words(jk), tk.numpy())
    for d in (0, 1, 316, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(
            _key_words(jax.random.fold_in(jk, d)), prng.fold_in(tk, d).numpy())


@pytest.mark.parametrize("shape", [(1,), (5,), (6, 1000), (2, 3, 7),
                                   (3, 400_000), (1, 2049)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("chain", [(), (3,), (3, 1), (2**32 - 1, 0, 17)],
                         ids=lambda c: "fold" + "-".join(map(str, c)))
def test_uniform_matches_jax(shape, chain):
    """Bit for bit over 1-D to 3-D shapes (one past 2**20 elements) and
    chained folds, with the first fold from device data as choco's
    round index is."""
    jk, tk = jax.random.key(SEED), prng.jax_key(SEED)
    for i, d in enumerate(chain):
        jk = jax.random.fold_in(jk, d)
        tk = prng.fold_in(tk, torch.tensor([d & 0xFFFFFFFF], dtype=torch.int64)
                          if i == 0 else d)
    np.testing.assert_array_equal(_bits(jax.random.uniform(jk, shape)),
                                  _bits(prng.uniform(tk, shape)))


def test_lane_fold_keys_match_jax():
    """dopt's per-lane vmapped fold (``lane_fold_keys``) and the draws
    from each lane's key."""
    base = jax.random.fold_in(jax.random.key(3), 9)
    lanes = jnp.arange(6, dtype=jnp.int32)
    want = JC.lane_fold_keys(base, lanes)
    tb = prng.fold_in(prng.jax_key(3), 9)
    draws = jax.vmap(lambda k: jax.random.uniform(k, (4, 33)))(want)
    for i in range(6):
        tk = prng.fold_in(tb, torch.tensor([i], dtype=torch.int32))
        np.testing.assert_array_equal(_key_words(want[i]), tk.numpy())
        np.testing.assert_array_equal(_bits(draws[i]),
                                      _bits(prng.uniform(tk, (4, 33))))


@pytest.mark.parametrize("call,exc", [
    (lambda: prng.jax_key(2**63), OverflowError),
    (lambda: prng.jax_key(-2**63 - 1), OverflowError),
    (lambda: prng.jax_key(1.5), TypeError),
    (lambda: prng.fold_in(prng.jax_key(1), -1), OverflowError),
    (lambda: prng.fold_in(prng.jax_key(1), 2**32), OverflowError),
])
def test_key_refusals_as_jax(call, exc):
    with pytest.raises(exc):
        call()


def test_jax_refuses_the_same_keys():
    for bad in (2**63, 2**64):
        with pytest.raises(OverflowError):
            jax.random.key(bad)
    for bad in (-1, 2**32):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jax.random.key(1), bad)


# -- compressors on a Model1 tree ----------------------------------------
def _model1_tree(seed: int = 0, ties: bool = True,
                 shape=SHAPE) -> dict[str, np.ndarray]:
    """A stacked ``[W, ...]`` Model1 tree in the port's layout, with runs
    of equal magnitudes (both signs) so top-k meets ties at its k-th
    place."""
    rng = np.random.default_rng(seed)
    shapes = param_shapes("model1", num_classes=10, input_shape=shape)
    tree = {k: rng.standard_normal((W, *s)).astype(np.float32)
            for k, s in shapes.items()}
    if ties:
        sign = np.where(rng.random(3000) < 0.5, -1.0, 1.0)
        tree["fc1.weight"].reshape(W, -1)[:, :3000] = 2.5 * sign
        tree["conv2.weight"].reshape(W, -1)[:, ::7] = -0.75
        tree["fc2.bias"][:, :4] = 0.0
    return tree


TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _run_both(name: str, dtype: str, layout: str, *, order_seed=None,
              ratio=0.1, levels=16, tree_seed=0, shape=SHAPE):
    """dopt's compressor on its tree and the port's on the same values
    (in the port's layout with the index maps, or in dopt's without):
    dopt's result, the port's and dopt's input, each in dopt's layout as
    f32 arrays."""
    port = _model1_tree(tree_seed, shape=shape)
    jtree = params_to_jax(port, input_shape=shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jt = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), jtree)
    key = jax.random.fold_in(jax.random.key(SEED), 3)
    tkey = prng.fold_in(prng.jax_key(SEED), 3)
    jfn = {"topk": lambda t: JC.top_k_compress(t, ratio),
           "randk": lambda t: JC.rand_k_compress(t, ratio, key),
           "qsgd": lambda t: JC.qsgd_compress(t, ratio, key, levels=levels)}
    tfn = {"topk": lambda t, o: TC.top_k_compress(t, ratio, order=o),
           "randk": lambda t, o: TC.rand_k_compress(t, ratio, tkey, order=o),
           "qsgd": lambda t, o: TC.qsgd_compress(t, ratio, tkey, order=o,
                                                 levels=levels)}
    want = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jax.device_get(jfn[name](jt)))
    given = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jt)
    if layout == "port":
        names = list(port)
        if order_seed is not None:
            np.random.default_rng(order_seed).shuffle(names)
        tt = {k: torch.from_numpy(port[k]).to(TORCH_DT[dtype]) for k in names}
        shapes = {k: v.shape[1:] for k, v in port.items()}
        order = TC.device_order(dopt_flat_order(shapes, input_shape=shape))
        out = tfn[name](tt, order)
        assert list(out) == sorted(names)
        got = params_to_jax({k: v.float().numpy() for k, v in out.items()},
                            input_shape=shape)
    else:
        leaves = {f"{layer}.{k}": np.asarray(jt[layer][k].astype(jnp.float32))
                  for layer in jt for k in jt[layer]}
        tt = {k: torch.from_numpy(v.copy()).to(TORCH_DT[dtype])
              for k, v in leaves.items()}
        out = tfn[name](tt, None)
        got = {}
        for k, v in out.items():
            layer, leaf = k.split(".")
            got.setdefault(layer, {})[leaf] = v.float().numpy()
    return want, got, given


SPARSIFIER_CASES = [(name, dtype, layout, SHAPE)
                    for name in ("topk", "randk")
                    for dtype in ("float32", "bfloat16")
                    for layout in ("port", "dopt")]
SPARSIFIER_CASES += [(name, "float32", "port", FULL)
                     for name in ("topk", "randk")]


@pytest.mark.parametrize("name,dtype,layout,shape", SPARSIFIER_CASES,
                         ids=lambda v: ("x".join(map(str, v[:2]))
                                        if isinstance(v, tuple) else v))
def test_sparsifiers_bit_for_bit(name, dtype, layout, shape):
    want, got, _ = _run_both(name, dtype, layout, shape=shape)
    for layer in want:
        for k in want[layer]:
            np.testing.assert_array_equal(_bits(want[layer][k]),
                                          _bits(got[layer][k]),
                                          err_msg=f"{layer}.{k}")


@pytest.mark.parametrize("name", ["topk", "randk", "qsgd"])
def test_leaf_order_is_dopts_whatever_the_insertion_order(name):
    """The port folds leaf i over sorted names (dopt's flatten order),
    not over the dict's insertion order."""
    a, _, _ = _run_both(name, "float32", "port")
    _, b, _ = _run_both(name, "float32", "port", order_seed=5)
    _, c, _ = _run_both(name, "float32", "port")
    for layer in a:
        for k in a[layer]:
            np.testing.assert_array_equal(_bits(b[layer][k]),
                                          _bits(c[layer][k]))
            if name != "qsgd":
                np.testing.assert_array_equal(_bits(a[layer][k]),
                                              _bits(b[layer][k]))


def _qsgd_within_bound(want: dict, got: dict, given: dict, levels: int,
                       dtype: str) -> None:
    """Every element within 1e-6 relative of dopt's, except at most 1e-4
    of all elements, which are one level (the input bucket's norm / s)
    away.  In bf16 both results are rounded once more: such an element
    is one level away within that rounding, or one bf16 step (the f32
    results straddled a bf16 rounding boundary)."""
    total = off = 0
    for layer in want:
        for k in want[layer]:
            a = want[layer][k].reshape(W, -1)
            b = got[layer][k].reshape(W, -1)
            d = np.abs(a - b)
            bad = d > 1e-6 * np.abs(a)
            total += a.size
            if not bad.any():
                continue
            off += int(bad.sum())
            x = given[layer][k].reshape(W, -1).astype(np.float64)
            n = x.shape[1]
            bsz = min(2048, n)
            x = np.pad(x, ((0, 0), (0, -(-n // bsz) * bsz - n)))
            step = np.repeat(np.sqrt((x ** 2).reshape(W, -1, bsz).sum(2)),
                             bsz, axis=1)[:, :n] / levels
            tol = 1e-5 * step
            if dtype == "bfloat16":
                # Each side's bf16 rounding moves it by up to 2**-9 of it.
                tol = tol + 2.0**-8 * np.maximum(np.abs(a), np.abs(b))
            one_level = np.abs(d - step) <= tol
            if dtype == "bfloat16":
                one_level |= d <= 2.0**-7 * np.abs(a)
            assert one_level[bad].all(), (f"{layer}.{k}", d[bad], step[bad])
    assert off <= 1e-4 * total, (off, total)


@pytest.mark.parametrize("layout", ["port", "dopt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels,tree_seed", [(16, 0), (4, 1), (256, 2)])
def test_qsgd_within_stated_bound(levels, tree_seed, dtype, layout):
    want, got, given = _run_both("qsgd", dtype, layout, levels=levels,
                                 tree_seed=tree_seed)
    _qsgd_within_bound(want, got, given, levels, dtype)


# dopt's statistical checks (tests/test_compression.py:22-56, :142-209),
# on the port's compressors.
def _small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 10)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(4, 3, 5)).astype(
                np.float32))}


def _key(i: int) -> torch.Tensor:
    return prng.jax_key(i)


def _topk_keeps_largest():
    tree = _small_tree()
    out = TC.top_k_compress(tree, 0.3)
    for k in tree:
        x = tree[k].numpy().reshape(4, -1)
        y = out[k].numpy().reshape(4, -1)
        keep = int(np.ceil(0.3 * x.shape[1]))
        for w in range(4):
            nz = np.nonzero(y[w])[0]
            assert len(nz) == keep
            thresh = np.sort(np.abs(x[w]))[-keep]
            assert np.all(np.abs(x[w][nz]) >= thresh - 1e-12)
            np.testing.assert_array_equal(y[w][nz], x[w][nz])


def _ratio_one_is_identity():
    tree = _small_tree()
    for name in ("topk", "randk", "none"):
        out = TC.make_compressor(name, 1.0)(tree, _key(0))
        for k in tree:
            np.testing.assert_array_equal(out[k].numpy(), tree[k].numpy())


def _randk_unbiased_rescaling():
    out = TC.rand_k_compress({"a": torch.ones(2, 2000)}, 0.25, _key(3))
    y = out["a"].numpy()
    np.testing.assert_allclose(y[y != 0], 4.0)
    assert abs(y.mean() - 1.0) < 0.15


def _qsgd_unbiased_and_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 4000)).astype(np.float32))
    acc = np.zeros((2, 4000), np.float64)
    for i in range(50):
        acc += TC.qsgd_compress({"a": x}, 0.25, _key(i),
                                bucket_size=256)["a"].numpy()
    assert np.abs(acc / 50 - x.numpy()).mean() < 0.03
    z = TC.qsgd_compress({"a": torch.zeros(2, 8)}, 0.25, _key(0))
    np.testing.assert_array_equal(z["a"].numpy(), 0.0)


def _randk_fixed_cardinality():
    x = {"a": torch.ones(4, 100), "b": torch.ones(4, 7)}
    out = TC.rand_k_compress(x, 0.25, _key(0))
    for name, n, k in (("a", 100, 25), ("b", 7, 2)):
        vals = out[name].numpy()
        np.testing.assert_array_equal(np.count_nonzero(vals, axis=1), k)
        assert np.allclose(vals[vals != 0], n / k, rtol=1e-6)
    means = np.mean([TC.rand_k_compress(x, 0.25, _key(s))["a"].numpy().mean()
                     for s in range(64)])
    assert abs(means - 1.0) < 0.05


def _qsgd_levels_knob():
    x = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 512)).astype(np.float32))}
    c4 = TC.make_compressor("qsgd", 1.0, qsgd_levels=4)
    c256 = TC.make_compressor("qsgd", 1.0)
    e4 = float((c4(x, _key(1))["w"] - x["w"]).abs().mean())
    e256 = float((c256(x, _key(1))["w"] - x["w"]).abs().mean())
    assert e4 > 3 * e256 > 0


@pytest.mark.parametrize("check", [
    _topk_keeps_largest, _ratio_one_is_identity, _randk_unbiased_rescaling,
    _qsgd_unbiased_and_bounded, _randk_fixed_cardinality, _qsgd_levels_knob,
], ids=lambda f: f.__name__.lstrip("_"))
def test_dopts_statistical_checks(check):
    check()


@pytest.mark.parametrize("args,kw", [
    (("signsgd", 0.5), {}), (("randk", 0.0), {}), (("randk", -0.5), {}),
    (("topk", 1.5), {}), (("qsgd", 0.0), {}),
    (("topk", 0.5), {"qsgd_levels": 8}), (("randk", 0.5), {"qsgd_levels": 1}),
    (("qsgd", 1.0), {"qsgd_levels": -1}),
], ids=str)
def test_make_compressor_refusals_in_dopts_words(args, kw):
    with pytest.raises(ValueError) as want:
        JC.make_compressor(*args, **kw)
    with pytest.raises(ValueError) as got:
        TC.make_compressor(*args, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,ratio", [("none", 0.3), ("none", 5.0),
                                        ("topk", 1.0), ("randk", 1.0)])
def test_make_compressor_identity_cases(name, ratio):
    tree = _small_tree(1)
    out = TC.make_compressor(name, ratio)(tree, _key(0))
    jout = JC.make_compressor(name, ratio)(
        {k: jnp.asarray(v.numpy()) for k, v in tree.items()},
        jax.random.key(0))
    for k in tree:
        assert out[k] is tree[k]
        np.testing.assert_array_equal(np.asarray(jout[k]), tree[k].numpy())


# -- the narrowed wire ---------------------------------------------------
@pytest.fixture(scope="module")
def one_mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]), ("w",))


def _stack(seed: int, storage: str, w: int = 6):
    rng = np.random.default_rng(seed)
    host = {"a": rng.standard_normal((w, 7, 5)).astype(np.float32),
            "b": (rng.standard_normal((w, 300)) * 40).astype(np.float32)}
    jdt = jnp.float32 if storage == "float32" else jnp.bfloat16
    jt = {k: jnp.asarray(v).astype(jdt) for k, v in host.items()}
    tt = {k: torch.from_numpy(v.copy()).to(TORCH_DT[storage])
          for k, v in host.items()}
    return jt, tt


def _rel(a, b) -> float:
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.float().numpy()
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_mix_dense_narrowed_matches_dopt(storage, one_mesh, devices):
    jt, tt = _stack(0, storage)
    wm = np.random.default_rng(1).random((6, 6)).astype(np.float32)
    wm /= wm.sum(1, keepdims=True)
    want = j_mix_dense(jt, jnp.asarray(wm), one_mesh, jnp.bfloat16)
    got = mix_dense(tt, torch.from_numpy(wm), torch.bfloat16)
    plain = mix_dense(tt, torch.from_numpy(wm))
    for k in tt:
        assert got[k].dtype == tt[k].dtype and got[k].shape == tt[k].shape
        assert _rel(want[k], got[k]) <= 1e-6, k
        assert not torch.equal(got[k], plain[k]), k


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [[1, 0, 1, 1, 0, 1], [0] * 6, [1] * 6],
                         ids=["some", "none", "all"])
def test_masked_average_narrowed_matches_dopt(storage, mask, one_mesh,
                                              devices):
    jt, tt = _stack(2, storage)
    m = np.asarray(mask, np.float32)
    want = j_masked_average(jt, jnp.asarray(m), mesh=one_mesh,
                            comm_dtype=jnp.bfloat16)
    got = masked_average(tt, torch.from_numpy(m), torch.bfloat16)
    plain = masked_average(tt, torch.from_numpy(m))
    for k in tt:
        assert got[k].dtype == tt[k].dtype
        if not m.any():
            np.testing.assert_array_equal(got[k].float().numpy(), 0.0)
            continue
        assert _rel(want[k], got[k]) <= 1e-6, k
        if storage == "float32":
            assert not torch.equal(got[k], plain[k]), k


@pytest.mark.parametrize("name,want", [(None, None), ("", None),
                                       ("float32", torch.float32),
                                       ("bfloat16", torch.bfloat16),
                                       ("float16", torch.float16)])
def test_wire_dtypes(name, want):
    assert wire_dtype(name) == want


def test_wire_dtype_refused_by_name():
    with pytest.raises(ValueError, match="unknown comm_dtype 'bf16'"):
        wire_dtype("bf16")


def test_flat_order_inverts_the_layout():
    """A tensor read through its map is dopt's leaf flattened."""
    port = _model1_tree(3, ties=False)
    order = dopt_flat_order({k: v.shape[1:] for k, v in port.items()},
                            input_shape=SHAPE)
    jtree = params_to_jax(port, input_shape=SHAPE)
    for name, fwd in order.items():
        layer, leaf = name.split(".")
        want = jtree[layer]["kernel" if leaf == "weight" else leaf]
        flat = port[name].reshape(W, -1)
        got = flat if fwd is None else flat[:, fwd]
        np.testing.assert_array_equal(got, want.reshape(W, -1))
    assert order["conv1.bias"] is None and order["fc1.weight"] is not None
    assert math.prod(port["fc1.weight"].shape[1:]) == order["fc1.weight"].size
