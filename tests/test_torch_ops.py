"""dopt_torch.ops / dopt_torch.parallel against dopt's Pallas kernels.

JAX runs the Pallas kernels in interpret mode (as tests/test_ops.py
does on the CPU); the port's wrappers take their plain PyTorch versions
because the tensors lie on the CPU.  Inputs come from seeded numpy.
Tolerances: 1e-6 for f32 (the tests/test_ops.py standard — the same f32
ops, only the summation/FMA association may differ), one bf16 rounding
step (2e-2, as tests/test_ops.py:136) for bf16 storage, and bit-exact
for the pure reshapes of the bucket layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dopt.ops import fused_mix_sgd as jax_fused_mix_sgd
from dopt.ops import fused_mix_update as jax_fused_mix_update
from dopt.ops import fused_sgd_momentum as jax_fused_sgd_momentum
from dopt.parallel import collectives as jcoll
from dopt_torch.ops import (fused_mix_sgd, fused_mix_update,
                            fused_sgd_momentum, mix_sgd_reference)
from dopt_torch.ops import fused_update as tops
from dopt_torch.ops._build import parse_ptxas
from dopt_torch.parallel import collectives as tcoll


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once, and torch's default (all cores each) oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    """A torch copy of a numpy array (never sharing its memory)."""
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("shape", [(7,), (128,), (513,), (32, 33),
                                   (4, 100, 17)])
def test_fused_sgd_momentum_matches_pallas(shape):
    rng = np.random.default_rng(0)
    p, m, g = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want_p, want_m = jax_fused_sgd_momentum(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(g), lr=0.1, mu=0.5,
        interpret=True)
    tp, tm = _t(p), _t(m)
    ptrs = (tp.data_ptr(), tm.data_ptr())
    fused_sgd_momentum([tp], [tm], [_t(g)], lr=0.1, mu=0.5)
    assert (tp.data_ptr(), tm.data_ptr()) == ptrs   # in place
    np.testing.assert_allclose(tp.numpy(), np.asarray(want_p), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tm.numpy(), np.asarray(want_m), rtol=1e-6,
                               atol=1e-7)


def test_fused_sgd_momentum_multi_tensor_and_bf16():
    """One call over several tensors (the trainer's per-step list) and
    bf16 storage with f32 math, against the Pallas kernel leaf by leaf."""
    rng = np.random.default_rng(1)
    shapes = [(6, 32, 1, 5, 5), (6, 32), (6, 10, 512), (3,)]
    for dtype, jdt, tol in ((torch.float32, jnp.float32, 1e-6),
                            (torch.bfloat16, jnp.bfloat16, 2e-2)):
        leaves = [[rng.normal(size=s).astype(np.float32) for s in shapes]
                  for _ in range(3)]
        tp, tm, tg = ([_t(a).to(dtype) for a in ls] for ls in leaves)
        fused_sgd_momentum(tp, tm, tg, lr=0.05, mu=0.9)
        for i in range(len(shapes)):
            jp, jm = jax_fused_sgd_momentum(
                *(jnp.asarray(ls[i]).astype(jdt) for ls in leaves),
                lr=0.05, mu=0.9, interpret=True)
            np.testing.assert_allclose(tp[i].float().numpy(),
                                       np.asarray(jp, np.float32),
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(tm[i].float().numpy(),
                                       np.asarray(jm, np.float32),
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("n,f", [(6, 137), (5, 1000), (8, 128), (3, 1),
                                 (12, 1001), (16, 2053), (32, 333)])
def test_fused_mix_sgd_matches_pallas(n, f):
    rng = np.random.default_rng(3)
    p = rng.normal(size=(n, f)).astype(np.float32)
    m = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.dirichlet(np.ones(n), size=n).astype(np.float32)
    want = jax_fused_mix_sgd(jnp.asarray(p), jnp.asarray(m), jnp.asarray(w),
                             lr=0.05, interpret=True)
    tp = _t(p)
    fused_mix_sgd(tp, _t(m), _t(w), lr=0.05)
    np.testing.assert_allclose(tp.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("alive", [5, 0])
def test_fused_mix_sgd_federated_form(alive):
    """The federated epilogue: lr = −1, p the displacement store with the
    masked rows zeroed, buf the theta slab (one row repeated), W the
    masked-mean matrix — θ' = M·disp + θ on every row.  An all-dead mask
    gives M = 0 and keeps θ exactly."""
    n, f = 16, 1037
    rng = np.random.default_rng(8)
    mask = np.zeros(n, np.float32)
    mask[rng.permutation(n)[:alive]] = 1.0
    disp = rng.normal(size=(n, f)).astype(np.float32) * mask[:, None]
    theta = np.broadcast_to(rng.normal(size=(1, f)).astype(np.float32),
                            (n, f)).copy()
    jw = np.asarray(jcoll.mean_weight_matrix(jnp.asarray(mask)))
    tw = tcoll.mean_weight_matrix(_t(mask))
    np.testing.assert_array_equal(tw.numpy(), jw)
    want = jax_fused_mix_sgd(jnp.asarray(disp), jnp.asarray(theta),
                             jnp.asarray(jw), lr=-1.0, interpret=True)
    tp = _t(disp)
    fused_mix_sgd(tp, _t(theta), tw, lr=-1.0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    mean = disp.sum(0) / max(alive, 1)
    np.testing.assert_allclose(tp.numpy(), np.broadcast_to(
        theta[0] + mean, (n, f)), rtol=1e-6, atol=1e-6)
    if not alive:
        np.testing.assert_array_equal(tp.numpy(), theta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mix_plan_fits_and_covers(dtype):
    """The ring kernel's tile plan for every n it serves (9..32): the
    tile is a power of two of at least 32 columns (so an aligned bucket's
    tiles start 16-byte aligned), a stage (p + buf) stays within its
    target, the block's shared memory within the 227 KB limit, and the
    whole tiles plus the ragged tail cover F exactly, for the main path's
    bucket widths."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for n in range(tops.MIX_NARROW_N + 1, tops.MAX_MIX_N + 1):
        plan = tops.mix_plan(n, itemsize)
        bf = plan.tile_cols
        assert 32 <= bf <= tops.MIX_MAX_TILE and bf & (bf - 1) == 0
        assert (bf * itemsize) % 16 == 0
        assert 2 * n * bf * itemsize <= tops.MIX_STAGE_BYTES
        assert plan.smem_bytes == (tops.MIX_W_BYTES + tops.MIX_STAGES * 2 * n
                                   * bf * itemsize) <= tops.MIX_MAX_SMEM
        for f in (1, 31, bf, bf + 1, 65_537, 614_794, 1_048_576):
            whole, tail = divmod(f, bf)   # ring tiles, then the tail
            assert whole * bf + tail == f and 0 <= tail < bf
    # The federated call site (n = 16, f32) stages [16, 256] tiles.
    assert tops.mix_plan(16, 4) == (256, 4096 + 3 * 2 * 16 * 256 * 4)


def test_parse_ptxas_report():
    """The spill guard's parser on ptxas's ``-v`` text (CUDA 12 format:
    the entry line, the properties block, the register line), with one
    kernel that spills and one that does not."""
    spill = "_ZN12_GLOBAL__N_114mix_sgd_kernelIfLi32ELi1ELi1EEEvPT_lPKS1_lPKfilfi"
    clean = ("_ZN12_GLOBAL__N_119mix_sgd_ring_kernelI13__nv_bfloat16EEvPT_l"
             "PKS2_lPKfilfil")
    text = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{spill}' for 'sm_90a'
ptxas info    : Function properties for {spill}
    3472 bytes stack frame, 3564 bytes spill stores, 3668 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 3472 bytes cumulative stack size, 412 bytes cmem[0]
ptxas info    : Compiling entry function '{clean}' for 'sm_90a'
ptxas info    : Function properties for {clean}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 416 bytes cmem[0]
"""
    got = parse_ptxas(text)
    assert got == {
        spill: {"registers": 255, "stack_frame": 3472, "spill_stores": 3564,
                "spill_loads": 3668},
        clean: {"registers": 64, "stack_frame": 0, "spill_stores": 0,
                "spill_loads": 0}}
    assert parse_ptxas("") == {}


def test_fused_mix_sgd_bf16_storage():
    rng = np.random.default_rng(4)
    p32 = rng.normal(size=(4, 300)).astype(np.float32)
    m32 = rng.normal(size=(4, 300)).astype(np.float32)
    w = rng.dirichlet(np.ones(4), size=4).astype(np.float32)
    want = jax_fused_mix_sgd(jnp.asarray(p32).astype(jnp.bfloat16),
                             jnp.asarray(m32).astype(jnp.bfloat16),
                             jnp.asarray(w), lr=0.1, interpret=True)
    tp = _t(p32).to(torch.bfloat16)
    fused_mix_sgd(tp, _t(m32).to(torch.bfloat16), _t(w), lr=0.1)
    assert tp.dtype == torch.bfloat16
    np.testing.assert_allclose(tp.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def _tree(rng):
    return {"a": rng.normal(size=(6, 33)).astype(np.float32),
            "b": rng.normal(size=(6, 5, 7)).astype(np.float32)}


def test_fused_mix_update_over_buckets_matches_pallas():
    """The flat-store epilogue over several buckets (fold 2, 64-byte
    buckets, as tests/test_ops.py:156) against dopt's tree wrapper."""
    rng = np.random.default_rng(5)
    tree, mom = _tree(rng), _tree(rng)
    w = rng.dirichlet(np.ones(6), size=6).astype(np.float32)
    jspec = jcoll.make_update_shard_spec(
        jax.tree.map(jnp.asarray, tree), fold=2, bucket_bytes=64)
    want = jax_fused_mix_update(jax.tree.map(jnp.asarray, tree),
                                jax.tree.map(jnp.asarray, mom), w, jspec,
                                lr=0.1, interpret=True)
    ttree = {k: _t(v) for k, v in tree.items()}
    spec = tcoll.make_update_shard_spec(ttree, fold=2, bucket_bytes=64)
    assert spec.num_buckets == jspec.num_buckets > 1
    fp, fb = tcoll.alloc_flat(6, spec), tcoll.alloc_flat(6, spec)
    for store, src in ((fp, ttree), (fb, mom)):
        for k, v in tcoll.flat_views(store, spec).items():
            v.copy_(torch.as_tensor(src[k]))
    fused_mix_update(fp, fb, _t(w), spec, lr=0.1)
    got = tcoll.flat_views(fp, spec)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fold,bucket_bytes", [(1, 4 << 20), (2, 64),
                                               (4, 100)])
def test_bucket_layout_bit_identical(fold, bucket_bytes):
    """Spec fields, bucket contents and the round trip, bit for bit."""
    rng = np.random.default_rng(6)
    tree = _tree(rng)
    jspec = jcoll.make_update_shard_spec(
        jax.tree.map(jnp.asarray, tree), fold=fold,
        bucket_bytes=bucket_bytes)
    ttree = {k: _t(v) for k, v in tree.items()}
    spec = tcoll.make_update_shard_spec(ttree, fold=fold,
                                        bucket_bytes=bucket_bytes)
    assert (spec.flat, spec.padded, spec.bounds, spec.shapes, spec.sizes) == (
        jspec.flat, jspec.padded, jspec.bounds, jspec.shapes, jspec.sizes)
    jb = jcoll.stacked_to_buckets(jax.tree.map(jnp.asarray, tree), jspec)
    tb = tcoll.stacked_to_buckets(ttree, spec)
    for a, b in zip(jb, tb, strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = tcoll.buckets_to_stacked(tb, spec)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])


def test_model1_buckets_at_full_width():
    """Model1 with six workers flattens to 1,663,370 a worker: two 4 MiB
    buckets, [6, 1,048,576] and [6, 614,794] — the main path's shapes."""
    from dopt_torch.models.zoo import param_shapes

    tree = {k: torch.empty(6, *s) for k, s in param_shapes("model1").items()}
    spec = tcoll.make_update_shard_spec(tree, bucket_bytes=4 << 20)
    assert spec.flat == 1_663_370
    assert [b - a for a, b in zip(spec.bounds, spec.bounds[1:])] == [
        1_048_576, 614_794]
    store = tcoll.alloc_flat(6, spec)
    assert store.stride(0) % 4 == 0 and store.stride(1) == 1


@pytest.mark.parametrize("mode", ["stochastic", "metropolis"])
def test_mix_dense_matches_jax(mode):
    from dopt_torch.topology import build_mixing_matrices

    rng = np.random.default_rng(7)
    tree = _tree(rng)
    w = build_mixing_matrices("circle", mode, 6, seed=3).for_round(0)
    want = jcoll.mix_dense(jax.tree.map(jnp.asarray, tree), w)
    got = tcoll.mix_dense({k: _t(v) for k, v in tree.items()},
                          _t(w.astype(np.float32)))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


def test_wrappers_validate_and_count_only_launches():
    """Bad shapes raise; n > 32 raises; CPU tensors take the plain
    version without touching the launch counters."""
    before = (fused_sgd_momentum.launches, fused_mix_sgd.launches)
    with pytest.raises(ValueError, match="differ"):
        fused_sgd_momentum([torch.zeros(3)], [torch.zeros(3)],
                           [torch.zeros(4)], lr=0.1, mu=0.5)
    with pytest.raises(ValueError, match="non-contiguous"):
        z = torch.zeros(4, 4).t()
        fused_sgd_momentum([z], [z], [z], lr=0.1, mu=0.5)
    with pytest.raises(ValueError, match="n <= 32"):
        fused_mix_sgd(torch.zeros(33, 4), torch.zeros(33, 4),
                      torch.eye(33), lr=1.0)
    with pytest.raises(ValueError, match="unit column stride"):
        fused_mix_sgd(torch.zeros(4, 6).t(), torch.zeros(6, 4),
                      torch.eye(6), lr=1.0)
    p = torch.ones(2, 3)
    fused_mix_sgd(p, torch.ones(2, 3), torch.full((2, 2), 0.5), lr=0.25)
    np.testing.assert_allclose(p.numpy(), np.full((2, 3), 0.75))
    assert (fused_sgd_momentum.launches, fused_mix_sgd.launches) == before


def test_mix_reference_is_in_place_on_strided_views():
    """The plain version writes through a row-strided bucket view."""
    store = torch.zeros(3, 10)
    view = store[:, 2:7]
    view.copy_(torch.arange(15.0).reshape(3, 5))
    mix_sgd_reference(view, torch.ones(3, 5), torch.eye(3), lr=1.0)
    np.testing.assert_array_equal(store[:, 2:7].numpy(),
                                  np.arange(15.0).reshape(3, 5) - 1.0)
    assert store[:, :2].abs().sum() == 0 and store[:, 7:].abs().sum() == 0
