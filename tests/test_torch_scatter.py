"""The scatter slice's pieces on one rank, against dopt: the qint codec,
the codec plan and byte budgets, the shard spec at any fold, the shift
decomposition, and the scatter, shift and codec collectives with no
wire (group None) against dopt's on a one-device mesh.

Tolerances:

* ``qint_encode``: payload and scale bit for bit (bits 8 and 4, chunk 64
  and 1024, an all-zero chunk, a width that is not a chunk multiple);
  ``qint_decode`` and ``qint_wire_bytes`` equal.  The draws are per
  global lane: lanes 3..5 encoded alone are rows 3..5 of the slab's.
* The plan's kinds and bytes, the budgets and the spec's bounds equal.
* The collectives in f32: within 1e-6 relative to the largest
  magnitude; with a narrowed partial (bf16, f16): one wire-dtype step on
  at most 1e-3 of the elements.  bf16 buckets are held to dopt's
  scatter (W and the sum in f32), never to the port's dense bf16 mix.
* The codec (``mix_codec_gather`` against ``mix_codec_reference``, and
  both against dopt's): the residuals bit for bit (eager, no FMA), the
  mixed buckets within 1e-6.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dopt.analysis.comm_bytes as JB
import dopt.topology as JT
from dopt.ops import compression as JQ
from dopt.parallel import collectives as JC
from dopt.parallel.mesh import make_mesh
from dopt_torch import topology as TT
from dopt_torch.analysis import comm_bytes as TB
from dopt_torch.ops import compression as TQ
from dopt_torch.parallel import collectives as TC
from dopt_torch.parallel.mesh import WorkerGroup
from dopt_torch.utils.prng import fold_in, jax_key

N = 6


def _tree(seed=0, dtype=np.float32, n=N):
    rng = np.random.default_rng(seed)
    return {"conv.weight": rng.standard_normal((n, 4, 3, 5, 5)).astype(dtype),
            "conv.bias": rng.standard_normal((n, 4)).astype(dtype),
            "fc.weight": rng.standard_normal((n, 10, 77)).astype(dtype)}


def _jtree(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _ttree(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
            for k, v in tree.items()}


def _near(a, b, tol=1e-6):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-12)


def _one_step(a, b, step):
    """Within 1e-6 except at most 1e-3 of the elements, within one
    wire-dtype step (``step`` of the value)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(np.abs(a).max(), 1e-12)
    d = np.abs(a - b)
    bad = d > 1e-6 * scale
    assert bad.mean() <= 1e-3, bad.sum()
    assert (d[bad] <= step * np.abs(a[bad]) + 1e-6 * scale).all()


# -- the qint codec ----------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("chunk,width", [(64, 1000), (1024, 3000),
                                         (64, 64), (1024, 700)])
def test_qint_encode_decode_bit_for_bit(bits, chunk, width):
    rng = np.random.default_rng(bits * width)
    v = rng.standard_normal((5, width)).astype(np.float32)
    v[2, :chunk] = 0.0       # an all-zero chunk
    ids = np.arange(5) + 7
    jk = jax.random.fold_in(jax.random.key(3 ^ 0xC0DEC), 4)
    tk = fold_in(jax_key(3 ^ 0xC0DEC), 4)
    jp, js = JQ.qint_encode(jnp.asarray(v), jnp.asarray(ids), jk,
                            chunk=chunk, bits=bits)
    tp, ts = TQ.qint_encode(torch.from_numpy(v), torch.from_numpy(ids), tk,
                            chunk=chunk, bits=bits)
    assert str(tp.dtype) == f"torch.{np.asarray(jp).dtype}"
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    jd = JQ.qint_decode(jp, js, width, chunk=chunk, bits=bits)
    td = TQ.qint_decode(tp, ts, width, chunk=chunk, bits=bits)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert not td[2, :chunk].any()
    assert (TQ.qint_wire_bytes(width, chunk=chunk, bits=bits)
            == JQ.qint_wire_bytes(width, chunk=chunk, bits=bits))


def test_qint_draws_are_per_global_lane():
    """tests/test_comm_substrate.py:134 in the port: a lane's bits do not
    depend on the slab that encodes it."""
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 100)).astype(np.float32))
    key = jax_key(9)
    for bits in (8, 4):
        fp, fs = TQ.qint_encode(v, torch.arange(8), key, chunk=64, bits=bits)
        hp, hs = TQ.qint_encode(v[3:6], torch.arange(3, 6), key, chunk=64,
                                bits=bits)
        assert torch.equal(fp[3:6], hp) and torch.equal(fs[3:6], hs)


@pytest.mark.parametrize("kw,match", [(dict(bits=2), "bits"),
                                      (dict(chunk=63), "even")])
def test_qint_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        TQ.qint_encode(torch.zeros(1, 8), torch.arange(1), jax_key(0), **kw)


# -- the plan, the budgets, the spec -------------------------------------------
def _specs(fold=1, dtype=np.float32, bucket_bytes=4000):
    tree = _tree(dtype=dtype)
    return (JC.make_update_shard_spec(_jtree(tree, dtype), fold=fold,
                                      bucket_bytes=bucket_bytes),
            TC.make_update_shard_spec(
                _ttree(tree, torch.bfloat16 if dtype != np.float32
                       else torch.float32), fold=fold,
                bucket_bytes=bucket_bytes))


PLANS = {
    "none": dict(),
    "q8": dict(codec="qsgd", chunk=64, min_codec_bytes=256),
    "budget-q4": dict(codec="qsgd", chunk=64, min_codec_bytes=256,
                      byte_budget=900),
    "budget-partial": dict(codec="qsgd", chunk=64, min_codec_bytes=256,
                           byte_budget=3000),
    "bf16": dict(wire_dtype="bfloat16"),
    "f16-q8": dict(wire_dtype="float16", codec="qsgd", chunk=64),
    "small-stays-raw": dict(codec="qsgd", chunk=64, min_codec_bytes=3000),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_codec_plan_equals_dopts(case):
    js, ts = _specs()
    a = JC.make_codec_plan(js, **PLANS[case])
    b = TC.make_codec_plan(ts, **PLANS[case])
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert (a.any_codec, a.compression) == (b.any_codec, b.compression)
    if case == "budget-q4":
        assert "q4" in b.kinds


@pytest.mark.parametrize("kw", [dict(codec="int8"),
                                dict(wire_dtype="float8")])
def test_codec_plan_refusals_in_dopts_words(kw):
    js, ts = _specs()
    with pytest.raises(ValueError) as want:
        JC.make_codec_plan(js, **kw)
    with pytest.raises(ValueError) as got:
        TC.make_codec_plan(ts, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("link", [dict(), dict(msg_drop=0.15),
                                  dict(msg_drop=0.15, msg_delay=0.2,
                                       msg_delay_max=2),
                                  dict(msg_drop=2.0, msg_delay=-1.0)])
def test_byte_budgets_equal_dopts(link):
    for dense in (1, 755_240, 6_653_480):
        assert (TC.link_byte_budget(dense, **link)
                == JC.link_byte_budget(dense, **link))
        for workers in (1, 6, 32):
            assert (TB.lossy_budget_bytes(dense, workers)
                    == JB.lossy_budget_bytes(dense, workers))


def test_comm_modes_config_is_dopts():
    for mode in ("dense", "scatter", "codec"):
        a = TB.comm_modes_config(mode, budget_mb=0.5, faults=True)
        b = JB.comm_modes_config(mode, budget_mb=0.5, faults=True)
        assert (a.name, a.seed) == (b.name, b.seed)
        for section in ("data", "model", "optim", "gossip", "faults",
                        "comm"):
            x, y = getattr(a, section), getattr(b, section)
            assert (x is None) == (y is None), section
            if x is not None:
                assert dataclasses.asdict(x) == dataclasses.asdict(y), section
    with pytest.raises(ValueError, match="unknown comm mode"):
        TB.comm_modes_config("ring")


@pytest.mark.parametrize("fold", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shard_spec_at_any_fold(fold, dtype):
    np_dtype = np.float32 if dtype == "float32" else jnp.bfloat16
    js, ts = _specs(fold, np_dtype)
    assert (ts.bounds, ts.padded, ts.flat, ts.fold, ts.sizes) == (
        js.bounds, js.padded, js.flat, js.fold, js.sizes)
    assert all((b - a) % fold == 0 for a, b in zip(ts.bounds, ts.bounds[1:]))
    tree = _ttree(_tree(), getattr(torch, dtype))
    order = TQ.device_order({k: np.random.default_rng(len(k)).permutation(
        v[0].numel()) for k, v in tree.items()})
    for o in (None, order):
        bk = TC.stacked_to_buckets(tree, ts, o)
        assert [b.shape[1] for b in bk] == [b - a for a, b in
                                            zip(ts.bounds, ts.bounds[1:])]
        back = TC.buckets_to_stacked(bk, ts, o)
        one = TC.buckets_to_tree([b[2] for b in bk], ts, o)
        for k, v in tree.items():
            assert torch.equal(back[k], v) and torch.equal(one[k], v[2])


# -- the shift decomposition --------------------------------------------------
@pytest.mark.parametrize("topology,mode", [("circle", "stochastic"),
                                           ("dynamic", "metropolis"),
                                           ("complete", "uniform")])
def test_shift_decomposition_equals_dopts(topology, mode):
    jm = JT.build_mixing_matrices(topology, mode, 8, seed=3)
    tm = TT.build_mixing_matrices(topology, mode, 8, seed=3)
    for extra in ((), (0,)):
        for cap in (None, 2):
            ids = TT.schedule_shift_decomposition(tm, max_shifts=cap,
                                                  extra_shifts=extra)
            assert ids == JT.schedule_shift_decomposition(
                jm, max_shifts=cap, extra_shifts=extra)
    ids = TT.schedule_shift_decomposition(tm)
    for w in tm.matrices:
        assert np.array_equal(TT.coeffs_for_matrix(w, ids),
                              JT.coeffs_for_matrix(w, ids))
    a = TT.shift_decomposition(tm.matrices[0])
    b = JT.shift_decomposition(jm.matrices[0])
    assert [s for s, _ in a] == [s for s, _ in b]
    with pytest.raises(ValueError, match="not covered"):
        TT.coeffs_for_matrix(np.ones((8, 8)), (0, 1))


@pytest.mark.parametrize("lanes,devices_", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_shift_plan_equals_dopts(lanes, devices_):
    for ids in ((0, 1, 7), (1, 7), (0, 3, 5)):
        assert (TC._shift_plan(ids, lanes, devices_)
                == JC._shift_plan(ids, lanes, devices_))
        assert (TC.shift_comm_lanes(ids, lanes, devices_)
                == JC.shift_comm_lanes(ids, lanes, devices_))
        assert (TC.device_rotations(ids, lanes, devices_)
                == JC.device_rotations(ids, lanes, devices_))


# -- the collectives on one rank, against dopt's one-device mesh ---------------
WIRES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16),
         "f16": (jnp.float16, torch.float16)}
STEP = {"f32": 0.0, "bf16": 2.0**-7, "f16": 2.0**-10}


def _check(wire, a, b):
    if wire == "f32":
        _near(a, b)
    else:
        _one_step(a, b, STEP[wire])


@pytest.mark.parametrize("leaf", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", sorted(WIRES))
def test_one_rank_scatter_matches_dopt(wire, leaf, devices):
    mesh = make_mesh(1)
    jd, td = WIRES[wire]
    jleaf = jnp.float32 if leaf == "float32" else jnp.bfloat16
    tleaf = getattr(torch, leaf)
    tree = _tree(1)
    js = JC.make_update_shard_spec(_jtree(tree, jleaf), fold=1,
                                   bucket_bytes=3000)
    ts = TC.make_update_shard_spec(_ttree(tree, tleaf), fold=1,
                                   bucket_bytes=3000)
    rng = np.random.default_rng(4)
    w = rng.random((N, N)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    jb = JC.stacked_to_buckets(_jtree(tree, jleaf), js)
    tb = TC.stacked_to_buckets(_ttree(tree, tleaf), ts)
    for a, b in zip(JC.mix_dense_scatter(jb, jnp.asarray(w), mesh, jd),
                    TC.mix_dense_scatter(tb, torch.from_numpy(w), None, td)):
        assert b.dtype == tleaf
        _check(wire, a, b.float())
    ja = JC.masked_average_scatter(_jtree(tree, jleaf), jnp.asarray(mask),
                                   mesh, js, comm_dtype=jd)
    ta = TC.masked_average_scatter(_ttree(tree, tleaf),
                                   torch.from_numpy(mask), None, ts,
                                   comm_dtype=td)
    for k in tree:
        _check(wire, ja[k], ta[k].float())
    ring = TT.build_mixing_matrices("circle", "metropolis", N)
    ids = TT.schedule_shift_decomposition(ring)
    coeffs = TT.coeffs_for_matrix(ring.matrices[0], ids)
    for shift, arg in ((None, w), (ids, coeffs)):
        ju = JC.mix_update_scatter(_jtree(tree, jleaf), jnp.asarray(arg),
                                   mesh, js, shift_ids=shift, comm_dtype=jd)
        tu = TC.mix_update_scatter(_ttree(tree, tleaf), torch.from_numpy(arg),
                                   None, ts, shift_ids=shift, comm_dtype=td)
        for k in tree:
            if leaf == "float32":
                _check(wire, ju[k], tu[k].float())
            else:
                # The shift path accumulates at the leaf dtype in plan
                # order: one bf16 step where a sum rounds differently.
                _one_step(ju[k], tu[k].float(), 2.0**-7)


@pytest.mark.parametrize("budget", [0, 1500], ids=["q8", "q4"])
def test_one_rank_codec_matches_dopt_and_its_reference(budget, devices):
    mesh = make_mesh(1)
    tree = _tree(2)
    js = JC.make_update_shard_spec(_jtree(tree), fold=1, bucket_bytes=3000)
    ts = TC.make_update_shard_spec(_ttree(tree), fold=1, bucket_bytes=3000)
    # 750 + 324 entries: the 1,296-byte tail stays raw.
    kw = dict(codec="qsgd", chunk=64, min_codec_bytes=1300,
              byte_budget=budget)
    jp, tp = JC.make_codec_plan(js, **kw), TC.make_codec_plan(ts, **kw)
    assert "raw" in tp.kinds and ("q4" in tp.kinds) == bool(budget)
    rng = np.random.default_rng(8)
    w = rng.random((N, N)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    widths = [b - a for a, b in zip(ts.bounds, ts.bounds[1:])]
    res = [(0.01 * rng.standard_normal((N, x))).astype(np.float32)
           for x in widths]
    jkey = jax.random.fold_in(jax.random.key(5 ^ 0xC0DEC), 2)
    tkey = fold_in(jax_key(5 ^ 0xC0DEC), 2)
    jb = JC.stacked_to_buckets(_jtree(tree), js)
    tb = TC.stacked_to_buckets(_ttree(tree), ts)
    jm, jr = JC.mix_codec_gather(jb, [jnp.asarray(r) for r in res],
                                 jnp.asarray(w), mesh, jp, jkey)
    tres = [torch.from_numpy(r) for r in res]
    tm, tr = TC.mix_codec_gather(tb, tres, torch.from_numpy(w), None, tp,
                                 tkey)
    rm, rr = TC.mix_codec_reference(tb, tres, torch.from_numpy(w), tp, tkey)
    for i in range(len(widths)):
        assert torch.equal(tr[i], rr[i]) and torch.equal(tm[i], rm[i])
        _near(jm[i], tm[i])
        if tp.kinds[i] in ("q8", "q4"):
            assert np.array_equal(np.asarray(jr[i]), tr[i].numpy())
        else:
            assert tr[i] is tres[i]
    meter = collections.Counter()
    TC.mix_codec_gather(tb, tres, torch.from_numpy(w), None, tp, tkey)
    TC.mix_codec_gather(tb, tres, torch.from_numpy(w),
                        WorkerGroup(1, 0, N, meter=meter), tp, tkey)
    assert not meter


def test_shift_forms_and_worker_group():
    """``mix_shifts_shardmap`` (the ``shift_decomposition`` pairs) equals
    ``mix_shifts`` and the dense mix on one rank; ``fit_mesh_devices``
    and the contiguous lane layout are dopt's."""
    from dopt.parallel.mesh import fit_mesh_devices as jfit
    from dopt_torch.parallel.mesh import (fit_mesh_devices,
                                          make_worker_group)

    ring = TT.build_mixing_matrices("circle", "metropolis", N)
    w = ring.matrices[0].astype(np.float32)
    tree = _ttree(_tree(3))
    pairs = TT.shift_decomposition(w)
    ids = [s for s, _ in pairs]
    a = TC.mix_shifts_shardmap(tree, pairs)
    b = TC.mix_shifts(tree, ids, torch.from_numpy(
        TT.coeffs_for_matrix(w, ids)))
    c = TC.mix_dense(tree, torch.from_numpy(w))
    for k in tree:
        assert torch.equal(a[k], b[k])
        _near(c[k], a[k])
    for workers in (1, 6, 7, 8, 32):
        for req in (1, 2, 3, 4, 8):
            assert fit_mesh_devices(workers, req) == jfit(workers, req)
    g = make_worker_group(8)
    assert (g.size, g.rank, g.lanes, g.wire) == (1, 0, 8, False)
    x = torch.arange(8)
    assert torch.equal(g.local(x), x)
    r2 = dataclasses.replace(g, size=4, rank=2, lanes=2)
    assert r2.local(x).tolist() == [4, 5]


def test_payload_report_on_one_rank():
    """One rank hands nothing to ``torch.distributed``; the report gives
    the codec plan's bytes (dopt's comm-modes codec leg)."""
    from dopt_torch.engine import GossipTrainer

    cfg = TB.comm_modes_config("codec", train_size=256, test_size=64)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, plan_impl="numpy"))
    rep = TB.payload_report(GossipTrainer(cfg, device="cpu"))
    assert rep["ranks"] == 1 and not rep["wire"]
    assert rep["counted"] == {} and rep["counted_total"] == 0
    plan = rep["plan"]
    assert plan["kinds"] == ["q8"] and plan["by_kind"] == {
        "q8": plan["wire_bytes"]}
    assert plan["dense_bytes"] == 796_840
