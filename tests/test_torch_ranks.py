"""The port's collectives across ranks: gloo on the CPU against dopt's
``shard_map`` forms on a mesh of as many devices.

For D ∈ {2, 4} ranks with W = 8 workers (L = 8/D lanes a rank), one
spawn per D (``dopt_torch.parallel.spawn_ranks``, a ``file://``
rendezvous under ``tmp_path``) runs every collective of
tests/torch_rank_body.py on each rank's lanes; dopt runs the same
inputs on ``make_mesh(D)`` of the suite's virtual CPU devices:
``mix_dense_scatter`` and ``masked_average_scatter`` (f32 and a bf16
partial), ``mix_update_scatter`` over shifts, ``mix_shifts`` on the
8-ring (at D = 4, L = 2, so shifts ±1 straddle rank boundaries: r ≠ 0),
the compressed dense forms (``mix_dense`` and ``masked_average`` with
``comm_dtype=bfloat16``), and ``mix_codec_gather`` with q8, q4 and raw
buckets (lane ids rank·L + arange(L)).

Tolerances:

* f32: within 1e-6 relative to the largest magnitude (gloo's and XLA's
  sums differ only in order);
* the encodes bit for bit: each rank's payloads and scales for its
  lanes are the rows of dopt's encode of the whole slab; the codec's
  mixed buckets within 1e-6, its residuals within four f32 ulps of the
  encoded values (XLA contracts v − level·scale into an FMA under jit);
* a narrowed wire: one bf16 step on at most 1e-3 of the elements (the
  reduce-scatter sums at bf16 across ranks in another order).

The bytes each rank hands to ``torch.distributed`` for the codec
buckets (the group's ``meter``), per lane, are the plan's: the packed payload
plus the f32 scales, ``qint_wire_bytes`` of each bucket.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_rank_body as body
from dopt.ops.compression import qint_encode
from dopt.parallel import collectives as JC
from dopt.parallel.mesh import make_mesh
from dopt_torch.ops.compression import qint_wire_bytes
from dopt_torch.parallel import spawn_ranks


def _dopt(seed: int, d: int) -> dict:
    """dopt's forms of every collective, traced into one jitted program
    (one compile a mesh)."""
    x = body.inputs(seed, d)
    mesh = make_mesh(d)
    spec = JC.make_update_shard_spec(
        {k: jnp.asarray(v) for k, v in x["tree"].items()}, fold=d,
        bucket_bytes=body.BUCKET_BYTES)
    assert spec.bounds == x["spec"].bounds
    plan = JC.BucketCodecPlan(kinds=x["plan"].kinds, chunk=body.CHUNK,
                              dense_bytes=0, wire_bytes=0)

    def run(tree, w, mask, coeffs, res):
        buckets = JC.stacked_to_buckets(tree, spec)
        out = {}

        def put(name, leaves):
            if isinstance(leaves, dict):
                leaves = [leaves[k] for k in sorted(leaves)]
            for i, a in enumerate(leaves):
                out[f"{name}.{i}"] = a.astype(jnp.float32)

        for tag, cd in (("f32", None), ("bf16", jnp.bfloat16)):
            put(f"scatter.{tag}", JC.mix_dense_scatter(buckets, w, mesh, cd))
            put(f"mean.{tag}", JC.masked_average_scatter(
                tree, mask, mesh, spec, comm_dtype=cd))
            put(f"shift.{tag}", JC.mix_shifts(tree, body.SHIFT_IDS, coeffs,
                                              mesh, cd))
        put("update.shift", JC.mix_update_scatter(
            tree, coeffs, mesh, spec, shift_ids=body.SHIFT_IDS))
        put("dense.bf16", JC.mix_dense(tree, w, mesh, jnp.bfloat16))
        put("avg.bf16", JC.masked_average(tree, mask, mesh, jnp.bfloat16))
        key = jax.random.fold_in(jax.random.key(seed ^ 0xC0DEC), body.ROUND)
        mixed, new_res = JC.mix_codec_gather(buckets, res, w, mesh, plan,
                                             key)
        put("codec.mixed", mixed)
        put("codec.res", new_res)
        return out

    out = jax.jit(run)({k: jnp.asarray(v) for k, v in x["tree"].items()},
                       jnp.asarray(x["w"]), jnp.asarray(x["mask"]),
                       jnp.asarray(x["coeffs"]),
                       [jnp.asarray(r) for r in x["res"]])
    out = {k: np.asarray(v) for k, v in out.items()}
    # The whole slab's encodes (lane ids 0..N−1), eagerly, as the
    # engine's one-device reference encodes.
    for i, kind in enumerate(x["plan"].kinds):
        if kind in ("q8", "q4"):
            v = (np.asarray(JC.stacked_to_buckets(
                {k: jnp.asarray(a) for k, a in x["tree"].items()}, spec)[i])
                + x["res"][i])
            key = jax.random.fold_in(jax.random.key(seed ^ 0xC0DEC),
                                     body.ROUND)
            p, sc = qint_encode(jnp.asarray(v), jnp.arange(body.N),
                                jax.random.fold_in(key, i), chunk=body.CHUNK,
                                bits=8 if kind == "q8" else 4)
            out[f"encode.{i}.payload"] = np.asarray(p)
            out[f"encode.{i}.scale"] = np.asarray(sc)
    return out


REPLICATED = ("mean.", "avg.")


@pytest.mark.parametrize("ranks", [2, 4])
def test_collectives_across_gloo_ranks_match_dopt(ranks, tmp_path, devices):
    seed = 5
    spawn_ranks(body.body, ranks, tmp_path, str(tmp_path), seed,
                num_workers=body.N)
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(ranks)]
    want = _dopt(seed, ranks)
    x = body.inputs(seed, ranks)
    lanes = body.N // ranks
    vmax = max(np.abs(v).max() for v in x["tree"].values())
    for name, a in want.items():
        if name.startswith(REPLICATED):
            parts = [g[name] for g in got]
        else:
            parts = [np.concatenate([g[name] for g in got])]
        for b in parts:
            assert b.shape == a.shape, name
            scale = max(np.abs(a).max(), 1e-12)
            d = np.abs(a - b)
            if name.startswith("encode."):
                assert np.array_equal(a, b), name
            elif name.startswith("codec.res"):
                assert d.max() <= 4 * 2.0**-23 * vmax, name
            elif "bf16" in name:
                bad = d > 1e-6 * scale
                assert bad.mean() <= 1e-3, (name, bad.sum())
                assert (d[bad] <= 2.0**-7 * np.abs(a[bad]) + 1e-6 * scale
                        ).all(), name
            else:
                assert d.max() <= 1e-6 * scale, (name, d.max() / scale)
    widths = [b - a for a, b in zip(x["spec"].bounds, x["spec"].bounds[1:])]
    for kind, bits in (("q8", 8), ("q4", 4)):
        plan_bytes = sum(qint_wire_bytes(w, chunk=body.CHUNK, bits=bits)
                         for w, k in zip(widths, x["plan"].kinds)
                         if k == kind)
        for g in got:
            counted = (g[f"wire.all_gather.{kind}"]
                       + g[f"wire.all_gather.{kind}-scale"])
            assert counted == plan_bytes, (kind, counted, plan_bytes)
            # The raw tail reduce-scatters its [n, Fb] f32 partial.
            assert g["wire.reduce_scatter.raw"] == (
                body.N * widths[-1] * 4 / lanes)
