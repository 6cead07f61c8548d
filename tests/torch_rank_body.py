"""The port's side of the cross-rank collective tests: what each spawned
rank runs (``dopt_torch.parallel.spawn_ranks``) in
tests/test_torch_ranks.py.

This module imports nothing of jax or dopt, because each spawned child
imports it again.  Every rank rebuilds the shared numpy inputs from the
seed (``inputs``), runs the port's collectives on its own lanes over the
gloo group, and writes its results to ``rank<r>.npz``; the test holds
the gathered results against dopt's ``shard_map`` forms.
"""

from __future__ import annotations

import collections
import dataclasses
from pathlib import Path

import numpy as np
import torch

from dopt_torch.ops.compression import qint_encode
from dopt_torch.parallel import collectives as C
from dopt_torch.parallel.mesh import meter_by_kind
from dopt_torch.utils.prng import fold_in, jax_key

N = 8                 # workers
SHIFT_IDS = (0, 1, 7)  # the 8-ring with self-weights
CHUNK = 64
ROUND = 3
BUCKET_BYTES = 400     # 100 f32 a bucket: 396 entries make four


def inputs(seed: int, ranks: int) -> dict:
    """The shared inputs: a two-leaf ``[N, ...]`` tree, its buckets at
    fold ``ranks`` (100, 100, 100 and 96 entries), a mixing matrix, a
    mask, the 8-ring's shift table, a residual a bucket and the codec
    plan (q8, q4, q4, and a raw tail)."""
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((N, 37, 5)).astype(np.float32),
            "b": rng.standard_normal((N, 211)).astype(np.float32)}
    tree["b"][:, :64] *= 0.0     # an all-zero chunk in every lane
    w = rng.random((N, N)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    ring = np.zeros((N, N), np.float32)
    for i in range(N):
        ring[i, i], ring[i, (i + 1) % N], ring[i, (i - 1) % N] = 0.5, .3, .2
    coeffs = np.stack([ring[np.arange(N), (np.arange(N) + s) % N]
                       for s in SHIFT_IDS]).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
    spec = C.make_update_shard_spec(
        {k: torch.from_numpy(v) for k, v in tree.items()}, fold=ranks,
        bucket_bytes=BUCKET_BYTES)
    widths = [b - a for a, b in zip(spec.bounds, spec.bounds[1:])]
    res = [(0.01 * rng.standard_normal((N, wd))).astype(np.float32)
           for wd in widths]
    kinds = ["q8"] * len(widths)
    kinds[1] = kinds[2] = "q4"
    kinds[-1] = "raw"
    plan = C.BucketCodecPlan(kinds=tuple(kinds), chunk=CHUNK,
                             dense_bytes=0, wire_bytes=0)
    return dict(tree=tree, w=w, ring=ring, coeffs=coeffs, mask=mask,
                spec=spec, res=res, plan=plan)


def codec_key(seed: int) -> torch.Tensor:
    return fold_in(jax_key(seed ^ 0xC0DEC), ROUND)


def body(wg, out_dir: str, seed: int) -> None:
    """One rank: every collective on this rank's lanes; results by name
    (per-lane results hold this rank's rows, replicated ones the whole
    value)."""
    x = inputs(seed, wg.size)
    spec, plan = x["spec"], x["plan"]
    tree = {k: torch.from_numpy(v) for k, v in x["tree"].items()}
    local = {k: wg.local(v).contiguous() for k, v in tree.items()}
    w, mask = torch.from_numpy(x["w"]), torch.from_numpy(x["mask"])
    coeffs = torch.from_numpy(x["coeffs"])
    buckets = C.stacked_to_buckets(local, spec)
    out: dict[str, np.ndarray] = {}

    def put(name, tensors):
        if isinstance(tensors, dict):
            tensors = [tensors[k] for k in sorted(tensors)]
        for i, t in enumerate(tensors):
            out[f"{name}.{i}"] = t.float().numpy()

    for tag, cd in (("f32", None), ("bf16", torch.bfloat16)):
        put(f"scatter.{tag}", C.mix_dense_scatter(buckets, w, wg, cd))
        put(f"mean.{tag}", C.masked_average_scatter(local, mask, wg, spec,
                                                    comm_dtype=cd))
        put(f"shift.{tag}", C.mix_shifts(local, SHIFT_IDS, coeffs, wg, cd))
    put("update.shift", C.mix_update_scatter(local, coeffs, wg, spec,
                                             shift_ids=SHIFT_IDS))
    put("dense.bf16", C.mix_dense(local, w, torch.bfloat16, wg))
    put("avg.bf16", C.masked_average(local, mask, torch.bfloat16, wg))
    res = [wg.local(torch.from_numpy(r)).contiguous() for r in x["res"]]
    meter = collections.Counter()
    mixed, new_res = C.mix_codec_gather(
        buckets, res, w, dataclasses.replace(wg, meter=meter), plan,
        codec_key(seed))
    put("codec.mixed", mixed)
    put("codec.res", new_res)
    # This rank's encodes of v = x + e under its global lane ids.
    lane_ids = torch.arange(wg.lane0, wg.lane0 + wg.lanes)
    for i, (b, e, kind) in enumerate(zip(buckets, res, plan.kinds)):
        if kind in ("q8", "q4"):
            p, sc = qint_encode(b + e, lane_ids, fold_in(codec_key(seed), i),
                                chunk=CHUNK, bits=8 if kind == "q8" else 4)
            out[f"encode.{i}.payload"] = p.numpy()
            out[f"encode.{i}.scale"] = sc.numpy()
    for (op, kind), b in meter_by_kind(meter).items():
        out[f"wire.{op}.{kind}"] = np.array(b / wg.lanes)
    np.savez(Path(out_dir) / f"rank{wg.rank}.npz", **out)
