"""Host-side batch planning for the worker-stacked trainer.

The port's copy of ``dopt.data.pipeline``'s planners: the numpy path
and (``impl="native"``) dopt's C++ planner (``dopt_torch.native``),
whose xoshiro stream differs from numpy's.  Batching is data: a
per-(seed, round, epoch, worker) shuffled index plan, bit
for bit the one dopt builds, which the trainer uploads once a round and
gathers from the device-resident train set.  The last partial batch is
padded by wraparound with a 0/1 sample weight, so padding never changes
the math.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BatchPlan:
    """Index plan for one round of local training on every worker.

    idx:    [W, S, B] int32 — S = local_ep * steps_per_epoch gather indices
    weight: [W, S, B] float32 — 1.0 for real samples, 0.0 for padding
    """

    idx: np.ndarray
    weight: np.ndarray


def make_batch_plan(index_matrix: np.ndarray, *, batch_size: int,
                    local_ep: int = 1, seed: int = 0, round_idx: int = 0,
                    workers: np.ndarray | None = None,
                    rows: np.ndarray | None = None,
                    impl: str = "numpy") -> BatchPlan:
    """Build the shuffled batch plan for one round from the [W, L]
    per-worker index matrix; deterministic in (seed, round_idx, epoch,
    worker).  ``workers`` ([m] worker ids) plans only those rows, keyed
    by the TRUE worker id, so the [m, S, B] result is bit-identical to
    those rows of the full plan (the compact federated path).  ``rows``
    ([m], needs ``workers``) decouples the gathered rows from the keys:
    row ``rows[i]`` is shuffled under key ``workers[i]`` — the client
    population binds client ids (the keys) onto their shards (the rows),
    so two clients of one shard draw distinct batch streams.
    ``impl="native"`` fills the plan with the C++ planner (dopt's
    native plan bit for bit) and raises where it cannot be built: dopt
    falls back to numpy there, a different draw stream."""
    if impl not in ("numpy", "native"):
        raise ValueError(f"unknown plan_impl {impl!r}; one of numpy|native "
                         "(the native planner is the C++ one)")
    if rows is not None and workers is None:
        raise ValueError("make_batch_plan: rows= requires workers= "
                         "(the RNG identity keys)")
    ids = (np.arange(index_matrix.shape[0]) if workers is None
           else np.asarray(workers, dtype=np.int64))
    if workers is not None:
        index_matrix = index_matrix[ids if rows is None
                                    else np.asarray(rows, dtype=np.int64)]
    if impl == "native":
        from dopt_torch.native import fill_batch_plan_native

        idx, weight = fill_batch_plan_native(
            index_matrix, batch_size=batch_size, local_ep=local_ep,
            seed=seed, round_idx=round_idx,
            worker_ids=None if workers is None else ids)
        return BatchPlan(idx=idx, weight=weight)
    w, l = index_matrix.shape
    bs = min(batch_size, l)
    steps_per_epoch = -(-l // bs)
    padded = steps_per_epoch * bs
    s = local_ep * steps_per_epoch
    pad = padded - l
    perms = np.empty((w, local_ep, padded), dtype=np.int64)
    for wi in range(w):
        for ep in range(local_ep):
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, round_idx, ep, int(ids[wi])]))
            perm = rng.permutation(l)
            if pad:
                perms[wi, ep, :l] = perm
                perms[wi, ep, l:] = perm[:pad]
            else:
                perms[wi, ep] = perm
    gathered = np.take_along_axis(index_matrix[:, None, :], perms, axis=2)
    idx = np.ascontiguousarray(
        gathered.reshape(w, s, bs).astype(np.int32, copy=False))
    if pad == 0:
        weight = np.ones((w, s, bs), np.float32)
    else:
        epoch_mask = np.concatenate(
            [np.ones(l, np.float32), np.zeros(pad, np.float32)]
        ).reshape(steps_per_epoch, bs)
        weight = np.tile(epoch_mask[None], (w, local_ep, 1)).reshape(w, s, bs)
    return BatchPlan(idx=idx, weight=weight)


def gather_batches(x: np.ndarray, y: np.ndarray, plan: BatchPlan
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Materialise ``[W, S, B, ...]`` feature, int32 label and weight
    arrays from a plan on the host (dopt's one-round transfer payload;
    the port's engines gather on the device instead)."""
    return x[plan.idx], y[plan.idx].astype(np.int32), plan.weight


def eval_batches(x: np.ndarray, y: np.ndarray, *, batch_size: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static-shape eval split: [S, B, ...] with a wraparound padding
    mask, shared by all workers (every worker evaluates the whole test
    split, as the reference's per-client test loader does)."""
    n = len(y)
    bs = min(batch_size, n)
    steps = -(-n // bs)
    pad = steps * bs - n
    idx = np.arange(n)
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return (x[idx].reshape(steps, bs, *x.shape[1:]),
            y[idx].reshape(steps, bs).astype(np.int32),
            mask.reshape(steps, bs))


def sharded_eval_batches(n: int, workers: int, *, batch_size: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Round-robin 1/W shard of an n-sample eval set per worker: [W, S, B]
    gather indices + 0/1 padding weights (``eval_mode="sharded"``: the
    fleet-mean metric from n sample-forwards instead of W·n).  Bit for
    bit dopt's plan.  Raises a ``ValueError`` when ``workers > n``: a
    worker without a row would report accuracy 0 and bias the fleet
    mean, where dopt pads it with zero-weight rows."""
    if workers > n:
        raise ValueError(
            f"eval_mode='sharded' needs at least one eval sample a worker: "
            f"{workers} workers over an eval set of {n}; use "
            "eval_mode='full' or a larger eval set")
    l = -(-n // workers)
    idx = np.zeros((workers, l), np.int64)
    wt = np.zeros((workers, l), np.float32)
    for i in range(workers):
        r = np.arange(i, n, workers)
        idx[i, :len(r)] = r
        wt[i, :len(r)] = 1.0
        if len(r) < l:
            idx[i, len(r):] = r[:l - len(r)]
    bs = min(batch_size, l)
    steps = -(-l // bs)
    pad = steps * bs - l
    if pad:
        idx = np.concatenate([idx, idx[:, :pad]], axis=1)
        wt = np.concatenate([wt, np.zeros((workers, pad), np.float32)],
                            axis=1)
    return (idx.reshape(workers, steps, bs).astype(np.int32),
            wt.reshape(workers, steps, bs))


def stacked_eval_batches(index_matrix: np.ndarray, *, batch_size: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Per-worker static-shape eval stacks over index rows: [W, S, B]
    gather indices + 0/1 wraparound-padding weights (the local-val
    holdout eval and the per-client train-split eval)."""
    w, l = index_matrix.shape
    bs = min(batch_size, l)
    steps = -(-l // bs)
    pad = steps * bs - l
    idx = (index_matrix if pad == 0
           else np.concatenate([index_matrix, index_matrix[:, :pad]], axis=1))
    weight = np.concatenate(
        [np.ones((w, l), np.float32), np.zeros((w, pad), np.float32)], axis=1)
    return (idx.reshape(w, steps, bs).astype(np.int32),
            weight.reshape(w, steps, bs))
