"""IID / non-IID data partitioning across workers.

The port's copy of ``dopt.data.partition``: the same seeded numpy
draws, so every worker's shard is bit-identical to dopt's.
"""

from __future__ import annotations

import numpy as np


def iid_split(labels: np.ndarray, num_users: int, *,
              seed: int = 0) -> dict[int, np.ndarray]:
    """Random equal split; every sample used at most once."""
    n = len(labels)
    per_user = n // num_users
    if per_user < 1:
        raise ValueError(f"cannot split {n} samples across {num_users} users")
    perm = np.random.default_rng(seed).permutation(n)
    return {
        i: np.sort(perm[i * per_user:(i + 1) * per_user]).astype(np.int64)
        for i in range(num_users)
    }


def noniid_split(labels: np.ndarray, num_users: int, *,
                 shards_per_user: int = 2,
                 seed: int = 0) -> dict[int, np.ndarray]:
    """Pathological non-IID: sort by label, carve into
    ``num_users * shards_per_user`` contiguous shards and deal
    ``shards_per_user`` random shards to each user."""
    n = len(labels)
    num_shards = num_users * shards_per_user
    shard_len = n // num_shards
    if shard_len < 1:
        raise ValueError(
            f"cannot carve {n} samples into {num_shards} shards "
            f"({num_users} users x {shards_per_user} shards)")
    order = np.argsort(labels, kind="stable")
    shard_ids = np.random.default_rng(seed).permutation(num_shards)
    out: dict[int, np.ndarray] = {}
    for i in range(num_users):
        mine = shard_ids[i * shards_per_user:(i + 1) * shards_per_user]
        idx = np.concatenate([order[s * shard_len:(s + 1) * shard_len]
                              for s in mine])
        out[i] = np.sort(idx).astype(np.int64)
    return out


def holdout_split(index_matrix: np.ndarray, *, fraction: float = 0.1,
                  mode: str = "deterministic",
                  seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Per-worker local train/val holdout (the reference's
    ``train_val_test``): ``val_size = max(int(L * fraction), 1)`` of each
    worker's shard become local validation.  'deterministic' takes the
    FIRST val_size indices (P1); 'random' draws them without replacement
    from a stream keyed by (seed, worker) (P2).  Returns
    ``(train [W, L - val_size], val [W, val_size])``, rows sorted."""
    if not 0.0 < fraction < 1.0:
        raise ValueError(f"holdout fraction must be in (0, 1), got {fraction}")
    if mode not in ("deterministic", "random"):
        raise ValueError(
            f"unknown holdout_mode {mode!r}; one of deterministic|random")
    w, l = index_matrix.shape
    val_size = max(int(l * fraction), 1)
    if val_size >= l:
        raise ValueError(f"holdout of {val_size} samples leaves no training "
                         f"data (shard length {l})")
    if mode == "deterministic":
        return (index_matrix[:, val_size:].copy(),
                index_matrix[:, :val_size].copy())
    train = np.empty((w, l - val_size), dtype=index_matrix.dtype)
    val = np.empty((w, val_size), dtype=index_matrix.dtype)
    for i in range(w):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 77_000 + i]))
        held = np.zeros(l, dtype=bool)
        held[rng.choice(l, val_size, replace=False)] = True
        val[i] = np.sort(index_matrix[i][held])
        train[i] = np.sort(index_matrix[i][~held])
    return train, val


def partition(labels: np.ndarray, num_users: int, *, iid: bool = True,
              shards_per_user: int = 2,
              seed: int = 0) -> tuple[dict[int, np.ndarray], np.ndarray]:
    """Partition + dense form: ``(user_groups, index_matrix)`` with
    ``index_matrix`` [num_users, L], L the shortest shard length."""
    groups = (iid_split(labels, num_users, seed=seed) if iid
              else noniid_split(labels, num_users,
                                shards_per_user=shards_per_user, seed=seed))
    lmin = min(len(v) for v in groups.values())
    matrix = np.stack([groups[i][:lmin]
                       for i in range(num_users)]).astype(np.int32)
    return groups, matrix


def assign_client_shards(population: int, num_shards: int, *,
                         seed: int = 0,
                         mode: str = "round_robin") -> np.ndarray:
    """The client population's shard map (``dopt_torch.population``):
    each of ``population`` client ids onto one of ``num_shards`` data
    shards, as an int32 ``[population]`` vector.  'round_robin' gives
    client c shard c % num_shards (the identity when the two counts are
    equal, which makes the cohort-vs-flat comparison exact);
    'random' permutes that assignment with a stream keyed by
    (seed, 0x5A4D), still balanced to within one client a shard."""
    if population < 1:
        raise ValueError(f"population must be >= 1, got {population}")
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    base = (np.arange(population) % num_shards).astype(np.int32)
    if mode == "round_robin":
        return base
    if mode == "random":
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5A4D]))
        return base[rng.permutation(population)].astype(np.int32)
    raise ValueError(
        f"unknown client-shard assignment mode {mode!r}; "
        "one of round_robin|random")


def orphan_shard_adopters(assignment: np.ndarray, alive: np.ndarray,
                          num_shards: int) -> dict[int, int]:
    """Population churn's shard map: a shard whose assigned clients are
    all away this round is adopted by the next shard id (mod S) that
    still has an alive client (``reassign_shards`` then interleaves the
    orphan's rows into the adopter's).  Empty when every shard, or none,
    has an alive client."""
    assignment = np.asarray(assignment)
    alive = np.asarray(alive, bool)
    covered = np.zeros(num_shards, bool)
    np.logical_or.at(covered, assignment[alive], True)
    if covered.all() or not covered.any():
        return {}
    out: dict[int, int] = {}
    for s in np.nonzero(~covered)[0]:
        a = (int(s) + 1) % num_shards
        while not covered[a]:
            a = (a + 1) % num_shards
        out[int(s)] = a
    return out


def reassign_shards(index_matrix: np.ndarray,
                    adopters: dict[int, int]) -> np.ndarray:
    """Deterministic shard reassignment for elastic membership
    (``FaultConfig.churn``): while a worker is away, its data shard is
    trained by its adopter so departed data keeps contributing.

    ``adopters`` maps departed worker -> alive adopter
    (``FaultPlan.adopters_for``).  The adopter's row for the round
    becomes the round-robin interleave of its own shard and every shard
    it adopted, truncated to the row length L — a shape-preserving
    deterministic subsample that covers all the merged shards evenly
    (L/(k+1) samples each for k adoptions).  Departed workers' own rows
    are left untouched (their lanes are frozen and never gather).
    Returns a new matrix; the input is never mutated."""
    if not adopters:
        return index_matrix
    out = index_matrix.copy()
    by_adopter: dict[int, list[int]] = {}
    for departed, adopter in sorted(adopters.items()):
        by_adopter.setdefault(adopter, []).append(departed)
    L = index_matrix.shape[1]
    for adopter, departed in by_adopter.items():
        rows = np.stack([index_matrix[adopter]]
                        + [index_matrix[i] for i in departed], axis=1)
        out[adopter] = rows.reshape(-1)[:L]
    return out
