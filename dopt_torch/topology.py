"""Communication graphs and mixing matrices for gossip/consensus learning.

The port's copy of ``dopt.topology``'s schedule constructors: the same
topologies, the same weight modes and the same numpy draws, so every
matrix is bit-identical to dopt's for the same arguments.  Matrices are
plain numpy data; the trainer moves each round's matrix to the device.

The repairs (``repair_for_dropout`` and its device twin,
``repair_for_partition``, ``repair_for_link_drop``,
``push_sum_link_matrix``, ``split_by_delay``) are dopt's too: the fault
model heals the mixing matrix as data each round.

``shift_decomposition``, ``schedule_shift_decomposition`` and
``coeffs_for_matrix`` cut a schedule into its circulant diagonals for
the shift path (``comm_impl="shift"``): one static shift set for the
run, and each round's ``[k, n]`` coefficients as data.

Faithful-mode invariants (as in dopt): zero diagonal unless
``self_weight``; ``stochastic`` normalises columns then transposes;
``double_stochastic`` is Sinkhorn with the reference's star special case
and final transpose, and raises where no such matrix exists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

# The reference spells it "compelete"; accept both.
_TOPOLOGIES = ("circle", "ring", "star", "complete", "compelete", "dynamic",
               "random", "torus", "hierarchical", "one_peer_exp")
_MODES = ("stochastic", "double_stochastic", "ones", "metropolis", "uniform")


class Topology:
    """Namespace of adjacency constructors. Each returns a list of [n, n]
    zero-diagonal 0/1 float64 matrices (len > 1 = time-varying schedule)."""

    @staticmethod
    def circle(n: int) -> list[np.ndarray]:
        g = np.zeros((n, n))
        for i in range(n):
            g[i, (i + 1) % n] = 1.0
            g[(i + 1) % n, i] = 1.0
        return [g]

    ring = circle

    @staticmethod
    def star(n: int) -> list[np.ndarray]:
        g = np.zeros((n, n))
        g[0, 1:] = 1.0
        g[1:, 0] = 1.0
        return [g]

    @staticmethod
    def complete(n: int) -> list[np.ndarray]:
        return [np.ones((n, n)) - np.eye(n)]

    @staticmethod
    def dynamic(n: int) -> list[np.ndarray]:
        """N single-edge graphs, edge (t, t+1 mod n) active in round t."""
        graphs = []
        for t in range(n):
            g = np.zeros((n, n))
            g[t, (t + 1) % n] = 1.0
            g[(t + 1) % n, t] = 1.0
            graphs.append(g)
        return graphs

    @staticmethod
    def random(n: int, *, p: float = 0.5, schedule_len: int = 10,
               rng: np.random.Generator | None = None) -> list[np.ndarray]:
        """Time-varying Erdős–Rényi schedule with a random Hamiltonian
        cycle in every round, so no worker is ever isolated."""
        rng = rng or np.random.default_rng(0)
        graphs = []
        for _ in range(schedule_len):
            g = (rng.random((n, n)) < p).astype(np.float64)
            g = np.triu(g, 1)
            g = g + g.T
            perm = rng.permutation(n)
            for i in range(n):
                a, b = perm[i], perm[(i + 1) % n]
                g[a, b] = g[b, a] = 1.0
            np.fill_diagonal(g, 0.0)
            graphs.append(g)
        return graphs

    @staticmethod
    def hierarchical(n: int, *, groups: int = 2,
                     period: int = 4) -> list[np.ndarray]:
        """period−1 intra-group rounds (block-diagonal complete graphs)
        then one global round, cycling; worker i is in group
        i // (n // groups)."""
        if n % groups:
            raise ValueError(f"{n} workers do not split into {groups} groups")
        if period < 2:
            raise ValueError(f"period must be >= 2, got {period}")
        size = n // groups
        intra = np.zeros((n, n))
        for g in range(groups):
            s = g * size
            intra[s:s + size, s:s + size] = np.ones((size, size)) - np.eye(size)
        global_g = np.ones((n, n)) - np.eye(n)
        return [intra] * (period - 1) + [global_g]

    @staticmethod
    def one_peer_exp(n: int) -> list[np.ndarray]:
        """log2(n) directed single-peer graphs, graph k carrying the edge
        i -> (i + 2^k) mod n, cycled per round (power-of-2 n only)."""
        if n < 2 or n & (n - 1):
            raise ValueError(
                f"one_peer_exp needs a power-of-2 worker count >= 2, "
                f"got {n}")
        idx = np.arange(n)
        graphs = []
        for k in range(n.bit_length() - 1):
            g = np.zeros((n, n))
            g[idx, (idx + (1 << k)) % n] = 1.0
            graphs.append(g)
        return graphs

    @staticmethod
    def torus(n: int) -> list[np.ndarray]:
        """2D torus on an r×c grid with r the largest divisor <= √n."""
        r = int(np.sqrt(n))
        while n % r:
            r -= 1
        c = n // r
        g = np.zeros((n, n))
        for i in range(n):
            x, y = divmod(i, c)
            for nx, ny in (((x + 1) % r, y), ((x - 1) % r, y),
                           (x, (y + 1) % c), (x, (y - 1) % c)):
                j = nx * c + ny
                if j != i:
                    g[i, j] = 1.0
        return [g]


def build_adjacency(topology: str, n: int, *, p: float = 0.5,
                    schedule_len: int = 10, seed: int = 0, groups: int = 2,
                    period: int = 4) -> list[np.ndarray]:
    t = topology.lower()
    if t not in _TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; one of {_TOPOLOGIES}")
    if t == "compelete":
        t = "complete"
    if t == "ring":
        t = "circle"
    if t == "random":
        return Topology.random(n, p=p, schedule_len=schedule_len,
                               rng=np.random.default_rng(seed))
    if t == "hierarchical":
        return Topology.hierarchical(n, groups=groups, period=period)
    return getattr(Topology, t)(n)


def _with_isolated_self_loops(w: np.ndarray) -> np.ndarray:
    """Give zero-degree workers an identity row so they keep their own
    weights (the reference divides by zero there)."""
    w = w.copy()
    isolated = w.sum(axis=1) == 0
    w[isolated, isolated] = 1.0
    return w


def _stochastic_weights(graphs: Sequence[np.ndarray],
                        rng: np.random.Generator) -> list[np.ndarray]:
    """Random positive weights on edges; column-normalise then transpose
    → row-stochastic (the reference's exact recipe)."""
    n = graphs[0].shape[0]
    rand = rng.random((n, n))
    out = []
    for g in graphs:
        w = rand * g
        colsum = w.sum(axis=0)
        colsum = np.where(colsum == 0, 1.0, colsum)
        out.append(_with_isolated_self_loops((w / colsum).T))
    return out


def _sinkhorn(w: np.ndarray, *, tol: float = 1e-12,
              max_iter: int = 10_000) -> np.ndarray:
    """Alternating row/column normalisation to a doubly-stochastic
    matrix; raises where the support admits none (zero-diagonal star
    for n > 2)."""
    w = w.astype(np.float64).copy()
    for _ in range(max_iter):
        rsum = w.sum(axis=1)
        csum = w.sum(axis=0)
        if np.all(np.abs(rsum - 1) < tol) and np.all(np.abs(csum - 1) < tol):
            return w
        w = w / np.where(csum == 0, 1.0, csum)
        rs = w.sum(axis=1, keepdims=True)
        w = w / np.where(rs == 0, 1.0, rs)
    raise ValueError(
        "Sinkhorn failed to converge: the graph support admits no "
        "doubly-stochastic matrix (zero-diagonal star graphs for n>2 are "
        "infeasible; use mode='metropolis' or self_weight=True).")


def _metropolis_weights(graphs: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Metropolis–Hastings: a_ij = 1/(1+max(d_i,d_j)) on edges, the
    self-loop takes the remainder (symmetric doubly stochastic)."""
    out = []
    for g in graphs:
        deg = g.sum(axis=1)
        w = np.zeros_like(g)
        for i, j in np.argwhere(g > 0):
            w[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        np.fill_diagonal(w, 1.0 - w.sum(axis=1))
        out.append(w)
    return out


def _uniform_weights(graphs: Sequence[np.ndarray],
                     self_weight: bool) -> list[np.ndarray]:
    out = []
    for g in graphs:
        a = g + np.eye(g.shape[0]) if self_weight else g.copy()
        rs = a.sum(axis=1, keepdims=True)
        out.append(_with_isolated_self_loops(a / np.where(rs == 0, 1.0, rs)))
    return out


@dataclass(frozen=True)
class MixingMatrices:
    """A (possibly time-varying) schedule of n×n mixing matrices;
    ``matrices[t % len(matrices)]`` is round t's matrix (the reference's
    ``adjacent_matrix[round % len(...)]`` selector)."""

    topology: str
    mode: str
    matrices: tuple[np.ndarray, ...]

    def for_round(self, t: int) -> np.ndarray:
        return self.matrices[t % len(self.matrices)]

    @property
    def n(self) -> int:
        return self.matrices[0].shape[0]

    def stacked(self) -> np.ndarray:
        """The schedule as one ``[T, n, n]`` array."""
        return np.stack(self.matrices, axis=0)

    # --- diagnostics (dopt's, dopt/topology.py:291-330) ----------------
    def is_row_stochastic(self, tol: float = 1e-9) -> bool:
        return all(np.all(np.abs(m.sum(1) - 1) < tol) and np.all(m >= -tol)
                   for m in self.matrices)

    def is_doubly_stochastic(self, tol: float = 1e-9) -> bool:
        return self.is_row_stochastic(tol) and all(
            np.all(np.abs(m.sum(0) - 1) < tol) for m in self.matrices)

    @staticmethod
    def _gap_of(m: np.ndarray) -> float:
        ev = np.sort(np.abs(np.linalg.eigvals(m)))[::-1]
        lam2 = ev[1] if len(ev) > 1 else 0.0
        return float(1.0 - lam2)

    def spectral_gap(self, kind: str = "product") -> float:
        """Consensus-rate diagnostic: 1 - |λ₂|.

        kind='product' (default): the gap of the per-period product
        ``∏_{t=T-1..0} W_t``, which governs how fast a time-varying
        schedule contracts the consensus error over one period; for a
        static schedule it is the single matrix's gap.  kind='mean': the
        gap of the round-averaged matrix, the classical static
        diagnostic, which can over- or under-state a dynamic schedule's
        rate.  To compare schedules of different lengths per round, use
        ``1 - (1 - gap)**(1/T)``."""
        if kind == "mean":
            return self._gap_of(np.mean(self.stacked(), axis=0))
        if kind != "product":
            raise ValueError(f"kind must be 'product' or 'mean', got {kind!r}")
        prod = np.eye(self.n)
        for m in self.matrices:
            prod = m @ prod
        return self._gap_of(prod)


def build_mixing_matrices(
    topology: str,
    mode: str,
    n: int,
    *,
    seed: int = 0,
    self_weight: bool = False,
    p: float = 0.5,
    schedule_len: int = 10,
    groups: int = 2,
    period: int = 4,
) -> MixingMatrices:
    """Build the mixing-matrix schedule for a topology/mode pair."""
    mode_l = mode.lower()
    if mode_l not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {_MODES}")
    if topology.lower() == "one_peer_exp":
        # W_t = (I + P_{2^t mod log2 n})/2 defines its own weights.
        if self_weight:
            raise ValueError(
                "topology='one_peer_exp' bakes its own exact dyadic "
                "self-weights (W_t = (I + P)/2); self_weight=True only "
                "applies to the reference weight modes — drop one of "
                "the two")
        mats = [(np.eye(n) + g) / 2.0 for g in build_adjacency(topology, n)]
        return MixingMatrices(topology="one_peer_exp", mode=mode_l,
                              matrices=tuple(mats))
    graphs = build_adjacency(topology, n, p=p, schedule_len=schedule_len,
                             seed=seed, groups=groups, period=period)
    rng = np.random.default_rng(seed)

    if mode_l == "stochastic":
        mats = _stochastic_weights(graphs, rng)
    elif mode_l == "double_stochastic":
        # Star special case: uniform 1/n base weights; the reference
        # transposes the converged matrix on assignment.
        base = (np.ones((n, n)) / n if topology.lower() == "star"
                else rng.random((n, n)))
        mats = [_sinkhorn(_with_isolated_self_loops(base * g)).T.copy()
                for g in graphs]
    elif mode_l == "ones":
        mats = [g.copy() for g in graphs]
    elif mode_l == "metropolis":
        mats = _metropolis_weights(graphs)
    else:  # uniform
        mats = _uniform_weights(graphs, self_weight)

    if self_weight and mode_l in ("stochastic", "double_stochastic", "ones"):
        # Lazy gossip, W' = (W + I)/2.
        mats = [(m + np.eye(n)) / 2.0 for m in mats]

    return MixingMatrices(topology=topology, mode=mode_l, matrices=tuple(mats))


def random_matching_matrix(n: int, rng: np.random.Generator) -> np.ndarray:
    """One round of pairwise gossip (``algorithm="gossip"``): a random
    perfect matching drawn from ``rng``, each matched pair averaging
    (w = 1/2 each), the unmatched worker of an odd n keeping its own
    params.  dopt's draw (dopt/engine/gossip.py:81-97), bit for bit."""
    w = np.zeros((n, n))
    perm = rng.permutation(n)
    for k in range(0, n - 1, 2):
        i, j = perm[k], perm[k + 1]
        w[i, i] = w[j, j] = 0.5
        w[i, j] = w[j, i] = 0.5
    if n % 2:
        i = perm[-1]
        w[i, i] = 1.0
    return w


def shift_decomposition(w: np.ndarray, max_shifts: int | None = None
                        ) -> list[tuple[int, np.ndarray]] | None:
    """``[(shift, coeffs[n]), ...]`` with ``W[i, (i+shift) % n] ==
    coeffs[i]`` covering every nonzero of ``w``, or None when there are
    more than ``max_shifts`` nonzero diagonals."""
    n = w.shape[0]
    shifts: list[tuple[int, np.ndarray]] = []
    for s in range(n):
        coeffs = np.array([w[i, (i + s) % n] for i in range(n)])
        if np.any(coeffs != 0):
            shifts.append((s, coeffs))
    if max_shifts is not None and len(shifts) > max_shifts:
        return None
    return shifts


def schedule_shift_decomposition(
    mixing: MixingMatrices,
    *,
    max_shifts: int | None = None,
    extra_shifts: Sequence[int] = (),
) -> tuple[int, ...] | None:
    """The sorted union of the circulant shifts of every matrix of a
    schedule (one static set for the run), with ``extra_shifts`` (mod n)
    added — shift 0 where a dropout repair may add identity rows.  None
    as soon as the union exceeds ``max_shifts``."""
    n = mixing.n
    ids: set[int] = {int(s) % n for s in extra_shifts}
    for m in mixing.matrices:
        dec = shift_decomposition(m)
        assert dec is not None
        ids.update(s for s, _ in dec)
        if max_shifts is not None and len(ids) > max_shifts:
            return None
    out = tuple(sorted(ids))
    if max_shifts is not None and len(out) > max_shifts:
        return None
    return out


def coeffs_for_matrix(w: np.ndarray, shift_ids: Sequence[int]) -> np.ndarray:
    """The ``[k, n]`` f32 table ``coeffs[k, i] = w[i, (i + shift_ids[k])
    % n]``; raises where ``w`` has support outside the shift set."""
    n = w.shape[0]
    rows = np.arange(n)
    coeffs = np.stack([w[rows, (rows + int(s)) % n] for s in shift_ids])
    recon = np.zeros_like(w)
    for k, s in enumerate(shift_ids):
        recon[rows, (rows + int(s)) % n] = coeffs[k]
    if not np.array_equal(recon, w):
        raise ValueError(
            f"matrix support is not covered by shifts {tuple(shift_ids)}"
        )
    return coeffs.astype(np.float32)


def repair_for_dropout(w: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Rebuild a mixing matrix after worker failures (fault injection /
    elastic recovery — the subsystem SURVEY §5 notes the reference lacks
    entirely; here failures are a per-round participation mask and the
    communication layer heals itself as data).

    ``alive`` is a 0/1 vector.  Edges to dead workers are removed and
    surviving rows renormalised to keep row-stochasticity; a live worker
    whose neighbors all died keeps its own weights for the round
    (identity row), and a dead worker is frozen (identity row) so it
    rejoins with stale-but-valid parameters when it comes back.
    """
    n = w.shape[0]
    a = np.asarray(alive, dtype=w.dtype).reshape(1, n)
    return _repair_edges(w, a, force_identity=np.asarray(alive) <= 0)


def repair_for_dropout_torch(w: torch.Tensor,
                             alive: torch.Tensor) -> torch.Tensor:
    """``repair_for_dropout`` on the device, in the matrix dtype (f32),
    the twin of dopt's ``repair_for_dropout_jnp``: the fused-quarantine
    round folds the quarantine mask into ``alive`` on the device and
    repairs there, so per-round and blocked runs (a graph replay) run
    the same arithmetic.  Dead edges dropped, surviving rows
    renormalised, isolated or dead rows exact identity rows."""
    n = w.shape[0]
    a = alive.to(w.dtype).reshape(1, n)
    masked = w * a
    rowsum = masked.sum(1, keepdim=True)
    safe = torch.where(rowsum > 0, rowsum, torch.ones_like(rowsum))
    repaired = masked / safe
    iso = (rowsum[:, 0] <= 0) | (a[0] <= 0)
    eye = torch.eye(n, dtype=w.dtype, device=w.device)
    return torch.where(iso[:, None], eye, repaired)


def _repair_edges(w: np.ndarray, edge_mask: np.ndarray,
                  force_identity: np.ndarray | None = None) -> np.ndarray:
    """Shared healing core for dropout/partition repair: drop the
    masked-out edges, renormalise surviving rows to stay stochastic,
    and give isolated rows (no surviving out-edges, or explicitly
    forced — dead workers) an exact identity row."""
    masked = w * edge_mask
    rowsum = masked.sum(axis=1, keepdims=True)
    safe = np.where(rowsum > 0, rowsum, 1.0)
    repaired = masked / safe
    iso = rowsum[:, 0] <= 0
    if force_identity is not None:
        iso = iso | force_identity
    isolated = np.nonzero(iso)[0]
    repaired[isolated, :] = 0.0
    repaired[isolated, isolated] = 1.0
    return repaired


def repair_for_link_drop(w: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Rebuild a mixing matrix under per-DIRECTED-EDGE message loss
    (the lossy-link model, ``FaultConfig.msg_drop``).

    ``keep`` is bool [n, n]: keep[i, j] = the message j -> i arrived.
    Dropped edges are removed and surviving rows renormalised (the
    receiver re-weights what it actually heard — the only thing a real
    receiver CAN do), with the ``repair_for_dropout`` healing semantics
    for rows left empty.  The self-edge always survives (a worker never
    loses its own state).

    Correctness note: because each direction drops independently, the
    repaired matrix is row-stochastic but in general NOT doubly
    stochastic even when ``w`` was — plain gossip through it converges
    to a *biased* weighted average.  ``push_sum_link_matrix`` is the
    mass-conserving counterpart that keeps the true mean recoverable.

    A worker with every in/out edge dropped is repaired exactly like a
    crashed worker (identity row) — crash = the degenerate all-links
    case, which is what lets the legacy ``GossipConfig.dropout`` alias
    route through this path."""
    n = w.shape[0]
    mask = (np.asarray(keep, bool) | np.eye(n, dtype=bool)).astype(w.dtype)
    return _repair_edges(w, mask)


def push_sum_link_matrix(w: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Column-stochastic (mass-conserving) effective matrix for
    push-sum / ratio consensus under message loss.

    ``w`` is the round's (already crash/partition/churn-repaired)
    row-stochastic mixing matrix; its transpose is the column-stochastic
    out-share matrix B (sender j splits its mass by its own mixing row).
    A dropped edge j -> i returns its share to the SENDER's self-term
    (the message bounced; mass is never destroyed), so every column
    still sums to exactly 1 and the ratio estimate params/mass stays a
    convex combination of the honest values — the invariant the
    push-sum property tests pin (Σ mass, nodes + in-flight, == n at
    every round)."""
    n = w.shape[0]
    eye = np.eye(n, dtype=bool)
    b = np.asarray(w, np.float64).T
    k = (np.asarray(keep, bool) | eye)
    m = b * k
    # Undelivered share of each column back to the sender's diagonal.
    lost = (b * ~k).sum(axis=0)
    m[np.arange(n), np.arange(n)] += lost
    return m


def split_by_delay(m: np.ndarray, delay: np.ndarray,
                   delay_max: int) -> np.ndarray:
    """Split an effective mixing matrix into its per-staleness parts:
    returns [D+1, n, n] with ``out[d] = m`` masked to the edges whose
    message is d rounds stale (diagonal always d = 0; entries of
    dropped edges are already 0 in ``m``).  ``sum(out, axis=0) == m``
    exactly, so the split never changes the round's total weights —
    only WHICH snapshot each weight applies to.  The input dtype is
    preserved (push-sum's mass-conservation property tests run the
    split in float64; the engines narrow to f32 at device put)."""
    n = m.shape[0]
    d = np.where(np.eye(n, dtype=bool), 0, np.asarray(delay))
    out = np.stack([m * (d == k) for k in range(delay_max + 1)])
    return out.astype(m.dtype)


def repair_for_partition(w: np.ndarray, groups: np.ndarray) -> np.ndarray:
    """Rebuild a mixing matrix under a network partition: edges that
    cross the cut are removed and surviving rows renormalised, exactly
    the ``repair_for_dropout`` healing semantics applied edge-wise.

    ``groups`` is an int vector of partition-side ids; only same-group
    edges survive.  A worker isolated by the cut (all neighbors on the
    other side) keeps its own weights for the span (identity row), so
    every side keeps mixing internally and the fleet re-fuses when the
    partition heals — the matrix is data, nothing is recompiled.
    """
    g = np.asarray(groups).reshape(-1)
    n = w.shape[0]
    if g.shape[0] != n:
        raise ValueError(f"groups has {g.shape[0]} entries for an "
                         f"{n}-worker matrix")
    same = (g[:, None] == g[None, :]).astype(w.dtype)
    return _repair_edges(w, same)
