"""Byzantine robustness for the port: the screens, clipped gossip and
quarantine.

The port's copy of ``dopt.robust``, over stacked ``[W, ...]`` tensor
dicts:

* ``finite_lane_mask`` — the non-finite screen (a lane with any NaN/Inf
  is flagged); the federated mean runs it on every round;
* ``lane_sq_norms`` — each lane's squared L2 norm, f32-accumulated;
* ``clip_to_ball`` — each lane's deviation from a center clipped to an
  L2 ball (the federated ``clip_radius``);
* the federated server's robust aggregators (``make_aggregator``):
  ``masked_trimmed_mean``, ``masked_median`` and Krum / multi-Krum
  (``krum_aggregate``), each over the alive lanes of a 0/1 mask with
  the survivor count as data (dead lanes sorted past the alive block
  and position-weighted out), so a captured round replays them with
  any mask;
* ``byzantine_mix`` — one UNDEFENDED consensus sweep under Byzantine
  sends: receivers absorb what neighbours broadcast, each self-term
  reads the worker's true state, non-finite poison reaches exactly the
  senders' out-edges;
* ``clipped_gossip_mix`` — the decentralized defense (He et al.,
  ClippedGossip): every neighbour deviation clipped to ``tau`` before
  the weights apply; returns the per-sender screened flags;
* ``quarantine_step`` — the host streak/sentence rule.

All device functions take data (masks, matrices) as tensors, so a
captured round replays them with new values.
"""

from __future__ import annotations

import numpy as np
import torch

# dopt.robust.masked_mean is collectives.masked_average without the mesh
# and wire knobs, which the port's single-device average never has.
from dopt_torch.parallel.collectives import masked_average as masked_mean

AGGREGATORS = ("mean", "trimmed_mean", "median", "krum", "multi_krum")


def validate_robust_config(cfg) -> None:
    """Range/enum checks for ``RobustConfig`` — fail at trainer
    construction with a clean message, not deep inside a trace."""
    if cfg.aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {cfg.aggregator!r}; one of "
                         f"{AGGREGATORS}")
    if not 0.0 <= cfg.trim_frac < 0.5:
        raise ValueError(
            f"RobustConfig.trim_frac={cfg.trim_frac} must be in [0, 0.5) "
            "(trimming half from each end leaves nothing)")
    if cfg.krum_f < 0:
        raise ValueError("RobustConfig.krum_f must be >= 0")
    if cfg.multi_krum_m < 0:
        raise ValueError("RobustConfig.multi_krum_m must be >= 0")
    if cfg.clip_radius < 0:
        raise ValueError("RobustConfig.clip_radius must be >= 0")
    if cfg.quarantine_after < 0:
        raise ValueError("RobustConfig.quarantine_after must be >= 0")
    if cfg.quarantine_rounds < 1:
        raise ValueError("RobustConfig.quarantine_rounds must be >= 1")


def finite_lane_mask(stacked: dict[str, torch.Tensor]) -> torch.Tensor:
    """[W] float32 flag per lane: 1.0 iff EVERY entry of the lane, across
    all tensors, is finite (one NaN anywhere marks the whole lane)."""
    flags = None
    for x in stacked.values():
        f = torch.isfinite(x).reshape(x.shape[0], -1).all(1)
        flags = f if flags is None else flags & f
    return flags.float()


def lane_sq_norms(stacked: dict[str, torch.Tensor]) -> torch.Tensor:
    """[W] float32 squared L2 norm of each lane across all tensors."""
    out = None
    for k in sorted(stacked):
        x = stacked[k]
        s = (x.float() ** 2).reshape(x.shape[0], -1).sum(1)
        out = s if out is None else out + s
    return out


def _lane(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def global_norm_f32(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """Global L2 norm of a dict of tensors, f32-accumulated."""
    return torch.sqrt(sum((tree[k].float() ** 2).sum() for k in sorted(tree)))


def clip_to_ball(stacked: dict[str, torch.Tensor],
                 center: dict[str, torch.Tensor],
                 radius: float) -> dict[str, torch.Tensor]:
    """Clip each lane's deviation from ``center`` (no worker axis) to an
    L2 ball of ``radius`` over the whole model: the per-lane scale
    min(1, r/‖dev‖) (non-finite scales become 0) is cast to each
    tensor's dtype.  ``radius=0`` is the caller's 'off' sentinel."""
    dev = {k: x - center[k] for k, x in stacked.items()}
    n = torch.sqrt(torch.clamp_min(lane_sq_norms(dev), 1e-24))
    s = torch.clamp_max(radius / n, 1.0)
    s = torch.where(torch.isfinite(s), s, torch.zeros_like(s))
    return {k: (center[k] + _lane(s, x).to(x.dtype) * dev[k]).to(x.dtype)
            for k, x in stacked.items()}


def masked_trimmed_mean(stacked: dict[str, torch.Tensor], mask: torch.Tensor,
                        trim_frac: float) -> dict[str, torch.Tensor]:
    """Coordinate-wise trimmed mean over the alive lanes: per coordinate
    the alive values are sorted and the k largest and k smallest
    dropped, k = floor(trim_frac · n_alive) clamped so one value
    survives.  Dead lanes sort past the alive block (+inf) and are
    position-weighted out.  Only the sorted values are used, so the
    sort need not be stable."""
    m = mask.float()
    n_alive = m.sum().to(torch.int32)
    k = torch.minimum((n_alive.float() * trim_frac).to(torch.int32),
                      torch.clamp_min((n_alive - 1) // 2, 0))
    out = {}
    for name, x in stacked.items():
        inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
        xs = torch.sort(torch.where(_lane(m, x).bool(), x, inf), dim=0).values
        pos = _lane(torch.arange(x.shape[0], device=x.device), x)
        sel = (pos >= k) & (pos < n_alive - k)
        kept = torch.where(sel, xs, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
        denom = torch.clamp_min(n_alive - 2 * k, 1).to(x.dtype)
        out[name] = kept.sum(0) / denom
    return out


def masked_median(stacked: dict[str, torch.Tensor],
                  mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """Coordinate-wise median over the alive lanes: the mean of the
    middle one or two alive positions of each sorted coordinate, read
    at positions that are data."""
    m = mask.float()
    n_alive = torch.clamp_min(m.sum().to(torch.int64), 1)
    lo = ((n_alive - 1) // 2).reshape(1)
    hi = (n_alive // 2).reshape(1)
    out = {}
    for name, x in stacked.items():
        inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
        xs = torch.sort(torch.where(_lane(m, x).bool(), x, inf), dim=0).values
        a = torch.index_select(xs, 0, lo)[0]
        b = torch.index_select(xs, 0, hi)[0]
        out[name] = ((a + b) / 2).to(x.dtype)
    return out


def krum_scores(stacked: dict[str, torch.Tensor], mask: torch.Tensor,
                f: int) -> torch.Tensor:
    """[W] Krum scores (Blanchard et al. 2017): each alive lane's summed
    squared distance to its n_alive − f − 2 closest alive peers, from
    the f32 Gram matrix of the lanes flattened in sorted-name order.
    Dead lanes and non-finite pairs score +inf."""
    flat = torch.cat([stacked[k].reshape(stacked[k].shape[0], -1).float()
                      for k in sorted(stacked)], 1)
    w = flat.shape[0]
    mb = mask.float().bool()
    n_alive = mask.float().sum().to(torch.int64)
    gram = flat @ flat.T
    n2 = torch.diagonal(gram)
    d2 = n2[:, None] + n2[None, :] - 2.0 * gram
    eye = torch.eye(w, dtype=torch.bool, device=flat.device)
    valid = mb[:, None] & mb[None, :] & ~eye & torch.isfinite(d2)
    inf = torch.full((), float("inf"), device=flat.device)
    d2 = torch.where(valid, torch.clamp_min(d2, 0.0), inf)
    ds = torch.sort(d2, dim=1).values
    c = torch.clamp(n_alive - f - 2, min=1, max=w - 1)
    pos = torch.arange(w, device=flat.device)[None, :]
    score = torch.where(pos < c, ds, torch.zeros_like(ds)).sum(1)
    return torch.where(mb, score, inf)


def krum_aggregate(stacked: dict[str, torch.Tensor], mask: torch.Tensor,
                   f: int, m: int = 1) -> dict[str, torch.Tensor]:
    """Krum (m=1) / multi-Krum: the mean of the m best-scored alive lanes
    (m=0 takes n_alive − f, clamped to [1, n_alive]).  The rank is
    argsort(argsort(scores)) with stable sorts, as jnp's, so ties rank
    alike; a round whose every alive lane scores +inf (a lone survivor)
    falls back to the masked mean of the alive lanes."""
    scores = krum_scores(stacked, mask, f)
    mask_f = mask.float()
    n_alive = torch.clamp_min(mask_f.sum().to(torch.int64), 1)
    if m > 0:
        m_eff = torch.clamp_max(n_alive, m)
    else:
        m_eff = torch.minimum(torch.clamp_min(n_alive - f, 1), n_alive)
    rank = torch.argsort(torch.argsort(scores, stable=True), stable=True)
    sel = (rank < m_eff).float() * mask_f
    sel = torch.where(sel.sum() > 0, sel, mask_f)
    return masked_mean(stacked, sel)


def make_aggregator(name: str, *, trim_frac: float = 0.1, krum_f: int = 1,
                    multi_krum_m: int = 0):
    """The ``aggregator=`` knob as ``fn(stacked, mask) -> dict`` without
    the worker axis.  'mean' is not served here: the engine keeps its
    exact masked-average call for it."""
    if name == "trimmed_mean":
        return lambda s, m: masked_trimmed_mean(s, m, trim_frac)
    if name == "median":
        return masked_median
    if name == "krum":
        return lambda s, m: krum_aggregate(s, m, krum_f, 1)
    if name == "multi_krum":
        return lambda s, m: krum_aggregate(s, m, krum_f, multi_krum_m)
    raise ValueError(f"unknown robust aggregator {name!r}; one of "
                     f"{AGGREGATORS[1:]}")


def _contract(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``tensordot(w, x, [[1], [0]])``: ``[n, n]`` by ``[n, ...]``."""
    return (w @ x.reshape(x.shape[0], -1)).reshape(x.shape)


def byzantine_mix(x: dict[str, torch.Tensor], x_send: dict[str, torch.Tensor],
                  w_matrix: torch.Tensor) -> dict[str, torch.Tensor]:
    """One undefended consensus sweep under Byzantine sends:

        x_i ← W_ii · x_i + Σ_{j≠i} W_ij · x_send_j

    in f32, cast back to each tensor's dtype.  A liar lies on the wire
    and keeps its own state honest; a non-finite sender's column is
    zeroed before the product (0·NaN would poison every row) and the
    receivers with a weighted edge from it become NaN.  With honest
    sends this is the dense consensus step."""
    wm = w_matrix.float()
    n = wm.shape[0]
    eye = torch.eye(n, device=wm.device)
    off = wm * (1.0 - eye)
    diag = torch.diagonal(wm)
    fin = finite_lane_mask(x_send)
    poisoned = (off @ (1.0 - fin)) > 0.0
    out = {}
    for k, xr in x.items():
        xs = x_send[k]
        zero = torch.zeros((), dtype=xs.dtype, device=xs.device)
        xs_z = torch.where(_lane(fin, xs).bool(), xs, zero)
        y = _lane(diag, xr) * xr.float() + _contract(off, xs_z.float())
        y = torch.where(_lane(poisoned, xr), torch.full_like(y, float("nan")),
                        y)
        out[k] = y.to(xr.dtype)
    return out


def clipped_gossip_mix(x: dict[str, torch.Tensor],
                       x_send: dict[str, torch.Tensor],
                       w_matrix: torch.Tensor, tau: float
                       ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """One clipped-gossip sweep (He et al., ClippedGossip):

        x_i ← x_i + Σ_{j≠i} W_ij · s_ij · (x_send_j − x_i),
        s_ij = min(1, τ / ‖x_send_j − x_i‖)   (0 for non-finite sends)

    ``x`` is each worker's true state, ``x_send`` its broadcast.  The
    distances come from the Gram identity over the lanes flattened in
    sorted-name order (dopt's tree order), all in f32.  Returns
    ``(mixed, screened)``: ``screened`` [W] is 1.0 for a sender that was
    non-finite or clipped by a majority of its neighbours."""
    names = sorted(x)
    fin = finite_lane_mask(x_send)
    x_send_z = {k: torch.where(_lane(fin, s).bool(), s,
                               torch.zeros((), dtype=s.dtype, device=s.device))
                for k, s in x_send.items()}
    flat_r = torch.cat([x[k].reshape(x[k].shape[0], -1).float()
                        for k in names], 1)
    flat_s = torch.cat([x_send_z[k].reshape(x_send_z[k].shape[0], -1).float()
                        for k in names], 1)
    n = flat_r.shape[0]
    d2 = ((flat_r ** 2).sum(1)[:, None] + (flat_s ** 2).sum(1)[None, :]
          - 2.0 * flat_r @ flat_s.T)
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    s = torch.clamp_max(tau / torch.clamp_min(dist, 1e-12), 1.0)
    s = torch.where(torch.isfinite(s), s, torch.zeros_like(s))
    eye = torch.eye(n, device=flat_r.device)
    s = s * (1.0 - eye) * fin[None, :]
    wm = w_matrix.float()
    c = wm * s
    rowsum = c.sum(1)
    mixed = {}
    for k, xr in x.items():
        y = (_lane(1.0 - rowsum, xr) * xr.float()
             + _contract(c, x_send_z[k].float()))
        mixed[k] = y.to(xr.dtype)
    edges = (wm * (1.0 - eye)) > 0.0
    clipped = edges & (s < 1.0)
    frac = clipped.sum(0).float() / torch.clamp_min(edges.sum(0), 1).float()
    screened = torch.maximum((frac > 0.5).float(), 1.0 - fin)
    return mixed, screened


def quarantine_step(streak: np.ndarray, until: np.ndarray,
                    ids: np.ndarray, flags: np.ndarray, t: int, *,
                    after: int, rounds: int) -> list[tuple[int, int]]:
    """One host-side detection/quarantine update over identity arrays:
    K consecutive screened participations → benched for ``rounds``; one
    clean participation resets the streak.  The rule the gossip engine
    applies lane by lane (``GossipTrainer._apply_screen_feedback``, and
    its device twin in the fused-quarantine round).

    ``streak``/``until`` are the identity-indexed int arrays (mutated
    in place); ``ids`` the identities that PARTICIPATED this round with
    their 0/1 ``flags``.  ``after`` <= 0 disables sentencing (streaks
    still track).  Returns [(id, until)] for the identities quarantined
    THIS call, so the caller can ledger them."""
    sentenced: list[tuple[int, int]] = []
    for j, wid in enumerate(np.asarray(ids).reshape(-1)):
        wid = int(wid)
        if float(flags[j]) > 0.5:
            streak[wid] += 1
            if after > 0 and streak[wid] >= after:
                until[wid] = int(t) + 1 + int(rounds)
                streak[wid] = 0
                sentenced.append((wid, int(until[wid])))
        else:
            streak[wid] = 0
    return sentenced
