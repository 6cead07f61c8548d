"""The port's robust aggregators, ``clip_to_ball`` and the federated
form of ``corrupt_update`` against dopt's.

Same inputs (numpy, from a seed) through ``dopt.robust`` /
``dopt.faults`` and their counterparts in ``dopt_torch``.  The
aggregators and the clip are held to 1e-6 (the same f32 ops; only the
association of the sums may differ), with dead lanes (NaN in a dead
lane must not leak), a lone survivor, no survivor, and Krum's ties
(equal scores rank alike only if both packages sort stably).  The lies
are elementwise, so ``corrupt_update`` is held bit for bit in f32 and
bf16.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import dopt.faults as jfaults
import dopt.robust as jrobust
import dopt_torch.faults as tfaults
import dopt_torch.robust as trobust

TOL = 1e-6
W = 7


def _tree(rng, w=W, dup=None):
    """A [W, ...] flat dict (dopt's tree form); ``dup`` maps a lane to
    the lane whose values it copies (equal lanes make Krum ties)."""
    tree = {"a/kernel": rng.standard_normal((w, 5, 3)).astype(np.float32),
            "a/bias": rng.standard_normal((w, 3)).astype(np.float32),
            "b/kernel": rng.standard_normal((w, 11)).astype(np.float32)}
    for dst, src in (dup or {}).items():
        for v in tree.values():
            v[dst] = v[src]
    return tree


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(want, got, tol=TOL):
    assert want.keys() == got.keys()
    for k, a in want.items():
        a = np.asarray(a, np.float64)
        b = got[k].double().numpy()
        assert a.shape == b.shape, k
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        fin = np.isfinite(a)
        assert np.array_equal(a[~fin], b[~fin], equal_nan=True), k
        if fin.any():
            err = np.abs(a[fin] - b[fin]).max() / max(np.abs(a[fin]).max(),
                                                      1.0)
            assert err <= tol, f"{k}: {err:.3e}"


MASKS = {
    "all-alive": [1, 1, 1, 1, 1, 1, 1],
    "dead-lanes": [1, 0, 1, 1, 0, 1, 1],
    "lone-survivor": [0, 0, 0, 1, 0, 0, 0],
    "two-alive": [0, 1, 0, 0, 0, 1, 0],
    "none-alive": [0, 0, 0, 0, 0, 0, 0],
}


def _inputs(mask_name, seed=0, dup=None):
    rng = np.random.default_rng(seed)
    tree = _tree(rng, dup=dup)
    mask = np.asarray(MASKS[mask_name], np.float32)
    # A dead lane holding NaN and Inf: what a screened lane carries.
    dead = np.nonzero(mask == 0)[0]
    if len(dead):
        tree["a/bias"][dead[0]] = np.nan
        tree["b/kernel"][dead[-1], 0] = np.inf
    return tree, mask


@pytest.mark.parametrize("trim", [0.0, 0.1, 0.25, 0.49])
@pytest.mark.parametrize("mask_name", MASKS)
def test_trimmed_mean_matches_dopt(mask_name, trim):
    tree, mask = _inputs(mask_name)
    want = jrobust.masked_trimmed_mean(_j(tree), jnp.asarray(mask), trim)
    got = trobust.masked_trimmed_mean(_t(tree), torch.from_numpy(mask), trim)
    _close(want, got)


@pytest.mark.parametrize("mask_name", MASKS)
def test_median_matches_dopt(mask_name):
    tree, mask = _inputs(mask_name, seed=1)
    want = jrobust.masked_median(_j(tree), jnp.asarray(mask))
    got = trobust.masked_median(_t(tree), torch.from_numpy(mask))
    _close(want, got)


KRUM_TIES = {"distinct": None,
             "ties": {1: 0, 2: 0, 4: 3, 6: 5}}


@pytest.mark.parametrize("ties", KRUM_TIES)
@pytest.mark.parametrize("f,m", [(0, 1), (1, 1), (2, 1), (1, 0), (1, 3),
                                 (2, 10)])
@pytest.mark.parametrize("mask_name", ["all-alive", "dead-lanes",
                                       "lone-survivor", "two-alive",
                                       "none-alive"])
def test_krum_matches_dopt(mask_name, f, m, ties):
    """Scores within 1e-6 where finite and +inf where dopt's are, and the
    aggregate (Krum m=1, multi-Krum otherwise) within 1e-6: with tied
    scores the stable ranks pick the same lanes in both packages."""
    tree, mask = _inputs(mask_name, seed=2, dup=KRUM_TIES[ties])
    ws = np.asarray(jrobust.krum_scores(_j(tree), jnp.asarray(mask), f))
    ts = trobust.krum_scores(_t(tree), torch.from_numpy(mask), f).numpy()
    assert np.array_equal(np.isinf(ws), np.isinf(ts))
    fin = np.isfinite(ws)
    if fin.any():
        assert np.abs(ws[fin] - ts[fin]).max() <= TOL * max(
            np.abs(ws[fin]).max(), 1.0)
    want = jrobust.krum_aggregate(_j(tree), jnp.asarray(mask), f, m)
    got = trobust.krum_aggregate(_t(tree), torch.from_numpy(mask), f, m)
    _close(want, got)


def test_krum_ties_rank_by_lane_order():
    """Equal scores: the lower lane ranks first (a stable sort), so Krum
    picks lane 0 of three identical lanes, and dopt does too."""
    tree, mask = _inputs("all-alive", seed=3, dup={1: 0, 2: 0})
    ts = trobust.krum_scores(_t(tree), torch.from_numpy(mask), 1)
    rank = torch.argsort(torch.argsort(ts, stable=True), stable=True)
    assert rank[0] < rank[1] < rank[2]
    want = jrobust.krum_aggregate(_j(tree), jnp.asarray(mask), 1, 1)
    got = trobust.krum_aggregate(_t(tree), torch.from_numpy(mask), 1, 1)
    _close(want, got)


@pytest.mark.parametrize("name", ["trimmed_mean", "median", "krum",
                                  "multi_krum"])
def test_make_aggregator_matches_dopt(name):
    tree, mask = _inputs("dead-lanes", seed=4)
    kw = dict(trim_frac=0.2, krum_f=1, multi_krum_m=2)
    want = jrobust.make_aggregator(name, **kw)(_j(tree), jnp.asarray(mask))
    got = trobust.make_aggregator(name, **kw)(_t(tree),
                                              torch.from_numpy(mask))
    _close(want, got)


def test_make_aggregator_does_not_serve_mean():
    for mod in (jrobust, trobust):
        with pytest.raises(ValueError, match="unknown robust aggregator"):
            mod.make_aggregator("mean")


@pytest.mark.parametrize("radius", [0.05, 1.0, 100.0])
def test_clip_to_ball_matches_dopt(radius):
    """Lanes inside and outside the ball, one at the center (a zero
    deviation) and one non-finite (its scale becomes 0)."""
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    center = {k: rng.standard_normal(v.shape[1:]).astype(np.float32)
              for k, v in tree.items()}
    for k, v in tree.items():
        v[2] = center[k]
        v[4] = center[k] + 1e-3 * v[4]
    tree["a/bias"][6, 1] = np.nan
    want = jrobust.clip_to_ball(_j(tree), _j(center), radius)
    got = trobust.clip_to_ball(_t(tree), _t(center), radius)
    _close(want, got)
    norms = np.asarray(jrobust.global_norm_f32(_j(center)))
    assert abs(float(trobust.global_norm_f32(_t(center))) - norms) <= \
        TOL * norms


def test_clip_to_ball_bf16_scale_cast_as_dopt():
    """bf16 lanes: the f32 scale is cast to bf16 before the multiply, as
    dopt casts it."""
    rng = np.random.default_rng(6)
    tree = {k: v.astype(ml_dtypes.bfloat16) for k, v in _tree(rng).items()}
    center = {k: np.zeros(v.shape[1:], ml_dtypes.bfloat16)
              for k, v in tree.items()}
    want = jrobust.clip_to_ball(_j(tree), _j(center), 0.5)
    got = trobust.clip_to_ball(
        {k: torch.from_numpy(v.astype(np.float32)).bfloat16()
         for k, v in tree.items()},
        {k: torch.from_numpy(v.astype(np.float32)).bfloat16()
         for k, v in center.items()}, 0.5)
    for k, a in want.items():
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      got[k].float().numpy(), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("mode", ["nan", "inf", "scale", "signflip",
                                  "stale"])
def test_corrupt_update_matches_dopt(mode, with_ref, dtype):
    """Every mode, around the origin (gossip) and around theta
    (federated: ``ref``), with ``prev`` for 'stale': bit for bit."""
    rng = np.random.default_rng(7)
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    tree = {k: v.astype(npdt) for k, v in _tree(rng).items()}
    prev = {k: v.astype(npdt) for k, v in _tree(rng).items()}
    ref = ({k: rng.standard_normal(v.shape[1:]).astype(npdt)
            for k, v in tree.items()} if with_ref else None)
    cmask = np.asarray([1, 0, 0, 1, 0, 1, 0], np.float32)

    def th(t):
        return None if t is None else {
            k: torch.from_numpy(v.astype(np.float32)).to(
                getattr(torch, dtype)) for k, v in t.items()}

    want = jfaults.corrupt_update(
        _j(tree), jnp.asarray(cmask), mode, 7.0,
        ref=None if ref is None else _j(ref), prev=_j(prev))
    got = tfaults.corrupt_update(th(tree), torch.from_numpy(cmask), mode,
                                 7.0, ref=th(ref), prev=th(prev))
    for k, a in want.items():
        assert got[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      got[k].float().numpy(), err_msg=k)


def test_corrupt_stale_without_prev_refused_as_at_gossip_sites():
    tree = _t(_tree(np.random.default_rng(8)))
    with pytest.raises(ValueError, match="only the federated engine"):
        tfaults.corrupt_update(tree, torch.ones(W), "stale", 1.0)
