"""The GroupNorm ResNet-18 and ``baseline5`` against dopt, on the CPU.

The port's worker-stacked ResNet (``dopt_torch.models.zoo``) against
dopt's ``_make_stacked_resnet_apply``: the forward and the gradients,
the stride-2 'SAME' padding, ``_group_norm_stacked`` in f32 and bf16,
the weight carry-over and its name order, one SGD step through each
kernel's plain version, 2-round gossip trajectories on a tiny
``baseline5`` (4 workers, stage sizes (1, 1), 8×8×3 synthetic data), a
fedavg round, and on the port's side blocked ≡ per-round, kill and
resume ≡ continuous and a dopt npz checkpoint restored bit for bit.
dopt runs with ``mesh_devices=1``, its Pallas kernels in interpret mode.

Yardsticks: f32 single steps within 1e-5 relative, 2-round
trajectories within 1e-3 train loss, 1e-4 test accuracy and 1e-4
max-relative params (slice 1's limits); bf16 within a quarter of dopt's
own bf16-vs-f32 distance.  Where a test holds a looser bound it names
dopt's own distance between two of its implementations as the bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dopt.config as J
import dopt_torch.config as T
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt.engine.local import make_stacked_local_update
from dopt.models import losses as jlosses
from dopt.models.zoo import (_group_norm_stacked, build_model,
                             make_stacked_apply)
from dopt.presets import get_preset as jax_preset
from dopt_torch.convert import params_from_jax, params_to_jax, port_layout
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.engine.local import local_steps
from dopt_torch.models import (StackedModel, cross_entropy_stacked, full_f32,
                               group_norm_stacked, param_shapes,
                               stacked_forward)
from dopt_torch.parallel.collectives import make_update_shard_spec
from dopt_torch.presets import get_preset

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _fleet(stages, workers, hw, seed=1):
    """dopt's ResNet and a fleet of distinct inits ([W, ...] leaves)."""
    model = build_model("resnet18", faithful=False, stage_sizes=stages)
    keys = jax.random.split(jax.random.key(seed), workers)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        model.init(k, jnp.zeros((1, hw, hw, 3)))["params"] for k in keys])
    return model, stacked


def _batch(workers, b, hw, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(workers, b, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 10, (workers, b)).astype(np.int32)
    wt = (rng.random((workers, b)) > 0.2).astype(np.float32)
    return x, y, wt


# -- the model --------------------------------------------------------------

@pytest.mark.parametrize("stages,workers,b,hw", [
    ((1, 1), 4, 3, 8), ((2, 2, 2, 2), 2, 4, 32)], ids=["1-1", "full"])
def test_stacked_forward_and_grad_match_dopt(stages, workers, b, hw):
    """The fleet forward and the gradients of the summed per-worker CE
    against dopt's stacked apply, within 1e-5 relative to each tensor's
    largest entry; the tensors' shapes are ``param_shapes``'."""
    model, stacked = _fleet(stages, workers, hw)
    x, y, wt = _batch(workers, b, hw)
    apply = make_stacked_apply(model)

    def loss(p):
        out = apply(p, jnp.asarray(x))
        return jlosses.cross_entropy_stacked(
            out, jnp.asarray(y), jnp.asarray(wt)).sum(), out

    (_, want), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    want_g = params_from_jax(jax.device_get(g))
    tp = {k: torch.tensor(v).requires_grad_()
          for k, v in params_from_jax(jax.device_get(stacked)).items()}
    assert {k: tuple(v.shape[1:]) for k, v in tp.items()} == param_shapes(
        "resnet18", input_shape=(hw, hw, 3), stage_sizes=stages)
    with full_f32(CPU):
        out = stacked_forward("resnet18", tp, torch.tensor(x),
                              faithful=False)
        lw = cross_entropy_stacked(out, torch.tensor(y).long(),
                                   torch.tensor(wt)).sum()
        grads = dict(zip(tp, torch.autograd.grad(lw, list(tp.values()))))
    want = np.asarray(want)
    assert out.shape == want.shape == (workers, b, 10)
    assert np.abs(out.detach().numpy() - want).max() <= 1e-5 * np.abs(
        want).max()
    for k, v in want_g.items():
        assert grads[k].is_contiguous()
        d = np.abs(grads[k].numpy() - v).max()
        assert d <= 1e-5 * np.abs(v).max(), (k, d)


@pytest.mark.parametrize("hw", [8, 7])
def test_stride2_same_padding_is_xla_s(hw):
    """A stride-2 3×3 conv pads as XLA's 'SAME' does — (0, 1) on an even
    axis, (1, 1) on an odd one — and the 1×1 stride-2 shortcut not at
    all; ``F.conv2d(padding=1)`` alone would pad (1, 1) on the even
    axis and disagree."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1, hw, hw, 4)).astype(np.float32)
    for k in (3, 1):
        kern = rng.normal(size=(1, k, k, 4, 8)).astype(np.float32)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x[:, 0]), jnp.asarray(kern[0]), (2, 2), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        params = {"Conv_0.weight": torch.tensor(kern).permute(0, 4, 3, 1, 2)
                  .contiguous()}
        from dopt_torch.models.zoo import _resnet_conv

        z = torch.tensor(x[:, 0]).permute(0, 3, 1, 2)
        with full_f32(CPU):
            got = _resnet_conv(z, params["Conv_0.weight"], 1, torch.float32,
                               stride=2)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
        if k == 3 and hw % 2 == 0:
            naive = F.conv2d(z, params["Conv_0.weight"][0], stride=2,
                             padding=1)
            assert np.abs(naive.permute(0, 2, 3, 1).numpy()
                          - np.asarray(want)).max() > 1e-2


def test_group_norm_stacked_f32_and_bf16():
    """``group_norm_stacked`` against dopt's ``_group_norm_stacked`` on
    worker-major channels (2 workers × 64 channels, 32 groups a worker,
    offset and scaled activations): f32 within 1e-5 relative, bf16
    within a quarter of dopt's own bf16-vs-f32 distance."""
    rng = np.random.default_rng(1)
    z = (rng.normal(size=(3, 5, 5, 128)) * 2.5 + 0.7).astype(np.float32)
    sc = rng.normal(size=(2, 64)).astype(np.float32)
    bi = rng.normal(size=(2, 64)).astype(np.float32)

    def dopt_gn(dt):
        out = _group_norm_stacked(jnp.asarray(z, dt), jnp.asarray(sc),
                                  jnp.asarray(bi), num_workers=2,
                                  groups_per_worker=32)
        assert out.dtype == dt
        return np.asarray(out.astype(jnp.float32))

    def port_gn(dt):
        zt = torch.tensor(z).permute(0, 3, 1, 2).to(dt)
        out = group_norm_stacked(zt, torch.tensor(sc), torch.tensor(bi),
                                 num_workers=2, groups_per_worker=32)
        assert out.dtype == dt
        return out.float().permute(0, 2, 3, 1).numpy()

    w32 = dopt_gn(jnp.float32)
    np.testing.assert_allclose(port_gn(torch.float32), w32,
                               atol=1e-5 * np.abs(w32).max(), rtol=0)
    w16 = dopt_gn(jnp.bfloat16)
    assert _rel_l2(port_gn(torch.bfloat16), w16) <= _rel_l2(w16, w32) / 4


def test_bf16_forward_within_dopts_bf16_distance():
    """bf16 compute: the forward's distance to dopt's bf16 forward is at
    most a quarter of dopt's own bf16-vs-f32 distance."""
    model, stacked = _fleet((1, 1), 2, 8)
    x, _, _ = _batch(2, 4, 8)
    tp = {k: torch.tensor(v)
          for k, v in params_from_jax(jax.device_get(stacked)).items()}
    outs = {}
    for dt in ("float32", "bfloat16"):
        m = build_model("resnet18", faithful=False, stage_sizes=(1, 1),
                        dtype=dt)
        outs[dt] = np.asarray(jnp.asarray(
            make_stacked_apply(m)(stacked, jnp.asarray(x)), jnp.float32))
    with full_f32(CPU):
        got = stacked_forward("resnet18", tp, torch.tensor(x),
                              faithful=False, dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert (_rel_l2(got.numpy(), outs["bfloat16"])
            <= _rel_l2(outs["bfloat16"], outs["float32"]) / 4)


@pytest.mark.parametrize("stacked", [False, True])
def test_convert_round_trip_bit_exact(stacked):
    """dopt's nested tree ↔ the port's dotted names, one worker and the
    fleet: conv kernels [kh, kw, Cin, Cout] ↔ [Cout, Cin, kh, kw], the
    head's kernel ↔ weight, GroupNorm's scale and bias as they are; the
    round trip is bit-exact, and bf16 leaves cross as exact f32."""
    model = build_model("resnet18", faithful=False)
    tree = jax.device_get(model.init(jax.random.key(0),
                                     jnp.zeros((1, 32, 32, 3)))["params"])
    if stacked:
        tree = jax.tree.map(lambda a: np.stack([a, a + 1, a * 2]), tree)
    port = params_from_jax(tree)
    want = {k: s if not stacked else (3, *s) for k, s in param_shapes(
        "resnet18", input_shape=(32, 32, 3)).items()}
    assert {k: v.shape for k, v in port.items()} == want
    assert sum(np.prod(s) for s in param_shapes(
        "resnet18", input_shape=(32, 32, 3)).values()) == 11_173_962
    back = params_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert port_layout(tree).keys() == port.keys()
    assert port_layout(port) == port
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      tree)
    for k, v in params_from_jax(bf).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(
            torch.tensor(v).to(torch.bfloat16).float().numpy(), v)


def test_names_sort_into_dopts_flatten_order():
    """The port's dotted names, sorted, are dopt's flatten order (its
    nested sorted keys), and both the module's registration and the
    fused stores' shard spec take that order; GroupNorm scales start
    at one."""
    model = build_model("resnet18", faithful=False)
    tree = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    paths = [".".join(p.key for p in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    want = [p[:-len("kernel")] + "weight" if p.endswith("kernel") else p
            for p in paths]
    assert len(want) == 62
    assert want == sorted(want)
    assert "ResidualBlock_0.Conv_0.weight" in want
    assert want.index("ResidualBlock_0.Conv_0.weight") < want.index(
        "ResidualBlock_0.GroupNorm_1.scale")
    shapes = param_shapes("resnet18", input_shape=(32, 32, 3))
    assert list(shapes) == want
    p = {k: torch.zeros(2, *s) for k, s in shapes.items()}
    m = StackedModel("resnet18", p, faithful=False)
    assert [k for k, _ in m.named_parameters()] == want
    assert list(make_update_shard_spec(p).names) == want
    gen = torch.Generator().manual_seed(0)
    from dopt_torch.models import init_worker_params

    init = init_worker_params("resnet18", input_shape=(32, 32, 3),
                              generator=gen)
    assert list(init) == want
    for k, v in init.items():
        if k.endswith("scale"):
            assert bool((v == 1).all()), k
        elif k.endswith("bias"):
            assert bool((v == 0).all()), k


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "kernel1"])
def test_one_step_matches_dopt(fused):
    """One momentum-SGD step of a 4-worker (1, 1) fleet through
    ``local_steps`` (a one-step plan over resident rows), the update
    through ``sgd_step`` or kernel 1's plain version, against dopt's
    stacked local update (jnp or its Pallas kernel in interpret mode):
    params and momentum within 1e-5 relative, losses within 1e-5."""
    model, stacked = _fleet((1, 1), 4, 8)
    x, y, wt = _batch(4, 6, 8)
    mom = jax.tree.map(lambda a: jnp.full_like(a, 0.01), stacked)
    f = make_stacked_local_update(
        model.apply, lr=0.1, momentum=0.9,
        update_impl="pallas" if fused else "jnp",
        stacked_apply=make_stacked_apply(model))
    jp, jm, jl, _ = jax.jit(f)(stacked, mom, jnp.asarray(x[:, None]),
                               jnp.asarray(y[:, None]),
                               jnp.asarray(wt[:, None]))
    tp = {k: torch.tensor(v).requires_grad_()
          for k, v in params_from_jax(jax.device_get(stacked)).items()}
    tm = {k: torch.full_like(v, 0.01) for k, v in tp.items()}
    model_t = StackedModel("resnet18", tp, faithful=False)
    w, b = y.shape
    with full_f32(CPU):
        lw, _, _ = local_steps(
            model_t, dict(model_t.named_parameters()), tm,
            torch.arange(w * b).view(w, 1, b), torch.tensor(wt)[:, None],
            torch.tensor(x).reshape(w * b, -1), torch.tensor(y).long().view(-1),
            (8, 8, 3), lr=0.1, momentum=0.9, fused=fused)
    np.testing.assert_allclose(lw.numpy(), np.asarray(jl), rtol=1e-5)
    for want, got in ((jp, tp), (jm, tm)):
        for k, v in params_from_jax(jax.device_get(want)).items():
            d = np.abs(got[k].detach().numpy() - v).max()
            assert d <= 1e-5 * np.abs(v).max(), (k, d)


# -- trainers ---------------------------------------------------------------

def _tiny(mod, *, fused=False, workers=4, prefetch="off", **gossip):
    """``baseline5`` cut to 4 workers, stage sizes (1, 1), 8×8×3
    synthetic data at 256/64 samples and batches of 16 (4 steps a
    round); dopt's lr 0.1, μ 0.9, random metropolis graphs."""
    c = (jax_preset if mod is J else get_preset)("baseline5")
    return c.replace(
        data=dataclasses.replace(c.data, dataset="synthetic",
                                 num_users=workers, synthetic_train_size=256,
                                 synthetic_test_size=64),
        model=dataclasses.replace(c.model, stage_sizes=(1, 1),
                                  input_shape=(8, 8, 3)),
        optim=dataclasses.replace(c.optim, fused_update=fused),
        gossip=dataclasses.replace(c.gossip, local_bs=16, prefetch=prefetch,
                                   fused_update="on" if fused else "off",
                                   **gossip),
        **({"mesh_devices": 1} if mod is J else {}))


def _max_rel(want, got) -> float:
    want = params_from_jax(jax.device_get(want))
    return max(float(np.abs(got[k] - v).max() / np.abs(v).max())
               for k, v in want.items())


def _close_rows(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k, v in a.items():
            assert abs(v - b[k]) <= (1e-4 if "acc" in k else 1e-3), (k, a, b)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_tiny_baseline5_gossip_matches_dopt(fused):
    """2 rounds of the tiny ``baseline5`` from dopt's init.  History
    within 1e-3 train loss and 1e-4 test accuracy.  Params: unfused
    within 1e-4 max-relative; fused within 2e-3, dopt's own bar for its
    stacked ResNet against its vmapped one after an SGD step
    (tests/test_stacked_apply.py): on this run dopt's two
    implementations (``stacked_impl`` auto and vmap) end 6.2e-4 apart
    on the fused path, as far as the port ends from dopt (the momentum
    of 0.9 carries the GroupNorm layers' rounding through the fused
    carry), and 1e-6 apart unfused."""
    jt = JaxGossipTrainer(_tiny(J, fused=fused))
    init = jax.device_get(jax.tree.map(lambda a: a[0], jt.params))
    tt = GossipTrainer(_tiny(T, fused=fused), device="cpu", init_params=init)
    assert tt.steps_per_round == 4 and len(tt._names) == 20
    _close_rows(jt.run(rounds=2).rows, tt.run(rounds=2).rows)
    assert _max_rel(jt.worker_params(), tt.worker_params()) <= (
        2e-3 if fused else 1e-4)


def _fed(mod, *, fused):
    """A 4-client fedavg of the (1, 1) ResNet on 8×8×3 synthetic data,
    half the clients a round: compact lanes unfused, the full-width
    masked mean through kernel 2 (and kernel 1) fused."""
    return mod.ExperimentConfig(
        name="fedavg-resnet", seed=5,
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=32),
        model=mod.ModelConfig(model="resnet18", faithful=False,
                              stage_sizes=(1, 1), input_shape=(8, 8, 3)),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5,
                                  fused_update=fused),
        federated=mod.FederatedConfig(
            algorithm="fedavg", frac=0.5, rounds=2, local_ep=1,
            local_bs=16, fused_update="on" if fused else "off"),
        **({"mesh_devices": 1} if mod is J else {}))


@pytest.mark.parametrize("fused", [False, True], ids=["compact", "fused"])
def test_fedavg_round_matches_dopt(fused):
    """2 fedavg rounds from dopt's init (compact unfused; full width with
    both kernels' plain versions fused): History, theta and the clients'
    params within slice 1's limits."""
    jt = JaxFederatedTrainer(_fed(J, fused=fused))
    tt = FederatedTrainer(_fed(T, fused=fused), device="cpu",
                          init_params=jax.device_get(jt._theta_single()))
    assert tt._use_compact() is not fused
    _close_rows(jt.run(rounds=2).rows, tt.run(rounds=2).rows)
    assert _max_rel(jt._theta_single(), tt.global_params()) <= 1e-4
    assert _max_rel(jt.params, tt.worker_params()) <= 1e-4


def _state(tr) -> dict:
    out = {"rows": [dict(r) for r in tr.history.rows], "round": tr.round,
           "workers": tr.worker_params(),
           "momentum": {str(i): m.detach().numpy().copy()
                        for i, m in enumerate(tr.momentum)}}
    for name in ("_q", "_fbuf"):
        if hasattr(tr, name):
            out[name] = {"": getattr(tr, name).numpy().copy()}
    return out


def _assert_same(want, got):
    assert want.keys() == got.keys()
    for key, w in want.items():
        if isinstance(w, dict):
            assert w.keys() == got[key].keys(), key
            for k in w:
                np.testing.assert_array_equal(got[key][k], w[k],
                                              err_msg=f"{key}.{k}")
        else:
            assert got[key] == w, key


class Killed(Exception):
    """The simulated kill."""


def test_diagnostics_streams_equal_blocked_and_change_nothing():
    """``diagnostics="on"`` on the fused tiny ``baseline5``: every round
    streams the six gauges, per-round and blocked streams are
    canonically equal, and the History and the state are the
    diagnostics-off run's bit for bit."""
    from dopt_torch.obs import MemorySink, Telemetry, attach, canonical

    off = GossipTrainer(_tiny(T, fused=True), device="cpu")
    off.run(rounds=2)
    streams = []
    for block in (1, 2):
        tr = GossipTrainer(_tiny(T, fused=True, diagnostics="on"),
                           device="cpu")
        mem = MemorySink()
        attach(tr, Telemetry([mem]), fresh=True)
        tr.run(rounds=2, block=block)
        _assert_same(_state(off), _state(tr))
        streams.append(mem.events)
    names = {e["name"] for e in streams[0] if e["kind"] == "gauge"}
    assert {"update_norm", "consensus_distance"} <= names
    assert canonical(streams[1]) == canonical(streams[0])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_blocked_and_resumed_equal_per_round(fused, tmp_path, monkeypatch):
    """On the port's side, bit for bit: 3 rounds in blocks of 2 with
    prefetch equal 3 per-round rounds, and a blocked run that saves
    every 2 rounds and dies in round 2 resumes from its checkpoint to
    the same end."""
    cont = GossipTrainer(_tiny(T, fused=fused), device="cpu")
    cont.run(rounds=3)
    want = _state(cont)
    blocked = GossipTrainer(_tiny(T, fused=fused, prefetch="on"),
                            device="cpu")
    blocked.run(rounds=3, block=2)
    _assert_same(want, _state(blocked))

    victim = GossipTrainer(_tiny(T, fused=fused), device="cpu")
    record = victim._record

    def record_or_die(t, *a):
        if t == 2:
            raise Killed(f"killed in round {t}")
        record(t, *a)

    monkeypatch.setattr(victim, "_record", record_or_die)
    with pytest.raises(Killed):
        victim.run(rounds=3, block=2, checkpoint_every=2,
                   checkpoint_path=tmp_path / "ck")
    resumed = GossipTrainer(_tiny(T, fused=fused), device="cpu")
    resumed.restore(tmp_path / "ck")
    assert resumed.round == 2
    resumed.run(rounds=1)
    _assert_same(want, _state(resumed))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_dopt_npz_checkpoint_restores_bit_for_bit(fused, tmp_path,
                                                  monkeypatch):
    """dopt's npz checkpoint of the tiny ``baseline5`` after round 1
    restores into the port bit for bit — the params (the post-mix q
    when fused), the momentum and the fused carry's displacement store
    — and the next round stays within the trajectory test's bounds of
    dopt's resumed round."""
    import dopt.utils.checkpoint as jckpt

    monkeypatch.setattr(jckpt, "HAVE_ORBAX", False)
    jt = JaxGossipTrainer(_tiny(J, fused=fused))
    jt.run(rounds=1)
    jt.save(tmp_path / "dopt")
    arrays = np.load(tmp_path / "dopt" / "state.npz")
    tt = GossipTrainer(_tiny(T, fused=fused), device="cpu")
    tt.restore(tmp_path / "dopt")
    assert tt.round == 1 and tt.history.rows == jt.history.rows

    def npz(prefix):
        tree = {}
        for key in arrays.files:
            parts = key.split("/")
            if parts[0] == prefix:
                node = tree
                for p in parts[1:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = arrays[key]
        return params_from_jax(tree)

    from dopt_torch.parallel.collectives import flat_views

    params = (flat_views(tt._q, tt.fused_spec) if fused
              else dict(zip(tt._names, tt._params)))
    stores = [(npz("params"), params),
              (npz("momentum"), dict(zip(tt._names, tt.momentum)))]
    if fused:
        stores.append((npz("fused_buf"), flat_views(tt._fbuf,
                                                    tt.fused_spec)))
    for want, got in stores:
        assert want.keys() == got.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].detach().numpy(), v)
    jt.run(rounds=1)
    tt.run(rounds=1)
    _close_rows(jt.history.rows, tt.history.rows)
    assert _max_rel(jt.worker_params(), tt.worker_params()) <= (
        2e-3 if fused else 1e-4)


@pytest.mark.parametrize("model", ["mlp", "model1"])
def test_stage_sizes_refused_off_resnet_in_dopts_words(model):
    """``model.stage_sizes`` on any other model is refused in both
    engines with dopt's words (dopt/models/zoo.py:595-596), as dopt's
    ``build_model`` refuses it."""
    with pytest.raises(ValueError, match="stage_sizes applies to resnet18"):
        build_model(model, stage_sizes=(1, 1))
    g = _tiny(T).replace(model=T.ModelConfig(model=model,
                                             stage_sizes=(1, 1)))
    with pytest.raises(ValueError,
                       match="stage_sizes applies to resnet18 only"):
        GossipTrainer(g, device="cpu")
    f = _fed(T, fused=False)
    f = f.replace(model=dataclasses.replace(f.model, model=model))
    with pytest.raises(ValueError,
                       match="stage_sizes applies to resnet18 only"):
        FederatedTrainer(f, device="cpu")


def test_baseline5_preset_is_dopts():
    """``baseline5`` is dopt's, field for field."""
    assert (dataclasses.asdict(get_preset("baseline5"))
            == dataclasses.asdict(jax_preset("baseline5")))
