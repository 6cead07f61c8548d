"""Checkpoint and kill-and-resume in both port engines, against dopt.

Model1 at 8×8 on the synthetic set, 4 workers, 128 train / 32 test,
batch 16, on the CPU (the kernels' plain versions; blocked runs go
through the same static buffers a CUDA graph reads on the card).

* Within the port, dopt's promise bit for bit: a run killed after a
  checkpoint landed (an exception raised from a round) and resumed by a
  fresh trainer equals the continuous run — History and client rows,
  params, momentum, the fused carry, theta and the slab, duals,
  controls and the client-sampling stream — per-round, blocked and
  blocked with prefetch, f32 and bf16 storage, and when the checkpoint
  is restored into a trainer that already ran (its static buffers, and
  on the card its graphs, in use).
* Against dopt: a dopt npz checkpoint (dopt's own ``save`` with orbax
  switched off by ``monkeypatch``) restores into the port, and the next
  round agrees with dopt's resumed round within the single-round
  standard; the port's 3-round kill-and-resume run stays within slice
  1's multi-round limits of dopt's (1e-3 loss, 1e-4 accuracy, 1e-4
  max-relative params).
* dopt's refusals, its atomic save and its size manifest.

The file takes about 60 s under the suite's ``-n 6`` on an 8-core CPU
(the bf16 cases are the slow ones: bf16 convolutions on the CPU).
"""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
import dopt_torch.utils.checkpoint as ckpt
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt_torch.convert import params_to_jax
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.utils import host_rng

SHAPE = (8, 8, 1)
ROUNDS, EVERY, KILL = 5, 2, 3   # checkpoints at rounds 2 and 4; killed in 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(mod, holdout=0.0):
    return mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                          shards=2, synthetic_train_size=128,
                          synthetic_test_size=32, local_holdout=holdout)


def _model(mod, bf16):
    dt = "bfloat16" if bf16 else "float32"
    return mod.ModelConfig(model="model1", input_shape=SHAPE, faithful=True,
                           compute_dtype=dt, param_dtype=dt)


def _gossip_cfg(mod, *, fused=False, bf16=False, prefetch="off", **kw):
    return mod.ExperimentConfig(
        name="ckpt", seed=11, data=_data(mod), model=_model(mod, bf16),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, fused_update=fused),
        gossip=mod.GossipConfig(
            algorithm="dsgd", topology="circle", mode="stochastic",
            rounds=2, local_ep=1, local_bs=16,
            fused_update="on" if fused else "off", prefetch=prefetch),
        **kw)


def _fed_cfg(mod, *, algorithm="fedavg", fused=False, compact=None,
             holdout=0.0, local_ep=1, bf16=False, prefetch="off", **kw):
    return mod.ExperimentConfig(
        name="ckpt", seed=11, data=_data(mod, holdout),
        model=_model(mod, bf16),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, rho=0.1,
                                  fused_update=fused),
        federated=mod.FederatedConfig(
            algorithm=algorithm, frac=0.5, rounds=2, local_ep=local_ep,
            local_bs=16, compact=compact,
            fused_update="on" if fused else "off", prefetch=prefetch),
        **kw)


CASES = {
    "gossip-unfused": (GossipTrainer, _gossip_cfg, {}),
    "gossip-fused": (GossipTrainer, _gossip_cfg, {"fused": True}),
    "gossip-unfused-bf16": (GossipTrainer, _gossip_cfg, {"bf16": True}),
    "gossip-fused-bf16": (GossipTrainer, _gossip_cfg,
                          {"fused": True, "bf16": True}),
    "fedavg-fused": (FederatedTrainer, _fed_cfg, {"fused": True}),
    "fedavg-fused-bf16": (FederatedTrainer, _fed_cfg,
                          {"fused": True, "bf16": True}),
    "fedprox-compact": (FederatedTrainer, _fed_cfg, {"algorithm": "fedprox"}),
    "fedadmm-holdout": (FederatedTrainer, _fed_cfg,
                        {"algorithm": "fedadmm", "holdout": 0.1,
                         "local_ep": 2}),
    "scaffold": (FederatedTrainer, _fed_cfg,
                 {"algorithm": "scaffold", "compact": False}),
}
# mode: (block, prefetch, restore into a trainer that already ran)
MODES = {"per-round": (1, "off", False), "blocked": (2, "off", False),
         "prefetched": (2, "on", False), "blocked-reused": (2, "on", True)}


def _state(tr) -> dict:
    """Everything a run leaves behind, as host values."""
    def host(tree):
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        return {str(k): v.detach().float().numpy().copy() for k, v in items}

    out = {"rows": [dict(r) for r in tr.history.rows],
           "clients": [dict(r) for r in tr.client_history.rows],
           "round": tr.round, "workers": tr.worker_params(),
           "momentum": host(tr.momentum)}
    for name in ("_q", "_fbuf", "_theta_flat"):
        if hasattr(tr, name):
            out[name] = {"": getattr(tr, name).float().numpy().copy()}
    for name in ("theta", "duals", "c_global"):
        if getattr(tr, name, None) is not None:
            out[name] = host(getattr(tr, name))
    if hasattr(tr, "_sample_rng"):
        out["sample_rng"] = tr._sample_rng.bit_generator.state
    return out


def _assert_same(want: dict, got: dict) -> None:
    assert want.keys() == got.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict) and w and isinstance(
                next(iter(w.values())), np.ndarray):
            assert w.keys() == g.keys(), key
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{key}.{k}")
        else:
            assert g == w, key


class Killed(Exception):
    """The simulated kill."""


def _kill_in_round(tr, monkeypatch, t_kill: int) -> None:
    """Make ``tr`` die while recording round ``t_kill`` (per-round and
    blocked runs both record through ``_record``)."""
    record = tr._record

    def record_or_die(t, *a):
        if t == t_kill:
            raise Killed(f"killed in round {t}")
        record(t, *a)

    monkeypatch.setattr(tr, "_record", record_or_die)


@functools.lru_cache(maxsize=None)
def _continuous(case: str) -> dict:
    cls, mk, kw = CASES[case]
    tr = cls(mk(T, **kw), device="cpu")
    tr.run(rounds=ROUNDS)
    return _state(tr)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_kill_and_resume_equals_continuous(case, mode, tmp_path,
                                           monkeypatch):
    """Checkpoints every 2 rounds, killed in round 3: a fresh trainer
    restores round 2's checkpoint and runs the last 3 rounds; or (the
    ``-reused`` mode) a trainer that already ran 4 blocked rounds
    restores it.  Either ends where the continuous per-round run ends,
    bit for bit."""
    cls, mk, kw = CASES[case]
    block, prefetch, reused = MODES[mode]
    cfg = mk(T, **kw, prefetch=prefetch)
    path = tmp_path / "ck"
    victim = cls(cfg, device="cpu")
    _kill_in_round(victim, monkeypatch, KILL)
    with pytest.raises(Killed):
        victim.run(rounds=ROUNDS, block=block, checkpoint_every=EVERY,
                   checkpoint_path=path)
    del victim
    resumed = cls(cfg, device="cpu")
    if reused:
        resumed.run(rounds=4, block=block)
    resumed.restore(path)
    assert resumed.round == 2 and len(resumed.history.rows) == 2
    resumed.run(rounds=ROUNDS - 2, block=block)
    _assert_same(_continuous(case), _state(resumed))


def test_blocked_checkpoints_land_at_block_boundaries(tmp_path, monkeypatch):
    """dopt's rule: a blocked run saves at the first block boundary at
    or past each multiple of K (blocks of 2, K = 3: after rounds 4 and
    6), and stages nothing across a scheduled save."""
    from dopt_torch.engine import graphs

    staged = []

    class Stager(graphs.PrefetchStager):
        def stage(self, key, build, meta):
            staged.append(key)
            super().stage(key, build, meta)

    monkeypatch.setattr(graphs, "PrefetchStager", Stager)
    tr = GossipTrainer(_gossip_cfg(T, prefetch="on"), device="cpu")
    saved = []
    monkeypatch.setattr(tr, "save", lambda p: saved.append(tr.round))
    tr.run(rounds=7, block=2, checkpoint_every=3, checkpoint_path=tmp_path)
    assert saved == [4, 6]
    # Blocks start at 0, 2, 4, 6; the blocks after the saves at rounds 4
    # and 6 are built inline.
    assert staged == [2]


def test_federated_resume_continues_sampling_stream(tmp_path):
    """A resumed run draws the samples a continuous run draws (the
    stream's state is in the checkpoint); a fresh stream would replay
    round 0's."""
    def recording(tr):
        seen = []
        draw = tr._round_participation

        def record(t, chosen=None):
            out = draw(t, chosen)
            seen.append(out[0])
            return out
        tr._round_participation = record
        return seen

    cfg = _fed_cfg(T, fused=True)
    a = FederatedTrainer(cfg, device="cpu")
    want = recording(a)
    a.run(rounds=4)
    b = FederatedTrainer(cfg, device="cpu")
    b.run(rounds=2, checkpoint_every=2, checkpoint_path=tmp_path / "ck")
    c = FederatedTrainer(cfg, device="cpu")
    c.restore(tmp_path / "ck")
    got = recording(c)
    c.run(rounds=2, block=2)
    assert len(want) == 4
    assert [s.tolist() for s in got] == [s.tolist() for s in want[2:]]
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    fresh = host_rng(cfg.seed, 314159)
    fresh.choice(4, 2, replace=False)
    fresh.choice(4, 2, replace=False)
    assert meta["sample_rng_state"] == fresh.bit_generator.state


def test_checkpoint_layout_and_meta(tmp_path):
    """The files, the array keys (the port's layout under dopt's
    top-level names) and dopt's meta keys; bf16 leaves on disk as f32,
    exact."""
    tr = GossipTrainer(_gossip_cfg(T, fused=True, bf16=True), device="cpu")
    tr.run(rounds=1)
    tr.save(tmp_path / "ck")
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "complete.json", "meta.json", "state.npz"]
    arrays, meta = ckpt.load_checkpoint(tmp_path / "ck")
    assert sorted(arrays) == ["fused_buf", "momentum", "params"]
    assert sorted(arrays["params"]) == sorted(tr._names)
    assert {v.dtype for t in arrays.values() for v in t.values()} == {
        np.dtype(np.float32)}
    q = tr._q.float().numpy()
    flat = np.concatenate([arrays["params"][k].reshape(4, -1)
                           for k in sorted(arrays["params"])], axis=1)
    np.testing.assert_array_equal(flat, q[:, :flat.shape[1]])
    assert {"round", "name", "algorithm", "history", "client_history",
            "fault_ledger", "screen_streak", "quarantine_until"} <= set(meta)
    assert meta["round"] == 1 and meta["history"] == tr.history.rows
    assert meta["screen_streak"] == [0] * 4


# -- against dopt ----------------------------------------------------------

def _close(a: float, b: float, tol: float, what) -> None:
    assert abs(a - b) <= tol, (what, a, b)


def _close_tree(want, got, limit) -> None:
    for layer in want:
        for k in want[layer]:
            a, b = np.asarray(want[layer][k]), np.asarray(got[layer][k])
            rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
            assert rel <= limit, f"{layer}.{k}: {rel:.3e}"


def _close_rows(want, got, loss_tol, acc_tol) -> None:
    for a, b in zip(want, got, strict=True):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k, v in a.items():
            _close(v, b[k], acc_tol if "acc" in k else loss_tol, k)


# One round from one state: the single-round standard (PARITY.md), 1e-5.
ROUND_TOL = 1e-5


@pytest.mark.parametrize("engine,fused", [("gossip", False),
                                          ("gossip", True),
                                          ("federated", True)])
def test_dopt_checkpoint_restores_into_port(engine, fused, tmp_path,
                                            monkeypatch):
    """dopt trains 2 rounds and saves (npz); the port restores that
    checkpoint and runs round 2, which agrees with dopt's resumed round
    2 within 1e-5.  From dopt's init, the port's own 3-round run, killed
    in round 2 and resumed from its round-2 checkpoint, stays within
    slice 1's multi-round limits of dopt's 3 rounds."""
    import dopt.utils.checkpoint as jckpt

    monkeypatch.setattr(jckpt, "HAVE_ORBAX", False)
    if engine == "gossip":
        jcls, tcls, mk, kw = (JaxGossipTrainer, GossipTrainer, _gossip_cfg,
                              {"fused": fused})
    else:
        jcls, tcls, mk, kw = (JaxFederatedTrainer, FederatedTrainer,
                              _fed_cfg, {"fused": fused})
    jcfg, tcfg = mk(J, mesh_devices=1, **kw), mk(T, **kw)
    jt = jcls(jcfg)
    jt.run(rounds=2)
    jt.save(tmp_path / "dopt")
    assert (tmp_path / "dopt" / "state.npz").exists()
    jr = jcls(jcfg)
    jr.restore(tmp_path / "dopt")
    jr.run(rounds=1)

    tt = tcls(tcfg, device="cpu")
    tt.restore(tmp_path / "dopt")
    assert tt.round == 2 and tt.history.rows == jt.history.rows
    tt.run(rounds=1)
    _close_rows(jr.history.rows[2:], tt.history.rows[2:], ROUND_TOL,
                ROUND_TOL)
    if engine == "gossip":
        pairs = [(jax.device_get(jr.worker_params()), tt.worker_params())]
    else:
        pairs = [(jax.device_get(jr._theta_single()), tt.global_params()),
                 (jax.device_get(jr.params), tt.worker_params())]
    for want, got in pairs:
        _close_tree(want, params_to_jax(got, input_shape=SHAPE), ROUND_TOL)

    # The port's kill-and-resume run from dopt's init against dopt's
    # continuous 3 rounds (jr: 2 restored + 1).
    jfresh = jcls(jcfg)
    init = jax.device_get(jax.tree.map(lambda x: x[0], jfresh.params)
                          if engine == "gossip" else jfresh._theta_single())
    victim = tcls(tcfg, device="cpu", init_params=init)
    _kill_in_round(victim, monkeypatch, 2)
    with pytest.raises(Killed):
        victim.run(rounds=3, checkpoint_every=1,
                   checkpoint_path=tmp_path / "port")
    resumed = tcls(tcfg, device="cpu", init_params=init)
    resumed.restore(tmp_path / "port")
    resumed.run(rounds=1)
    _close_rows(jr.history.rows, resumed.history.rows, 1e-3, 1e-4)
    if engine == "gossip":
        pairs = [(jax.device_get(jr.worker_params()),
                  resumed.worker_params())]
    else:
        pairs = [(jax.device_get(jr._theta_single()),
                  resumed.global_params()),
                 (jax.device_get(jr.params), resumed.worker_params())]
    for want, got in pairs:
        _close_tree(want, params_to_jax(got, input_shape=SHAPE), 1e-4)


# -- refusals, as dopt's ----------------------------------------------------

def test_gossip_fused_checkpoint_direction_guards(tmp_path):
    """The displacement buffer is carried state: a fused trainer refuses
    an unfused checkpoint, and the reverse."""
    for fused, name in ((True, "on"), (False, "off")):
        tr = GossipTrainer(_gossip_cfg(T, fused=fused), device="cpu")
        tr.run(rounds=1)
        tr.save(tmp_path / name)
    with pytest.raises(ValueError, match="fused_buf"):
        GossipTrainer(_gossip_cfg(T, fused=True), device="cpu").restore(
            tmp_path / "off")
    with pytest.raises(ValueError, match="fused_buf"):
        GossipTrainer(_gossip_cfg(T), device="cpu").restore(tmp_path / "on")


@pytest.mark.parametrize("src,dst", [(True, False), (False, True)])
def test_federated_fused_checkpoints_interchangeable(src, dst, tmp_path):
    """The federated checkpoint holds the single theta (slab row 0), so
    fused and unfused trainers adopt each other's checkpoints; their
    continuations agree to reassociation (1e-5, dopt's bound)."""
    a = FederatedTrainer(_fed_cfg(T, fused=src, compact=False), device="cpu")
    a.run(rounds=2)
    a.save(tmp_path / "ck")
    b = FederatedTrainer(_fed_cfg(T, fused=dst, compact=False), device="cpu")
    b.restore(tmp_path / "ck")
    a.run(rounds=2)
    b.run(rounds=2)
    for want, got in ((a.global_params(), b.global_params()),
                      (a.worker_params(), b.worker_params())):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def _resave(path, src, **edits) -> None:
    """Rewrite a checkpoint with some arrays dropped (``name=None``) or
    its meta edited (``meta={...}``)."""
    arrays, meta = ckpt.load_checkpoint(src)
    meta.update(edits.pop("meta", {}))
    for k in edits:
        arrays.pop(k)
    ckpt.save_checkpoint(path, arrays=arrays, meta=meta)


def test_restore_refuses_wrong_algorithm(tmp_path):
    a = FederatedTrainer(_fed_cfg(T), device="cpu")
    a.run(rounds=1)
    a.save(tmp_path / "ck")
    b = FederatedTrainer(_fed_cfg(T, algorithm="fedadmm"), device="cpu")
    with pytest.raises(ValueError, match="algorithm"):
        b.restore(tmp_path / "ck")
    g = GossipTrainer(_gossip_cfg(T), device="cpu")
    g.save(tmp_path / "g")
    _resave(tmp_path / "choco", tmp_path / "g", meta={"algorithm": "choco"})
    with pytest.raises(ValueError, match="algorithm 'choco'"):
        GossipTrainer(_gossip_cfg(T), device="cpu").restore(
            tmp_path / "choco")


@pytest.mark.parametrize("algorithm,drop", [("fedadmm", "duals"),
                                            ("scaffold", "duals"),
                                            ("scaffold", "c_global")])
def test_restore_refuses_missing_companion_state(algorithm, drop, tmp_path):
    a = FederatedTrainer(_fed_cfg(T, algorithm=algorithm), device="cpu")
    a.run(rounds=1)
    a.save(tmp_path / "ck")
    _resave(tmp_path / "cut", tmp_path / "ck", **{drop: None})
    b = FederatedTrainer(_fed_cfg(T, algorithm=algorithm), device="cpu")
    with pytest.raises(ValueError, match=drop):
        b.restore(tmp_path / "cut")


def test_restore_refuses_other_shapes(tmp_path):
    """A checkpoint of another fleet size or model is refused by name,
    never broadcast into the trainer's tensors."""
    a = GossipTrainer(_gossip_cfg(T), device="cpu")
    a.save(tmp_path / "ck")
    cfg = _gossip_cfg(T)
    b = GossipTrainer(cfg.replace(data=dataclasses.replace(
        cfg.data, num_users=2)), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        b.restore(tmp_path / "ck")


def test_checkpoint_every_requires_path():
    with pytest.raises(ValueError, match="checkpoint_path"):
        FederatedTrainer(_fed_cfg(T), device="cpu").run(
            rounds=1, checkpoint_every=1)
    with pytest.raises(ValueError, match="checkpoint_path"):
        GossipTrainer(_gossip_cfg(T), device="cpu").run(
            rounds=1, checkpoint_every=1)


# -- the checkpoint module: atomic save, size manifest ----------------------

def test_checkpoint_atomic_crash_before_promote(tmp_path, monkeypatch):
    """A save that dies while materialising the new checkpoint leaves
    the previous checkpoint fully loadable."""
    path = tmp_path / "ck"
    ckpt.save_checkpoint(path, arrays={"w": {"a": np.arange(4.0)}},
                         meta={"round": 1})

    def boom(dest, meta):
        raise RuntimeError("simulated crash before meta write")

    monkeypatch.setattr(ckpt, "_write_meta", boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ckpt.save_checkpoint(path, arrays={"w": {"a": np.arange(4.0) * 2}},
                             meta={"round": 2})
    monkeypatch.undo()
    arrays, meta = ckpt.load_checkpoint(path)
    assert meta["round"] == 1
    np.testing.assert_array_equal(arrays["w"]["a"], np.arange(4.0))


def test_checkpoint_atomic_crash_between_renames(tmp_path, monkeypatch):
    """The old checkpoint parked at <path>.old, the promotion rename
    never happens: load falls back; the next save keeps .old until its
    own promotion landed."""
    path = tmp_path / "ck"
    ckpt.save_checkpoint(path, arrays={"w": {"a": np.arange(3.0)}},
                         meta={"round": 7})
    real_replace = os.replace
    calls = {"n": 0}

    def crashy_replace(src, dst):
        calls["n"] += 1
        if calls["n"] == 2:  # first = park old, second = promote tmp
            raise RuntimeError("simulated crash mid-swap")
        return real_replace(src, dst)

    monkeypatch.setattr(ckpt.os, "replace", crashy_replace)
    with pytest.raises(RuntimeError, match="mid-swap"):
        ckpt.save_checkpoint(path, arrays={"w": {"a": np.arange(3.0) * 5}},
                             meta={"round": 8})
    monkeypatch.undo()
    assert not (path / "meta.json").exists()
    arrays, meta = ckpt.load_checkpoint(path)
    assert meta["round"] == 7
    np.testing.assert_array_equal(arrays["w"]["a"], np.arange(3.0))

    calls["n"] = 10  # disarm
    monkeypatch.setattr(ckpt.os, "replace", crashy_replace)
    real_rmtree = ckpt.shutil.rmtree

    def guarded_rmtree(p, *a, **kw):
        if str(p).endswith(".old") and not (path / "meta.json").exists():
            raise AssertionError(".old deleted while no primary exists")
        return real_rmtree(p, *a, **kw)

    monkeypatch.setattr(ckpt.shutil, "rmtree", guarded_rmtree)
    ckpt.save_checkpoint(path, arrays={"w": {"a": np.arange(3.0) * 9}},
                         meta={"round": 9})
    monkeypatch.undo()
    arrays, meta = ckpt.load_checkpoint(path)
    assert meta["round"] == 9
    assert not path.with_name(path.name + ".old").exists()


def test_truncated_checkpoint_raises_clear_error(tmp_path):
    path = tmp_path / "ckpt"
    arrays = {"theta": {"w": np.arange(64, dtype=np.float32)}}
    ckpt.save_checkpoint(path, arrays=arrays, meta={"round": 3})
    a, m = ckpt.load_checkpoint(path)
    assert m["round"] == 3
    np.testing.assert_array_equal(a["theta"]["w"], arrays["theta"]["w"])
    state = path / "state.npz"
    state.write_bytes(state.read_bytes()[: state.stat().st_size // 2])
    with pytest.raises(ckpt.IncompleteCheckpointError, match="truncated"):
        ckpt.load_checkpoint(path)


def test_half_written_checkpoint_falls_back_then_errors(tmp_path):
    path = tmp_path / "ckpt"
    ckpt.save_checkpoint(path, arrays={"x": np.ones(4)}, meta={"round": 1})
    ckpt.save_checkpoint(path, arrays={"x": np.full(4, 2.0)},
                         meta={"round": 2})
    (path / "meta.json").unlink()
    with pytest.raises(ckpt.IncompleteCheckpointError):
        ckpt.load_checkpoint(path)
    # A parked complete copy is the fallback.
    ckpt.save_checkpoint(path.with_name("ckpt.old"),
                         arrays={"x": np.full(4, 3.0)}, meta={"round": 3})
    arrays, meta = ckpt.load_checkpoint(path)
    assert meta["round"] == 3
    np.testing.assert_array_equal(arrays["x"], np.full(4, 3.0))


def test_orbax_checkpoint_refused_by_name(tmp_path):
    (tmp_path / "ck" / "state").mkdir(parents=True)
    (tmp_path / "ck" / "meta.json").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_checkpoint(tmp_path / "ck")


def test_meta_expect_reports_every_mismatch():
    ckpt.meta_expect({"a": 1, "b": 2}, a=1, b=2, c=None)
    with pytest.raises(ValueError, match="a=1 .*; b=2 "):
        ckpt.meta_expect({"a": 1, "b": 2}, a=3, b=4)


def test_bf16_round_trip_is_exact():
    """bf16 goes to disk as f32 and comes back as the same bits."""
    x = torch.randn(3, 1000).to(torch.bfloat16)
    host = ckpt.host_tree({"x": x})
    assert host["x"].dtype == np.float32
    y = torch.zeros_like(x)
    ckpt.copy_into({"x": y}, host, what="t")
    assert torch.equal(x.view(torch.int16), y.view(torch.int16))


# -- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("preset,sets", [
    ("headline-dsgd-model1", ["gossip.local_ep=1", "gossip.local_bs=20"]),
    ("headline-fedavg-model1", ["federated.local_ep=1",
                                "federated.local_bs=20", "data.num_users=2"]),
])
def test_cli_kill_and_resume_csv_byte_identical(preset, sets, tmp_path,
                                                capsys):
    """``--rounds 2 --checkpoint ck --checkpoint-every 1`` then
    ``--resume ck --rounds 2`` writes the CSV a continuous ``--rounds
    4`` writes, byte for byte."""
    from dopt_torch.run import main

    base = ["--preset", preset, "--device", "cpu", "--set",
            "data.synthetic_train_size=80", "--set",
            "data.synthetic_test_size=16"]
    for s in sets:
        base += ["--set", s]
    ck, a, b = tmp_path / "ck", tmp_path / "a.csv", tmp_path / "b.csv"
    assert main([*base, "--rounds", "4", "--csv", str(a)]) == 0
    assert main([*base, "--rounds", "2", "--checkpoint", str(ck),
                 "--checkpoint-every", "1"]) == 0
    assert main([*base, "--rounds", "2", "--resume", str(ck), "--csv",
                 str(b)]) == 0
    assert "resumed at round 2" in capsys.readouterr().err
    assert a.read_bytes() == b.read_bytes()
    with pytest.raises(SystemExit, match="requires --checkpoint"):
        main([*base, "--rounds", "1", "--checkpoint-every", "1"])
