"""Multi-round blocks and the prefetched pipeline in both port engines.

Model1 at 8×8 on the synthetic set, 4 workers, 128 train / 32 test,
batch 16, on the CPU (the kernels' plain versions; the block loop runs
the round body eagerly on the same static buffers a CUDA graph reads on
the card).  Within the port the contract is dopt's own: a blocked run
is the per-round run bit for bit — History rows, client rows, final
params, momentum, the fused carry, theta and the slab, duals, controls
and the client-sampling stream — over 5 rounds in blocks of 2 and of 3
(a shorter last block), and ``run(2)`` then ``run(3)`` in blocks of 2;
``prefetch="on"`` is ``"off"`` bit for bit.  Against dopt, slice 1's
limits (1e-3 train loss, 1e-4 test accuracy, 1e-4 max-relative
params): the blocked gossip run against dopt's blocked run, the blocked
federated run against dopt's per-round run (dopt's own federated
blocked stream has a seed failure on this jax, ROADMAP queue 3).
The file takes 20-32 s under the suite's ``-n 6`` on an 8-core CPU.
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt_torch.convert import params_to_jax
from dopt_torch.data import PrefetchStager
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.engine.graphs import RoundGraphs
from dopt_torch.models import deterministic
from dopt_torch.ops import fused_update
from dopt_torch.optim import _scalar

SHAPE = (8, 8, 1)


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
                          synthetic_test_size=32, local_holdout=holdout,
                          holdout_mode="deterministic")


def _gossip_cfg(mod, *, fused=False, holdout=0.0, local_ep=1, bf16=False,
                clip=0.0, prefetch="off", **kw):
    dt = "bfloat16" if bf16 else "float32"
    return mod.ExperimentConfig(
        name="blocks", seed=11, data=_data(mod, holdout),
        model=mod.ModelConfig(model="model1", input_shape=SHAPE,
                              faithful=True, compute_dtype=dt,
                              param_dtype=dt),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, fused_update=fused,
                                  clip_norm=clip),
        gossip=mod.GossipConfig(
            algorithm="dsgd", topology="circle", mode="stochastic",
            rounds=2, local_ep=local_ep, local_bs=16,
            fused_update="on" if fused else "off", prefetch=prefetch),
        **kw)


def _fed_cfg(mod, *, algorithm="fedavg", fused=False, compact=None,
             holdout=0.0, local_ep=1, prefetch="off", **kw):
    return mod.ExperimentConfig(
        name="blocks", seed=11, data=_data(mod, holdout),
        model=mod.ModelConfig(model="model1", input_shape=SHAPE,
                              faithful=True),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, rho=0.1,
                                  fused_update=fused),
        federated=mod.FederatedConfig(
            algorithm=algorithm, frac=0.5, rounds=2, local_ep=local_ep,
            local_bs=16, compact=compact,
            fused_update="on" if fused else "off", prefetch=prefetch),
        **kw)


GOSSIP = {
    "unfused": {},
    "fused": {"fused": True},
    "bf16-storage-clip": {"fused": True, "bf16": True, "clip": 1.0},
    "holdout": {"holdout": 0.1, "local_ep": 2},
}
FEDERATED = {
    "fedavg-fused": {"fused": True},
    "fedprox-compact": {"algorithm": "fedprox"},
    "fedadmm-compact-holdout": {"algorithm": "fedadmm", "holdout": 0.1,
                                "local_ep": 2},
    "scaffold-full": {"algorithm": "scaffold", "compact": False},
}


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


def _run(cls, cfg, plan, **kw) -> dict:
    """A fresh trainer through ``plan``: a list of (rounds, block)."""
    tr = cls(cfg, device="cpu", **kw)
    for rounds, block in plan:
        tr.run(rounds=rounds, block=block)
    return _state(tr)


@functools.lru_cache(maxsize=None)
def _per_round(engine: str, case: str, eval_every: int = 1) -> dict:
    if engine == "gossip":
        return _run(GossipTrainer, _gossip_cfg(T, **GOSSIP[case]),
                    [(5, 1)], eval_every=eval_every)
    return _run(FederatedTrainer, _fed_cfg(T, **FEDERATED[case]), [(5, 1)])


PLANS = {"block2": [(5, 2)], "block3": [(5, 3)],
         "run2-then-run3": [(2, 2), (3, 2)]}


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("case", GOSSIP)
def test_gossip_blocked_equals_per_round(case, plan):
    got = _run(GossipTrainer, _gossip_cfg(T, **GOSSIP[case]), PLANS[plan])
    _assert_same(_per_round("gossip", case), got)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("case", FEDERATED)
def test_federated_blocked_equals_per_round(case, plan):
    got = _run(FederatedTrainer, _fed_cfg(T, **FEDERATED[case]),
               PLANS[plan])
    _assert_same(_per_round("federated", case), got)


@pytest.mark.parametrize("engine,case", [("gossip", "fused"),
                                         ("gossip", "holdout"),
                                         ("federated", "fedavg-fused"),
                                         ("federated",
                                          "fedadmm-compact-holdout")])
def test_prefetch_on_equals_off(engine, case):
    """Prefetch-on blocks equal prefetch-off blocks (and so the
    per-round run), the sampling stream included; block 2 over 5
    rounds stages the second and the third (shorter) block."""
    if engine == "gossip":
        cls, mk, kw = GossipTrainer, _gossip_cfg, GOSSIP[case]
    else:
        cls, mk, kw = FederatedTrainer, _fed_cfg, FEDERATED[case]
    off = _run(cls, mk(T, **kw, prefetch="off"), [(5, 2)])
    on = _run(cls, mk(T, **kw, prefetch="on"), [(5, 2)])
    _assert_same(off, on)
    _assert_same(_per_round(engine, case), on)


def test_block_rounds_from_config_and_eval_every():
    """``gossip.block_rounds`` is run()'s default block; with
    ``eval_every=2`` rounds 1 and 3 lack the test keys, blocked or
    not, and the blocked run is the per-round one bit for bit."""
    cfg = _gossip_cfg(T, fused=True)
    cfg = cfg.replace(gossip=dataclasses.replace(cfg.gossip, block_rounds=2))
    got = _run(GossipTrainer, cfg, [(5, None)], eval_every=2)
    want = _per_round("gossip", "fused", eval_every=2)
    _assert_same(want, got)
    assert [("avg_test_acc" in r) for r in got["rows"]] == [
        True, False, True, False, True]


def _close_tree(want, got, limit=1e-4):
    for layer in want:
        for k in want[layer]:
            a, b = np.asarray(want[layer][k]), got[layer][k]
            rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
            assert rel <= limit, f"{layer}.{k}: {rel:.3e}"


def test_gossip_blocked_matches_dopt_blocked():
    """``run(rounds=2, block=2)`` in both packages, both fused
    switches on, from dopt's init, with ``eval_every=2``: the same rows
    carry the test keys, within slice 1's limits."""
    jt = JaxGossipTrainer(_gossip_cfg(J, fused=True, mesh_devices=1),
                          eval_every=2)
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    tt = GossipTrainer(_gossip_cfg(T, fused=True), device="cpu",
                       init_params=init, eval_every=2)
    jh, th = jt.run(rounds=2, block=2), tt.run(rounds=2, block=2)
    for a, b in zip(jh.rows, th.rows, strict=True):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        assert abs(a["avg_train_loss"] - b["avg_train_loss"]) <= 1e-3
        if "avg_test_acc" in a:
            assert abs(a["avg_test_acc"] - b["avg_test_acc"]) <= 1e-4
    assert ["avg_test_acc" in r for r in th.rows] == [True, False]
    _close_tree(jax.device_get(jt.worker_params()),
                params_to_jax(tt.worker_params(), input_shape=SHAPE))


@pytest.mark.parametrize("case", ["fedavg-fused", "fedadmm-compact-holdout"])
def test_federated_blocked_matches_dopt_per_round(case):
    kw = FEDERATED[case]
    jt = JaxFederatedTrainer(_fed_cfg(J, mesh_devices=1, **kw))
    init = jax.device_get(jt._theta_single())
    tt = FederatedTrainer(_fed_cfg(T, **kw), device="cpu", init_params=init)
    jh, th = jt.run(rounds=2), tt.run(rounds=2, block=2)
    for a, b in zip(jh.rows, th.rows, strict=True):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        for k in ("train_loss", "local_loss", "test_loss", "train_acc"):
            assert abs(a[k] - b[k]) <= 1e-3, (k, a, b)
        assert abs(a["test_acc"] - b["test_acc"]) <= 1e-4, (a, b)
    for a, b in zip(jt.client_history.rows, tt.client_history.rows,
                    strict=True):
        assert a.keys() == b.keys()
        for k, v in a.items():
            assert abs(v - b[k]) <= 1e-3, (k, a, b)
    _close_tree(jax.device_get(jt._theta_single()),
                params_to_jax(tt.global_params(), input_shape=SHAPE))
    _close_tree(jax.device_get(jt.params),
                params_to_jax(tt.worker_params(), input_shape=SHAPE))


def test_round_graphs_on_cpu_stage_and_pack():
    """On the CPU ``RoundGraphs`` copies round j's slice into the static
    buffers, runs the body on them with round j's kind and stacks the
    slot after each round."""
    seen = []
    slot = torch.zeros(3)

    def body(statics, kind):
        seen.append((kind, statics["x"].clone()))
        slot.copy_(statics["x"] * (10.0 if kind else 1.0))

    graphs = RoundGraphs(body, slot)
    x = torch.arange(6.0).reshape(2, 3)
    out = graphs.run_block({"x": x}, [True, False])
    np.testing.assert_array_equal(out.numpy(), [[0, 10, 20], [3, 4, 5]])
    assert [k for k, _ in seen] == [True, False]
    assert all(torch.equal(v, x[j]) for j, (_, v) in enumerate(seen))
    assert graphs.captures == {}


def test_launch_count_helpers():
    before = fused_update.launch_counts()
    assert set(before) == {"fused_sgd_momentum", "fused_mix_sgd"}
    fused_update.add_launch_counts({"fused_mix_sgd": 3})
    fused_update.add_launch_counts({"fused_mix_sgd": -3})
    assert fused_update.launch_counts() == before


def test_deterministic_mode_sets_and_restores_flags():
    """On a CUDA device the mode turns on cuDNN's deterministic
    algorithms (no autotuning), torch's deterministic mode without the
    NaN fill, and restores every flag; on the CPU it changes nothing."""
    import torch.utils.deterministic as det

    cudnn = torch.backends.cudnn
    flags = lambda: (cudnn.deterministic, cudnn.benchmark,  # noqa: E731
                     torch.are_deterministic_algorithms_enabled(),
                     det.fill_uninitialized_memory)
    before = flags()
    with deterministic(torch.device("cpu")):
        assert flags() == before
    with deterministic(torch.device("cuda")):
        assert flags() == (True, False, True, False)
    assert flags() == before


def test_scalar_rounding_is_cached():
    """The update's scalars round as jnp's weak typing rounds them and
    are looked up, not rebuilt, after the first use."""
    b = torch.zeros(1, dtype=torch.bfloat16)
    assert _scalar(0.9, b) == 0.8984375
    assert _scalar(0.5, torch.zeros(1)) == 0.5
    from dopt_torch.optim import rounded
    hits = rounded.cache_info().hits
    _scalar(0.9, b)
    assert rounded.cache_info().hits == hits + 1


def test_prefetch_stager_contract():
    """Take returns what was staged (or None), a key miss drops the
    rest, the queue holds one staged block, build errors surface at
    take, and discard joins."""
    st = PrefetchStager()
    assert st.take(0) is None
    st.stage(1, lambda m: m * 2, 21)
    with pytest.raises(RuntimeError, match="queue full"):
        st.stage(2, lambda m: m, 0)
    assert st.take(1) == 42 and len(st) == 0
    st.stage(3, lambda m: m, 0)
    assert st.take(4) is None and len(st) == 0
    st.stage(5, lambda m: 1 / m, 0)
    with pytest.raises(ZeroDivisionError):
        st.take(5)
    st.stage(6, lambda m: m, 0)
    st.discard()
    assert len(st) == 0
    with pytest.raises(ValueError, match="depth"):
        PrefetchStager(depth=1)


@pytest.mark.parametrize("preset,sets,keys", [
    ("headline-dsgd-model1",
     ["gossip.block_rounds=2", "gossip.prefetch=on", "gossip.local_ep=1",
      "gossip.local_bs=20"], {"avg_train_loss", "avg_test_acc"}),
    ("headline-fedavg-model1",
     ["federated.block_rounds=2", "federated.prefetch=on",
      "federated.local_ep=1", "federated.local_bs=20", "federated.rounds=3",
      "data.num_users=2"], {"local_loss", "test_acc"}),
])
def test_run_cli_blocked_prefetched_on_cpu(preset, sets, keys, capsys):
    """``python -m dopt_torch.run`` runs blocked and prefetched from
    ``--set`` alone: three rounds, a block of 2 then 1."""
    from dopt_torch.run import main

    argv = ["--preset", preset, "--device", "cpu", "--set",
            "data.synthetic_train_size=80", "--set",
            "data.synthetic_test_size=16"]
    for s in sets:
        argv += ["--set", s]
    if preset.startswith("headline-dsgd"):
        argv += ["--rounds", "3"]
    assert main(argv) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["round"] for r in rows] == [0, 1, 2]
    assert all(keys <= r.keys() and np.isfinite(r[next(iter(keys))])
               for r in rows)
