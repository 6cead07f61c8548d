"""dopt_torch's host side against dopt's: configs, presets, mixing
schedules, data, partitions, batch plans and metrics.

Every host-side draw is numpy in both packages, so everything here is
held BIT-IDENTICAL (array_equal / ==), never to a tolerance.
"""

import dataclasses

import numpy as np
import pytest

import dopt.config as jcfg
import dopt_torch.config as tcfg
from dopt import topology as jtopo
from dopt.data import datasets as jds
from dopt.data.partition import partition as jpartition
from dopt.data import pipeline as jpipe
from dopt.utils import metrics as jmetrics
from dopt.utils import prng as jprng
from dopt_torch import topology as ttopo
from dopt_torch.data import datasets as tds
from dopt_torch.data.partition import partition as tpartition
from dopt_torch.data import pipeline as tpipe
from dopt_torch.utils import metrics as tmetrics
from dopt_torch.utils import prng as tprng


@pytest.mark.parametrize("topology", ["circle", "complete", "star"])
@pytest.mark.parametrize("mode", ["stochastic", "double_stochastic",
                                  "metropolis"])
def test_mixing_matrices_bit_identical(topology, mode):
    if topology == "star" and mode == "double_stochastic":
        # No zero-diagonal doubly-stochastic star exists: both refuse.
        for mod in (jtopo, ttopo):
            with pytest.raises(ValueError, match="Sinkhorn"):
                mod.build_mixing_matrices(topology, mode, 6, seed=2028)
        return
    for n, seed in ((6, 2028), (5, 3)):
        want = jtopo.build_mixing_matrices(topology, mode, n, seed=seed)
        got = ttopo.build_mixing_matrices(topology, mode, n, seed=seed)
        assert len(got.matrices) == len(want.matrices)
        for t in range(len(want.matrices)):
            np.testing.assert_array_equal(got.for_round(t), want.for_round(t))


@pytest.mark.parametrize("topology,mode,kw", [
    ("dynamic", "stochastic", {}), ("random", "metropolis", {}),
    ("torus", "uniform", {"self_weight": True}),
    ("hierarchical", "ones", {"groups": 2, "period": 3}),
    ("one_peer_exp", "stochastic", {}),
])
def test_time_varying_schedules_bit_identical(topology, mode, kw):
    want = jtopo.build_mixing_matrices(topology, mode, 8, seed=5, **kw)
    got = ttopo.build_mixing_matrices(topology, mode, 8, seed=5, **kw)
    for t in range(12):
        np.testing.assert_array_equal(got.for_round(t), want.for_round(t))


@pytest.mark.parametrize("iid", [True, False])
def test_partition_bit_identical(iid):
    labels = np.random.default_rng(0).integers(0, 10, 600).astype(np.int32)
    for users, shards in ((6, 2), (4, 3)):
        jg, jm = jpartition(labels, users, iid=iid, shards_per_user=shards,
                            seed=2028)
        tg, tm = tpartition(labels, users, iid=iid, shards_per_user=shards,
                            seed=2028)
        np.testing.assert_array_equal(tm, jm)
        assert jg.keys() == tg.keys()
        for k in jg:
            np.testing.assert_array_equal(tg[k], jg[k])


@pytest.mark.parametrize("batch,ep", [(16, 1), (7, 3), (128, 4), (10, 2)])
def test_batch_plan_bit_identical(batch, ep):
    index = np.random.default_rng(1).permutation(600).reshape(6, 100)
    index = index.astype(np.int32)
    for rnd in (0, 3):
        want = jpipe.make_batch_plan(index, batch_size=batch, local_ep=ep,
                                     seed=2028, round_idx=rnd)
        got = tpipe.make_batch_plan(index, batch_size=batch, local_ep=ep,
                                    seed=2028, round_idx=rnd)
        np.testing.assert_array_equal(got.idx, want.idx)
        np.testing.assert_array_equal(got.weight, want.weight)
        assert got.idx.dtype == want.idx.dtype


def test_datasets_bit_identical():
    kw = dict(train_size=300, test_size=70, seed=11)
    for name, shape in (("synthetic", (8, 8, 1)), ("mnist", None)):
        want = jds.load_dataset(name, input_shape=shape, **kw)
        got = tds.load_dataset(name, input_shape=shape, **kw)
        assert got.name == want.name
        for f in ("train_x", "train_y", "test_x", "test_y"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype
    x, y = want.test_x, want.test_y
    for a, b in zip(tpipe.eval_batches(x, y, batch_size=32),
                    jpipe.eval_batches(x, y, batch_size=32), strict=True):
        np.testing.assert_array_equal(a, b)
    for load in (jds.load_dataset, tds.load_dataset):
        with pytest.raises(FileNotFoundError,
                           match="no raw files for 'imagenet'"):
            load("imagenet")


def test_idx_reader_and_raw_mnist_dir(tmp_path):
    """Raw IDX files under data_dir load identically (gzipped or not)."""
    import gzip
    import struct

    rng = np.random.default_rng(2)

    def write(name, arr, gz):
        head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
            ">" + "I" * arr.ndim, *arr.shape)
        path = tmp_path / "MNIST" / "raw" / (name + (".gz" if gz else ""))
        path.parent.mkdir(parents=True, exist_ok=True)
        with (gzip.open if gz else open)(path, "wb") as f:
            f.write(head + arr.tobytes())

    for stem, n, gz in (("train", 40, True), ("t10k", 12, False)):
        write(f"{stem}-images-idx3-ubyte",
              rng.integers(0, 256, (n, 28, 28)).astype(np.uint8), gz)
        write(f"{stem}-labels-idx1-ubyte",
              rng.integers(0, 10, n).astype(np.uint8), gz)
    want = jds.load_dataset("mnist", data_dir=tmp_path)
    got = tds.load_dataset("mnist", data_dir=tmp_path)
    assert got.name == want.name == "mnist"
    for f in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_host_rng_and_metrics_bit_identical(tmp_path):
    a = jprng.host_rng(2028, 60551).random(16)
    b = tprng.host_rng(2028, 60551).random(16)
    np.testing.assert_array_equal(a, b)
    samples = [3.0, 1.0, 2.5, 9.0, 2.0, 2.2]
    assert tmetrics.trimmed_stats(samples) == jmetrics.trimmed_stats(samples)
    rows = [{"round": 0, "avg_train_loss": 2.3, "avg_train_acc": 0.1,
             "avg_test_acc": 0.2, "avg_test_loss": 2.2},
            {"round": 1, "avg_train_loss": np.float32(2.1),
             "avg_train_acc": 0.3}]
    paths = []
    for mod, tag in ((jmetrics, "j"), (tmetrics, "t")):
        h = mod.History("x")
        for r in rows:
            h.append(**r)
        paths.append(h.to_csv(tmp_path / f"{tag}.csv"))
        assert h.rows == rows
    assert paths[0].read_bytes() == paths[1].read_bytes()


@pytest.mark.parametrize("mode", ["deterministic", "random"])
def test_holdout_split_bit_identical(mode):
    from dopt.data.partition import holdout_split as jsplit
    from dopt_torch.data.partition import holdout_split as tsplit

    index = np.random.default_rng(3).permutation(600).reshape(6, 100)
    index = np.sort(index, axis=1).astype(np.int32)
    for frac, seed in ((0.1, 2028), (0.25, 7), (0.001, 0)):
        want = jsplit(index, fraction=frac, mode=mode, seed=seed)
        got = tsplit(index, fraction=frac, mode=mode, seed=seed)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for bad in (dict(fraction=0.0), dict(fraction=1.0),
                dict(mode="stratified")):
        kw = {"fraction": 0.1, "mode": mode, **bad}
        with pytest.raises(ValueError):
            jsplit(index, **kw)
        with pytest.raises(ValueError):
            tsplit(index, **kw)


def test_batch_plan_for_sampled_workers_bit_identical():
    """``workers=`` plans only the sampled rows, keyed by the true worker
    id: equal to dopt's, and to those rows of the full plan."""
    index = np.random.default_rng(4).permutation(800).reshape(8, 100)
    index = index.astype(np.int32)
    full = tpipe.make_batch_plan(index, batch_size=30, local_ep=2, seed=5,
                                 round_idx=3)
    for sel in (np.array([1, 4, 6]), np.array([7]), np.arange(8)):
        want = jpipe.make_batch_plan(index, batch_size=30, local_ep=2, seed=5,
                                     round_idx=3, workers=sel)
        got = tpipe.make_batch_plan(index, batch_size=30, local_ep=2, seed=5,
                                    round_idx=3, workers=sel)
        for f in ("idx", "weight"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(full, f)[sel])


def test_stacked_eval_batches_bit_identical():
    index = np.random.default_rng(5).integers(0, 1000, (5, 37))
    index = index.astype(np.int32)
    for bs in (8, 37, 64, 256):
        want = jpipe.stacked_eval_batches(index, batch_size=bs)
        got = tpipe.stacked_eval_batches(index, batch_size=bs)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("workers,frac", [(16, 0.5), (100, 0.1)])
def test_client_sample_sequence_bit_identical(workers, frac):
    """Five rounds of the port trainer's client sample against dopt's own
    ``_sample_indices`` on dopt's seeded stream."""
    import types

    from dopt.engine.federated import FederatedTrainer as JaxFed
    from dopt_torch.engine import FederatedTrainer

    cfg = tcfg.ExperimentConfig(
        seed=2022, data=tcfg.DataConfig(
            dataset="synthetic", num_users=workers, iid=True,
            synthetic_train_size=2 * workers, synthetic_test_size=8),
        model=tcfg.ModelConfig(input_shape=(8, 8, 1)),
        federated=tcfg.FederatedConfig(frac=frac, local_bs=2))
    port = FederatedTrainer(cfg, device="cpu")
    ref = types.SimpleNamespace(num_workers=workers,
                                _sample_rng=jprng.host_rng(2022, 314159))
    for _ in range(5):
        want = JaxFed._sample_indices(ref, frac)
        got = port._sample_indices()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and len(got) == max(int(frac *
                                                               workers), 1)


@pytest.mark.parametrize("cls", ["DataConfig", "ModelConfig",
                                 "OptimizerConfig", "GossipConfig",
                                 "FederatedConfig"])
def test_config_fields_mirror_dopt(cls):
    """Every field the port keeps has dopt's name and default."""
    jf = {f.name: f for f in dataclasses.fields(getattr(jcfg, cls))}
    for f in dataclasses.fields(getattr(tcfg, cls)):
        assert f.name in jf, f"{cls}.{f.name} is not a dopt field"
        assert f.default == jf[f.name].default, f"{cls}.{f.name}"


def _shared(port_cfg, jax_cfg):
    """Each section of a port config as a dict, next to the same fields
    of the dopt config."""
    out = []
    for sec in ("data", "model", "optim", "gossip", "federated"):
        if getattr(port_cfg, sec) is None:
            assert getattr(jax_cfg, sec) is None, sec
            continue
        t = dataclasses.asdict(getattr(port_cfg, sec))
        j = dataclasses.asdict(getattr(jax_cfg, sec))
        out.append((t, {k: j[k] for k in t}))
    return out


@pytest.mark.parametrize("name", ["reference-fedavg", "reference-fedprox",
                                  "reference-fedadmm", "reference-scaffold",
                                  "baseline3",
                                  "reference-dsgd-star",
                                  "reference-dsgd-circle",
                                  "reference-dsgd-complete",
                                  "reference-dsgd-circle-double",
                                  "reference-dsgd-complete-double",
                                  "reference-dsgd-dynamic"])
def test_reference_presets_match_dopt(name):
    from dopt.presets import get_preset as jget
    from dopt_torch.presets import get_preset as tget

    t, j = tget(name), jget(name)
    assert (t.name, t.seed) == (j.name, j.seed)
    for a, b in _shared(t, j):
        assert a == b


def test_headline_preset_is_bench_config_with_both_kernels():
    """headline-dsgd-model1 = bench.py _config(fast=False) at MNIST scale
    with both fused_update switches on."""
    from dopt.config import ExperimentConfig, GossipConfig, OptimizerConfig
    from dopt_torch.presets import get_preset

    bench = ExperimentConfig(  # bench.py:115-149, fast=False
        seed=2028,
        data=jcfg.DataConfig(dataset="mnist", num_users=6, iid=False,
                             shards=2, synthetic_train_size=60_000,
                             synthetic_test_size=10_000, plan_impl="numpy"),
        model=jcfg.ModelConfig(model="model1", faithful=True,
                               compute_dtype="float32"),
        optim=OptimizerConfig(lr=0.01, momentum=0.5, fused_update=True),
        gossip=GossipConfig(algorithm="dsgd", topology="circle",
                            mode="stochastic", rounds=10, local_ep=4,
                            local_bs=128, fused_update="on"))
    t = get_preset("headline-dsgd-model1")
    assert t.seed == bench.seed
    for a, b in _shared(t, bench):
        assert a == b


@pytest.mark.parametrize("faithful", [True, False])
def test_bf16_presets_are_bench_fast_legs(faithful):
    """headline-dsgd-model1[-idiomatic]-bf16 = bench.py
    _config(fast=True, faithful_model=faithful, fused="on") at MNIST
    scale with both fused_update switches on, the native planner
    included."""
    import importlib.util
    import pathlib

    from dopt_torch.presets import get_preset

    path = pathlib.Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("dopt_bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    want = bench._config(fast=True, train_size=60_000, test_size=10_000,
                         faithful_model=faithful, fused="on")
    assert want.data.plan_impl == "native"
    want = want.replace(
        optim=dataclasses.replace(want.optim, fused_update=True))
    suffix = "" if faithful else "-idiomatic"
    t = get_preset(f"headline-dsgd-model1{suffix}-bf16")
    assert t.name == f"headline-dsgd-model1{suffix}-bf16"
    assert t.seed == want.seed
    for a, b in _shared(t, want):
        assert a == b
    assert (t.model.compute_dtype, t.model.param_dtype) == ("bfloat16",
                                                            "float32")
    assert t.optim.clip_norm == (0.0 if faithful else 1.0)


def test_headline_fedavg_preset_is_baseline3_with_both_kernels():
    """headline-fedavg-model1 = dopt's baseline3 with both fused_update
    switches on: 16 clients of 3,750 samples, 375 steps a round."""
    from dopt.presets import get_preset as jget
    from dopt_torch.presets import get_preset as tget

    b3 = jget("baseline3")
    want = b3.replace(
        optim=dataclasses.replace(b3.optim, fused_update=True),
        federated=dataclasses.replace(b3.federated, fused_update="on"))
    t = tget("headline-fedavg-model1")
    assert t.seed == want.seed
    for a, b in _shared(t, want):
        assert a == b
    f = t.federated
    labels = np.random.default_rng(0).integers(
        0, 10, t.data.synthetic_train_size)
    _, index = tpartition(labels, t.data.num_users, iid=t.data.iid,
                          shards_per_user=t.data.shards, seed=t.seed)
    plan = tpipe.make_batch_plan(index, batch_size=f.local_bs,
                                 local_ep=f.local_ep, seed=t.seed)
    assert index.shape == (16, 3750) and plan.idx.shape == (16, 375, 50)
    assert max(int(f.frac * t.data.num_users), 1) == 8
    # Kernel 2 runs once a bucket: Model1 flattens to two 4 MiB buckets.
    import torch

    from dopt_torch.models.zoo import param_shapes
    from dopt_torch.parallel.collectives import make_update_shard_spec

    spec = make_update_shard_spec(
        {k: torch.empty(16, *s) for k, s in param_shapes("model1").items()},
        bucket_bytes=int(f.update_bucket_mb * (1 << 20)))
    assert spec.num_buckets == 2


def test_cli_override_and_list(capsys):
    from dopt_torch.presets import get_preset
    from dopt_torch.run import apply_override, main

    cfg = get_preset("reference-dsgd-circle")
    cfg = apply_override(cfg, "optim.lr=0.05")
    cfg = apply_override(cfg, "gossip.comm_dtype=none")
    cfg = apply_override(cfg, "data.iid=true")
    assert (cfg.optim.lr, cfg.gossip.comm_dtype, cfg.data.iid) == (
        0.05, None, True)
    for bad in ("optim.lr", "optim.nope=1", "data.iid=maybe",
                "model.input_shape=3", "faults.crash=0.1"):
        with pytest.raises(SystemExit):
            apply_override(cfg, bad)
    assert main(["--preset", "list"]) == 0
    assert "headline-dsgd-model1" in capsys.readouterr().out.split()
