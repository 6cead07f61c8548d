"""The port's GossipTrainer against dopt's, and the port's boundaries.

Both trainers run the same config from the same init (dopt's, carried
over with ``params_from_jax``): Model1 on the synthetic set, 4 workers,
128 train / 32 test, batch 16, one local epoch, 2 rounds, with both
fused switches off and with both on (dopt runs its Pallas kernels in
interpret mode; the port takes their plain versions on the CPU).
Tolerances, as tests/test_torch_backend.py and test_oracle_parity.py
set them for the oracle: train loss 1e-3 absolute, test accuracy 1e-4
absolute, final worker params 1e-4 max-relative — reordered float sums
drift over dependent SGD steps even inside dopt (PARITY.md).
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import dopt.config as J
import dopt_torch.config as T
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt_torch.convert import params_to_jax
from dopt_torch.engine import GossipTrainer

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once, and torch's default (all cores each) oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, shape, fused, **kw):
    return mod.ExperimentConfig(
        name="parity", seed=11,
        data=mod.DataConfig(dataset="synthetic", num_users=4, iid=False,
                            shards=2, synthetic_train_size=128,
                            synthetic_test_size=32),
        model=mod.ModelConfig(model="model1", input_shape=shape,
                              faithful=True),
        optim=mod.OptimizerConfig(lr=0.05, momentum=0.5, fused_update=fused),
        gossip=mod.GossipConfig(algorithm="dsgd", topology="circle",
                                mode="stochastic", rounds=2, local_ep=1,
                                local_bs=16,
                                fused_update="on" if fused else "off"),
        **kw)


@pytest.mark.parametrize("shape,fused", [((8, 8, 1), False),
                                         ((8, 8, 1), True),
                                         ((28, 28, 1), False)])
def test_slice_matches_dopt(shape, fused, devices):
    jt = JaxGossipTrainer(_cfg(J, shape, fused, mesh_devices=1))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    tt = GossipTrainer(_cfg(T, shape, fused), device="cpu", init_params=init)
    jh, th = jt.run(rounds=2), tt.run(rounds=2)
    assert len(jh.rows) == len(th.rows) == 2
    for a, b in zip(jh.rows, th.rows):
        assert a.keys() == b.keys()
        assert a["round"] == b["round"]
        assert abs(a["avg_train_loss"] - b["avg_train_loss"]) <= 1e-3
        assert abs(a["avg_test_acc"] - b["avg_test_acc"]) <= 1e-4
    want = jax.device_get(jt.worker_params())
    got = params_to_jax(tt.worker_params(), input_shape=shape)
    for layer in want:
        for k in want[layer]:
            a, b = np.asarray(want[layer][k]), got[layer][k]
            assert a.shape == b.shape
            rel = np.abs(a - b).max() / np.abs(a).max()
            assert rel <= 1e-4, f"{layer}.{k}: {rel:.3e}"
    ev = tt.evaluate()
    assert ev["acc"].shape == (4,) and np.isfinite(ev["loss_mean"]).all()


def test_holdout_matches_dopt():
    """The reference's P2 holdout (random 10% val split, local_ep 2): the
    History and the per-epoch client rows (mean-flavour val loss) match
    dopt's, as do the final params."""
    def cfg(mod, **kw):
        c = _cfg(mod, (8, 8, 1), False, **kw)
        return c.replace(
            data=dataclasses.replace(c.data, local_holdout=0.1,
                                     holdout_mode="random"),
            gossip=dataclasses.replace(c.gossip, local_ep=2))

    jt = JaxGossipTrainer(cfg(J, mesh_devices=1))
    init = jax.device_get(jax.tree.map(lambda x: x[0], jt.params))
    tt = GossipTrainer(cfg(T), device="cpu", init_params=init)
    jh, th = jt.run(rounds=2), tt.run(rounds=2)
    for a, b in zip(jh.rows, th.rows, strict=True):
        assert a.keys() == b.keys() and a["round"] == b["round"]
        assert abs(a["avg_train_loss"] - b["avg_train_loss"]) <= 1e-3
        assert abs(a["avg_test_acc"] - b["avg_test_acc"]) <= 1e-4
    jc, tc = jt.client_history.rows, tt.client_history.rows
    assert len(jc) == len(tc) == 2 * 4 * 2
    for a, b in zip(jc, tc):
        assert a.keys() == b.keys()
        for k, v in a.items():
            assert abs(v - b[k]) <= 1e-3, (k, a, b)
    want = jax.device_get(jt.worker_params())
    got = params_to_jax(tt.worker_params(), input_shape=(8, 8, 1))
    for layer in want:
        for k in want[layer]:
            a = np.asarray(want[layer][k])
            assert np.abs(a - got[layer][k]).max() / np.abs(a).max() <= 1e-4


def test_fused_round_zero_equals_default_round_zero():
    """Round 0 of the fused ordering contracts a zero displacement, so
    it trains from exactly the default ordering's mixed state."""
    a = GossipTrainer(_cfg(T, (8, 8, 1), False), device="cpu")
    b = GossipTrainer(_cfg(T, (8, 8, 1), True), device="cpu")
    ra, rb = a.run(rounds=1).rows[0], b.run(rounds=1).rows[0]
    assert ra == rb
    for k, v in a.worker_params().items():
        np.testing.assert_allclose(b.worker_params()[k], v, rtol=1e-6,
                                   atol=1e-7)


def test_no_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GossipTrainer(_cfg(T, (8, 8, 1), False))


def _replace(cfg, section, **kw):
    return cfg.replace(**{section: dataclasses.replace(getattr(cfg, section),
                                                       **kw)})


@pytest.mark.parametrize("edit,match", [
    # Lifted by the codecs slice: choco and the narrowed wire now run
    # (match None).
    pytest.param(lambda c: _replace(c, "gossip", algorithm="choco"), None,
                 id="<lambda>-codecs0"),
    # Lifted by the scatter slice: the scatter path and the shift path
    # now run, and cfg.comm takes a CommConfig (match None).
    pytest.param(lambda c: _replace(c, "gossip", update_sharding="scatter"),
                 None, id="<lambda>-scatter and multi-GPU"),
    pytest.param(lambda c: _replace(c, "gossip", comm_dtype="bfloat16"),
                 None, id="<lambda>-codecs1"),
    pytest.param(lambda c: _replace(c, "gossip", comm_impl="shift"), None,
                 id="<lambda>-scatter"),
    # Lifted by the async slice: the option now runs (match None).
    pytest.param(lambda c: _replace(c, "gossip", mixing="async"), None,
                 id="<lambda>-async"),
    (lambda c: _replace(c, "gossip", eval_mode="stratified"),
     "unknown eval_mode 'stratified'; one of full|sharded"),
    (lambda c: _replace(c, "data", local_holdout=0.1,
                        holdout_mode="stratified"), "holdout"),
    (lambda c: _replace(c, "data", plan_impl="rust"), "native planner"),
    (lambda c: _replace(c, "model", compute_dtype="float16"),
     "unknown model.compute_dtype"),
    # Lifted by the ResNet-18 slice: the model now runs (match None).
    pytest.param(lambda c: _replace(c, "model", model="resnet18"), None,
                 id="<lambda>-ResNet-18"),
    (lambda c: _replace(c, "model", model="transformer"), "seqlm"),
    (lambda c: c.replace(faults=object()), "faults"),
    (lambda c: c.replace(robust=object()), "robust"),
    (lambda c: c.replace(population=object()), "population"),
    pytest.param(lambda c: c.replace(comm=object()),
                 "cfg.comm must be a dopt_torch.config.CommConfig",
                 id="<lambda>-codecs2"),
    (lambda c: c.replace(federated=object()), "federated engine"),
])
def test_unsupported_configs_raise(edit, match):
    cfg = edit(_cfg(T, (8, 8, 1), False))
    if match is None:
        assert len(GossipTrainer(cfg, device="cpu").run(rounds=1).rows) == 1
        return
    with pytest.raises(ValueError, match=match):
        GossipTrainer(cfg, device="cpu")


def test_run_cli_on_cpu(tmp_path, capsys):
    from dopt_torch.run import main

    out = tmp_path / "h.csv"
    assert main(["--preset", "headline-dsgd-model1", "--device", "cpu",
                 "--rounds", "1", "--set", "data.synthetic_train_size=240",
                 "--set", "data.synthetic_test_size=32", "--set",
                 "gossip.local_ep=1", "--set", "gossip.local_bs=20",
                 "--csv", str(out)]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["round"] == 0 and np.isfinite(row["avg_train_loss"])
    assert out.read_text().splitlines()[0] == (
        ",round,avg_test_acc,avg_test_loss,avg_train_loss,avg_train_acc")


def test_run_cli_bf16_preset_on_cpu(capsys):
    """The idiomatic bf16 preset runs from the CLI on the CPU at a shrunk
    size, the header names its dtypes and clip, and ``--set`` reaches
    the trainer; without ``--device cpu`` it raises here."""
    from dopt_torch.presets import get_preset
    from dopt_torch.run import main

    shrink = ["--set", "data.num_users=2", "--set",
              "data.synthetic_train_size=40", "--set",
              "data.synthetic_test_size=8", "--set", "gossip.local_ep=1",
              "--set", "gossip.local_bs=20"]
    assert main(["--preset", "headline-dsgd-model1-idiomatic-bf16",
                 "--device", "cpu", "--rounds", "1", *shrink]) == 0
    out, err = capsys.readouterr()
    assert np.isfinite(json.loads(out.strip().splitlines()[-1])[
        "avg_train_loss"])
    assert ("compute bfloat16, storage float32, clip_norm 1.0" in err)
    assert main(["--preset", "headline-dsgd-model1-bf16", "--device", "cpu",
                 "--rounds", "1", *shrink, "--set",
                 "model.param_dtype=bfloat16", "--set",
                 "optim.clip_norm=0.5"]) == 0
    assert ("compute bfloat16, storage bfloat16, clip_norm 0.5"
            in capsys.readouterr().err)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GossipTrainer(get_preset("headline-dsgd-model1-idiomatic-bf16"))


def test_port_imports_nothing_of_jax_or_dopt(tmp_path):
    """A fresh interpreter imports dopt_torch and runs CPU gossip and
    federated rounds, per-round and in prefetched blocks (the graphs and
    prefetch modules), and saves and restores a checkpoint in both
    engines; runs the MLP through matching, fedlcon and centralized with
    the sharded eval and checkpoints, the logistic model through
    ``baseline4`` and loads the FMNIST and CIFAR fallbacks; neither jax,
    flax, orbax nor dopt may be loaded.  The
    sources must not import them either."""
    code = (
        "import sys\n"
        f"ck = {str(tmp_path)!r}\n"
        "import dopt_torch\n"
        "from dopt_torch import config as C\n"
        "cfg = C.ExperimentConfig(seed=3, data=C.DataConfig("
        "dataset='synthetic', num_users=2, synthetic_train_size=64, "
        "synthetic_test_size=16), model=C.ModelConfig(input_shape=(8, 8, 1),"
        " compute_dtype='bfloat16', param_dtype='bfloat16'),"
        " optim=C.OptimizerConfig(fused_update=True, clip_norm=1.0),"
        " gossip=C.GossipConfig("
        "local_ep=1, local_bs=16, fused_update='on', prefetch='on'))\n"
        "tr = dopt_torch.GossipTrainer(cfg, device='cpu', eval_every=2)\n"
        "tr.run(rounds=1); tr.run(rounds=3, block=2, checkpoint_every=2,"
        " checkpoint_path=ck + '/g')\n"
        "dopt_torch.GossipTrainer(cfg, device='cpu').restore(ck + '/g')\n"
        "fed = cfg.replace(gossip=None, federated=C.FederatedConfig("
        "frac=0.5, local_ep=1, local_bs=16, fused_update='on',"
        " prefetch='on'))\n"
        "tr = dopt_torch.FederatedTrainer(fed, device='cpu')\n"
        "tr.run(rounds=1); tr.run(rounds=3, block=2)\n"
        "tr.save(ck + '/f')\n"
        "dopt_torch.FederatedTrainer(fed, device='cpu').restore(ck + '/f')\n"
        "for algo in ('gossip', 'fedlcon', 'centralized'):\n"
        "    mlp = cfg.replace(model=C.ModelConfig(model='mlp',"
        " input_shape=(8, 8, 1)), gossip=C.GossipConfig(algorithm=algo,"
        " eps=2, local_ep=1, local_bs=16, eval_mode='sharded',"
        " prefetch='on'))\n"
        "    tr = dopt_torch.GossipTrainer(mlp, device='cpu')\n"
        "    tr.run(rounds=3, block=2, checkpoint_every=2,"
        " checkpoint_path=ck + '/' + algo)\n"
        "    dopt_torch.GossipTrainer(mlp, device='cpu').restore("
        "ck + '/' + algo)\n"
        "from dopt_torch.presets import get_preset\n"
        "from dopt_torch.run import apply_override\n"
        "b4 = get_preset('baseline4')\n"
        "for s in ('data.num_users=2', 'data.synthetic_train_size=64',"
        " 'data.synthetic_test_size=16', 'federated.local_bs=16'):\n"
        "    b4 = apply_override(b4, s)\n"
        "dopt_torch.FederatedTrainer(b4, device='cpu').run(rounds=1)\n"
        "for name in ('fmnist', 'cifar100'):\n"
        "    dopt_torch.data.load_dataset(name, train_size=4, test_size=2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'dopt'))\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|orbax|dopt)\b",
                     re.M)
    for path in [*sorted((REPO / "dopt_torch").rglob("*.py")),
                 REPO / "chip_smoke.py"]:
        assert not pat.search(path.read_text()), path
