"""The multi-GPU engines on the CPU: the port's trainers over R gloo
ranks against dopt's at ``mesh_devices = R`` on the suite's virtual
devices, for R ∈ {2, 4}.

Each R is one spawn (``dopt_torch.parallel.spawn_ranks``, a ``file://``
rendezvous) that runs every config of tests/torch_engine_rank_body.py on
its ranks, once per test session: the first test worker to need an R
runs the spawn under a file lock, the others read its results.  Each
config is a case of its own; the case runs dopt's trainer at
``mesh_devices = R`` (and ``mesh_hosts = 2`` on the hybrid cases) from
the same init and compares.  W = 8 workers (L = 4 or 2 lanes a rank),
2 rounds, an MLP (and Model1 on two cases) on 8×8 synthetic data.

Tolerances, slice 1's multi-round limits: train and test loss 1e-3,
test accuracy 1e-4, worker params (and theta) 1e-4 max-relative.  The
fault ledger, the client rows and the shift set are exact, and the
History is equal on every rank.  The bucket codec: a 1e-7 difference
can move a level by one where v/scale + u sits at an integer, so at
most 1e-3 of the elements may differ by up to one q8 level; a bf16 wire
one bf16 step on at most 1e-3 of the elements (the codecs slice's rule).

The port's own promises hold bit for bit at R ranks: two runs equal,
blocked ≡ per-round (gossip faults and robust layer, federated chaos
and staleness), killed and resumed ≡ continuous.  A one-rank checkpoint
resumed at R ranks is within the limits of the R-rank run, and rank 0's
checkpoint of an R-rank run restores at one rank bit for bit.  Every
refusal is dopt's, in dopt's words: the fused epilogue on a multi-rank
group, shift and scatter and population on a hybrid layout, population
lanes that do not divide the ranks, compact sampling across ranks.

The sequence-parallel LM rides the same spawn: ``SeqLMTrainer`` with the
sequence split over the R ranks (ring, ring with ``kv_chunk``, Ulysses
with 8 heads) against dopt's ``SeqLMTrainer(mesh_devices=R)`` — one step
within 1e-5, three within the trainer bound (loss 1e-4, params 1e-4
max-relative) — and dopt's rank-count refusals in dopt's words.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from filelock import FileLock

import dopt.config as J
import dopt_torch.config as T
import torch_engine_rank_body as body
from dopt.engine import FederatedTrainer as JaxFederatedTrainer
from dopt.engine import GossipTrainer as JaxGossipTrainer
from dopt.engine import SeqLMTrainer as JaxSeqLMTrainer
from dopt_torch.convert import params_from_jax, params_to_jax
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.parallel import spawn_ranks

LOSS_TOL, ACC_TOL, PARAM_TOL = 1e-3, 1e-4, 1e-4
RANKS = (2, 4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(ranks: int) -> list[str]:
    return ([n for n in [*body.CONFIGS, *body.SEQLM, *body.SEQLM_REFUSED]
             if body.runs_at(n, ranks)] + list(body.PROMISES))


def _jax_cls(name: str):
    return (JaxGossipTrainer if body.CONFIGS[name][0] == "gossip"
            else JaxFederatedTrainer)


def _prepare(out) -> None:
    """dopt's init of each model (its flax tree, one worker) and the
    one-rank checkpoints the ``from1`` promises resume at R ranks."""
    for model, cfg in (("mlp", "dsgd-dense"), ("model1", "dsgd-model1")):
        jt = JaxGossipTrainer(body.build(J, cfg, 1))
        body.save_tree(out / f"init.{model}.npz",
                       jax.device_get(jax.tree.map(lambda x: x[0],
                                                   jt.params)))
    jt = JaxSeqLMTrainer(body.build_seqlm(J, "seqlm-ring", 1))
    body.save_tree(out / "init.transformer.npz", jax.device_get(jt.params))
    init = body.load_tree(out / "init.mlp.npz")
    for cfg in ("dsgd-dense", "fedavg"):
        tr = body.trainer(cfg, 1, init)
        tr.run(rounds=1)
        tr.save(out / f"{cfg}.one.ck")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(R)``: the directory holding the R-rank results, made by
    one spawn a session (shared by the test workers)."""
    base = tmp_path_factory.getbasetemp()
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
            ) / "torch-multigpu"
    root.mkdir(parents=True, exist_ok=True)
    done = {}

    def get(ranks: int):
        if ranks not in done:
            out = root / f"r{ranks}"
            with FileLock(str(root / f"r{ranks}.lock")):
                if not (out / "done").exists():
                    shutil.rmtree(out, ignore_errors=True)
                    out.mkdir(parents=True)
                    _prepare(out)
                    spawn_ranks(body.body, ranks, out / "rendezvous",
                                str(out), _names(ranks))
                    (out / "done").write_text("ok")
            done[ranks] = out
        return done[ranks]

    return get


def _records(out, name: str, ranks: int) -> list[dict]:
    return [json.loads((out / f"{name}.r{r}.json").read_text())
            for r in range(ranks)]


def _arrays(out, name: str) -> dict:
    return dict(np.load(out / f"{name}.npz"))


def _rows(want, got) -> None:
    """History (or client) rows: the same keys, integers equal, accuracies
    within 1e-4 and losses within 1e-3 (a diverged NaN on both sides)."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.keys() == b.keys(), (a, b)
        for k, v in a.items():
            if not isinstance(v, float):
                assert v == b[k], (k, a, b)
            elif np.isnan(v):
                assert np.isnan(b[k]), (k, a, b)
            else:
                tol = ACC_TOL if "acc" in k else LOSS_TOL
                assert abs(v - b[k]) <= tol, (k, a, b)


def _close(want: dict, got: dict, *, few=None) -> None:
    """Every array within 1e-4 max-relative; with ``few = (frac,
    extra)`` at most ``frac`` of all elements may exceed it by up to
    ``extra(a, amax)``."""
    total = off = 0
    for name, a in want.items():
        b = got[name]
        assert a.shape == b.shape, name
        # A lane poisoned by a NaN lie is NaN in both packages.
        nan = np.isnan(a)
        assert np.array_equal(nan, np.isnan(b)), name
        a, b = np.where(nan, 0.0, a), np.where(nan, 0.0, b)
        d = np.abs(a - b)
        base = PARAM_TOL * max(np.abs(a).max(), 1e-12)
        if few is None:
            assert d.max() <= base, (name, d.max() / (base / PARAM_TOL))
            continue
        bad = d > base
        total += a.size
        off += int(bad.sum())
        assert (d[bad] <= base + few[1](a[bad], np.abs(a).max())).all(), name
    if few is not None:
        assert off <= few[0] * total, (off, total)


def _dopt_arrays(jt, name: str) -> dict:
    fed = body.CONFIGS[name][0] == "federated"
    out = {f"p.{k}": np.asarray(v, np.float32) for k, v in _flat(
        jax.device_get(jt.params if fed else jt.worker_params())).items()}
    if fed:
        out.update({f"theta.{k}": np.asarray(v, np.float32) for k, v in
                    _flat(jax.device_get(jt._theta_single())).items()})
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _port_arrays(arrays: dict, prefix: str = "") -> dict:
    """The port's gathered arrays in dopt's layout and names."""
    out = {}
    for part in ("p", "theta"):
        tree = {k[len(prefix) + len(part) + 1:]: v for k, v in arrays.items()
                if k.startswith(f"{prefix}{part}.")}
        if tree:
            out.update({f"{part}.{k}": np.asarray(v, np.float32)
                        for k, v in _flat(params_to_jax(
                            tree, input_shape=body.SHAPE)).items()})
    return out


CASES = [pytest.param(r, n, id=f"r{r}-{n}") for r in RANKS
         for n in body.CONFIGS if body.runs_at(n, r)
         and n not in body.REFUSED and n not in body.PORT_REFUSED]
TOLERANCES = {
    "codec": (1e-3, lambda a, amax: np.full_like(a, 2.0 * amax / 127.0)),
    "bf16-wire": (1e-3, lambda a, amax: 2.0**-7 * np.abs(a) + 1e-6 * amax),
    "fed-bf16-wire": (1e-3,
                      lambda a, amax: 2.0**-7 * np.abs(a) + 1e-6 * amax),
}


@pytest.mark.parametrize("ranks,name", CASES)
def test_ranks_match_dopt_mesh(ranks, name, spawned, devices):
    out = spawned(ranks)
    recs = _records(out, name, ranks)
    for rec in recs[1:]:
        for key in ("rows", "faults", "clients", "shift_ids"):
            assert rec[key] == recs[0][key], (key, rec["lanes"])
    assert all(rec["lanes"] == body.USERS // ranks for rec in recs)
    jt = _jax_cls(name)(body.build(J, name, ranks))
    assert int(np.prod(list(jt.mesh.shape.values()))) == ranks
    jt.run()
    got = recs[0]
    want_shift = getattr(jt, "_shift_ids", None)
    assert got["shift_ids"] == (None if want_shift is None
                                else list(want_shift))
    _rows(jt.history.rows, got["rows"])
    assert got["faults"] == jt.history.faults
    _rows(jt.client_history.rows, got["clients"])
    _close(_dopt_arrays(jt, name), _port_arrays(_arrays(out, name)),
           few=TOLERANCES.get(name))
    if name == "dsgd-dense":
        # The dense wire: each round all-gathers every rank's lanes of
        # every tensor, L·P f32 a rank.
        p = sum(v[0].size for k, v in _arrays(out, name).items())
        for rec in recs:
            assert rec["meter"]["all_gather.dense"] == (
                body.ROUNDS * (body.USERS // ranks) * p * 4)


REFUSAL_CASES = [pytest.param(r, n, id=f"r{r}-{n}") for r in RANKS
                 for n in body.REFUSED if body.runs_at(n, r)]


@pytest.mark.parametrize("ranks,name", REFUSAL_CASES)
def test_refusals_across_ranks_in_dopts_words(ranks, name, spawned,
                                              devices):
    out = spawned(ranks)
    recs = _records(out, name, ranks)
    with pytest.raises(ValueError) as want:
        _jax_cls(name)(body.build(J, name, ranks)).run()
    for rec in recs:
        assert rec["error"] == str(want.value)


def test_world_that_does_not_divide_the_workers_is_refused(spawned):
    """6 workers over 4 ranks: dopt's mesh factory would run 3 devices
    and leave one idle; the port refuses on every rank and names the
    rank count that fits."""
    for rec in _records(spawned(4), "refuse-nondividing", 4):
        assert "6 workers do not fold onto 4 ranks" in rec["error"]
        assert "launch 3 ranks (mesh_devices=3)" in rec["error"]


PROMISE_CASES = [pytest.param(r, n, id=f"r{r}-{n}") for r in RANKS
                 for n in body.PROMISES]


@pytest.mark.parametrize("ranks,name", PROMISE_CASES)
def test_port_promises_across_ranks(ranks, name, spawned):
    out = spawned(ranks)
    recs = _records(out, name, ranks)
    for rec in recs:
        assert rec == recs[0]
    rec = recs[0]
    if name.startswith("stream"):
        # Equal on every rank (above); the one-rank stream's events, in
        # its order, with its deterministic fields and the round rows
        # within the limits.
        assert len(rec["a"]) == len(rec["b"])
        for ea, eb in zip(rec["a"], rec["b"]):
            assert ea.keys() == eb.keys(), (ea, eb)
            for k in ea:
                if k not in ("metrics", "value"):
                    assert ea[k] == eb[k], (k, ea, eb)
            if "metrics" in ea:
                _rows([eb["metrics"]], [ea["metrics"]])
            if "value" in ea:
                assert abs(ea["value"] - eb["value"]) <= LOSS_TOL * max(
                    1.0, abs(eb["value"])), (ea, eb)
        return
    arrays = _arrays(out, name)
    a = {k[2:]: v for k, v in arrays.items() if k.startswith("a.")}
    b = {k[2:]: v for k, v in arrays.items() if k.startswith("b.")}
    if name.startswith("from1"):
        _rows(rec["a"]["rows"], rec["b"]["rows"])
        _close(a, b)
        return
    assert rec["a"]["rows"] == rec["b"]["rows"]
    assert rec["a"]["faults"] == rec["b"]["faults"]
    assert rec["a"]["clients"] == rec["b"]["clients"]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


SEQLM_CASES = [pytest.param(r, n, id=f"r{r}-{n}") for r in RANKS
               for n in body.SEQLM if body.runs_at(n, r)]


@pytest.mark.parametrize("ranks,name", SEQLM_CASES)
def test_seqlm_ranks_match_dopt_mesh(ranks, name, spawned, devices):
    """dopt's SeqLMTrainer at ``mesh_devices = R`` against the port's
    over R gloo ranks, from dopt's init: the History equal on every rank,
    one step within 1e-5 (relative L2, a tensor), three steps within the
    trainer bound (loss rows 1e-4, params 1e-4 max-relative), and the
    bytes each rank hands to torch.distributed: the ring's hops (a KV
    pair a hop, forward and backward), Ulysses' two all-to-alls a layer
    (q, k, v stacked, then the output; again in the backward), and the
    gradients with the NLL sum, all-gathered once a step."""
    out = spawned(ranks)
    recs = _records(out, name, ranks)
    for rec in recs:
        assert rec == recs[0]
    cfg = body.build_seqlm(J, name, ranks)
    jt = JaxSeqLMTrainer(cfg)
    assert jt.mesh.size == ranks
    arrays = _arrays(out, name)
    jt.run(steps=1)
    for k, v in params_from_jax(jax.device_get(jt.params)).items():
        got = arrays[f"one.{k}"]
        assert np.linalg.norm(got - v) <= 1e-5 * np.linalg.norm(v), k
    jt.run(steps=body.SEQ["steps"] - 1)
    rows = recs[0]["rows"]
    assert [r["step"] for r in rows] == [r["step"] for r in jt.history.rows]
    for a, b in zip(jt.history.rows, rows):
        assert abs(a["loss"] - b["loss"]) <= PARAM_TOL, (a, b)
    _close({k: np.asarray(v) for k, v in params_from_jax(
        jax.device_get(jt.params)).items()},
        {k[4:]: v for k, v in arrays.items() if k.startswith("end.")})
    s = cfg.seqlm
    block, steps = s.seq_len // ranks, s.steps
    p = sum(v.size for k, v in arrays.items() if k.startswith("end."))
    want = {"all_gather.grad": steps * (p + 1) * 4}
    if s.attn == "ring":
        kv = 2 * s.batch * block * s.dim * 4
        want["send.ring"] = steps * 2 * s.depth * (ranks - 1) * kv
    else:
        want["all_to_all.ulysses"] = steps * 2 * s.depth * (
            4 * s.batch * block * s.dim * 4)
    assert recs[0]["meter"] == want


SEQLM_REFUSALS = [pytest.param(r, n, id=f"r{r}-{n}") for r in RANKS
                  for n in body.SEQLM_REFUSED if body.runs_at(n, r)]


@pytest.mark.parametrize("ranks,name", SEQLM_REFUSALS)
def test_seqlm_refusals_across_ranks_in_dopts_words(ranks, name, spawned,
                                                     devices):
    recs = _records(spawned(ranks), name, ranks)
    with pytest.raises(ValueError) as want:
        JaxSeqLMTrainer(body.build_seqlm(J, name, ranks))
    for rec in recs:
        assert rec["error"] == str(want.value)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("name", ["dsgd-dense", "fedavg"])
def test_checkpoint_written_across_ranks_restores_at_one(ranks, name,
                                                         spawned):
    """Rank 0's checkpoint of the R-rank run (dopt's format, the whole
    [W] fleet) restores into a one-rank trainer bit for bit, which then
    runs on."""
    out = spawned(ranks)
    init = body.load_tree(out / "init.mlp.npz")
    tr = body.trainer(name, 1, init)
    tr.restore(out / f"{name}.r{ranks}.ck")
    want = _arrays(out, name)
    for k, v in tr.worker_params().items():
        np.testing.assert_array_equal(v, want[f"p.{k}"], err_msg=k)
    assert tr.history.rows == _records(out, name, ranks)[0]["rows"]
    assert len(tr.run(rounds=1).rows) == body.ROUNDS + 1


def test_one_rank_path_names_what_a_multi_rank_mesh_needs():
    """Without a process group the engines run one rank; asking for more
    names the launch, and a world that does not divide the workers names
    the rank count that fits."""
    from dopt_torch.parallel.mesh import engine_group

    cfg = body.build(T, "dsgd-dense", None)
    assert GossipTrainer(cfg, device="cpu").group.size == 1
    for cls, name in ((GossipTrainer, "dsgd-dense"),
                      (FederatedTrainer, "fedavg")):
        with pytest.raises(ValueError, match="torch.distributed.run "
                           "--nproc-per-node 2"):
            cls(body.build(T, name, 2), device="cpu")
    assert engine_group(8, 1).size == 1
    with pytest.raises(ValueError, match="mesh_hosts=2"):
        engine_group(8, None, 2)


def test_params_for_rank_takes_a_ranks_rows_of_dopts_fleet(devices):
    """dopt's stacked ``[W, ...]`` flax tree → each rank's rows in the
    port's layout, with no collective."""
    from dopt_torch.convert import params_for_rank, params_from_jax
    from dopt_torch.parallel import WorkerGroup

    jt = JaxGossipTrainer(body.build(J, "dsgd-model1", 1))
    fleet = jax.device_get(jt.params)
    whole = params_from_jax(fleet, input_shape=body.SHAPE)
    for rank in range(4):
        wg = WorkerGroup(size=4, rank=rank, lanes=2, group=object())
        got = params_for_rank(fleet, wg, input_shape=body.SHAPE)
        for k, v in whole.items():
            np.testing.assert_array_equal(got[k], v[2 * rank:2 * rank + 2])
    one = params_for_rank(fleet, WorkerGroup(1, 0, 8), input_shape=body.SHAPE)
    assert all(np.array_equal(one[k], v) for k, v in whole.items())


def test_multihost_helpers_match_dopts(devices):
    """The hybrid layout, the DCN edge count and the coordinator handoff
    are dopt's; ``initialize_distributed`` is a no-op without a
    launcher."""
    from dopt.parallel import multihost as JM
    from dopt_torch.parallel import multihost as TM
    from dopt_torch.topology import build_mixing_matrices

    grid = TM.make_hybrid_mesh(2, 4)
    jmesh = JM.make_hybrid_mesh(2, devices=jax.devices()[:4])
    assert grid.tolist() == [[d.id for d in row] for row in jmesh.devices]
    for topo in ("circle", "complete"):
        w = build_mixing_matrices(topo, "stochastic", 8, seed=0).for_round(0)
        for hosts in (1, 2, 4):
            assert TM.dcn_edge_count(w, hosts) == JM.dcn_edge_count(w, hosts)
    assert TM.initialize_distributed() is False
    # A rank's (hosts × ici) coordinates and dopt's mesh shape for the
    # same layout, which the refusals print.
    from dopt.parallel.mesh import make_worker_mesh
    from dopt_torch.parallel import WorkerGroup

    for hosts, shape in ((1, make_worker_mesh(8, 4).shape),
                         (2, make_worker_mesh(8, 4, 2).shape)):
        wg = WorkerGroup(size=4, rank=3, lanes=2, group=object(),
                         hosts=hosts)
        assert repr(wg.shape) == repr(shape)
        assert wg.coords == ((1, 1) if hosts == 2 else (0, 3))
        assert wg.flat == (hosts == 1)


def test_handoff_publishes_the_coordinator(tmp_path):
    from dopt_torch.parallel import multihost as TM

    addr = TM.coordinator_handoff(tmp_path / "h.json", 0)
    assert TM.coordinator_handoff(tmp_path / "h.json", 1) == addr
    assert TM.wait_handoff(tmp_path / "h.json") == addr


def test_cli_under_torchrun_equals_one_process(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    dopt_torch.run ... --device cpu --set mesh_devices=2`` joins gloo
    ranks from torchrun's variables; rank 0 alone prints the rows and
    writes the CSV and the checkpoint, and the rows are the one-process
    run's."""
    import subprocess
    import sys

    args = ["--preset", "baseline1", "--device", "cpu", "--num-users", "4",
            "--synthetic-scale", "0.01", "--rounds", "2"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}

    def rows(cmd):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=tmp_path, timeout=240)
        assert out.returncode == 0, out.stderr[-3000:]
        return [json.loads(x) for x in out.stdout.splitlines()
                if x.startswith("{")]

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    one = rows([sys.executable, "-m", "dopt_torch.run", *args])
    two = rows([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "-m", "dopt_torch.run", *args,
                "--set", "mesh_devices=2", "--csv", str(tmp_path / "h.csv"),
                "--checkpoint", str(tmp_path / "ck")])
    assert len(one) == 2 and len(two) == 2
    _rows(one, two)
    assert (tmp_path / "h.csv").exists() and (tmp_path / "ck").exists()


def test_torchrun_rank_without_a_gpu_names_the_gloo_route(monkeypatch):
    from dopt_torch.run import _join_launch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="init_file_group"):
        _join_launch(None)
