"""The port's side of tests/test_torch_multigpu.py: the configs, and what
each spawned rank runs (``dopt_torch.parallel.spawn_ranks``).

This module imports nothing of jax or dopt, because each spawned child
imports it again.  ``build(mod, name, ranks)`` makes a config from
either package's config module, so the test builds dopt's config for
``mesh_devices = ranks`` from the same table.  ``body`` runs every
config the test asks for on this rank's lanes over the gloo group, from
dopt's init (``init.npz``, written by the test), and writes per rank
the History rows, client rows, fault ledger and the trainer's path
choices (``<name>.r<rank>.json``) and, on rank 0, the gathered worker
params and theta (``<name>.npz``); a config the port refuses writes its
message instead.  The seqlm configs (``SEQLM``) run ``SeqLMTrainer``
with the sequence split over the ranks, from dopt's init.  The
self-consistency configs (``repeat``, ``blocked``, ``resumed``,
``from1``) write what they compare.
"""

from __future__ import annotations

import json
import traceback
from pathlib import Path

import numpy as np
import torch

SHAPE = (8, 8, 1)
USERS = 8

# name -> (engine, spec); spec keys: "g"/"f" (the engine section's
# fields), "faults", "robust", "comm", "data", "model", "top" (top-level
# fields, e.g. mesh_hosts), "ranks" (the rank counts the config runs at).
GOSSIP = {
    "dsgd-dense": dict(g=dict(comm_impl="dense")),
    "dsgd-auto": dict(g=dict()),
    "dsgd-model1": dict(g=dict(comm_impl="dense"), model=dict(
        model="model1", faithful=True), optim=dict(fused_update=True)),
    "nocons": dict(g=dict(algorithm="nocons")),
    "fedlcon": dict(g=dict(algorithm="fedlcon", eps=2, comm_impl="dense")),
    "matching": dict(g=dict(algorithm="gossip")),
    "scatter": dict(g=dict(update_sharding="scatter", comm_impl="dense")),
    "shift": dict(g=dict(comm_impl="shift")),
    "bf16-wire": dict(g=dict(comm_dtype="bfloat16", comm_impl="dense")),
    "codec": dict(g=dict(update_sharding="scatter", update_bucket_mb=0.01),
                  comm=dict(codec="qsgd", chunk=64, min_codec_bytes=256)),
    "choco": dict(g=dict(algorithm="choco", compression="randk",
                         compression_ratio=0.25, choco_gamma=0.2,
                         comm_impl="dense")),
    "async": dict(g=dict(mixing="async", comm_impl="dense")),
    "faults": dict(g=dict(comm_impl="dense"),
                   faults=dict(crash=0.2, straggle=0.3, straggle_frac=0.5,
                               partition=0.2, partition_span=2,
                               churn=0.15, churn_span=2)),
    "robust": dict(g=dict(), faults=dict(corrupt=0.3, corrupt_mode="scale",
                                         corrupt_scale=20.0),
                   robust=dict(clip_radius=0.5, quarantine_after=1,
                               quarantine_rounds=1)),
    "byzantine": dict(g=dict(), faults=dict(corrupt=0.25,
                                            corrupt_mode="nan")),
    "push-sum": dict(g=dict(correction="push_sum"),
                     faults=dict(msg_drop=0.2, msg_delay=0.3,
                                 msg_delay_max=2)),
    "diag-holdout": dict(g=dict(diagnostics="on", eval_mode="sharded",
                                comm_impl="dense"),
                         data=dict(local_holdout=0.25,
                                   holdout_mode="deterministic")),
    "population": dict(g=dict(comm_impl="dense"),
                       population=dict(clients=40, cohort=USERS)),
    "hybrid-dsgd": dict(g=dict(), top=dict(mesh_hosts=2), ranks=(4,)),
}
FEDERATED = {
    "fedavg": dict(f=dict()),
    "fedavg-model1": dict(f=dict(), model=dict(model="model1",
                                               faithful=True),
                          optim=dict(fused_update=True)),
    "fedprox": dict(f=dict(algorithm="fedprox")),
    "fedadmm": dict(f=dict(algorithm="fedadmm")),
    "scaffold": dict(f=dict(algorithm="scaffold")),
    "fed-faults": dict(f=dict(), faults=dict(
        crash=0.2, straggle=0.3, straggle_frac=0.5, over_select=0.5,
        partition=0.2, partition_span=2, msg_drop=0.1, corrupt=0.25,
        corrupt_mode="nan"), robust=dict(quarantine_after=1,
                                         quarantine_rounds=1)),
    "krum": dict(f=dict(frac=1.0), faults=dict(corrupt=0.25,
                                               corrupt_mode="scale",
                                               corrupt_scale=20.0),
                 robust=dict(aggregator="krum", krum_f=1, clip_radius=2.0)),
    "staleness": dict(f=dict(staleness_max=2),
                      faults=dict(msg_delay=0.4, msg_delay_max=2,
                                  straggle=0.3, straggler_policy="drop")),
    "fed-scatter": dict(f=dict(update_sharding="scatter")),
    "fed-bf16-wire": dict(f=dict(comm_dtype="bfloat16")),
    "fed-diag-holdout": dict(f=dict(diagnostics="on"),
                             data=dict(local_holdout=0.25,
                                       holdout_mode="deterministic")),
    "fed-population": dict(f=dict(), population=dict(clients=40, cohort=8,
                                                     lanes=4),
                           faults=dict(crash=0.2, corrupt=0.2,
                                       corrupt_mode="nan")),
    "hybrid-fedavg": dict(f=dict(), top=dict(mesh_hosts=2), ranks=(4,)),
}
# Configs both packages refuse across ranks, in dopt's words.
REFUSED = {
    "refuse-fused-gossip": ("gossip", dict(g=dict(fused_update="on"),
                                           optim=dict(fused_update=True))),
    "refuse-fused-fed": ("federated", dict(f=dict(fused_update="on"),
                                           optim=dict(fused_update=True))),
    "refuse-shift-hybrid": ("gossip", dict(g=dict(comm_impl="shift"),
                                           top=dict(mesh_hosts=2),
                                           ranks=(4,))),
    "refuse-scatter-hybrid": ("gossip", dict(
        g=dict(update_sharding="scatter"), top=dict(mesh_hosts=2),
        ranks=(4,))),
    "refuse-population-hybrid": ("federated", dict(
        f=dict(), population=dict(clients=40, cohort=8),
        top=dict(mesh_hosts=2), ranks=(4,))),
    "refuse-population-lanes": ("federated", dict(
        f=dict(), population=dict(clients=40, cohort=8, lanes=4),
        data=dict(num_users=6), ranks=(4,))),
    "refuse-compact": ("federated", dict(f=dict(compact=True))),
}
# A world that does not divide the workers: dopt would leave devices
# idle, the port refuses and names the rank count that fits.
PORT_REFUSED = {
    "refuse-nondividing": ("gossip", dict(g=dict(), data=dict(num_users=6),
                                          ranks=(4,))),
}
CONFIGS = {**{k: ("gossip", v) for k, v in GOSSIP.items()},
           **{k: ("federated", v) for k, v in FEDERATED.items()},
           **REFUSED, **PORT_REFUSED}
# The port's own promises, bit for bit: (config, what).
PROMISES = {"repeat": "dsgd-dense", "blocked-gossip": "faults",
            "blocked-robust": "robust", "blocked-fed": "fed-faults",
            "blocked-stale": "staleness", "resumed-gossip": "push-sum",
            "resumed-fed": "scaffold", "from1-gossip": "dsgd-dense",
            "from1-fed": "fedavg", "stream-gossip": "diag-holdout",
            "stream-fed": "fed-faults"}
ROUNDS = 2
# The sequence-parallel LM: name -> (SeqLMConfig fields, the rank counts
# it runs at); every one from dopt's tiny-width init.  The refused ones
# break a rank-count rule in dopt's words.
SEQ = dict(seq_len=32, batch=2, dim=32, heads=4, vocab=16, steps=3,
           log_every=1)
SEQLM = {"seqlm-ring": (dict(attn="ring"), (2, 4)),
         "seqlm-ring-chunk": (dict(attn="ring", kv_chunk=4), (2, 4)),
         "seqlm-ulysses": (dict(attn="ulysses", heads=8), (2, 4))}
SEQLM_REFUSED = {"seqlm-refuse-dense": (dict(attn="dense"), (2, 4)),
                 "seqlm-refuse-seqlen": (dict(seq_len=30), (4,)),
                 "seqlm-refuse-heads": (dict(attn="ulysses", heads=6), (4,))}


def runs_at(name: str, ranks: int) -> bool:
    if name in SEQLM or name in SEQLM_REFUSED:
        return ranks in {**SEQLM, **SEQLM_REFUSED}[name][1]
    spec = CONFIGS[name][1]
    return ranks in spec.get("ranks", (2, 4))


def build_seqlm(mod, name: str, ranks: int | None):
    """The seqlm config ``name`` (dopt's ``seqlm`` preset at SEQ's
    widths) from a config module, for ``ranks`` ranks."""
    fields = {**SEQ, **{**SEQLM, **SEQLM_REFUSED}[name][0]}
    return mod.ExperimentConfig(
        name=name, seed=7, model=mod.ModelConfig(model="transformer"),
        optim=mod.OptimizerConfig(lr=0.3, momentum=0.9),
        seqlm=mod.SeqLMConfig(**fields), mesh_devices=ranks)


def _seqlm(name: str, wg, init: dict) -> tuple[dict, dict]:
    """One seqlm config at ``wg.size`` ranks: a first step (its params
    kept), then the other two; the rows, the byte meter and the params
    after one and after three steps."""
    import dopt_torch.config as T
    from dopt_torch.engine import SeqLMTrainer
    from dopt_torch.parallel.mesh import meter_by_kind

    tr = SeqLMTrainer(build_seqlm(T, name, wg.size), device="cpu",
                      init_params=init)
    tr.run(steps=1)
    arrays = {f"one.{k}": v.detach().numpy().copy()
              for k, v in tr.params.items()}
    tr.run(steps=SEQ["steps"] - 1)
    arrays.update({f"end.{k}": v.detach().numpy().copy()
                   for k, v in tr.params.items()})
    rec = {"rows": tr.history.rows,
           "meter": {f"{op}.{kind}": n for (op, kind), n
                     in meter_by_kind(tr.group.meter).items()}}
    return rec, arrays


def build(mod, name: str, ranks: int | None):
    """The config ``name`` from a config module (``dopt.config`` or
    ``dopt_torch.config``) for ``ranks`` ranks (``mesh_devices``)."""
    engine, spec = CONFIGS[name]
    model = dict(model="mlp", input_shape=SHAPE, faithful=False)
    model.update(spec.get("model", {}))
    data = dict(dataset="synthetic", num_users=USERS, iid=False, shards=2,
                synthetic_train_size=16 * USERS, synthetic_test_size=32)
    data.update(spec.get("data", {}))
    optim = dict(lr=0.05, momentum=0.5, rho=0.1)
    optim.update(spec.get("optim", {}))
    kw = dict(name=name, seed=11, data=mod.DataConfig(**data),
              model=mod.ModelConfig(**model),
              optim=mod.OptimizerConfig(**optim), mesh_devices=ranks,
              **spec.get("top", {}))
    if engine == "gossip":
        g = dict(algorithm="dsgd", topology="circle", mode="stochastic",
                 rounds=ROUNDS, local_ep=1, local_bs=16)
        g.update(spec.get("g", {}))
        kw["gossip"] = mod.GossipConfig(**g)
    else:
        f = dict(algorithm="fedavg", frac=0.5, rounds=ROUNDS, local_ep=1,
                 local_bs=16)
        f.update(spec.get("f", {}))
        kw["federated"] = mod.FederatedConfig(**f)
    for key, cls in (("faults", "FaultConfig"), ("robust", "RobustConfig"),
                     ("comm", "CommConfig"),
                     ("population", "PopulationConfig")):
        if key in spec:
            kw[key] = getattr(mod, cls)(**spec[key])
    return mod.ExperimentConfig(**kw)


def init_key(name: str) -> str:
    """Configs of one model share dopt's init."""
    return CONFIGS[name][1].get("model", {}).get("model", "mlp")


def trainer(name: str, ranks: int | None, init: dict, **kw):
    import dopt_torch.config as T
    from dopt_torch.engine import FederatedTrainer, GossipTrainer

    cls = GossipTrainer if CONFIGS[name][0] == "gossip" else FederatedTrainer
    return cls(build(T, name, ranks), device="cpu", init_params=init, **kw)


def outputs(tr) -> tuple[dict, dict]:
    """(the rank's json record, rank 0's arrays): History, client rows,
    the ledger and the path choices; the gathered params (and theta)."""
    from dopt_torch.parallel.mesh import meter_by_kind

    rec = {"rows": tr.history.rows, "faults": tr.history.faults,
           "clients": tr.client_history.rows,
           "shift_ids": (None if getattr(tr, "_shift_ids", None) is None
                         else list(tr._shift_ids)),
           "lanes": tr.lanes}
    arrays = {f"p.{k}": v for k, v in tr.worker_params().items()}
    if hasattr(tr, "global_params"):
        arrays.update({f"theta.{k}": v
                       for k, v in tr.global_params().items()})
    if tr.group.meter is not None:
        rec["meter"] = {f"{op}.{kind}": n for (op, kind), n
                        in meter_by_kind(tr.group.meter).items()}
    return rec, arrays


def save_tree(path: Path, tree: dict) -> None:
    """A nested dict of arrays (dopt's flax params) as one npz with
    ``/``-joined keys."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path: Path) -> dict:
    tree: dict = {}
    for key, v in np.load(path).items():
        node = tree
        *head, leaf = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def _write(out: Path, name: str, rank: int, rec: dict, arrays: dict) -> None:
    (out / f"{name}.r{rank}.json").write_text(json.dumps(rec))
    if rank == 0 and arrays:
        np.savez(out / f"{name}.npz", **arrays)


def _promise(name: str, wg, out: Path, init: dict) -> tuple[dict, dict]:
    """The port's promises at R ranks: two runs equal, blocked ≡
    per-round, killed after round 1 and resumed ≡ continuous, a
    one-rank checkpoint (``<cfg>.one.ck``, written by the test) resumed
    here; every record holds both sides, equal bit for bit or (from1)
    within the test's limits."""
    cfg = PROMISES[name]
    ranks = wg.size
    a = trainer(cfg, ranks, init[init_key(cfg)])
    a.run()
    rec, arrays = outputs(a)
    if name == "repeat" or name.startswith("blocked"):
        b = trainer(cfg, ranks, init[init_key(cfg)])
        if name == "repeat":
            b.run()
        else:
            b.run(block=2)
    elif name.startswith("stream"):
        return _streams(cfg, ranks, init[init_key(cfg)])
    elif name.startswith("resumed"):
        ck = out / f"{name}.ck"
        b = trainer(cfg, ranks, init[init_key(cfg)])
        b.run(rounds=1, checkpoint_every=1, checkpoint_path=ck)
        b = trainer(cfg, ranks, init[init_key(cfg)])
        b.restore(ck)
        b.run(rounds=ROUNDS - 1)
    else:
        b = trainer(cfg, ranks, init[init_key(cfg)])
        b.restore(out / f"{cfg}.one.ck")
        b.run(rounds=ROUNDS - 1)
    rec2, arrays2 = outputs(b)
    rec = {"a": rec, "b": rec2}
    arrays = {**{f"a.{k}": v for k, v in arrays.items()},
              **{f"b.{k}": v for k, v in arrays2.items()}}
    return rec, arrays


def _streams(cfg: str, ranks: int, init: dict) -> tuple[dict, dict]:
    """The telemetry stream at R ranks (attached on every rank: its
    gauges may gather) and at one rank in this process, in the
    comparison form ``canonical``: a record "a" (R ranks) and "b" (one
    rank), and no arrays."""
    from dopt_torch.obs import MemorySink, Telemetry, attach, canonical

    rec = {}
    for side, r in (("a", ranks), ("b", 1)):
        tr = trainer(cfg, r, init)
        sink = MemorySink()
        attach(tr, Telemetry([sink]))
        tr.run()
        rec[side] = canonical(sink.events)
    return rec, {}


def body(wg, out_dir: str, names: list[str]) -> None:
    """One rank: every config in ``names`` at ``wg.size`` ranks."""
    out = Path(out_dir)
    init = {k: load_tree(out / f"init.{k}.npz")
            for k in ("mlp", "model1", "transformer")}
    torch.manual_seed(0)
    for name in names:
        try:
            if name in SEQLM or name in SEQLM_REFUSED:
                rec, arrays = _seqlm(name, wg, init["transformer"])
            elif name in PROMISES:
                rec, arrays = _promise(name, wg, out, init)
            else:
                tr = trainer(name, wg.size, init[init_key(name)])
                tr.run()
                rec, arrays = outputs(tr)
                if name in ("dsgd-dense", "fedavg"):
                    # Rank 0's checkpoint, for the test to resume at 1.
                    tr.save(out / f"{name}.r{wg.size}.ck")
        except ValueError as e:
            if name not in {**REFUSED, **PORT_REFUSED, **SEQLM_REFUSED}:
                raise
            rec, arrays = {"error": str(e)}, {}
        except Exception:
            (out / f"{name}.r{wg.rank}.err").write_text(
                traceback.format_exc())
            raise
        _write(out, name, wg.rank, rec, arrays)

