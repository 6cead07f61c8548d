"""Bytes on the consensus wire: ``python -m dopt_torch.analysis.comm_bytes``.

The port's copy of dopt/analysis/comm_bytes.py: dopt's comm-modes
workload (``comm_modes_config``: the MLP gossip round as ``dense``,
``scatter`` or ``codec``), the lossy-link byte budget the codec plan
must fit (``lossy_budget_bytes``), ``payload_report`` (what a run's
collectives hand to ``torch.distributed``, per lane per round, beside
the codec plan's own bytes) and ``measure_comm_bytes`` with its CLI.

dopt lowers the three round programs and reads each collective's
result-buffer bytes from the compiled HLO (``hlo_collective_bytes``).
The port runs one round of each mode across the ranks of a
``torch.distributed`` group and counts what its collectives hand over
(the worker group's ``meter``), reported in dopt's shape and
convention: per op kind and per dtype, an all-gather as the gathered
buffer on a rank (the whole fleet's), a reduce-scatter as the rank's
own shard.  The headline ``wire_compression`` is dense/codec, both
gathered fleet buffers; the scatter leg's reduce-scatter bytes are
reported and never put in a ratio with them.

On one rank nothing crosses a wire: the counted bytes are 0 and the
plan's bytes (``BucketCodecPlan.wire_bytes`` against ``dense_bytes``)
are the figures a run can report.  The CLI spawns ``--ranks R``
processes on the card when one is up (``--device cuda``: NCCL when
there is a card a rank, else gloo with every rank on the one card),
else on the CPU over gloo (``--device cpu``), and prints ONE JSON
object; exit 0 on success, 2 on a usage error.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import tempfile
from pathlib import Path

from dopt_torch.parallel.mesh import meter_by_kind

# The lossy-link preset's rates (baseline1-lossy): the link model that
# motivates compression prices it.
LOSSY_LINK = {"msg_drop": 0.15, "msg_delay": 0.2, "msg_delay_max": 2}


def comm_modes_config(mode: str, *, workers: int = 8,
                      train_size: int = 2_048, test_size: int = 512,
                      rounds: int = 8, budget_mb: float = 0.0,
                      chunk: int = 64, min_codec_bytes: int = 256,
                      faults: bool = False):
    """dopt's comm-ablation workload, one config per wire mode: ``dense``
    | ``scatter`` | ``codec`` (the MLP on the synthetic set, f32, the
    complete graph under metropolis weights; ``faults=True`` arms the
    lossy preset's crash and churn)."""
    from dopt_torch.config import (CommConfig, DataConfig, ExperimentConfig,
                                   FaultConfig, GossipConfig, ModelConfig,
                                   OptimizerConfig)

    if mode not in ("dense", "scatter", "codec"):
        raise ValueError(f"unknown comm mode {mode!r}; "
                         "one of dense|scatter|codec")
    comm = None
    if mode == "codec":
        comm = CommConfig(codec="qsgd", byte_budget_mb=budget_mb,
                          chunk=chunk, min_codec_bytes=min_codec_bytes)
    return ExperimentConfig(
        name=f"bench-comm-{mode}",
        seed=2030,
        data=DataConfig(dataset="synthetic", num_users=workers, iid=True,
                        synthetic_train_size=train_size,
                        synthetic_test_size=test_size,
                        plan_impl="native"),
        model=ModelConfig(model="mlp", faithful=False),
        optim=OptimizerConfig(lr=0.05, momentum=0.9),
        gossip=GossipConfig(
            algorithm="dsgd", topology="complete", mode="metropolis",
            rounds=rounds, local_ep=1, local_bs=128,
            update_sharding="off" if mode == "dense" else "scatter"),
        faults=(FaultConfig(crash=0.05, churn=0.02, churn_span=3)
                if faults else None),
        comm=comm,
    )


def lossy_budget_bytes(dense_bytes: int, workers: int) -> int:
    """The per-lane budget under the lossy-link preset: one slab's
    goodput (``link_byte_budget``) over the gathered wire's fan-in, the
    n − 1 remote slabs that cross every link every round."""
    from dopt_torch.parallel.collectives import link_byte_budget

    goodput = link_byte_budget(dense_bytes, **LOSSY_LINK)
    return max(goodput // max(workers - 1, 1), 1)


def plan_bytes(plan, spec) -> dict:
    """The codec plan's per-lane bytes a round, in total and by bucket
    kind, with the dense f32 bytes and their ratio."""
    from dopt_torch.parallel.collectives import _bucket_wire_bytes

    widths = [b - a for a, b in zip(spec.bounds, spec.bounds[1:])]
    by_kind: dict[str, int] = {}
    for w, k in zip(widths, plan.kinds):
        by_kind[k] = by_kind.get(k, 0) + _bucket_wire_bytes(w, k, plan.chunk)
    return {"kinds": list(plan.kinds), "by_kind": by_kind,
            "wire_bytes": plan.wire_bytes, "dense_bytes": plan.dense_bytes,
            "compression": plan.compression}


def _run_metered(trainer, rounds: int) -> collections.Counter:
    """Run ``rounds`` rounds of ``trainer`` and return what its group's
    own meter counted in them, by ``(op, kind, dtype)``: empty on one
    rank, where no meter runs and nothing crosses a wire."""
    meter = trainer.group.meter
    before = collections.Counter(meter or {})
    trainer.run(rounds=rounds)
    return collections.Counter(meter or {}) - before


def payload_report(trainer, rounds: int = 1) -> dict:
    """Run ``rounds`` rounds of a gossip trainer and count the bytes its
    collectives hand to ``torch.distributed`` on this rank, per lane per
    round, by ``(operation, kind)``; with the plan's bytes beside them
    when the trainer has a codec plan.  On one rank the count is empty
    (no wire)."""
    counted = meter_by_kind(_run_metered(trainer, rounds))
    lanes = trainer.group.lanes * rounds
    out = {"ranks": trainer.group.size, "wire": trainer.group.wire,
           "counted": {f"{op}/{kind}": b / lanes
                       for (op, kind), b in sorted(counted.items())},
           "counted_total": sum(counted.values()) / lanes}
    if trainer.codec_plan is not None:
        out["plan"] = plan_bytes(trainer.codec_plan, trainer.scatter_spec)
    return out


# The ops the port's collectives run, by dopt's HLO names, and how a
# rank's handed-over bytes become dopt's result-buffer bytes: an
# all-gather's result is ``size`` times its input, a reduce-scatter's a
# ``size``-th.
_HLO_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                    "collective-permute", "all-to-all")
_OPS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
        "all_to_all": "all-to-all", "send": "collective-permute"}
# HLO's dtype names for the meter's torch ones.
_DTYPES = {"float32": "f32", "float64": "f64", "bfloat16": "bf16",
           "float16": "f16", "uint8": "u8", "int8": "s8", "int32": "s32",
           "int64": "s64", "bool": "pred"}


def wire_bytes(trainer, rounds: int = 1) -> dict:
    """Run ``rounds`` rounds of ``trainer`` (a collective: every rank of
    its group runs it) and count its collectives' bytes in dopt's
    ``hlo_collective_bytes`` shape: ``{op: bytes, ..., "total",
    "by_dtype", "by_op_dtype"}``, plus ``by_kind`` (the port's payload
    kinds, ``op/kind``), result-buffer bytes a round."""
    group = trainer.group
    out: dict = {k: 0 for k in _HLO_COLLECTIVES}
    by_dtype: dict[str, int] = {}
    by_op: dict[str, dict[str, int]] = {k: {} for k in _HLO_COLLECTIVES}
    by_kind: dict[str, int] = {}
    for (op, kind, dt), b in sorted(_run_metered(trainer, rounds).items()):
        dt = _DTYPES.get(dt, dt)
        b = (b * group.size if op == "all_gather"
             else b // group.size if op == "reduce_scatter" else b) // rounds
        name = _OPS[op]
        out[name] += b
        by_dtype[dt] = by_dtype.get(dt, 0) + b
        by_op[name][dt] = by_op[name].get(dt, 0) + b
        by_kind[f"{op}/{kind}"] = by_kind.get(f"{op}/{kind}", 0) + b
    out["total"] = sum(out[k] for k in _HLO_COLLECTIVES)
    out["by_dtype"] = by_dtype
    out["by_op_dtype"] = {k: v for k, v in by_op.items() if v}
    out["by_kind"] = by_kind
    return out


def measure_comm_bytes(*, workers: int = 8, train_size: int = 2_048,
                       test_size: int = 512, chunk: int = 64,
                       min_codec_bytes: int = 256,
                       budget_mb: float | None = None,
                       device=None) -> dict:
    """One round of each wire mode on ``device`` (the GPU when None),
    over the ranks of the ``torch.distributed`` group that is up (every
    rank calls it), and its collective bytes (``wire_bytes``).
    ``budget_mb=None`` derives the codec budget from the lossy-link
    preset (``lossy_budget_bytes``).  Each mode gets a freshly built
    trainer, as dopt's does."""
    from dopt_torch.engine import GossipTrainer

    def build(mode, bmb=0.0):
        return GossipTrainer(
            comm_modes_config(mode, workers=workers,
                              train_size=train_size, test_size=test_size,
                              budget_mb=bmb, chunk=chunk,
                              min_codec_bytes=min_codec_bytes),
            device=device, eval_every=1 << 20)

    scatter_tr = build("scatter")
    spec = scatter_tr.scatter_spec
    dense_bytes = (spec.bounds[-1] - spec.bounds[0]) * 4
    budget = (lossy_budget_bytes(dense_bytes, workers)
              if budget_mb is None else int(budget_mb * (1 << 20)))
    codec_tr = build("codec", bmb=budget / (1 << 20))
    plan = codec_tr.codec_plan
    out = {
        "workers": workers,
        "ranks": scatter_tr.group.size,
        "backend": scatter_tr.group.backend,
        "device": str(scatter_tr.device),
        "budget_bytes": int(budget),
        "plan_kinds": list(plan.kinds),
        "plan_chunk": plan.chunk,
        "plan_dense_bytes": plan.dense_bytes,
        "plan_wire_bytes": plan.wire_bytes,
        "plan_compression": round(plan.compression, 3),
        "dense": wire_bytes(build("dense")),
        "scatter": wire_bytes(scatter_tr),
        "codec": wire_bytes(codec_tr),
    }
    out["wire_compression"] = round(
        out["dense"]["total"] / max(out["codec"]["total"], 1), 3)
    return out


def _rank(wg, out_dir: str, device: str, kw: dict) -> None:
    """One spawned rank of the CLI: rank 0 writes the result."""
    import torch

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    result = measure_comm_bytes(device=dev, **kw)
    if wg.rank == 0:
        (Path(out_dir) / "result.json").write_text(json.dumps(result))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dopt_torch.analysis.comm_bytes",
        description="bytes on the wire of the dense / scatter / codec "
                    "rounds across ranks (one JSON object)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=4,
                    help="torch.distributed ranks to spawn (dopt's "
                         "--devices); must divide --workers")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="cuda (the default when a card is up): NCCL with "
                         "a card a rank, else gloo with the ranks sharing "
                         "one card; cpu: gloo ranks on the CPU")
    ap.add_argument("--train-size", type=int, default=2_048)
    ap.add_argument("--test-size", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--min-codec-bytes", type=int, default=256)
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="codec byte budget in MiB (default: derived "
                         "from the lossy-link preset)")
    args = ap.parse_args(argv)

    import torch

    from dopt_torch.parallel.mesh import fold_error, spawn_ranks

    if args.ranks < 1:
        ap.error(f"--ranks {args.ranks} must be >= 1")
    if args.workers % args.ranks:
        ap.error(fold_error(args.workers, args.ranks))
    if args.device is None:
        args.device = "cuda" if torch.cuda.is_available() else "cpu"
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available")
    backend = ("nccl" if args.device == "cuda"
               and torch.cuda.device_count() >= args.ranks else "gloo")
    kw = dict(workers=args.workers, train_size=args.train_size,
              test_size=args.test_size, chunk=args.chunk,
              min_codec_bytes=args.min_codec_bytes,
              budget_mb=args.budget_mb)
    with tempfile.TemporaryDirectory(prefix="dopt-torch-comm-") as d:
        spawn_ranks(_rank, args.ranks, d, d, args.device, kw,
                    backend=backend, num_workers=args.workers)
        result = json.loads((Path(d) / "result.json").read_text())
    json.dump(result, sys.stdout)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
