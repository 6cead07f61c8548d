"""Bytes on the consensus wire, per lane per round, by bucket kind.

The port's counterpart of dopt/analysis/comm_bytes.py:52-102: dopt's
comm-modes workload (``comm_modes_config``: the MLP gossip round as
``dense``, ``scatter`` or ``codec``), the lossy-link byte budget the
codec plan must fit (``lossy_budget_bytes``), and ``payload_report``,
which counts what the port's collectives hand to ``torch.distributed``
during a run (the worker group's ``meter``) beside the codec plan's own
bytes.  dopt reads the same from compiled HLO
(``hlo_collective_bytes``); the port counts the payloads themselves.

On one rank nothing crosses a wire: the counted bytes are 0 and the
plan's bytes (``BucketCodecPlan.wire_bytes`` against ``dense_bytes``)
are the figures a run can report.
"""

from __future__ import annotations

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


def payload_report(trainer, rounds: int = 1) -> dict:
    """Run ``rounds`` rounds of a gossip trainer and count the bytes its
    collectives hand to ``torch.distributed`` on this rank, per lane per
    round, by ``(operation, kind)``; with the plan's bytes beside them
    when the trainer has a codec plan.  On one rank the count is empty
    (no wire)."""
    import collections
    import dataclasses

    group = trainer.group
    meter: collections.Counter = collections.Counter()
    trainer.group = dataclasses.replace(group, meter=meter)
    try:
        trainer.run(rounds=rounds)
    finally:
        trainer.group = group
    lanes = trainer.group.lanes * rounds
    out = {"ranks": trainer.group.size, "wire": trainer.group.wire,
           "counted": {f"{op}/{kind}": b / lanes
                       for (op, kind), b in sorted(meter.items())},
           "counted_total": sum(meter.values()) / lanes}
    if trainer.codec_plan is not None:
        out["plan"] = plan_bytes(trainer.codec_plan, trainer.scatter_spec)
    return out
