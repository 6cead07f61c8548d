"""Runnable experiment presets for the port.

``reference-dsgd-*`` replay the reference P2 notebook grid (``Weighted
Average.ipynb`` cell 11: 6 workers, 10 rounds, local_ep 4, bs 128,
lr 0.01, momentum 0.5, non-IID 2 shards, seed 2028) exactly as
dopt.presets types them — including the reference's 90/10 local
holdout, which arrives in a later slice (the trainer refuses it until
then; ``--set data.local_holdout=0`` runs the rest).

``headline-dsgd-model1`` is dopt's bench.py headline workload
(``_config(fast=False)``: f32, numpy planner, faithful Model1, 60,000 /
10,000 samples) with both ``fused_update`` switches on — the slice's
main path, on which both CUDA kernels run.
"""

from __future__ import annotations

from dopt_torch.config import (DataConfig, ExperimentConfig, GossipConfig,
                               ModelConfig, OptimizerConfig)

MNIST_TRAIN, MNIST_TEST = 60_000, 10_000


def _mnist_data(num_users: int, iid: bool, shards: int = 2,
                **kw) -> DataConfig:
    return DataConfig(dataset="mnist", num_users=num_users, iid=iid,
                      shards=shards, synthetic_train_size=MNIST_TRAIN,
                      synthetic_test_size=MNIST_TEST, **kw)


def reference_gossip(algorithm: str = "dsgd", topology: str = "circle",
                     mode: str = "stochastic",
                     iid: bool = False) -> ExperimentConfig:
    """P2 notebook setup (cell 11): 6 workers, the topology/mode grid."""
    return ExperimentConfig(
        name=f"reference-{algorithm}-{topology}-{mode}", seed=2028,
        data=_mnist_data(6, iid=iid, local_holdout=0.1,
                         holdout_mode="random"),
        model=ModelConfig(model="model1", faithful=True),
        optim=OptimizerConfig(lr=0.01, momentum=0.5),
        gossip=GossipConfig(algorithm=algorithm, topology=topology, mode=mode,
                            rounds=10, local_ep=4, local_bs=128),
    )


def headline_dsgd_model1() -> ExperimentConfig:
    """dopt bench.py ``_config(fast=False, train_size=60_000,
    test_size=10_000)`` with ``optim.fused_update=True`` and
    ``gossip.fused_update="on"``."""
    return ExperimentConfig(
        name="headline-dsgd-model1", seed=2028,
        data=DataConfig(dataset="mnist", num_users=6, iid=False, shards=2,
                        synthetic_train_size=MNIST_TRAIN,
                        synthetic_test_size=MNIST_TEST, plan_impl="numpy"),
        model=ModelConfig(model="model1", faithful=True,
                          compute_dtype="float32"),
        optim=OptimizerConfig(lr=0.01, momentum=0.5, fused_update=True),
        gossip=GossipConfig(algorithm="dsgd", topology="circle",
                            mode="stochastic", rounds=10, local_ep=4,
                            local_bs=128, fused_update="on"),
    )


PRESETS = {
    "reference-dsgd-star": lambda: reference_gossip("dsgd", "star"),
    "reference-dsgd-circle": lambda: reference_gossip("dsgd", "circle"),
    "reference-dsgd-complete": lambda: reference_gossip("dsgd", "complete"),
    "reference-dsgd-circle-double": lambda: reference_gossip(
        "dsgd", "circle", "double_stochastic"),
    "reference-dsgd-complete-double": lambda: reference_gossip(
        "dsgd", "complete", "double_stochastic"),
    # The notebook's "dynamic"-mode run: the raw 0/1 adjacency of the
    # complete graph as the mixing matrix (dopt's explicit 'ones' mode).
    "reference-dsgd-dynamic": lambda: reference_gossip(
        "dsgd", "complete", "ones"),
    "headline-dsgd-model1": headline_dsgd_model1,
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; one of {sorted(PRESETS)}")
    return PRESETS[name]()

