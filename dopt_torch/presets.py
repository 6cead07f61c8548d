"""Runnable experiment presets for the port.

``reference-fed*`` and ``reference-scaffold`` replay the reference P1
notebook setup (100 users, frac 0.1, 20 rounds, local_ep 10, bs 50,
lr 0.1, rho 0.1, IID, seed 2022, the deterministic 90/10 local
holdout); ``reference-dsgd-*`` replay the P2 grid (``Weighted
Average.ipynb`` cell 11: 6 workers, 10 rounds, local_ep 4, bs 128,
lr 0.01, momentum 0.5, non-IID 2 shards, seed 2028, the random 90/10
holdout) — both exactly as dopt.presets types them, and so do
``reference-nocons-{iid,noniid}``, ``reference-centralized``,
``reference-fedlcon`` (eps 5) and ``reference-gossip`` (pairwise
matching), the P2 study's other algorithms.  ``baseline1`` (4-worker
MNIST MLP, metropolis ring), ``baseline2`` (16-worker Model3 on
CIFAR-10, doubly-stochastic ring), ``baseline3`` (16-client FedAvg),
``baseline4`` (16-worker FedADMM logistic regression on a9a) and
``baseline5`` (32-worker D-SGD of the GroupNorm ResNet-18 on CIFAR-10,
random graphs) are dopt's BASELINE.json configs.  Dataset sizes are the
real datasets'; without raw files on disk the loaders fall back to the
shape-compatible synthetic set.

``headline-dsgd-model1`` is dopt's bench.py headline workload
(``_config(fast=False)``: f32, numpy planner, faithful Model1, 60,000 /
10,000 samples) with both ``fused_update`` switches on; the gossip main
path, on which both CUDA kernels run.  ``headline-fedavg-model1`` is
``baseline3`` with both switches on: the federated main path, where
kernel 2 runs the masked mean at lr = −1.  ``headline-dsgd-model1-bf16``
and ``headline-dsgd-model1-idiomatic-bf16`` are bench.py's fast legs
(bf16 compute, the native planner; the idiomatic one with the corrected
head and clip 1.0).

The fault presets are dopt's: ``baseline1-faulty`` (crash, straggle,
partition), ``baseline1-byzantine`` (a scale-mode liar, clipped gossip,
quarantine) and ``baseline1-lossy`` (message drop and delay, churn,
crash, push-sum); ``bench-chaos-baseline1-lossy`` is bench.py's chaos
cocktail at MNIST's sizes, and ``headline-dsgd-model1-faulty`` the
headline under ``baseline1-faulty``'s faults.  The federated ones are
dopt's too: ``baseline3-faulty`` (crash, ``partial`` stragglers,
over-selection, partitions), ``baseline3-byzantine`` (three pinned
sign-flipping liars against the trimmed mean) and ``baseline3-elastic``
(``drop`` stragglers, lossy and delayed uplinks and churn under the
staleness buffer); ``headline-fedavg-model1-faulty`` is the federated
headline under ``baseline3-faulty``'s faults.  ``bench-topo-complete-sync``,
``bench-topo-one_peer_exp-sync`` and ``bench-topo-one_peer_exp-async`` are
bench.py's topology-modes legs (dense, one-peer and async mixing at 32
workers).  ``baseline3-xclients`` is dopt's client-scale variant of
``baseline3``: a 1,000-client population sampling a cohort of 64 a round
onto the 16 shard lanes (4 waves, one reduce a round).  ``seqlm`` is
dopt's sequence-parallel TransformerLM (``SeqLMTrainer``: ring attention
with the sequence split over the launched ranks; one rank runs a
one-block ring).
"""

from __future__ import annotations

import dataclasses

from dopt_torch.config import (DataConfig, ExperimentConfig, FaultConfig,
                               FederatedConfig, GossipConfig, ModelConfig,
                               OptimizerConfig, PopulationConfig,
                               RobustConfig, SeqLMConfig)

MNIST_TRAIN, MNIST_TEST = 60_000, 10_000
CIFAR_TRAIN, CIFAR_TEST = 50_000, 10_000

# dopt's per-preset throughput-trim compute dtype (its time-to-target
# runs): baseline2's corrected-head CNN pays a convergence tax in bf16
# that swamps bf16's step-time win, so it trims in float32; baseline5's
# GroupNorm ResNet keeps bfloat16.  Presets not listed trim in bfloat16.
TRIM_COMPUTE_DTYPE = {"baseline2": "float32", "baseline5": "bfloat16"}


def _mnist_data(num_users: int, iid: bool, shards: int = 2,
                **kw) -> DataConfig:
    return DataConfig(dataset="mnist", num_users=num_users, iid=iid,
                      shards=shards, synthetic_train_size=MNIST_TRAIN,
                      synthetic_test_size=MNIST_TEST, **kw)


def _cifar_data(num_users: int, iid: bool, shards: int = 2) -> DataConfig:
    return DataConfig(dataset="cifar10", num_users=num_users, iid=iid,
                      shards=shards, synthetic_train_size=CIFAR_TRAIN,
                      synthetic_test_size=CIFAR_TEST)


def reference_federated(algorithm: str = "fedavg") -> ExperimentConfig:
    """P1 notebook setup (cells 8/10): 100 users, the deterministic
    90/10 local holdout with per-epoch client history."""
    return ExperimentConfig(
        name=f"reference-{algorithm}", seed=2022,
        data=_mnist_data(100, iid=True, local_holdout=0.1,
                         holdout_mode="deterministic"),
        model=ModelConfig(model="model1", faithful=True),
        optim=OptimizerConfig(lr=0.1, momentum=0.5, rho=0.1),
        federated=FederatedConfig(algorithm=algorithm, frac=0.1, rounds=20,
                                  local_ep=10, local_bs=50),
    )


def baseline_3_fedavg_noniid() -> ExperimentConfig:
    """FedAvg primal decomposition, 16 non-IID clients, MNIST."""
    return ExperimentConfig(
        name="baseline3-fedavg16-noniid", seed=2022,
        data=_mnist_data(16, iid=False),
        model=ModelConfig(model="model1", faithful=True),
        optim=OptimizerConfig(lr=0.1, momentum=0.5),
        federated=FederatedConfig(algorithm="fedavg", frac=0.5, rounds=30,
                                  local_ep=5, local_bs=50),
    )


def headline_fedavg_model1() -> ExperimentConfig:
    """``baseline3`` with ``optim.fused_update=True`` and
    ``federated.fused_update="on"`` (so full width: all 16 lanes train
    375 steps a round, 8 sampled)."""
    cfg = baseline_3_fedavg_noniid()
    return cfg.replace(
        name="headline-fedavg-model1",
        optim=dataclasses.replace(cfg.optim, fused_update=True),
        federated=dataclasses.replace(cfg.federated, fused_update="on"))


def reference_gossip(algorithm: str = "dsgd", topology: str = "circle",
                     mode: str = "stochastic", iid: bool = False,
                     eps: int = 1) -> ExperimentConfig:
    """P2 notebook setup (cell 11): 6 workers, the topology/mode grid."""
    return ExperimentConfig(
        name=f"reference-{algorithm}-{topology}-{mode}", seed=2028,
        data=_mnist_data(6, iid=iid, local_holdout=0.1,
                         holdout_mode="random"),
        model=ModelConfig(model="model1", faithful=True),
        optim=OptimizerConfig(lr=0.01, momentum=0.5),
        gossip=GossipConfig(algorithm=algorithm, topology=topology, mode=mode,
                            rounds=10, local_ep=4, local_bs=128, eps=eps),
    )


def baseline_1_ring_mnist_mlp() -> ExperimentConfig:
    """4-worker weighted-average consensus, ring mixing, MNIST MLP."""
    return ExperimentConfig(
        name="baseline1-ring-mnist-mlp", seed=2028,
        data=_mnist_data(4, iid=False),
        model=ModelConfig(model="mlp", faithful=False),
        optim=OptimizerConfig(lr=0.05, momentum=0.5),
        gossip=GossipConfig(algorithm="dsgd", topology="circle",
                            mode="metropolis", rounds=20, local_ep=2,
                            local_bs=64),
    )


def baseline_2_dsgd_cifar_cnn() -> ExperimentConfig:
    """16-worker D-SGD, doubly-stochastic mixing, CIFAR-10 small CNN
    (dopt's lr/momentum choice, 0.01/0.5)."""
    return ExperimentConfig(
        name="baseline2-dsgd16-cifar-cnn", seed=1,
        data=_cifar_data(16, iid=False),
        model=ModelConfig(model="model3", faithful=False,
                          input_shape=(32, 32, 3)),
        optim=OptimizerConfig(lr=0.01, momentum=0.5),
        gossip=GossipConfig(algorithm="dsgd", topology="circle",
                            mode="double_stochastic", rounds=100, local_ep=1,
                            local_bs=64),
    )


def baseline_4_admm_a9a() -> ExperimentConfig:
    """ADMM dual decomposition, 16 workers, ℓ2-regularised logistic
    regression on a9a (λ = 1e-4 as ``optim.weight_decay``, a loss term)."""
    return ExperimentConfig(
        name="baseline4-admm16-a9a", seed=0,
        data=DataConfig(dataset="a9a", num_users=16, iid=True,
                        synthetic_train_size=32_561,
                        synthetic_test_size=16_281),
        model=ModelConfig(model="logistic", num_classes=2,
                          input_shape=(123,), faithful=False),
        optim=OptimizerConfig(lr=0.05, momentum=0.0, rho=1.0,
                              weight_decay=1e-4),
        federated=FederatedConfig(algorithm="fedadmm", frac=1.0, rounds=50,
                                  local_ep=2, local_bs=128),
    )


def baseline_5_gossip32_resnet() -> ExperimentConfig:
    """32-worker gossip SGD, ResNet-18 (GroupNorm) on CIFAR-10,
    time-varying random graphs with metropolis weights; 13 steps of 128
    a round on 1,560 samples a worker."""
    return ExperimentConfig(
        name="baseline5-gossip32-resnet18", seed=3,
        data=_cifar_data(32, iid=False, shards=4),
        model=ModelConfig(model="resnet18", faithful=False,
                          input_shape=(32, 32, 3)),
        optim=OptimizerConfig(lr=0.1, momentum=0.9),
        gossip=GossipConfig(algorithm="dsgd", topology="random",
                            mode="metropolis", rounds=200, local_ep=1,
                            local_bs=128),
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


def headline_dsgd_model1_bf16(faithful: bool = True) -> ExperimentConfig:
    """dopt bench.py ``_config(fast=True, faithful_model=faithful,
    fused="on")``, the JAX bench's fast leg exactly: the headline at
    ``compute_dtype="bfloat16"`` (params stay f32) with batches planned
    by the C++ native planner (``plan_impl="native"``, dopt's xoshiro
    stream), both fused switches on; with ``faithful=False`` the
    corrected head (post-conv ReLUs, raw logits, the logits layer in
    f32) and ``clip_norm=1.0``."""
    cfg = headline_dsgd_model1()
    suffix = "" if faithful else "-idiomatic"
    return cfg.replace(
        name=f"headline-dsgd-model1{suffix}-bf16",
        data=dataclasses.replace(cfg.data, plan_impl="native"),
        model=dataclasses.replace(cfg.model, faithful=faithful,
                                  compute_dtype="bfloat16"),
        optim=dataclasses.replace(cfg.optim,
                                  clip_norm=0.0 if faithful else 1.0))


# dopt's gossip fault presets (dopt/presets.py:244-293): baseline1 under
# a production-shaped failure regime (crashes, a straggler deadline at
# half the local work, occasional 2-way partitions), under one
# persistent scale-mode liar against clipped gossip and a 3-strike
# quarantine, and over lossy, delayed links with churn and push-sum.
BASELINE1_FAULTS = FaultConfig(crash=0.1, straggle=0.2, straggle_frac=0.5,
                               partition=0.05, partition_span=2)


def baseline_1_faulty() -> ExperimentConfig:
    return dataclasses.replace(baseline_1_ring_mnist_mlp(),
                               name="baseline1-ring-mnist-mlp-faulty",
                               faults=BASELINE1_FAULTS)


def baseline_1_byzantine() -> ExperimentConfig:
    return dataclasses.replace(
        baseline_1_ring_mnist_mlp(),
        name="baseline1-ring-mnist-mlp-byzantine",
        faults=FaultConfig(corrupt=1.0, corrupt_max=1, corrupt_mode="scale",
                           corrupt_scale=50.0),
        robust=RobustConfig(clip_radius=1.0, quarantine_after=3,
                            quarantine_rounds=5))


def baseline_1_lossy() -> ExperimentConfig:
    cfg = baseline_1_ring_mnist_mlp()
    return dataclasses.replace(
        cfg, name="baseline1-ring-mnist-mlp-lossy",
        gossip=dataclasses.replace(cfg.gossip, correction="push_sum"),
        faults=FaultConfig(msg_drop=0.15, msg_delay=0.2, msg_delay_max=2,
                           churn=0.02, churn_span=3, crash=0.05))


def bench_chaos_baseline1_lossy() -> ExperimentConfig:
    """dopt bench.py ``_chaos_config`` at MNIST's sizes: the degraded-
    network cocktail on baseline1's workload (4-worker MLP, metropolis
    ring, bf16 compute, native plans) — lossy links, stragglers,
    Byzantine scale-lies and an armed quarantine."""
    return ExperimentConfig(
        name="bench-chaos-baseline1-lossy", seed=2028,
        data=DataConfig(dataset="mnist", num_users=4, iid=False, shards=2,
                        synthetic_train_size=MNIST_TRAIN,
                        synthetic_test_size=MNIST_TEST, plan_impl="native"),
        model=ModelConfig(model="mlp", faithful=False,
                          compute_dtype="bfloat16"),
        optim=OptimizerConfig(lr=0.05, momentum=0.5),
        gossip=GossipConfig(algorithm="dsgd", topology="circle",
                            mode="metropolis", rounds=20, local_ep=2,
                            local_bs=64),
        faults=FaultConfig(msg_drop=0.15, straggle=0.25, straggle_frac=0.5,
                           corrupt=0.15, corrupt_mode="scale",
                           corrupt_scale=10.0),
        robust=RobustConfig(quarantine_after=3, quarantine_rounds=5))


def bench_topology(topology: str, mixing: str) -> ExperimentConfig:
    """dopt bench.py ``_topology_config`` (its topology-modes legs,
    ``_measure_topology_modes``) at the sizes its full run passes: 32
    workers on IID synthetic data, the non-faithful MLP in bf16 compute,
    native plans, metropolis weights, one local epoch."""
    return ExperimentConfig(
        name=f"bench-topo-{topology}-{mixing}", seed=2028,
        data=DataConfig(dataset="synthetic", num_users=32, iid=True,
                        synthetic_train_size=16_384,
                        synthetic_test_size=2_048, plan_impl="native"),
        model=ModelConfig(model="mlp", faithful=False,
                          compute_dtype="bfloat16"),
        optim=OptimizerConfig(lr=0.05, momentum=0.5),
        gossip=GossipConfig(algorithm="dsgd", topology=topology,
                            mode="metropolis", mixing=mixing, rounds=20,
                            local_ep=1, local_bs=64))


# baseline3's federated fault variants, as dopt.presets defines them.
BASELINE3_FAULTS = FaultConfig(crash=0.1, straggle=0.2, straggle_frac=0.5,
                               over_select=0.3, partition=0.05,
                               partition_span=2)


def baseline_3_faulty() -> ExperimentConfig:
    return dataclasses.replace(baseline_3_fedavg_noniid(),
                               name="baseline3-fedavg16-noniid-faulty",
                               faults=BASELINE3_FAULTS)


def baseline_3_byzantine() -> ExperimentConfig:
    return dataclasses.replace(
        baseline_3_fedavg_noniid(), name="baseline3-fedavg16-byzantine",
        faults=FaultConfig(corrupt=1.0, corrupt_max=3,
                           corrupt_mode="signflip", corrupt_scale=10.0),
        robust=RobustConfig(aggregator="trimmed_mean", trim_frac=0.25))


def baseline_3_elastic() -> ExperimentConfig:
    cfg = baseline_3_fedavg_noniid()
    return dataclasses.replace(
        cfg, name="baseline3-fedavg16-noniid-elastic",
        federated=dataclasses.replace(cfg.federated, staleness_max=3,
                                      staleness_decay=0.5),
        faults=FaultConfig(straggle=0.5, straggle_frac=0.5,
                           straggler_policy="drop", msg_drop=0.05,
                           msg_delay=0.15, msg_delay_max=3, churn=0.02,
                           churn_span=3, crash=0.05))


def baseline_3_xclients() -> ExperimentConfig:
    """``baseline3`` with the worker == lane equation broken (dopt's
    ``baseline3-xclients``): 1,000 clients, a cohort of 64 a round on the
    16 shard lanes, 4 waves; scale it with ``--clients``/``--cohort``."""
    return dataclasses.replace(
        baseline_3_fedavg_noniid(), name="baseline3-fedavg-xclients-1k",
        population=PopulationConfig(clients=1000, cohort=64))


def headline_fedavg_model1_faulty() -> ExperimentConfig:
    """``headline-fedavg-model1`` (both fused switches on) under
    ``baseline3-faulty``'s fault config: kernel 1 gated by the straggler
    budget at 16 lanes, kernel 2 on the survivors' mask."""
    return dataclasses.replace(headline_fedavg_model1(),
                               name="headline-fedavg-model1-faulty",
                               faults=BASELINE3_FAULTS)


def headline_dsgd_model1_faulty() -> ExperimentConfig:
    """``headline-dsgd-model1`` (both fused switches on) under
    ``baseline1-faulty``'s fault config: kernel 1 gated by the straggler
    budget, kernel 2 on the crash- and partition-repaired matrix."""
    return dataclasses.replace(headline_dsgd_model1(),
                               name="headline-dsgd-model1-faulty",
                               faults=BASELINE1_FAULTS)


def seqlm_ring() -> ExperimentConfig:
    """dopt's ``seqlm``: a TransformerLM (vocab 64, dim 128, depth 2, 4
    heads, ~469.5K params) on 8 × 512-token windows of the synthetic
    Markov corpus, 60 steps of lr 0.3 and momentum 0.9, ring attention
    over the launched ranks.  The loss falls from log(vocab) toward
    log(branching) as the model learns the transitions."""
    return ExperimentConfig(
        name="seqlm-ring", seed=7,
        model=ModelConfig(model="transformer"),
        optim=OptimizerConfig(lr=0.3, momentum=0.9),
        seqlm=SeqLMConfig(steps=60, batch=8, seq_len=512, vocab=64,
                          dim=128, depth=2, heads=4, attn="ring"),
    )


PRESETS = {
    "reference-fedavg": lambda: reference_federated("fedavg"),
    "reference-fedprox": lambda: reference_federated("fedprox"),
    "reference-fedadmm": lambda: reference_federated("fedadmm"),
    "reference-scaffold": lambda: reference_federated("scaffold"),
    "reference-centralized": lambda: reference_gossip("centralized"),
    "reference-nocons-iid": lambda: reference_gossip("nocons", iid=True),
    "reference-nocons-noniid": lambda: reference_gossip("nocons"),
    "reference-fedlcon": lambda: reference_gossip("fedlcon", eps=5),
    "reference-gossip": lambda: reference_gossip("gossip"),
    "baseline1": baseline_1_ring_mnist_mlp,
    "baseline2": baseline_2_dsgd_cifar_cnn,
    "baseline3": baseline_3_fedavg_noniid,
    "baseline4": baseline_4_admm_a9a,
    "baseline5": baseline_5_gossip32_resnet,
    "seqlm": seqlm_ring,
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
    "headline-fedavg-model1": headline_fedavg_model1,
    "headline-dsgd-model1-bf16": headline_dsgd_model1_bf16,
    "headline-dsgd-model1-idiomatic-bf16": lambda: headline_dsgd_model1_bf16(
        faithful=False),
    "headline-dsgd-model1-faulty": headline_dsgd_model1_faulty,
    "bench-topo-complete-sync": lambda: bench_topology("complete", "sync"),
    "bench-topo-one_peer_exp-sync": lambda: bench_topology("one_peer_exp",
                                                           "sync"),
    "bench-topo-one_peer_exp-async": lambda: bench_topology("one_peer_exp",
                                                            "async"),
    "headline-fedavg-model1-faulty": headline_fedavg_model1_faulty,
    "baseline3-faulty": baseline_3_faulty,
    "baseline3-byzantine": baseline_3_byzantine,
    "baseline3-elastic": baseline_3_elastic,
    "baseline3-xclients": baseline_3_xclients,
    "baseline1-faulty": baseline_1_faulty,
    "baseline1-byzantine": baseline_1_byzantine,
    "baseline1-lossy": baseline_1_lossy,
    "bench-chaos-baseline1-lossy": bench_chaos_baseline1_lossy,
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; one of {sorted(PRESETS)}")
    return PRESETS[name]()

