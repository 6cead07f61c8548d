"""dopt_torch — the PyTorch/CUDA port of dopt.

A package of its own beside the JAX reference ``dopt``: it imports
``torch`` and numpy and nothing of ``dopt`` or JAX.  Its entry points
run on the GPU unless the caller passes ``device="cpu"``; the update
kernels are hand-written CUDA (``dopt_torch/csrc``), built with ``nvcc``
at first use.  Ported so far: the gossip engine — D-SGD, no consensus,
centralized, FedLCon and pairwise matching (``GossipTrainer``) — and the
federated engine — FedAvg, FedProx, FedADMM and SCAFFOLD
(``FederatedTrainer``) — on the reference CNNs, the MLP, the logistic
model and dopt's GroupNorm ResNet-18, over MNIST, FMNIST, CIFAR-10/100 and a9a (raw files or the
synthetic fallback), with the reference's local train/val holdout, and
both of dopt's Pallas kernels.
Both trainers run multi-round blocks (``block_rounds > 1``) as CUDA-graph
replays of the round, with a prefetched host pipeline, and save and
restore their whole state (``save``/``restore``,
``run(checkpoint_every=K, checkpoint_path=P)``): a killed run resumes
bit for bit.  Both engines run dopt's fault model (``FaultConfig``,
``RobustConfig``): gossip under crash, straggle, partition, churn,
Byzantine sends, clipped gossip, quarantine, lossy links and push-sum;
federated under crash, stragglers, over-selection, server partitions,
churn, lossy and delayed uplinks, Byzantine updates, the robust
aggregators, clip-to-ball, quarantine and the staleness buffer.
``plan_impl="native"`` plans batches with dopt's C++ planner, built
with ``g++`` at first use.  The gossip engine runs async (staleness-1)
and one-peer mixing and CHOCO-SGD with dopt's compressors (top-k,
rand-k, QSGD; dopt's ``jax.random`` draws bit for bit); both engines
narrow their consensus or aggregation wire (``comm_dtype``) and stream
dopt's telemetry (``dopt_torch.obs``) with the on-card diagnostics.
Both run dopt's ``update_sharding="scatter"``, and the gossip engine
``comm_impl="shift"`` and the bucket codec (``CommConfig``: q8/q4 with
error feedback).  Both run the worker axis over ranks
(``mesh_devices``, ``mesh_hosts``; ``dopt_torch.parallel``): each rank
of a ``torch.distributed`` group holds W/R contiguous lanes, NCCL with
one GPU a rank (``python -m torch.distributed.run --nproc-per-node R -m
dopt_torch.run ...``) or gloo on the CPU or for ranks that share a card
(``init_file_group``, ``spawn_ranks``).  Both run dopt's client population
(``PopulationConfig``, ``dopt_torch.population``): cohorts sampled from
a registry of up to thousands of clients, trained by the federated
engine in waves of lanes with one reduce a round, and bound onto the
gossip engine's lanes.  ``SeqLMTrainer`` is dopt's sequence-parallel
TransformerLM (``SeqLMConfig``, the ``seqlm`` preset): the sequence split
over the launched ranks, ring or Ulysses attention
(``dopt_torch.parallel.sequence``).  ``backend="torch"`` trains on dopt's
sequential reference oracle (``dopt_torch.engine.torch_backend``: one
torch model and optimizer a worker, state-dict consensus) and
``model.stacked_impl="vmap"`` runs the engines' forward as a
``torch.func.vmap`` over the worker's model; ``dopt_torch.analysis``
holds dopt's static gates (lint, eligibility, fingerprint).

dopt's library surface is here too: ``build_model`` (lazy, as dopt's)
gives one worker's zoo model as an ``nn.Module`` that loads dopt's flax
params (``load_jax_params``), ``dopt_torch.models`` has the single-model
losses, ``dopt_torch.optim`` ``init_sgd`` and ``clip_by_global_norm``,
and ``dopt_torch.ops.fused_sgd_momentum_tree`` steps one model's
tensors through the update kernel.
"""

import os

# cuBLAS is deterministic only with a fixed workspace, and it reads this
# at its first call, so it is set before any: the trainers run under
# torch.use_deterministic_algorithms on the GPU
# (dopt_torch.models.zoo.deterministic), which raises for a cuBLAS call
# without it.  A value the caller set is kept.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from dopt_torch.config import (CommConfig, DataConfig, ExperimentConfig,
                               FaultConfig, FederatedConfig, GossipConfig,
                               ModelConfig, OptimizerConfig, PopulationConfig,
                               RobustConfig, SeqLMConfig, from_reference_args)
from dopt_torch.engine import FederatedTrainer, GossipTrainer, SeqLMTrainer
from dopt_torch.parallel import (WorkerGroup, engine_group, init_file_group,
                                 spawn_ranks)
from dopt_torch.presets import PRESETS, get_preset
from dopt_torch.topology import (MixingMatrices, Topology,
                                 build_mixing_matrices)

# Resolved at first use (PEP 562), as dopt's ``_LAZY``.
_LAZY = {"build_model": ("dopt_torch.models", "build_model")}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'dopt_torch' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)


__all__ = [
    "from_reference_args",
    "CommConfig",
    "DataConfig",
    "ExperimentConfig",
    "FaultConfig",
    "FederatedConfig",
    "GossipConfig",
    "ModelConfig",
    "OptimizerConfig",
    "PopulationConfig",
    "RobustConfig",
    "SeqLMConfig",
    "FederatedTrainer",
    "GossipTrainer",
    "SeqLMTrainer",
    "PRESETS",
    "WorkerGroup",
    "engine_group",
    "get_preset",
    "init_file_group",
    "spawn_ranks",
    "MixingMatrices",
    "Topology",
    "build_mixing_matrices",
    *_LAZY,
]
