"""dopt_torch — the PyTorch/CUDA port of dopt.

A package of its own beside the JAX reference ``dopt``: it imports
``torch`` and numpy and nothing of ``dopt`` or JAX.  Its entry points
run on the GPU unless the caller passes ``device="cpu"``; the update
kernels are hand-written CUDA (``dopt_torch/csrc``), built with ``nvcc``
at first use.  Ported so far: synchronous gossip D-SGD
(``GossipTrainer``) and the federated engine — FedAvg, FedProx, FedADMM
and SCAFFOLD (``FederatedTrainer``) — on the reference CNNs, with the
reference's local train/val holdout, and both of dopt's Pallas kernels.
"""

from dopt_torch.config import (DataConfig, ExperimentConfig, FederatedConfig,
                               GossipConfig, ModelConfig, OptimizerConfig)
from dopt_torch.engine import FederatedTrainer, GossipTrainer
from dopt_torch.presets import PRESETS, get_preset

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "FederatedConfig",
    "GossipConfig",
    "ModelConfig",
    "OptimizerConfig",
    "FederatedTrainer",
    "GossipTrainer",
    "PRESETS",
    "get_preset",
]
