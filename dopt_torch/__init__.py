"""dopt_torch — the PyTorch/CUDA port of dopt.

A package of its own beside the JAX reference ``dopt``: it imports
``torch`` and numpy and nothing of ``dopt`` or JAX.  Its entry points
run on the GPU unless the caller passes ``device="cpu"``; the update
kernels are hand-written CUDA (``dopt_torch/csrc``), built with ``nvcc``
at first use.  Slice one: synchronous gossip D-SGD on the reference
CNNs (``GossipTrainer``), with both of dopt's Pallas kernels ported.
"""

from dopt_torch.config import (DataConfig, ExperimentConfig, GossipConfig,
                               ModelConfig, OptimizerConfig)
from dopt_torch.engine import GossipTrainer
from dopt_torch.presets import PRESETS, get_preset

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "GossipConfig",
    "ModelConfig",
    "OptimizerConfig",
    "GossipTrainer",
    "PRESETS",
    "get_preset",
]
