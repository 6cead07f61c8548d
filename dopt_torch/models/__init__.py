from dopt_torch.models.losses import accuracy_stacked, cross_entropy_stacked
from dopt_torch.models.zoo import (StackedCNN, deterministic, full_f32,
                                   init_worker_params, param_shapes,
                                   stacked_cnn_forward)

__all__ = [
    "StackedCNN",
    "init_worker_params",
    "param_shapes",
    "stacked_cnn_forward",
    "full_f32",
    "deterministic",
    "accuracy_stacked",
    "cross_entropy_stacked",
]
