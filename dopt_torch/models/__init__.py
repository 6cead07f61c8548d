from dopt_torch.models.losses import accuracy_stacked, cross_entropy_stacked
from dopt_torch.models.zoo import (LAYERS, StackedCNN, StackedModel,
                                   deterministic, full_f32,
                                   init_worker_params, param_shapes,
                                   stacked_cnn_forward, stacked_dense_forward,
                                   stacked_forward)

__all__ = [
    "LAYERS",
    "StackedCNN",
    "StackedModel",
    "init_worker_params",
    "param_shapes",
    "stacked_cnn_forward",
    "stacked_dense_forward",
    "stacked_forward",
    "full_f32",
    "deterministic",
    "accuracy_stacked",
    "cross_entropy_stacked",
]
