from dopt_torch.models.losses import accuracy_stacked, cross_entropy_stacked
from dopt_torch.models.zoo import (LAYERS, MODELS, StackedCNN, StackedModel,
                                   deterministic, full_f32,
                                   group_norm_stacked, init_worker_params,
                                   param_shapes, stacked_cnn_forward,
                                   stacked_dense_forward, stacked_forward,
                                   stacked_resnet_forward)

__all__ = [
    "LAYERS",
    "MODELS",
    "StackedCNN",
    "StackedModel",
    "init_worker_params",
    "param_shapes",
    "stacked_cnn_forward",
    "stacked_dense_forward",
    "stacked_forward",
    "stacked_resnet_forward",
    "group_norm_stacked",
    "full_f32",
    "deterministic",
    "accuracy_stacked",
    "cross_entropy_stacked",
]
