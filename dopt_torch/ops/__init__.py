from dopt_torch.ops.fused_update import (fused_mix_sgd, fused_mix_update,
                                         fused_sgd_momentum,
                                         fused_sgd_momentum_tree,
                                         mix_sgd_reference,
                                         sgd_momentum_reference)

__all__ = [
    "fused_mix_sgd",
    "fused_mix_update",
    "fused_sgd_momentum",
    "fused_sgd_momentum_tree",
    "mix_sgd_reference",
    "sgd_momentum_reference",
]
