"""The federated aggregation's always-on guard: the non-finite screen.

The port's copy of the two pieces of ``dopt.robust`` the federated
engine runs on every round.  The Byzantine aggregators, clipping and
quarantine arrive with the robust slice.
"""

from __future__ import annotations

import torch

# dopt.robust.masked_mean is collectives.masked_average without the mesh
# and wire knobs, which the port's single-device average never has.
from dopt_torch.parallel.collectives import masked_average as masked_mean


def finite_lane_mask(stacked: dict[str, torch.Tensor]) -> torch.Tensor:
    """[W] float32 flag per lane: 1.0 iff EVERY entry of the lane, across
    all tensors, is finite (one NaN anywhere marks the whole lane)."""
    flags = None
    for x in stacked.values():
        f = torch.isfinite(x).reshape(x.shape[0], -1).all(1)
        flags = f if flags is None else flags & f
    return flags.float()


__all__ = ["finite_lane_mask", "masked_mean"]
