"""Deterministic host-side numpy streams.

The port keeps dopt's seeding rule: nothing global, every draw from an
explicit seeded generator.  Host draws use numpy, so they are
bit-identical to dopt's; device-side init uses ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np


def host_rng(seed: int, *salts: int) -> np.random.Generator:
    """Named deterministic numpy stream (client sampling, matchings...)."""
    return np.random.default_rng(np.random.SeedSequence([seed, *salts]))
