"""Deterministic streams: host numpy generators, and dopt's keyed draws.

The port keeps dopt's seeding rule: nothing global, every draw from an
explicit seeded generator.  Host draws use numpy, so they are
bit-identical to dopt's; device-side init uses ``torch.Generator``.

dopt's device draws (choco's compressors) come from ``jax.random`` keys:
threefry2x32 (Salmon et al. 2011) in jax's partitionable mode, a
counter-based generator with a public algorithm.  ``jax_key``,
``fold_in`` and ``uniform`` compute it here in torch, bit for bit:

* ``jax_key(s)`` is the key ``(0, s mod 2**32)`` that
  ``jax.random.key(s)`` makes for a Python int s in [-2**63, 2**63)
  (jax's 32-bit mode truncates the seed; beyond int64 it raises);
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* ``uniform(k, shape)`` runs threefry2x32 on each element's flat index
  as the counter pair (hi, lo), takes ``bits = x0 ^ x1`` and returns
  ``bitcast_f32((bits >> 9) | 0x3F800000) − 1``, a float in [0, 1);
* ``fold_in_many`` and ``uniform_many`` are the same for a ``[L, 2]``
  stack of keys at once (``jax.vmap`` of the two).

A key is a ``[2]`` int64 tensor holding two 32-bit words.  The words are
carried in int64 and masked to 32 bits after every add and shift,
because torch's uint32 lacks most operations on CUDA; the draw is then
the same on the CPU and on the card.  Everything stays on the key's
device (a round index folded in from device data keeps a captured CUDA
graph correct when it replays another round).
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def host_rng(seed: int, *salts: int) -> np.random.Generator:
    """Named deterministic numpy stream (client sampling, matchings...)."""
    return np.random.default_rng(np.random.SeedSequence([seed, *salts]))


def jax_key(seed, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s two words as a ``[2]`` int64 tensor."""
    if isinstance(seed, bool) or not isinstance(seed, numbers.Integral):
        raise TypeError(f"PRNG key seed must be an integer; got {seed!r}")
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError("Python int too large to convert to C long")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate the 32-bit words of ``x`` left by ``r``, in place."""
    hi = x >> (32 - r)
    return x.bitwise_left_shift_(r).bitwise_and_(_M32).bitwise_or_(hi)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """jax's threefry2x32 (20 rounds) on 32-bit words held in int64.
    ``k0``/``k1`` broadcast against the counters ``x0``/``x1``, which are
    overwritten and returned."""
    ks = (k0, k1, (k0 ^ k1 ^ _KS_PARITY) & _M32)
    x0.add_(ks[0]).bitwise_and_(_M32)
    x1.add_(ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M32)
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``data`` is a Python int in
    [0, 2**32) or an integer tensor of one element on the key's device
    (device data, read by no host sync)."""
    if isinstance(data, torch.Tensor):
        if data.numel() != 1 or data.dtype.is_floating_point:
            raise TypeError("fold_in data must be one integer element, got "
                            f"{tuple(data.shape)} {data.dtype}")
        d = data.reshape(1).to(device=key.device,
                               dtype=torch.int64) & _M32
    else:
        if isinstance(data, bool) or not isinstance(data, numbers.Integral):
            raise TypeError(f"fold_in data must be an integer; got {data!r}")
        if not 0 <= int(data) <= _M32:
            raise OverflowError(
                f"Python integer {int(data)} out of bounds for uint32")
        d = torch.full((1,), int(data), dtype=torch.int64, device=key.device)
    x0 = torch.zeros(1, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[0:1], key[1:2], x0, d)
    return torch.cat([x0, x1])


def fold_in_many(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(lambda d: fold_in(key, d))(data)``: an ``[L, 2]`` stack
    of keys from one key and an integer tensor of L elements."""
    d = data.reshape(-1).to(device=key.device, dtype=torch.int64) & _M32
    x0 = torch.zeros_like(d)
    x0, x1 = threefry2x32(key[0:1], key[1:2], x0, d)
    return torch.stack([x0, x1], dim=1)


def _bits_to_uniform(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    bits = x0.bitwise_xor_(x1).bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform_many(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.vmap(lambda k: uniform(k, shape))(keys)`` for an ``[L, 2]``
    stack of keys: ``[L, *shape]`` f32 on the keys' device."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    lanes = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    x0 = (idx >> 32).expand(lanes, n).contiguous()
    x1 = (idx & _M32).expand(lanes, n).contiguous()
    del idx
    x0, x1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], x0, x1)
    return _bits_to_uniform(x0, x1).reshape((lanes,) + shape)


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1), on ``device``
    (the key's when None)."""
    shape = tuple(int(s) for s in (shape if isinstance(shape, (tuple, list))
                                   else (shape,)))
    if device is not None:
        key = key.to(device)
    n = 1
    for s in shape:
        n *= s
    # jax's partitionable 32-bit draw: the counters (hi, lo) of each
    # flat index, then x0 ^ x1.
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[0:1], key[1:2], idx >> 32, idx & _M32)
    return _bits_to_uniform(x0, x1).reshape(shape)
