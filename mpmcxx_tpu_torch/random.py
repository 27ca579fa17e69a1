"""Counter-based random keys, bit for bit the draws of ``jax.random``.

JAX twin: none (the JAX package calls ``jax.random`` directly).  This
module reproduces jax's default threefry2x32 generator in its
*partitionable* layout (``jax_threefry_partitionable=True``, the default
of jax 0.9): the algorithms of ``jax/_src/prng.py``
(``_threefry2x32_lowering``, ``_threefry_split_foldlike``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``, ``_normal_real``).  Trajectory parity
with the JAX chain rests on it.

A key is an int64 tensor of shape ``[..., 2]`` holding two uint32 words;
uint32 arithmetic runs in int64 and is masked with ``& 0xFFFFFFFF``.
Functions broadcast over leading key dimensions, so a whole chunk's keys
can be derived in a few vectorised calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2); all int64 tensors holding uint32, broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed split into two words."""
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def _counts(key, n: int):
    """Low counter words 0..n-1 shaped to broadcast against ``key[..., 0]``
    (the high words are 0 for every size this package draws)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return lo.reshape((1,) * (key.dim() - 1) + (n,))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[..., num, 2]`` keys."""
    c = _counts(key, num)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(c),
                          c)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    z = torch.zeros_like(key[..., 0])
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], z, z + (data & _M32))
    return torch.stack([b1, b2], dim=-1)


def _bits(key, shape):
    """The two threefry output words for each element of ``shape``
    (flattened row-major counters), each ``[..., *shape]``."""
    n = math.prod(shape)
    c = _counts(key, n)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(c),
                          c)
    lead = key.shape[:-1]
    return b1.reshape(lead + tuple(shape)), b2.reshape(lead + tuple(shape))


def uniform(key: torch.Tensor, shape=(), dtype=torch.float64,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: mantissa bits under exponent 0, minus 1,
    scaled into [minval, maxval)."""
    b1, b2 = _bits(key, tuple(shape))
    if dtype == torch.float64:
        # (b1 << 32 | b2) >> 12 without leaving 52 bits
        fbits = (b1 << 20) | (b2 >> 12)
        fbits = fbits | 0x3FF0000000000000
        floats = fbits.view(torch.float64) - 1.0
    elif dtype == torch.float32:
        fbits = ((b1 ^ b2) >> 9) | 0x3F800000
        floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    else:
        raise NotImplementedError(f"uniform dtype {dtype}")
    # the bounds and their span rounded in ``dtype`` as jax does, kept as
    # Python scalars: a device scalar tensor would be a synchronous copy
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    lo = float(np_dt(minval))
    span = float(np_dt(maxval) - np_dt(minval))
    return torch.clamp(floats * span + lo, min=lo)


def normal(key: torch.Tensor, shape=(), dtype=torch.float64) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) erfinv(u), u uniform on
    [nextafter(-1, 0), 1).  The erfinv implementations differ between
    the two libraries in the last bits, so these draws agree with jax to
    ~1e-15 relative rather than bit for bit."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    lo = float(np.nextafter(np_dt(-1.0), np_dt(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0)
    return float(np.sqrt(np_dt(2.0))) * torch.special.erfinv(u)
