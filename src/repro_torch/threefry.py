"""Threefry-2x32 and the few ``jax.random`` calls the port reproduces:
``PRNGKey``, ``fold_in``, ``split``, 32-bit ``random_bits`` (a scalar on
the host, or an array of any shape on a device) and scalar ``randint``,
bit for bit, and float32 ``normal``, in jax 0.9.0's partitionable
threefry layout.

Words are uint32 values held in Python ints, int64 numpy arrays or int64
torch tensors, every sum masked back to 32 bits. A key is a pair of words
``(k0, k1)`` of Python ints.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter ``(x0, x1)`` under the key
    ``(k0, k1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a non-negative int32 seed."""
    if not 0 <= seed <= 0x7FFFFFFF:
        raise ValueError(f"seed {seed} is not a non-negative int32")
    return 0, seed


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the key hashes the counter ``(0, data)``."""
    return threefry2x32(key[0], key[1], 0, data & M32)


def split2(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)`` into two: the counters ``(0, 0)`` and
    ``(0, 1)``, each hashed pair a new key."""
    return (threefry2x32(key[0], key[1], 0, 0),
            threefry2x32(key[0], key[1], 0, 1))


def split(key: Key, n: int) -> List[Key]:
    """``jax.random.split(key, n)``: key ``i`` hashes the counter ``(0,
    i)``."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(n)]


def random_bits(key: Key, shape: Sequence[int], device=None
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in [0,
    2**32) on ``device``: element ``i`` (row-major) hashes the counter
    ``(i >> 32, i & 0xFFFFFFFF)``, and its bits are the xor of the two
    words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
    return (b0 ^ b1).reshape(tuple(shape))


_ONE_BITS = int(np.array(1.0, np.float32).view(np.uint32))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """float32 ``jax.random.uniform``: the top 23 bits of each draw as the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval)
    and clipped below at minval. XLA fuses the scaling into one
    multiply-add, rounded once; here its float64 result is rounded to
    float32, which is the same wherever the product and the sum fit a
    float64 (always where the span is a power of two, as the normal's
    is)."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    y = (f.double() * span + float(lo)).float()
    return torch.clamp(y, min=float(lo))


def normal(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """float32 ``jax.random.normal``: ``sqrt(2) * erfinv(u)`` for ``u``
    uniform on ``[nextafter(-1, 0), 1)``. The uniforms are bit for bit the
    reference's; ``torch.erfinv`` and XLA's may differ in the last bits."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, device)
    return torch.erfinv(u) * np.float32(np.sqrt(2))


def random_bits32(key: Key) -> int:
    """One 32-bit ``random_bits`` draw: the xor of the two words hashed at
    counter ``(0, 0)``."""
    b0, b1 = threefry2x32(key[0], key[1], 0, 0)
    return b0 ^ b1


def randint(key: Key, minval: int, maxval: int) -> int:
    """Scalar ``jax.random.randint(key, (), minval, maxval)`` for int32
    bounds: two 32-bit draws from a split, combined modulo the span in
    uint32 arithmetic."""
    if maxval <= minval:
        return minval
    hi_key, lo_key = split2(key)
    higher, lower = random_bits32(hi_key), random_bits32(lo_key)
    span = (maxval - minval) & M32
    multiplier = (1 << 16) % span
    multiplier = (multiplier * multiplier) % span
    offset = (((higher % span) * multiplier) & M32) + (lower % span)
    return minval + (offset & M32) % span
