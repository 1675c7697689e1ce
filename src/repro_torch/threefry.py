"""Threefry-2x32 and the few ``jax.random`` calls the port reproduces bit
for bit on the host: ``PRNGKey``, ``fold_in``, ``split`` into two,
32-bit ``random_bits`` and scalar ``randint``, in jax 0.9.0's
partitionable threefry layout.

Words are uint32 values held in Python ints or int64 numpy arrays, every
sum masked back to 32 bits. A key is a pair of words ``(k0, k1)``.
"""
from __future__ import annotations

from typing import Tuple

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
