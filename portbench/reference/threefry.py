"""JAX's default random numbers (threefry2x32, partitionable layout) in plain
torch, frozen for the benchmark's reference.

Element ``i`` of a draw of shape ``s`` from key ``(k1, k2)`` is the xor of
the two words of threefry2x32((k1, k2), (i >> 32, i & 0xffffffff)), ``i``
the row-major index; ``split`` hashes the counters 0..n-1 and keeps both
words.  A uniform takes the top 23 bits as a mantissa in [1, 2), minus 1;
a Gumbel is -log(-log(u)) of a uniform on [tiny, 1); a normal is
sqrt(2)·erfinv(u) of a uniform on (-1, 1), erfinv as XLA's float32
polynomial (Giles' approximation).  Keys are pairs of Python ints.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

Key = Tuple[int, int]
MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
TINY = 1.1754943508222875e-38
NEXT_ABOVE_MINUS_ONE = -0.99999994039535522


def key_of_seed(seed: int) -> Key:
    """The benchmark's root key of a seed of up to 64 bits: its high and
    low words (``jax.random.PRNGKey`` of a seed under 2**32)."""
    return (seed >> 32) & MASK, seed & MASK


def hash2x32(k, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words ``x0``, ``x1`` (ints or
    int64 tensors) under key ``k`` (two ints or two int64 tensors)."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for r in range(5):
        for rot in ROTATIONS[r % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << rot) | (x1 >> (32 - rot))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(r + 1) % 3]) & MASK
        x1 = (x1 + ks[(r + 2) % 3] + r + 1) & MASK
    return x0, x1


def split(k: Key, num: int = 2) -> List[Key]:
    return [hash2x32(k, i >> 32, i & MASK) for i in range(num)]


def bits(k: Key, n: int, device) -> torch.Tensor:
    """``n`` random 32-bit words (int64) of key ``k``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = hash2x32(k, i >> 32, i & MASK)
    return b0 ^ b1


def uniform(k: Key, shape, device, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    b = bits(k, math.prod(shape), device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
    return torch.maximum(lo_t, f * (hi_t - lo_t) + lo_t).reshape(shape)


def gumbel(k: Key, shape, device) -> torch.Tensor:
    return -torch.log(-torch.log(uniform(k, shape, device, TINY, 1.0)))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, ERFINV_LT5[0], ERFINV_GE5[0])
    for a, b in zip(ERFINV_LT5[1:], ERFINV_GE5[1:]):
        p = torch.where(small, a, b) + p * w
    return p * x


def normal(k: Key, shape, device) -> torch.Tensor:
    u = uniform(k, shape, device, NEXT_ABOVE_MINUS_ONE, 1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32, device=device) * erfinv(u)
