"""The ``jax.random`` draws the trainers make, in plain torch, from key data.

A frozen copy of the Threefry-2x32 subset that the measured package draws
from (its ``ops/threefry.py``), written again here so that the reference
shares no code with the program: Threefry-2x32 with 20 rounds (Salmon et
al., SC'11), JAX's partitionable counters (element ``i`` of a draw hashes the
64 bits of ``i``), ``split``, ``fold_in``, 32-bit ``bits``, ``uniform`` with
its float32 fused multiply-add, ``randint`` and ``permutation``.

Key data is an int64 tensor ``[..., 2]`` of two words in ``[0, 2**32)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_data(seed: int, device=None) -> torch.Tensor:
    """Key data of a seed of up to 64 bits: its high and low words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device)


def threefry(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counters ``(x0, x1)`` (int64 of one shape S)
    under ``key`` int64[..., 2]: two words int64[..., *S]."""
    shape = key.shape[:-1] + (1,) * x0.dim()
    k0, k1 = key[..., 0].reshape(shape), key[..., 1].reshape(shape)
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) & MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _hash(key: torch.Tensor, index: torch.Tensor):
    index = index.to(torch.int64).to(key.device)
    return threefry(key, index >> 32, index & MASK32)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)``: int64[..., num, 2]."""
    y0, y1 = _hash(key, torch.arange(num))
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    y0, y1 = _hash(key, torch.tensor(int(data) & MASK32))
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)``: int64[..., *shape] in [0, 2**32)."""
    y0, y1 = _hash(key, torch.arange(math.prod(shape)).reshape(shape))
    return y0 ^ y1


def _fma(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """``a * b + c`` in float32 rounded once: the exact float64 product plus
    ``c``, rounded to odd, then to float32."""
    f64 = torch.float64
    p = a.to(f64) * float(b)
    c64 = torch.tensor(float(c), dtype=f64, device=a.device)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(f64)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).to(torch.float32)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)``, float32."""
    f = ((bits(key, shape) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    span = np.float32(hi - lo)
    if lo == 0.0 and span == 1.0:
        return f
    return torch.clamp_min(_fma(f, span, lo), float(lo))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)``, int32."""
    k = split(key, 2)
    hi, lo = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    span = max(1, maxval - minval)
    mult = (((2**16 % span) ** 2) & MASK32) % span
    off = ((((hi % span) * mult) & MASK32) + lo % span) & MASK32
    return (minval + off % span).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` over the key's leading dims: int64[..., n]."""
    x = torch.arange(n, device=key.device).expand(key.shape[:-1] + (n,))
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1)))
    for _ in range(rounds):
        k = split(key, 2)
        key = k[..., 0, :]
        order = torch.sort(bits(k[..., 1, :], (n,)), dim=-1, stable=True).indices
        x = x.gather(-1, order)
    return x
