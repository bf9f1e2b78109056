"""Philox4x32-10 in plain torch.

The counter-based generator of Salmon, Moraes, Dror and Shaw, "Parallel
random numbers: as easy as 1, 2, 3" (SC'11): ten rounds of two 32x32→64-bit
multiplies and xors turn a 128-bit counter and a 64-bit key into four
uniform 32-bit words. Any (counter, key) can be evaluated on its own, so a
stream indexed by (seed, env, step) is the same wherever and in whatever
order it is computed.

The fused rollout kernels (``csrc/philox.cuh``) draw their random actions
with this generator, and this module reproduces those draws bit for bit on
any device; the two together define the action stream of
``ops/packed_fused.py``. It has no counterpart in the JAX package, whose
kernels used the TPU's hardware generator.

torch has no unsigned 64-bit arithmetic, so words are carried as int64
tensors holding values in [0, 2**32), and each 32x32-bit product is formed
from two 16x32-bit partial products, which stay below 2**48.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9  # golden ratio
PHILOX_W1 = 0xBB67AE85  # sqrt(3) - 1
ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit halves of ``m * x`` for a constant ``m < 2**32``."""
    p_lo = x * (m & 0xFFFF)  # < 2**48
    p_hi = x * (m >> 16)  # < 2**48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox4x32(counter, key):
    """Philox4x32-10 of a counter (4 words) under a key (2 words).

    ``counter`` holds four int64 tensors (or ints) of one broadcast shape with
    values in [0, 2**32); ``key`` holds two ints. Returns the four output
    words as int64 tensors.
    """
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3
