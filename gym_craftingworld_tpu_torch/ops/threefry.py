"""The ``jax.random`` subset that the env layer draws from, in plain torch.

``jax.random``'s default generator is Threefry-2x32 (Salmon, Moraes, Dror
and Shaw, "Parallel random numbers: as easy as 1, 2, 3", SC'11): twenty
rounds of add, rotate and xor turn a 64-bit counter under a 64-bit key into
two 32-bit words. Every draw of the JAX package is such a hash of a key and
a counter, so these functions reproduce its draws bit for bit on any device
(``tests/test_torch_threefry.py``). They follow JAX 0.9's implementation
(``jax/_src/prng.py``, ``jax/_src/random.py``) with
``jax_threefry_partitionable`` on, its default, and 64-bit types off:

* ``split(key, num)``: key ``i`` is the hash of the counter ``(hi(i),
  lo(i))`` of ``i``'s 64 bits; ``fold_in(key, d)`` is the hash of ``(0,
  d)``; ``random_bits(key, shape)`` is ``y0 ^ y1`` of the hash of each
  element's row-major linear index. So the ``i``-th key of a split, or the
  bits of one element, need nothing of the others (``keys_at``,
  ``bits_at``): a rank of a mesh derives only its own envs' keys.
* ``uniform``: ``(bits >> 9) | 0x3F800000`` read as a float32, minus 1,
  then ``max(minval, f * (maxval - minval) + minval)`` in float32, where
  XLA's CPU backend contracts the product and the sum into one fused
  multiply-add, rounded once (``fma_f32``; measured against JAX 0.9).
* ``gumbel`` (JAX's default ``"low"`` mode): ``-log(-log(u))`` of uniforms
  on ``[tiny, 1)``; ``categorical``: the argmax over the last axis of
  ``gumbel(key, logits.shape) + logits``; ``normal``: ``sqrt(2) *
  erfinv(u)`` of uniforms on ``[nextafter(-1, 0), 1)``. Their bits are
  JAX's; the logarithms and ``erfinv`` are torch's, which agree with XLA's
  to a few ulp (``tests/test_torch_threefry.py`` states the tolerance).
* ``randint``: two bit draws from ``split(key)`` folded into the span with
  32-bit unsigned arithmetic.
* ``permutation``: ``ceil(3 ln n / ln(2**32 - 1))`` rounds of a stable sort
  by fresh 32-bit keys.

Every draw has a form addressed by linear index (``bits_at``,
``uniform_at``, ``keys_at``), so that a rank of a mesh draws only its own
columns of a draw and gets the whole draw's values there.

Key data is an int64 tensor ``[..., 2]`` holding two words in ``[0,
2**32)``, as ``ops/philox.py`` carries its words and as ``interop.py``
widens JAX's uint32 key data; every function batches over the key's leading
dims. The hot draws of a reset run in a hand-written kernel on the card
(``ops/keyed_draws.py``), which these functions hold bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA  # Threefry's key-schedule constant
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jax/_src/random.py _shuffle: rounds of sorting by 32-bit keys
SHUFFLE_EXPONENT = 3
UINT32_MAX = 2**32 - 1


def _words(key: torch.Tensor, nd: int):
    """The key's two words, shaped to broadcast over ``nd`` trailing dims."""
    shape = key.shape[:-1] + (1,) * nd
    return key[..., 0].reshape(shape), key[..., 1].reshape(shape)


def threefry2x32(key: torch.Tensor, counter):
    """Threefry-2x32 (20 rounds) of ``counter`` = ``(x0, x1)`` under ``key``.

    ``key`` int64[..., 2]; ``x0``, ``x1`` int64 tensors of one shape S with
    values in [0, 2**32). Returns the two output words, int64[..., *S].
    """
    x0, x1 = counter
    k0, k1 = _words(key, x0.dim())
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    # in place on the two fresh words: a quarter of the time of new tensors
    x0 = (x0 + k0).bitwise_and_(MASK32)
    x1 = (x1 + k1).bitwise_and_(MASK32)
    high = torch.empty_like(x1)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            # x1 = rotl(x1, r) ^ x0
            torch.bitwise_left_shift(x1, r, out=high).bitwise_and_(MASK32)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK32)
    return x0, x1


def _counter(index: torch.Tensor):
    """(hi, lo) words of 64-bit linear indices."""
    index = index.to(torch.int64)
    return index >> 32, index & MASK32


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s key data, int64[2].

    With 64-bit types off, JAX takes the seed as an int32, so the key is
    ``(0, seed mod 2**32)`` for any Python int.
    """
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def keys_at(key: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Keys ``index`` (int tensor of shape S) of ``split(key, n)``, for any
    ``n`` above them: int64[..., *S, 2]."""
    y0, y1 = threefry2x32(key, _counter(index.to(key.device)))
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: int64[..., num, 2]."""
    return keys_at(key, torch.arange(num, device=key.device))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of ``(0, data)``."""
    return keys_at(key, torch.tensor(int(data) & MASK32, device=key.device))


def bits_at(key: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """32-bit random bits of the elements at row-major linear ``index`` of
    any draw from ``key``: int64[..., *S] in [0, 2**32)."""
    y0, y1 = threefry2x32(key, _counter(index.to(key.device)))
    return y0 ^ y1


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): int64[..., *shape]."""
    n = math.prod(shape)
    return bits_at(key, torch.arange(n, device=key.device).reshape(shape))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32-bit words, as ``jax.random.uniform``."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform_span(minval: float = 0.0, maxval: float = 1.0):
    """(minval, maxval - minval) as JAX's ``_uniform`` takes them: each
    bound rounded to float32, their difference taken in float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return lo, np.float32(hi - lo)


def fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """``a * b + c`` of float32 ``a`` and float32 scalars, rounded once to
    float32, as a fused multiply-add rounds it.

    The product is exact in float64 (24 + 24 bits); the float64 sum is
    rounded to odd (its exact error, by TwoSum, moves an inexact even result
    one ulp towards the true sum), and a round-to-odd result of 53 bits
    rounds to 24 bits as the exact sum would.
    """
    f64 = torch.float64
    p = a.to(f64) * float(b)
    c64 = torch.tensor(float(c), dtype=f64, device=a.device)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(f64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def scale_uniform(floats: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``max(minval, floats * (maxval - minval) + minval)`` in float32, as
    JAX's ``_uniform`` ends, the product and sum fused (``fma_f32``)."""
    lo, span = uniform_span(minval, maxval)
    if lo == 0.0 and span == 1.0:
        return floats  # f * 1 + 0 and max(0, f) are f
    return torch.clamp_min(fma_f32(floats, span, lo), float(lo))


def uniform_at(key: torch.Tensor, index: torch.Tensor, minval: float = 0.0,
               maxval: float = 1.0) -> torch.Tensor:
    """The elements at row-major linear ``index`` of ``jax.random.uniform(key,
    shape, minval=minval, maxval=maxval)`` for any ``shape`` holding them."""
    return scale_uniform(uniform_from_bits(bits_at(key, index)), minval, maxval)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)`` (float32)."""
    return scale_uniform(uniform_from_bits(random_bits(key, shape)), minval, maxval)


TINY = float(np.finfo(np.float32).tiny)
NORMAL_LOW = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = np.float32(np.sqrt(2))


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """``-log(-log(u))`` of uniforms on [tiny, 1)."""
    return -torch.log(-torch.log(u))


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in its default ``"low"`` mode."""
    return gumbel_from_uniform(uniform(key, shape, TINY, 1.0))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: int64
    indices, the first on ties as ``jnp.argmax``."""
    return torch.argmax(gumbel(key, tuple(logits.shape)) + logits, dim=-1)


def normal_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """``sqrt(2) * erfinv(u)`` of uniforms on [nextafter(-1, 0), 1)."""
    return torch.tensor(SQRT2, device=u.device) * torch.erfinv(u)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32)."""
    return normal_from_uniform(uniform(key, shape, NORMAL_LOW, 1.0))


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval: int,
                      maxval: int) -> torch.Tensor:
    """int32 in [minval, maxval) from the two 32-bit draws of ``randint``:
    ``(higher % span * m + lower % span) % span`` with ``m = (2**16 %
    span)**2 % span``, every product and sum wrapping at 2**32 (so ``m`` is 0
    for spans above 2**16)."""
    span = 1 if maxval <= minval else maxval - minval
    multiplier = (((2**16 % span) ** 2) & MASK32) % span
    offset = ((((higher % span) * multiplier) & MASK32) + lower % span) & MASK32
    return (minval + offset % span).to(torch.int32)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32)."""
    k = split(key)
    return randint_from_bits(random_bits(k[..., 0, :], shape),
                             random_bits(k[..., 1, :], shape), minval, maxval)


def shuffle_rounds(n: int) -> int:
    """Sorting rounds of ``permutation`` over ``n`` elements."""
    return int(math.ceil(SHUFFLE_EXPONENT * math.log(max(1, n)) / math.log(UINT32_MAX)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int32[..., n])."""
    x = torch.arange(n, dtype=torch.int32, device=key.device).expand(key.shape[:-1] + (n,))
    for _ in range(shuffle_rounds(n)):
        k = split(key)
        key = k[..., 0, :]
        order = torch.sort(random_bits(k[..., 1, :], (n,)), dim=-1, stable=True).indices
        x = x.gather(-1, order)
    return x
