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
* ``uniform``: ``(bits >> 9) | 0x3F800000`` read as a float32, minus 1.
* ``randint``: two bit draws from ``split(key)`` folded into the span with
  32-bit unsigned arithmetic.
* ``permutation``: ``ceil(3 ln n / ln(2**32 - 1))`` rounds of a stable sort
  by fresh 32-bit keys.

Key data is an int64 tensor ``[..., 2]`` holding two words in ``[0,
2**32)``, as ``ops/philox.py`` carries its words and as ``interop.py``
widens JAX's uint32 key data; every function batches over the key's leading
dims. The hot draws of a reset run in a hand-written kernel on the card
(``ops/keyed_draws.py``), which these functions hold bit for bit.
"""

from __future__ import annotations

import math

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


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 on [0, 1))."""
    return uniform_from_bits(random_bits(key, shape))


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
