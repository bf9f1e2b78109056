"""Legacy-gym seeding schemes (shared by the gym shim and the host mirror).

The reference's ``seed()`` routes through ``gym.utils.seeding.np_random``
(craftingworld_ray.py:145-147). Two deterministic schemes are provided:

``direct``
    ``RandomState(seed)`` — the simplest bit-reproducible scheme. The parity
    harness seeds both the oracle (through the shim) and its own host-side
    RNG mirror identically, so any shared scheme proves parity.

``legacy_hash``
    Historical gym's scheme (gym 0.9-0.19 ``gym/utils/seeding.py``, i.e. the
    versions the reference was developed against, before the 0.21 rewrite to
    ``np.random.Generator``): the integer seed is normalised
    (``create_seed``), hashed with SHA-512 (``hash_seed``), and the
    RandomState is seeded with the resulting uint32 list. Under a real
    2019-era gym install the reference's ``seed(N)`` therefore produces
    *different* draws than ``RandomState(N)`` — this mode reproduces them.

Select per call (``np_random(seed, scheme=...)``) or globally via the
``CW_GYMSHIM_SEEDING`` env var (default ``direct``, which all existing parity
artifacts were recorded under). tests/test_legacy_seeding.py pins the hash
algebra to golden values and re-proves public-API episode parity under the
hashed scheme.

This module lives outside the shim so the host-side mirror
(parity/host_rng.py) can import it without mounting the shim as ``gym``.
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np


def _bigint_from_bytes(bts: bytes) -> int:
    # gym<=0.19 seeding._bigint_from_bytes: little-endian uint32 accumulation
    sizeof_int = 4
    padding = sizeof_int - len(bts) % sizeof_int
    bts += b"\0" * padding
    int_count = len(bts) // sizeof_int
    unpacked = struct.unpack(f"{int_count}I", bts)
    accum = 0
    for i, val in enumerate(unpacked):
        accum += 2 ** (sizeof_int * 8 * i) * val
    return accum


def _int_list_from_bigint(bigint: int) -> list[int]:
    if bigint < 0:
        raise ValueError(f"Seed must be non-negative, not {bigint}")
    ints: list[int] = []
    while bigint > 0:
        bigint, mod = divmod(bigint, 2**32)
        ints.append(mod)
    return ints


def create_seed(a: int | str | None = None, max_bytes: int = 8) -> int:
    """gym<=0.19 seeding.create_seed: normalise a seed to an int."""
    if a is None:
        a = _bigint_from_bytes(os.urandom(max_bytes))
    elif isinstance(a, str):
        bts = a.encode("utf8")
        bts += hashlib.sha512(bts).digest()
        a = _bigint_from_bytes(bts[:max_bytes])
    elif isinstance(a, int):
        a = a % 2 ** (8 * max_bytes)
    else:
        raise ValueError(f"Invalid type for seed: {type(a)} ({a})")
    return a


def hash_seed(seed: int | None = None, max_bytes: int = 8) -> int:
    """gym<=0.19 seeding.hash_seed: SHA-512 of the decimal string."""
    if seed is None:
        seed = create_seed(max_bytes=max_bytes)
    digest = hashlib.sha512(str(seed).encode("utf8")).digest()
    return _bigint_from_bytes(digest[:max_bytes])


def np_random(seed=None, scheme: str | None = None):
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"Seed must be a non-negative integer, got {seed!r}")
    scheme = scheme or os.environ.get("CW_GYMSHIM_SEEDING", "direct")
    if scheme == "legacy_hash":
        seed = create_seed(seed)
        rng = np.random.RandomState()
        rng.seed(_int_list_from_bigint(hash_seed(seed)))
        return rng, seed
    if scheme != "direct":
        raise ValueError(f"unknown seeding scheme {scheme!r}")
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**31))
    rng = np.random.RandomState(seed)
    return rng, seed
