"""flax's parameter keys, on JAX's Threefry key data.

``model.init(key, ...)`` of a flax ``linen`` module does not split its key
into one key a parameter. Each scope carries the root key and a static
suffix (``flax/core/scope.py``, flax 0.12: ``LazyRng``, ``Scope.push``,
``Scope.make_rng``):

* a child scope appends its name to the suffix (``push``);
* each ``param`` call, constant initialisers included, counts up the
  scope's ``params`` counter (1, 2, ...) and appends the count
  (``make_rng``), so a Dense's kernel takes count 1 and its bias count 2;
* the key is ``fold_in(root, h)``, with ``h`` the first four bytes,
  big-endian, of the SHA-1 of the suffix's strings (UTF-8) and ints
  (big-endian, in as few bytes as they need), with no separator between
  them, as ``flax_fix_rng_separator`` is off by default (``_fold_in_static``).

``Rngs`` is that scope, on the root key's device: the port's layers take one
in place of flax's scope and draw their parameters from ``Rngs.param_key``.
The fold-in runs through the counter kernel on the card
(``ops/keyed_draws.fold_in``). ``Rngs(..., log=[])`` lists each drawn
parameter as a ``Draw``, so a caller can check its key and its uniforms.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch.ops import keyed_draws as kd

FIX_RNG_SEPARATOR = False  # flax's config.flax_fix_rng_separator, off in flax 0.12


def path_hash(path) -> int:
    """flax's ``_fold_in_static`` hash of a suffix of strings and ints: the
    first four bytes, big-endian, of its SHA-1."""
    m = hashlib.sha1()
    for x in path:
        if FIX_RNG_SEPARATOR:
            m.update(b"\x00")
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected an int or a string, got {x!r}")
    return int.from_bytes(m.digest()[:4], byteorder="big")


def fold_in_static(key: torch.Tensor, path) -> torch.Tensor:
    """``_fold_in_static(key, path)``: ``key`` itself for an empty path."""
    return kd.fold_in(key, path_hash(path)) if path else key


class Draw(NamedTuple):
    """One parameter's draw: its flax path (``"torso0/kernel"``), key data
    int64[2], initializer (``"truncated_normal"``, ``"normal"`` or
    ``"orthogonal"``), shape and the initializer's argument (the fan-in,
    the standard deviation, None): ``models/layers.from_uniforms``'s."""

    path: str
    key: torch.Tensor
    init: str
    shape: tuple
    arg: float | int | None


class Rngs:
    """A flax scope's ``params`` keys: the root key data int64[2], the
    scope's names, and its counter."""

    def __init__(self, key: torch.Tensor, path: tuple = (), log: list | None = None):
        self.key, self.path, self.log = key, tuple(path), log
        self.count = 0

    @property
    def device(self) -> torch.device:
        return self.key.device

    def child(self, name: str) -> Rngs:
        """The scope of the submodule ``name`` (a counter of its own)."""
        return Rngs(self.key, self.path + (name,), self.log)

    def param_key(self, name: str) -> torch.Tensor:
        """The key of this scope's next parameter, ``name``."""
        self.count += 1
        return fold_in_static(self.key, self.path + (self.count,))

    def skip(self) -> None:
        """A parameter with a constant init: it takes its count, and no key."""
        self.count += 1

    def record(self, name: str, key: torch.Tensor, init: str, shape, arg=None) -> None:
        if self.log is not None:
            self.log.append(Draw("/".join(self.path + (name,)), key, init, tuple(shape), arg))


def as_rngs(key) -> Rngs | None:
    """A root ``Rngs`` of key data int64[2]; an ``Rngs`` or None as it is."""
    if key is None or isinstance(key, Rngs):
        return key
    return Rngs(key)


def child(rngs: Rngs | None, name: str) -> Rngs | None:
    """``rngs.child(name)``, None without scope (a module to load weights into)."""
    return None if rngs is None else rngs.child(name)
