"""Spaces used by the reference: Box, Dict, Discrete (legacy gym semantics)."""

from __future__ import annotations

import numpy as np


class Space:
    def __init__(self, shape=None, dtype=None):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = np.dtype(dtype) if dtype is not None else None


class Box(Space):
    """Legacy Box: scalar low/high broadcast to full arrays.

    The reference reads ``.low`` as a live array to seed its pre-reset
    desired_goal_vector (craftingworld_ray.py:112), and ``.shape`` in
    sample_state (:606).
    """

    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        super().__init__(shape, dtype)
        self.low = np.full(self.shape, low, dtype=self.dtype)
        self.high = np.full(self.shape, high, dtype=self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return (
            x.shape == self.shape and np.all(x >= self.low) and np.all(x <= self.high)
        )


class Discrete(Space):
    def __init__(self, n):
        super().__init__((), np.int64)
        self.n = int(n)

    def contains(self, x):
        return 0 <= int(x) < self.n


class Dict(Space):
    def __init__(self, spaces_dict=None, **kwargs):
        super().__init__(None, None)
        if spaces_dict is None:
            spaces_dict = kwargs
        self.spaces = dict(spaces_dict)

    def __getitem__(self, key):
        return self.spaces[key]

    def contains(self, x):
        return isinstance(x, dict) and all(
            k in x and s.contains(x[k]) for k, s in self.spaces.items()
        )
