"""Self-contained observation/action space descriptions.

Shaped like classic gym spaces (Box/Dict/Discrete with ``.low/.high/.shape``)
so code written against the reference keeps working, without importing gym or
gymnasium. `to_gymnasium()` converts when gymnasium interop is wanted.
"""

from __future__ import annotations

import numpy as np


class Box:
    def __init__(self, low, high, shape, dtype=np.int64):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.full(self.shape, low, dtype=self.dtype)
        self.high = np.full(self.shape, high, dtype=self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return x.shape == self.shape and np.all(x >= self.low) and np.all(
            x <= self.high
        )

    def to_gymnasium(self):
        import gymnasium

        return gymnasium.spaces.Box(self.low, self.high, dtype=self.dtype)

    def __repr__(self):
        return f"Box{self.shape}"


class Discrete:
    def __init__(self, n):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def contains(self, x):
        return 0 <= int(x) < self.n

    def to_gymnasium(self):
        import gymnasium

        return gymnasium.spaces.Discrete(self.n)

    def __repr__(self):
        return f"Discrete({self.n})"


class Dict:
    def __init__(self, spaces):
        self.spaces = dict(spaces)

    def __getitem__(self, k):
        return self.spaces[k]

    def contains(self, x):
        return isinstance(x, dict) and all(
            k in x and s.contains(x[k]) for k, s in self.spaces.items()
        )

    def to_gymnasium(self):
        import gymnasium

        return gymnasium.spaces.Dict(
            {k: s.to_gymnasium() for k, s in self.spaces.items()}
        )

    def __repr__(self):
        return f"Dict({list(self.spaces)})"
