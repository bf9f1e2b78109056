"""Clamped 2-D coordinate utility — API parity with the reference's
``Coord`` (`coordinates.py:6-43`).

The compiled core never uses this class (movement clamping is vectorised in
core/step.py); it exists for user code written against the reference, where
``env.agent_pos`` arithmetic and ``.tuple()`` are part of the public surface.
"""

from __future__ import annotations


class Coord:
    def __init__(self, row: int, col: int, max_row: int = 100,
                 max_col: int = 100, name: str | None = None):
        self.row = row
        self.col = col
        self.max_row = max_row
        self.max_col = max_col
        self.name = name

    def _clamp(self, row, col):
        return Coord(
            max(0, min(row, self.max_row)),
            max(0, min(col, self.max_col)),
            self.max_row,
            self.max_col,
        )

    def __add__(self, other):
        return self._clamp(self.row + other.row, self.col + other.col)

    def __sub__(self, other):
        return self._clamp(self.row - other.row, self.col - other.col)

    def __eq__(self, other):
        if not isinstance(other, Coord):
            return False
        return self.row == other.row and self.col == other.col

    def __hash__(self):
        return hash((self.row, self.col))

    def __str__(self):
        return str(self.tuple())

    def tuple(self):
        return (self.row, self.col)
