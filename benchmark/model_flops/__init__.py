"""Model FLOPs of a configuration, counted from the shapes in its own file.

``model_flops/<family>.py`` gives ``forward(conf)``: the multiply-adds (times
two) of one row's forward pass. A training iteration's model FLOPs are the
collect's forwards over T x B rows, the last value's over B, and each
epoch's forward and backward, counted as three forwards, over every row.
The same work counts the same whatever implements it.
"""

from __future__ import annotations

import importlib


def forward(conf: dict) -> float:
    return importlib.import_module(f"benchmark.model_flops.{conf['family']}").forward(conf)


def train_iteration(conf: dict, envs: int) -> float:
    rows = conf["rollout_steps"] * envs
    return forward(conf) * (rows + envs + 3 * conf["update_epochs"] * rows)
