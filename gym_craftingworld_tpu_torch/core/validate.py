"""Debug-mode state invariant checking.

Counterpart of ``gym_craftingworld_tpu/core/validate.py``, which is numpy
already; it is copied rather than imported because importing the JAX package
imports JAX. It checks the invariants every reachable state satisfies and
that the fast paths (slots, fused kernels) rely on:

  * exactly one agent position inside the grid
  * at most one object per cell
  * the held-item code is 0..3 and the agent holds at most one item
  * achieved/desired are 0/1 vectors
  * object multiset is conserved up to the crafting rules (counts never grow)

``assert_valid_state`` runs on host (numpy) and raises with the offending env
index; ``check_state`` returns a boolean mask for use in tests.
"""

from __future__ import annotations

import numpy as np

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.state import EnvState


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def check_state(cfg: EnvConfig, state: EnvState) -> np.ndarray:
    """Per-env validity mask (True = all invariants hold)."""
    objects = _np(state.objects)
    agent = _np(state.agent)
    holding = _np(state.holding)
    achieved = _np(state.achieved)
    desired = _np(state.desired)
    B = objects.shape[0]

    ok = np.ones(B, bool)
    ok &= (agent[:, 0] >= 0) & (agent[:, 0] < cfg.height)
    ok &= (agent[:, 1] >= 0) & (agent[:, 1] < cfg.width)
    ok &= (objects >= 0).all(axis=(1, 2)) & (objects <= C.N_OBJECTS).all(axis=(1, 2))
    ok &= (holding >= C.HOLD_NONE) & (holding <= C.HOLD_HAMMER)
    ok &= ((achieved == 0) | (achieved == 1)).all(axis=1)
    ok &= ((desired == 0) | (desired == 1)).all(axis=1)

    # object counts never grow: total on-grid + held <= 8 (the JAX version
    # counts each env's positive codes with a bincount, which raises on a
    # negative code; this is that count, and such an env is already invalid)
    total = (objects.reshape(B, -1) > 0).sum(axis=1) + (holding != 0)
    ok &= total <= C.N_OBJECTS
    return ok


def assert_valid_state(cfg: EnvConfig, state: EnvState):
    ok = check_state(cfg, state)
    if not ok.all():
        bad = int(np.flatnonzero(~ok)[0])
        raise AssertionError(
            f"invalid env state at batch index {bad}: "
            f"agent={_np(state.agent)[bad]}, "
            f"holding={int(_np(state.holding)[bad])}"
        )
