"""Multi-step rollouts on the grid layout.

Counterpart of ``gym_craftingworld_tpu/core/rollout.py``: T steps of
:func:`~gym_craftingworld_tpu_torch.core.step.step` over a batch, as a loop
of batched steps on the state's device.

Auto-reset. The JAX rollout draws each done env's fresh world from that env's
own ``rng`` key. The port's ``rng`` field is opaque and zeroed
(``core/state.py``), so ``rollout(..., auto_reset=True)`` takes a
``generator=`` instead: after every step it draws a fresh batch of B worlds
with the port's :func:`~gym_craftingworld_tpu_torch.core.reset.reset` from
that generator, and takes the fresh world for each env whose step was done.
Every step draws, done or not, so the shapes are fixed and a run is a pure
function of the state, the actions and the generator's state.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import scan, step


class RolloutOut(NamedTuple):
    reward: torch.Tensor  # int32[T, B]
    done: torch.Tensor  # bool[T, B]


def _select(done: torch.Tensor, fresh: EnvState, state: EnvState) -> EnvState:
    """Per env, ``fresh`` where ``done`` else ``state``."""
    pick = lambda f, s: torch.where(done.view((-1,) + (1,) * (s.dim() - 1)), f, s)
    return EnvState(**{f.name: pick(getattr(fresh, f.name), getattr(state, f.name))
                       for f in dataclasses.fields(EnvState)})


def rollout(cfg: EnvConfig, state: EnvState, actions: torch.Tensor,
            auto_reset: bool = False, generator: torch.Generator | None = None):
    """Run ``actions: int[T, B]`` through the env. Returns ``(state, RolloutOut)``.

    With ``auto_reset``, every env whose step is done restarts from a fresh
    world drawn from ``generator`` (module docstring). The input state is not
    modified.
    """
    if auto_reset and generator is None:
        raise ValueError("auto_reset=True needs a generator to draw fresh worlds")
    B = state.objects.shape[0]

    def body(st, action_t):
        st, res = step(cfg, st, action_t)
        if auto_reset:
            st = _select(res.done, reset(cfg, B, generator, st.objects.device), st)
        return st, res

    state, out = scan(body, state, actions)
    return state, RolloutOut(reward=out.reward, done=out.done)


def rollout_random(cfg: EnvConfig, state: EnvState, generator: torch.Generator,
                   num_steps: int):
    """T steps of uniform-random actions, drawn from ``generator`` as int32 ``[T, B]``."""
    B = state.objects.shape[0]
    actions = torch.randint(0, C.N_ACTIONS, (num_steps, B), generator=generator,
                            device=state.objects.device, dtype=torch.int32)
    return rollout(cfg, state, actions)
