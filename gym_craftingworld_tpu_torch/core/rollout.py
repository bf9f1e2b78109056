"""Multi-step rollouts on the grid layout.

Counterpart of ``gym_craftingworld_tpu/core/rollout.py``: T steps of
:func:`~gym_craftingworld_tpu_torch.core.step.step` over a batch, as a loop
of batched steps on the state's device.

Auto-reset, as in JAX: after every step each env's fresh world is drawn from
that env's own ``rng`` key (``core/reset.reset``), and each env whose step
was done takes it. Every step draws for the whole batch, done or not, so the
shapes are fixed and a step makes no host sync; an env's worlds depend only
on its key, so a run equals the JAX rollout's bit for bit.
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
from gym_craftingworld_tpu_torch.ops.keyed_draws import randint_cols


class RolloutOut(NamedTuple):
    reward: torch.Tensor  # int32[T, B]
    done: torch.Tensor  # bool[T, B]


def _select(done: torch.Tensor, fresh: EnvState, state: EnvState) -> EnvState:
    """Per env, ``fresh`` where ``done`` else ``state``."""
    pick = lambda f, s: torch.where(done.view((-1,) + (1,) * (s.dim() - 1)), f, s)
    return EnvState(**{f.name: pick(getattr(fresh, f.name), getattr(state, f.name))
                       for f in dataclasses.fields(EnvState)})


def rollout(cfg: EnvConfig, state: EnvState, actions: torch.Tensor,
            auto_reset: bool = False):
    """Run ``actions: int[T, B]`` through the env. Returns ``(state, RolloutOut)``.

    With ``auto_reset``, every env whose step is done restarts from a fresh
    world drawn from its own key (module docstring). The input state is not
    modified.
    """

    def body(st, action_t):
        st, res = step(cfg, st, action_t)
        if auto_reset:
            st = _select(res.done, reset(cfg, st.rng), st)
        return st, res

    state, out = scan(body, state, actions)
    return state, RolloutOut(reward=out.reward, done=out.done)


def rollout_random(cfg: EnvConfig, state: EnvState, key: torch.Tensor, num_steps: int):
    """T steps of uniform-random actions, ``jax.random.randint(key, (T, B), 0,
    6)`` (int32) from key data ``key`` int64[2]."""
    B = state.objects.shape[0]
    actions = randint_cols(key, (num_steps, B), 0, C.N_ACTIONS, device=state.objects.device)
    return rollout(cfg, state, actions)
