"""Gymnasium-style vector environment over the batched core.

Counterpart of ``gym_craftingworld_tpu/api/vector.py``. Modern RL stacks
consume `gymnasium.vector.VectorEnv`-shaped interfaces; this adapter exposes
the whole device-resident batch through that protocol — ``reset() -> (obs,
info)`` and ``step(actions) -> (obs, rewards, terminations, truncations,
infos)`` with per-env autoreset — while stepping, resets and rendering stay
on the device, and so do the tensors it returns. No per-env Python objects
exist.

Auto-reset. The JAX package resets each done env from that env's own key.
The port's ``rng`` field is opaque (``core/state.py``), so every step draws a
fresh batch of worlds from the env's ``torch.Generator`` and takes the fresh
world for each env whose step was done, as ``core/rollout.py`` does: the
shapes stay fixed and a step makes no host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.api import spaces
from gym_craftingworld_tpu_torch.config import EnvConfig, resolve_selected_tasks
from gym_craftingworld_tpu_torch.core.reset import reset as core_reset
from gym_craftingworld_tpu_torch.core.rollout import _select
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import step as core_step


def _step_autoreset(cfg: EnvConfig, state: EnvState, actions, generator):
    """One batched step; finished episodes restart from worlds freshly drawn
    from ``generator``."""
    state, res = core_step(cfg, state, actions)
    fresh = core_reset(cfg, state.objects.shape[0], generator, state.objects.device)
    return _select(res.done, fresh, state), res


class CraftingWorldVectorEnv:
    """num_envs CraftingWorlds stepping in lockstep on ``device`` (the card
    unless the caller asks for the CPU).

    obs_mode: 'onehot' (B, H, W, 12) | 'pixels' (B, 4H, 4W, 3) |
              'features' (B, H*W*12 + 18) — the policy-feature vector.
    """

    def __init__(self, num_envs: int, size=(21, 21), max_steps=300,
                 selected_tasks=None, number_of_tasks=None, stacking=True,
                 reward_style=None, obs_mode="onehot", seed=0, device="cuda"):
        sel = (
            resolve_selected_tasks(selected_tasks)
            if selected_tasks is not None
            else tuple(range(C.N_TASKS))
        )
        self.cfg = EnvConfig(
            height=size[0],
            width=size[1],
            max_steps=max_steps,
            stacking=stacking,
            selected_task_indices=sel,
            number_of_tasks=(
                number_of_tasks if number_of_tasks is not None else len(sel)
            ),
            reward_equal=(reward_style is None),
        )
        self.num_envs = int(num_envs)
        self.obs_mode = obs_mode
        self.device = torch.device(device)
        self._seed = seed
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._state: EnvState | None = None

        self.single_action_space = spaces.Discrete(C.N_ACTIONS)
        self.action_space = spaces.Discrete(C.N_ACTIONS)
        H, W = size
        if obs_mode == "onehot":
            self.single_observation_space = spaces.Box(
                0, 1, (H, W, C.N_CHANNELS), dtype=np.uint8
            )
        elif obs_mode == "pixels":
            self.single_observation_space = spaces.Box(
                0, 255, (4 * H, 4 * W, 3), dtype=np.uint8
            )
        elif obs_mode == "features":
            self.single_observation_space = spaces.Box(
                0, 1, (H * W * C.N_CHANNELS + 2 * C.N_TASKS,), dtype=np.float32
            )
        else:
            raise ValueError(f"unknown obs_mode {obs_mode!r}")

    # -- observation builders ---------------------------------------------

    def _obs(self):
        from gym_craftingworld_tpu_torch.models.actor_critic import obs_features
        from gym_craftingworld_tpu_torch.render import raster

        st = self._state
        if self.obs_mode == "onehot":
            return raster.render_onehot(st.objects, st.agent, st.holding)
        if self.obs_mode == "pixels":
            return raster.render_ray(st.objects, st.agent, st.holding)
        return obs_features(st)

    # -- vector env protocol ----------------------------------------------

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._seed = seed
            self._gen.manual_seed(seed)
        self._state = core_reset(self.cfg, self.num_envs, self._gen, self.device)
        return self._obs(), {}

    def step(self, actions):
        actions = torch.as_tensor(actions, dtype=torch.int32, device=self.device)
        self._state, res = _step_autoreset(self.cfg, self._state, actions, self._gen)
        obs = self._obs()
        rewards = res.reward
        # success → terminated; step-cap → truncated (gymnasium semantics)
        terminated = res.reward == self.cfg.max_steps
        truncated = res.done & ~terminated
        infos = {
            "achieved_goal": self._state.achieved,
            "desired_goal": self._state.desired,
        }
        return obs, rewards, terminated, truncated, infos

    @property
    def state(self) -> EnvState:
        return self._state

    def close(self):
        pass
