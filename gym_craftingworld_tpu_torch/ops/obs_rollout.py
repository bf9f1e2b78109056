"""Observation-interleaved rollout: env-steps/s *with* per-step observations.

Counterpart of ``gym_craftingworld_tpu/ops/obs_rollout.py``. The reference
rebuilds its observation dict after every effective step
(craftingworld_ray.py:348-360), so raw stepping rate overstates what a
pixel-consuming agent can draw from the env. This rollout steps the slot
engine on a uniform-random action, then renders the new observation — Ray
4x4 pixels, AltObs 3x3+strip tiles, or the 12-channel one-hot — from the slot
state, every step.

Each step's observation is reduced at once into a running checksum, so every
pixel of every step is computed while only a few frames are ever held: one
Ray frame of 16,384 envs on 21x21 is 347 MB, and T of them would not fit
(``_sum64`` keeps the reduction's own copy within a frame).
The checksum is the uint32 wrap-sum of every pixel plus the rewards, as in
the JAX package; it is summed in int64 on the device and returned modulo
2**32.
"""

from __future__ import annotations

import torch

from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.slots import (
    SlotState,
    holding_of,
    random_actions,
    step_slots,
    to_grid,
)
from gym_craftingworld_tpu_torch.render.raster import (
    render_altobs,
    render_onehot,
    render_ray,
)

_RENDER = {
    "ray": render_ray,
    "altobs": render_altobs,
    "onehot": render_onehot,
}


def slots_to_codes(cfg: EnvConfig, s: SlotState) -> torch.Tensor:
    """Packed object codes int32[B, H, W] from slots: ``core.slots.to_grid``'s
    grid, which scatters each env's on-grid slots into its cells."""
    return to_grid(s, cfg)[0].to(torch.int32)


def _sum64(img: torch.Tensor) -> torch.Tensor:
    """The int64 sum of a frame ``[B, ...]``. torch's integer sum casts its
    whole input to the sum's dtype first, eight times a uint8 frame's bytes,
    so the frame is summed in slices of envs whose int64 copy is at most the
    frame's own size."""
    step = max(1, img.shape[0] * img.element_size() // 8)
    return sum(part.sum(dtype=torch.int64) for part in img.split(step))


def _rollout_obs(cfg: EnvConfig, slots: SlotState, actions: torch.Tensor,
                 obs_mode: str = "ray"):
    """The rollout over given actions int32[T, B]: ``(final_slots, checksum)``."""
    render = _RENDER[obs_mode]
    csum = torch.zeros((), dtype=torch.int64, device=actions.device)
    for action_t in actions:
        slots, res = step_slots(cfg, slots, action_t)
        img = render(slots_to_codes(cfg, slots), slots.agent, holding_of(slots))
        csum = csum + _sum64(img) + res.reward.sum(dtype=torch.int64)
    return slots, csum & 0xFFFFFFFF


def rollout_obs_random(cfg: EnvConfig, slots: SlotState, key: torch.Tensor,
                       num_steps: int, obs_mode: str = "ray"):
    """T random-action steps, rendering the observation after every step.

    The actions are ``core.slots.random_actions`` of ``key``, the draw of
    ``core.slots.rollout_slots_random``, so from one key both reach the same
    final state. Returns ``(final_slots, checksum)``: ``checksum`` is a 0-dim
    int64 tensor holding the uint32 wrap-sum of every observation pixel plus
    the reward stream; reading it on the host waits for the whole rollout.
    The input state is not modified.
    """
    return _rollout_obs(cfg, slots, random_actions(slots, key, num_steps), obs_mode)
