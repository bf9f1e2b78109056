"""Pixel-observation actor-critic (CNN family).

Counterpart of ``gym_craftingworld_tpu/models/cnn.py``. For users training
from the Ray/Flat RGB renders instead of the compact one-hot features.
Convolutions run in bf16 on NHWC tensors (flax's layout, with XLA's SAME
pads: ``models/layers.py``); at 4x4-px cells the 84x84x3 frames reduce
quickly with stride-4 then stride-2 convs (the classic DQN stem shape),
ending in the same policy/value heads as the MLP family. The first dense
layer reads the conv output flattened in (h, w, c) order, as flax's
``reshape`` of an NHWC tensor does.
"""

from __future__ import annotations

import torch
from torch import nn

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.models.flax_rng import as_rngs, child
from gym_craftingworld_tpu_torch.models.layers import Conv, Dense
from gym_craftingworld_tpu_torch.render.raster import render_ray

bf16 = torch.bfloat16
f32 = torch.float32


def _out(n: int, s: int) -> int:
    """A SAME convolution's output size on an axis of ``n`` at stride ``s``."""
    return -(-n // s)


class PixelActorCritic(nn.Module):
    """Conv torso + goal-bit fusion + policy/value heads.

    pixels uint8[B, 4H, 4W, 3], goal_bits [B, 18] -> (logits f32[B, 6],
    value f32[B]). Parameters under the flax names (``Conv_0 Conv_1 Conv_2
    Dense_0 policy value``).
    """

    def __init__(self, height: int = 21, width: int = 21, hidden: int = 256,
                 n_actions: int = C.N_ACTIONS, key=None, device=None):
        super().__init__()
        rngs = as_rngs(key)
        kw = lambda name: dict(key=child(rngs, name), device=device)
        self.Conv_0 = Conv(3, 32, (8, 8), (4, 4), **kw("Conv_0"))
        self.Conv_1 = Conv(32, 64, (4, 4), (2, 2), **kw("Conv_1"))
        self.Conv_2 = Conv(64, 64, (3, 3), (1, 1), **kw("Conv_2"))
        h, w = _out(_out(4 * height, 4), 2), _out(_out(4 * width, 4), 2)
        self.Dense_0 = Dense(h * w * 64 + 2 * C.N_TASKS, hidden, **kw("Dense_0"))
        self.policy = Dense(hidden, n_actions, dtype=f32, **kw("policy"))
        self.value = Dense(hidden, 1, dtype=f32, **kw("value"))

    def forward(self, pixels: torch.Tensor, goal_bits: torch.Tensor):
        x = pixels.to(bf16) / 255.0
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = torch.relu(conv(x))
        x = x.reshape(x.shape[0], -1)  # NHWC: (h, w, c) order
        x = torch.cat([x, goal_bits.to(bf16)], dim=-1)
        x = torch.relu(self.Dense_0(x))
        return self.policy(x), self.value(x)[:, 0]


def pixel_obs(state: EnvState):
    """(pixels uint8[B, 4H, 4W, 3], goal_bits f32[B, 18]) for the CNN family."""
    pixels = render_ray(state.objects, state.agent, state.holding)
    goal_bits = torch.cat([state.desired.to(f32), state.achieved.to(f32)], dim=-1)
    return pixels, goal_bits


def init_params(key, height: int = 21, width: int = 21, hidden: int = 256) -> PixelActorCritic:
    """A ``PixelActorCritic`` for ``height x width`` worlds, its weights
    flax's ``model.init(key, ...)`` from JAX's key data, on the key's
    device. The module holds its parameters."""
    return PixelActorCritic(height, width, hidden, key=key)


class PixelDistillStudent(nn.Module):
    """Images-only policy for the canonical setting (distillation student).

    Consumes exactly the reference's pixel observation content
    (craftingworld_ray.py:84-92): the current frame, the imagined
    desired-goal frame and the init frame, stacked channel-wise as
    [B, 4H, 4W, 9]. The stem is a 4x4/stride-4 conv aligned to the
    renderer's 4x4-px cells, so after one layer the net is back on the H x W
    cell lattice. Parameters under the flax names (``stem conv0 conv1 conv2
    squeeze dense0 dense1 policy value``).
    """

    def __init__(self, height: int = 21, width: int = 21, channels: int = 96,
                 hidden: int = 1536, stem: int = 64, n_actions: int = C.N_ACTIONS,
                 key=None, device=None):
        super().__init__()
        rngs = as_rngs(key)
        kw = lambda name: dict(key=child(rngs, name), device=device)
        self.stem = Conv(9, stem, (4, 4), (4, 4), **kw("stem"))
        self.conv0 = Conv(stem, channels, (3, 3), **kw("conv0"))
        self.conv1 = Conv(channels, channels, (3, 3), **kw("conv1"))
        self.conv2 = Conv(channels, channels, (3, 3), **kw("conv2"))
        self.squeeze = Conv(channels, 32, (1, 1), **kw("squeeze"))
        self.dense0 = Dense(height * width * 32, hidden, **kw("dense0"))
        self.dense1 = Dense(hidden, hidden // 2, **kw("dense1"))
        self.policy = Dense(hidden // 2, n_actions, dtype=f32, **kw("policy"))
        self.value = Dense(hidden // 2, 1, dtype=f32, **kw("value"))

    def forward(self, images: torch.Tensor):
        x = images.to(bf16) / 255.0
        for conv in (self.stem, self.conv0, self.conv1, self.conv2, self.squeeze):
            x = torch.relu(conv(x))
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.dense0(x))
        x = torch.relu(self.dense1(x))
        return self.policy(x), self.value(x)[:, 0]


def student_images(cfg, objects, agent, holding, goal_objects, goal_agent,
                   init_objects, init_agent):
    """(current, goal, init) Ray frames stacked on channels: uint8[B,4H,4W,9].

    The goal and init frames render with holding=0 and the episode's
    imagined/init agent cells, matching the reference's desired_goal and
    init_observation images (craftingworld_ray.py:191-196).
    """
    zero = torch.zeros_like(holding)
    cur = render_ray(objects, agent, holding)
    goal = render_ray(goal_objects, goal_agent, zero)
    init = render_ray(init_objects, init_agent, zero)
    return torch.cat([cur, goal, init], dim=-1)


def init_student(key, cfg, channels: int = 96, hidden: int = 1536,
                 stem: int = 64) -> PixelDistillStudent:
    """A ``PixelDistillStudent`` for ``cfg``'s grid, flax's init from ``key``."""
    return PixelDistillStudent(cfg.height, cfg.width, channels, hidden, stem, key=key)
