"""Grid-attention (ViT-style) actor-critic family.

Counterpart of ``gym_craftingworld_tpu/models/vit.py``. Each grid cell is a
token (its 12-channel one-hot embedded, plus a learned positional code), and
a goal token carrying the desired/achieved bits, at position 0, attends over
the board through a small pre-LN transformer. All products are bf16; the
layers follow flax's rounding (``models/layers.py``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.models.flax_rng import as_rngs, child
from gym_craftingworld_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MultiHeadDotProductAttention,
    gelu,
    param,
)
from gym_craftingworld_tpu_torch.render.raster import render_onehot

bf16 = torch.bfloat16
f32 = torch.float32


class _Block(nn.Module):
    """Pre-LN transformer block, bf16 compute (flax names ``LayerNorm_0
    MultiHeadDotProductAttention_0 LayerNorm_1 Dense_0 Dense_1``)."""

    def __init__(self, dim: int, heads: int, key=None, device=None):
        super().__init__()
        rngs = as_rngs(key)
        kw = lambda name: dict(key=child(rngs, name), device=device)
        self.LayerNorm_0 = LayerNorm(dim, **kw("LayerNorm_0"))
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, heads, **kw("MultiHeadDotProductAttention_0"))
        self.LayerNorm_1 = LayerNorm(dim, **kw("LayerNorm_1"))
        self.Dense_0 = Dense(dim, 4 * dim, **kw("Dense_0"))
        self.Dense_1 = Dense(4 * dim, dim, **kw("Dense_1"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        return x + self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))


class GridActorCritic(nn.Module):
    """Cell tokens + goal token -> transformer -> policy/value heads.

    cells [B, N, 12], goal_bits [B, 18] -> (logits f32[B, 6], value f32[B]),
    with N = H*W fixed by the learned ``pos`` [1, N, hidden]. ``hidden`` is
    the token width. Under autograd each block is checkpointed: at 21x21 and
    hidden 512 a block's activations take ~9 MB a row (its [N, 4*hidden]
    MLP and its [heads, N, N] attention weights). Parameters under the flax names (``embed pos goal
    block0..block{depth-1} LayerNorm_0 policy value``).
    """

    def __init__(self, n_tokens: int, hidden: int = 128, depth: int = 2, heads: int = 4,
                 n_actions: int = C.N_ACTIONS, key=None, device=None):
        super().__init__()
        rngs = as_rngs(key)
        kw = lambda name: dict(key=child(rngs, name), device=device)
        self.embed = Dense(C.N_CHANNELS, hidden, **kw("embed"))
        self.pos = param(rngs, "pos", (1, n_tokens, hidden), "normal", std=0.02, device=device)
        self.goal = Dense(2 * C.N_TASKS, hidden, **kw("goal"))
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block{i}", _Block(hidden, heads, **kw(f"block{i}")))
        self.LayerNorm_0 = LayerNorm(hidden, **kw("LayerNorm_0"))
        self.policy = Dense(hidden, n_actions, dtype=f32, **kw("policy"))
        self.value = Dense(hidden, 1, dtype=f32, **kw("value"))

    def forward(self, cells: torch.Tensor, goal_bits: torch.Tensor):
        x = self.embed(cells.to(bf16)) + self.pos.to(bf16)
        goal_tok = self.goal(goal_bits.to(bf16))
        x = torch.cat([goal_tok[:, None, :], x], dim=1)
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            # under autograd a block's activations are recomputed in the
            # backward: the same numbers, one block's activations held at a time
            x = checkpoint(block, x, use_reentrant=False) if torch.is_grad_enabled() else block(x)
        h = self.LayerNorm_0(x[:, 0, :])  # the goal token summarises the board
        return self.policy(h), self.value(h)[:, 0]


def grid_tokens(state: EnvState):
    """(cells u8[B, H*W, 12], goal_bits f32[B, 18]) for the ViT family."""
    B, H, W = state.objects.shape
    grid = render_onehot(state.objects, state.agent, state.holding)
    cells = grid.reshape(B, H * W, C.N_CHANNELS)
    goal_bits = torch.cat([state.desired.to(f32), state.achieved.to(f32)], dim=-1)
    return cells, goal_bits


def init_params(key, height: int = 21, width: int = 21, hidden: int = 128) -> GridActorCritic:
    """A ``GridActorCritic`` over ``height * width`` cell tokens, flax's init
    from JAX's key data ``key``, on its device. The module holds its
    parameters."""
    return GridActorCritic(height * width, hidden, key=key)
