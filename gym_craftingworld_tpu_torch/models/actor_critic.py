"""Flagship policy network: goal-conditioned actor-critic.

Counterpart of ``gym_craftingworld_tpu/models/actor_critic.py``: the policy
consumes the flat one-hot grid with the desired and achieved goal bits
(``obs_features``; with the init-grid one-hot, ``obs_features_init``) through
a bf16 MLP torso and f32 heads (``ActorCritic``). The vector env's
``features`` observation mode uses the same features.
"""

from __future__ import annotations

import torch
from torch import nn

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.models.flax_rng import as_rngs, child
from gym_craftingworld_tpu_torch.models.layers import Dense
from gym_craftingworld_tpu_torch.render.raster import render_onehot

f32 = torch.float32


class ActorCritic(nn.Module):
    """Shared-torso MLP actor-critic (bf16 compute, f32 params and heads).

    obs [B, in_features] -> (logits f32[B, 6], value f32[B]). Parameters
    under the flax names (``torso0 torso1 policy value``, each ``kernel``
    [in, out] and ``bias``).
    """

    def __init__(self, in_features: int, hidden: int = 512, n_actions: int = C.N_ACTIONS,
                 key=None, device=None):
        super().__init__()
        rngs = as_rngs(key)
        self.torso0 = Dense(in_features, hidden, key=child(rngs, "torso0"), device=device)
        self.torso1 = Dense(hidden, hidden // 2, key=child(rngs, "torso1"), device=device)
        self.policy = Dense(hidden // 2, n_actions, dtype=f32, key=child(rngs, "policy"),
                            device=device)
        self.value = Dense(hidden // 2, 1, dtype=f32, key=child(rngs, "value"), device=device)

    def forward(self, obs: torch.Tensor):
        x = torch.relu(self.torso0(obs))
        x = torch.relu(self.torso1(x))
        return self.policy(x), self.value(x)[:, 0]


def obs_features(state: EnvState) -> torch.Tensor:
    """Policy features: flat one-hot grid + desired + achieved bits, f32[B, D]."""
    B = state.objects.shape[0]
    grid = render_onehot(state.objects, state.agent, state.holding)
    return torch.cat(
        [grid.reshape(B, -1).to(f32), state.desired.to(f32), state.achieved.to(f32)],
        dim=-1,
    )


def feature_dim(height: int, width: int) -> int:
    return height * width * C.N_CHANNELS + 2 * C.N_TASKS


def obs_features_init(state: EnvState) -> torch.Tensor:
    """:func:`obs_features` ++ the flattened init-grid one-hot (9 channels:
    8 objects + the agent's reset cell).

    The Move*/GoToHouse evaluation compares the live grid against
    INIT_OBS_VECTOR (craftingworld_ray.py:670-702): stepping on an item's
    *origin* cell while carrying it clears its Move* bit — but origin cells
    are empty in the current grid, so a policy without the init view cannot
    route around them (the reference carries ``init_observation`` in its
    observation dict for exactly this reason, :183-187).
    """
    B = state.objects.shape[0]
    init = state.init_objects.to(torch.int32)
    # channels 0-7: object origins; channel 8: agent reset cell (code 9);
    # code 0 gives a zero row, as jax.nn.one_hot(init - 1, 9) does
    codes = torch.arange(1, C.N_OBJECTS + 2, dtype=torch.int32, device=init.device)
    init_oh = (init[..., None] == codes).to(f32)
    return torch.cat([obs_features(state), init_oh.reshape(B, -1)], dim=-1)


def feature_dim_init(height: int, width: int) -> int:
    return feature_dim(height, width) + height * width * (C.N_OBJECTS + 1)


def init_params(key, height: int = 21, width: int = 21, hidden: int = 512) -> ActorCritic:
    """An ``ActorCritic`` over ``feature_dim(height, width)`` features, its
    weights flax's ``model.init(key, ...)`` from JAX's key data ``key``
    int64[2], on the key's device. The module holds its parameters."""
    return ActorCritic(feature_dim(height, width), hidden, key=key)
