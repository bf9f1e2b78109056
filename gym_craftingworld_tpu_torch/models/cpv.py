"""Compositional plan-vector policy (CPV family).

Counterpart of ``gym_craftingworld_tpu/models/cpv.py``, the model family of
"Plan Arithmetic: Compositional Plan Vectors" (NeurIPS 2019), for which
CraftingWorld was published:

  * each of the 9 skills owns a learned embedding row ``E[i]``
    (``task_embed``, drawn from a standard normal, flax's ``normal(1.0)``);
  * the policy is conditioned on the residual plan vector
    ``plan = (desired - achieved) @ E``, an f32 product rounded to bf16
    before it joins the torso, so plan vectors compose additively by
    construction: ``plan({A, B}) = plan({A}) + plan({B})``.

``CPVPolicy`` reads the flat ``obs_features`` rows (with ``with_init``, the
``obs_features_init`` rows); ``CPVGridPolicy`` reads the (planes, extras) of
``models/grid_policy.py`` but takes the goal only through the plan vector.
"""

from __future__ import annotations

import torch
from torch import nn

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.models.actor_critic import feature_dim, feature_dim_init
from gym_craftingworld_tpu_torch.models.grid_policy import GridPolicy
from gym_craftingworld_tpu_torch.models.flax_rng import as_rngs, child
from gym_craftingworld_tpu_torch.models.layers import Dense, param

bf16 = torch.bfloat16
f32 = torch.float32


def _plan(E: torch.Tensor, desired: torch.Tensor, achieved: torch.Tensor) -> torch.Tensor:
    """Residual plan embedding: ``(desired - achieved).astype(f32) @ E``."""
    return (desired - achieved).to(f32) @ E


class CPVPolicy(nn.Module):
    """Actor-critic over [grid features, residual plan vector].

    obs [B, feature_dim] (with ``with_init``, [B, feature_dim_init]) ->
    (logits f32[B, 6], value f32[B]). Parameters under the flax names
    (``task_embed grid0 torso1 policy value``).
    """

    def __init__(self, height: int, width: int, embed_dim: int = 32, hidden: int = 256,
                 n_actions: int = C.N_ACTIONS, with_init: bool = False, key=None, device=None):
        super().__init__()
        self.height, self.width, self.with_init = height, width, with_init
        rngs = as_rngs(key)
        kw = lambda name: dict(key=child(rngs, name), device=device)
        grid_in = height * width * C.N_CHANNELS
        if with_init:
            grid_in += height * width * (C.N_OBJECTS + 1)
        # nn.initializers.normal(stddev=1.0), the module's own parameter
        self.task_embed = param(rngs, "task_embed", (C.N_TASKS, embed_dim), "normal",
                                device=device)
        self.grid0 = Dense(grid_in, hidden, **kw("grid0"))
        self.torso1 = Dense(hidden + embed_dim, hidden // 2, **kw("torso1"))
        self.policy = Dense(hidden // 2, n_actions, dtype=f32, **kw("policy"))
        self.value = Dense(hidden // 2, 1, dtype=f32, **kw("value"))

    def plan_vector(self, desired, achieved):
        return _plan(self.task_embed, desired, achieved)

    def forward(self, obs: torch.Tensor):
        grid_dim = self.height * self.width * C.N_CHANNELS
        want = (feature_dim_init(self.height, self.width) if self.with_init
                else feature_dim(self.height, self.width))
        if obs.shape[-1] != want:
            raise ValueError(
                f"obs width {obs.shape[-1]} != {want} for "
                f"CPVPolicy(with_init={self.with_init}, {self.height}x{self.width})")
        grid = obs[..., :grid_dim]
        desired = obs[..., grid_dim: grid_dim + C.N_TASKS]
        achieved = obs[..., grid_dim + C.N_TASKS: grid_dim + 2 * C.N_TASKS]
        if self.with_init:
            grid = torch.cat([grid, obs[..., grid_dim + 2 * C.N_TASKS:]], dim=-1)
        plan = self.plan_vector(desired, achieved)
        x = torch.relu(self.grid0(grid.to(bf16)))
        x = torch.relu(self.torso1(torch.cat([x, plan.to(bf16)], dim=-1)))
        return self.policy(x), self.value(x)[:, 0]


def init_cpv(key, height: int, width: int, embed_dim: int = 32, hidden: int = 256,
             with_init: bool = False) -> CPVPolicy:
    """A ``CPVPolicy``, flax's init from JAX's key data ``key``, on its device."""
    return CPVPolicy(height, width, embed_dim, hidden, with_init=with_init, key=key)


class CPVGridPolicy(GridPolicy):
    """CPV at canonical scale: conv torso, goal via residual plan vector ONLY.

    Consumes the (planes, extras) of ``models/grid_policy.py``, so the
    snapshot trainer (``train/dagger.py``) and the rollouts take it
    unchanged, but reads only the first 18 planes (current objects 8, agent
    1, init objects 8, init-agent mark 1) and, of the 33 extras, holding
    (``[:4]``) and the agent's row and column (``[-2:]``); the desired and
    achieved rows (``[4:13]``, ``[13:22]``) enter only through the plan
    vector. Parameters under the flax names (``task_embed conv0 conv1 conv2
    squeeze dense0 dense1 policy value``).
    """

    def __init__(self, height: int = 21, width: int = 21, channels: int = 64, hidden: int = 1024,
                 embed_dim: int = 32, n_actions: int = C.N_ACTIONS, key=None, device=None):
        rngs = as_rngs(key)
        super().__init__(height, width, channels, hidden, n_actions, in_planes=18,
                         n_extras=4 + 2 + embed_dim, key=rngs, device=device)
        self.task_embed = param(rngs, "task_embed", (C.N_TASKS, embed_dim), "normal",
                                device=device)

    def forward(self, planes: torch.Tensor, extras: torch.Tensor):
        hold = extras[..., :4].to(bf16)
        rc = extras[..., -2:].to(bf16)
        plan = _plan(self.task_embed, extras[..., 4:13], extras[..., 13:22])
        x = self.torso(planes[..., :18].to(bf16))  # objects + agent + init only
        return self.head(torch.cat([x, hold, rc, plan.to(bf16)], dim=-1))


def init_cpv_grid(key, cfg: EnvConfig, channels: int = 64, hidden: int = 1024,
                  embed_dim: int = 32) -> CPVGridPolicy:
    """A ``CPVGridPolicy`` for ``cfg``'s grid, flax's init from ``key``."""
    return CPVGridPolicy(cfg.height, cfg.width, channels, hidden, embed_dim, key=key)


@torch.no_grad()
def plan_of(model: nn.Module, desired, achieved) -> torch.Tensor:
    """The residual plan vector for given goal masks (plan arithmetic probe);
    the module holds its ``task_embed``."""
    E = model.task_embed
    as_t = lambda x: torch.as_tensor(x, device=E.device)
    return _plan(E, as_t(desired), as_t(achieved))
