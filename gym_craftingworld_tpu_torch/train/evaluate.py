"""Policy evaluation: success and per-skill completion metrics.

Counterpart of ``gym_craftingworld_tpu/train/evaluate.py``: batched greedy
evaluation of a learned policy (argmax actions, the first index on ties, one
episode per env slot) and host-side evaluation of the scripted expert.

The JAX package loops until every episode is done. Every episode ends by
``cfg.max_steps``, and a finished episode is frozen, so the port runs exactly
``max_steps`` steps: the same result, with no host sync per step.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.core.rollout import _select
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import step
from gym_craftingworld_tpu_torch.ops.keyed_draws import split_keys
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train.ppo import PPOConfig, make_policy, snapshot


@torch.no_grad()
def _eval_batch(cfg: EnvConfig, ppo: PPOConfig, params, state: EnvState) -> dict:
    """One greedy episode per env from ``state``; terminal stats as tensors."""
    _, apply_fn = make_policy(ppo)
    B = state.objects.shape[0]
    dev = state.objects.device
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    reward = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for _ in range(cfg.max_steps):
        logits, _ = apply_fn(params, snapshot(state))
        action = torch.argmax(logits, dim=-1).to(torch.int32)
        stepped, res = step(cfg, state, action)
        state = _select(done, state, stepped)  # freeze finished episodes
        reward = torch.where(done, reward, res.reward)
        done = done | res.done
    return {"success": reward == cfg.max_steps, "steps": state.step_num,
            "desired": state.desired, "achieved": state.achieved}


def evaluate_policy(cfg: EnvConfig, ppo: PPOConfig, params, num_episodes: int,
                    seed: int = 0) -> dict:
    """Greedy-policy evaluation over ``num_episodes`` parallel episodes, reset
    from ``split(PRNGKey(seed), num_episodes)`` on the parameters' device."""
    device = next(params.parameters()).device
    keys = split_keys(prng_key(seed), num_episodes, device=device)
    return summarize(_eval_batch(cfg, ppo, params, reset(cfg, keys)))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def summarize(out) -> dict:
    success = _host(out["success"])
    desired = _host(out["desired"]).astype(bool)
    achieved = _host(out["achieved"]).astype(bool)
    per_skill = {}
    for k, name in enumerate(C.TASK_LIST):
        sel = desired[:, k]
        per_skill[name] = float(achieved[sel, k].mean()) if sel.any() else None
    return {
        "success_rate": float(success.mean()),
        "mean_episode_steps": float(_host(out["steps"]).mean()),
        "episodes": int(success.shape[0]),
        "skill_completion": per_skill,
    }


class _HostView:
    """An env as the numpy expert reads it, made after a reset: every
    attribute the env's own, but its init grid (all the expert reads of
    ``_state``, with numpy) copied to the host once for the episode."""

    def __init__(self, env):
        self._env = env
        self._state = SimpleNamespace(init_objects=env.state.init_objects.cpu())

    def __getattr__(self, name):
        return getattr(self._env, name)


def evaluate_expert(num_episodes: int = 20, seed: int = 0, **env_kwargs) -> dict:
    """Host-side expert evaluation through the public API (``env_kwargs`` go
    to ``CraftingWorldEnvRay``, the card unless ``device="cpu"``)."""
    from gym_craftingworld_tpu_torch.agents.expert import ExpertPolicy
    from gym_craftingworld_tpu_torch.api import CraftingWorldEnvRay

    desired, achieved, success, steps = [], [], [], []
    for ep in range(num_episodes):
        env = CraftingWorldEnvRay(seed=seed + ep, **env_kwargs)
        env.reset()
        reward = ExpertPolicy(_HostView(env)).run_episode()
        desired.append(env.desired_goal_vector[0].copy())
        achieved.append(env.achieved_goal_vector[0].copy())
        success.append(reward == env.MAX_STEPS)
        steps.append(env.step_num)
    return summarize({"success": np.asarray(success), "steps": np.asarray(steps),
                      "desired": np.stack(desired), "achieved": np.stack(achieved)})
