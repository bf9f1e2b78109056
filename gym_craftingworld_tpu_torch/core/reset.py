"""Batched environment reset.

Counterpart of ``gym_craftingworld_tpu/core/reset.py``. It reproduces the
reference reset pipeline (``craftingworld_ray.py:156-218``) in two layers:

* ``reset_from_draws`` is a pure function of explicit random draws, with the
  semantics of the JAX ``_reset_one``: task sampling, world sampling, goal
  imagination. Fed the draws that the JAX reset takes from its keys, it gives
  the JAX state field for field (``tests/test_torch_reset.py``).
* ``reset(cfg, keys)``, ``reset_from_pool``, ``generate_pool`` and
  ``reset_from_seed`` take JAX's signatures: they make the draws that the
  JAX functions make with ``jax.random`` from the same key data, bit for
  bit (``ops/keyed_draws.py``: a kernel on the card, ``ops/threefry.py`` on
  the CPU), so they give the JAX package's states field for field,
  ``rng`` included (``tests/test_torch_keyed_reset.py``). Each reset stores
  the env's next key (``k_next`` of ``split(key, 4)``) in ``rng``, from
  which the env's auto-reset draws its next world.

World placement is one stable descending sort of iid uniform scores per env:
iid scores rank the cells in a uniform permutation, so the first 9 cells in
score order are a uniform ordered 9-subset. Ties go to the lower cell index,
as they do in XLA's ``top_k`` (``torch.topk`` leaves their order open).
"""

from __future__ import annotations

import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.imagine import imagine_goal
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.ops import keyed_draws
from gym_craftingworld_tpu_torch.ops.threefry import prng_key


def sample_desired(cfg: EnvConfig, k: torch.Tensor, perm: torch.Tensor):
    """Desired-goal bit vectors int8[B, 9] (craftingworld_ray.py:169-176).

    ``k`` int[B] is the number of tasks (1..number_of_tasks), ``perm``
    int[B, n_sel] a permutation of the selected tasks; the first ``k`` of the
    permuted selection are desired.
    """
    device = perm.device
    n_sel = len(cfg.selected_task_indices)
    sel_idx = torch.tensor(cfg.selected_task_indices, dtype=torch.int64, device=device)
    sel = sel_idx[perm.to(torch.int64)]  # [B, n_sel]
    chosen = torch.arange(n_sel, device=device)[None, :] < k.to(device)[:, None]
    tasks = torch.arange(C.N_TASKS, device=device)
    hit = (sel[:, None, :] == tasks[None, :, None]) & chosen[:, None, :]
    return hit.any(dim=2).to(torch.int8)


def ordered_cells(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` best cells of each row of ``scores``, best first (int64[B, k]).

    A stable descending sort: ties go to the lower cell index, as in XLA's
    ``top_k``.
    """
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def sample_world(cfg: EnvConfig, scores: torch.Tensor):
    """Place one of each object + the agent on distinct cells, from scores f32[B, H*W].

    Returns ``(objects int8[B,H,W], agent int32[B,2], init_objects int8[B,H,W])``.
    """
    B = scores.shape[0]
    idx = ordered_cells(scores, C.N_OBJECTS + 1)  # 9 distinct ordered cells
    codes = torch.arange(1, C.N_OBJECTS + 1, dtype=torch.int8, device=scores.device)
    flat = torch.zeros((B, cfg.n_cells), dtype=torch.int8, device=scores.device)
    flat.scatter_(1, idx[:, : C.N_OBJECTS], codes.expand(B, -1))
    agent_idx = idx[:, C.N_OBJECTS]
    init_flat = flat.clone()
    init_flat.scatter_(1, agent_idx[:, None], C.AGENT_INIT_MARK)
    agent = torch.stack([agent_idx // cfg.width, agent_idx % cfg.width], dim=1)
    shape = (B, cfg.height, cfg.width)
    return flat.view(shape), agent.to(torch.int32), init_flat.view(shape)


def reset_from_draws(
    cfg: EnvConfig,
    k: torch.Tensor,
    perm: torch.Tensor,
    world_scores: torch.Tensor,
    goal_scores: torch.Tensor,
) -> EnvState:
    """Batched reset as a pure function of its draws.

    Args:
      k: int[B], number of desired tasks (1 when ``cfg.stacking`` is False).
      perm: int[B, len(selected_task_indices)], a permutation per env.
      world_scores: float32[B, H*W], placement scores.
      goal_scores: float32[B, 7, H*W], goal-imagination scores
        (see ``core/imagine.py`` for the row order).
    """
    objects, agent, init_objects = sample_world(cfg, world_scores)
    return _state_from_world(cfg, sample_desired(cfg, k, perm), objects, agent,
                             init_objects, goal_scores)


def _state_from_world(cfg: EnvConfig, desired, objects, agent, init_objects,
                      goal_scores, rng=None) -> EnvState:
    """A fresh EnvState around a placed world: goal imagination and bookkeeping."""
    B = objects.shape[0]
    device = objects.device
    agent_idx = agent[:, 0] * cfg.width + agent[:, 1]
    goal_flat, goal_agent_idx = imagine_goal(
        goal_scores, objects.reshape(B, -1), agent_idx, desired
    )
    goal_agent = torch.stack(
        [goal_agent_idx // cfg.width, goal_agent_idx % cfg.width], dim=1
    ).to(torch.int32)
    return EnvState(
        objects=objects,
        agent=agent,
        holding=torch.zeros((B,), dtype=torch.int32, device=device),
        desired=desired,
        achieved=torch.zeros((B, C.N_TASKS), dtype=torch.int8, device=device),
        init_objects=init_objects,
        init_agent=agent.clone(),
        goal_objects=goal_flat.view(B, cfg.height, cfg.width),
        goal_agent=goal_agent,
        step_num=torch.zeros((B,), dtype=torch.int32, device=device),
        rng=torch.zeros((B, 2), dtype=torch.int64, device=device) if rng is None else rng,
    )


def reset(cfg: EnvConfig, keys: torch.Tensor) -> EnvState:
    """Batched reset from per-env key data int64[B, 2], on the keys' device.

    Env ``b`` is JAX ``_reset_one(keys[b])``; its ``rng`` holds ``k_next``.
    """
    d = keyed_draws.reset_draws(cfg, keys)
    objects, agent, init_objects = sample_world(cfg, d.world)
    return _state_from_world(cfg, sample_desired(cfg, d.k, d.perm), objects, agent,
                             init_objects, d.goal, d.k_next)


def generate_pool_from_scores(cfg: EnvConfig, scores: torch.Tensor):
    """Pool worlds from placement scores float32[N, H*W] (one ``sample_world`` row each).

    Returns ``(objects int8[N, H, W], agent int32[N, 2])``.
    """
    objects, agent, _ = sample_world(cfg, scores)
    return objects, agent


def generate_pool(cfg: EnvConfig, key: torch.Tensor, num_states: int, device=None):
    """Pre-generate ``num_states`` worlds (reference generate_fixed_states):
    world ``i`` is ``sample_world`` of key ``i`` of ``split(key, num_states)``,
    on ``device`` (the key's by default)."""
    keys = keyed_draws.split_keys(key, num_states, device=device)
    return generate_pool_from_scores(cfg, keyed_draws.reset_draws(cfg, keys, "world").world)


def reset_from_pool_draws(cfg: EnvConfig, k: torch.Tensor, perm: torch.Tensor,
                          pick: torch.Tensor, goal_scores: torch.Tensor,
                          pool_objects: torch.Tensor, pool_agent: torch.Tensor) -> EnvState:
    """Fixed-init-state reset as a pure function of its draws.

    The reference ``fixed_init_state`` path (craftingworld_ray.py:116-118,
    630-644): task sampling as in ``reset_from_draws``, then env ``b`` takes
    pool world ``pick[b]`` (int[B]) in place of a fresh placement; goal
    imagination from ``goal_scores`` float32[B, 7, H*W].
    """
    pick = pick.to(torch.int64)
    objects = pool_objects[pick]
    agent = pool_agent[pick]
    # Pool worlds come from sample_world: the agent's cell holds no object.
    agent_idx = (agent[:, 0] * cfg.width + agent[:, 1]).to(torch.int64)
    init_objects = objects.reshape(objects.shape[0], -1).clone()
    init_objects.scatter_(1, agent_idx[:, None], C.AGENT_INIT_MARK)
    return _state_from_world(cfg, sample_desired(cfg, k, perm), objects, agent,
                             init_objects.view(objects.shape), goal_scores)


def reset_from_pool(cfg: EnvConfig, keys: torch.Tensor, pool_objects: torch.Tensor,
                    pool_agent: torch.Tensor) -> EnvState:
    """Batched fixed-init-state reset: each env draws one pool entry uniformly,
    from its key (JAX ``_reset_one_from_pool``); ``rng`` holds ``k_next``."""
    d = keyed_draws.reset_draws(cfg, keys, "pool", pool_objects.shape[0])
    st = reset_from_pool_draws(cfg, d.k, d.perm, d.pick, d.goal, pool_objects, pool_agent)
    st.rng = d.k_next
    return st


def reset_from_seed(cfg: EnvConfig, seed: int, batch_size: int, device="cuda") -> EnvState:
    """Convenience: derive B per-env keys from one integer seed
    (``split(PRNGKey(seed), B)``) and reset, on ``device`` (the card unless
    asked for the CPU)."""
    return reset(cfg, keyed_draws.split_keys(prng_key(seed), batch_size, device=device))
