"""Batched environment reset.

Counterpart of ``gym_craftingworld_tpu/core/reset.py``. It reproduces the
reference reset pipeline (``craftingworld_ray.py:156-218``) in two layers:

* ``reset_from_draws`` is a pure function of explicit random draws, with the
  semantics of the JAX ``_reset_one``: task sampling, world sampling, goal
  imagination. Fed the draws that the JAX reset takes from its keys, it gives
  the JAX state field for field (``tests/test_torch_reset.py``).
* ``reset`` and ``reset_from_seed`` draw those inputs with a
  ``torch.Generator`` on the target device. ``torch`` and ``jax.random`` give
  different numbers from one seed, so these resets agree with the JAX ones in
  distribution, not bit for bit.
* The fixed-init-state reset has the same two layers: ``generate_pool`` /
  ``generate_pool_from_scores`` make the pool, ``reset_from_pool`` /
  ``reset_from_pool_draws`` draw each env's world from it.

World placement is one stable descending sort of iid uniform scores per env:
iid scores rank the cells in a uniform permutation, so the first 9 cells in
score order are a uniform ordered 9-subset. Ties go to the lower cell index,
as they do in XLA's ``top_k`` (``torch.topk`` leaves their order open).
"""

from __future__ import annotations

import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.imagine import N_GOAL_SCORE_ROWS, imagine_goal
from gym_craftingworld_tpu_torch.core.state import EnvState


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
                      goal_scores) -> EnvState:
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
        rng=torch.zeros((B, 2), dtype=torch.int64, device=device),
    )


def _task_draws(cfg: EnvConfig, B: int, draw: dict):
    """(k, perm) for ``sample_desired``, drawn from ``draw``'s generator."""
    if cfg.stacking:
        k = torch.randint(0, cfg.number_of_tasks, (B,), **draw) + 1
    else:
        k = torch.ones((B,), dtype=torch.int64, device=draw["device"])
    perm = torch.argsort(torch.rand((B, len(cfg.selected_task_indices)), **draw), dim=1)
    return k, perm


def reset(cfg: EnvConfig, batch_size: int, generator: torch.Generator,
          device=None) -> EnvState:
    """Batched reset drawing every random choice from ``generator``.

    ``device`` defaults to the generator's device; the two must agree.
    """
    device = generator.device if device is None else torch.device(device)
    B, n = batch_size, cfg.n_cells
    draw = dict(generator=generator, device=device)
    k, perm = _task_draws(cfg, B, draw)
    world_scores = torch.rand((B, n), **draw)
    goal_scores = torch.rand((B, N_GOAL_SCORE_ROWS, n), **draw)
    return reset_from_draws(cfg, k, perm, world_scores, goal_scores)


def generate_pool_from_scores(cfg: EnvConfig, scores: torch.Tensor):
    """Pool worlds from placement scores float32[N, H*W] (one ``sample_world`` row each).

    Returns ``(objects int8[N, H, W], agent int32[N, 2])``.
    """
    objects, agent, _ = sample_world(cfg, scores)
    return objects, agent


def generate_pool(cfg: EnvConfig, generator: torch.Generator, num_states: int,
                  device=None):
    """Pre-generate ``num_states`` worlds (reference generate_fixed_states)."""
    device = generator.device if device is None else torch.device(device)
    scores = torch.rand((num_states, cfg.n_cells), generator=generator, device=device)
    return generate_pool_from_scores(cfg, scores)


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


def reset_from_pool(cfg: EnvConfig, batch_size: int, generator: torch.Generator,
                    pool_objects: torch.Tensor, pool_agent: torch.Tensor) -> EnvState:
    """Batched fixed-init-state reset: each env draws one pool entry uniformly.

    The draws come from ``generator``, on the pool's device.
    """
    device = pool_objects.device
    B = batch_size
    draw = dict(generator=generator, device=device)
    k, perm = _task_draws(cfg, B, draw)
    pick = torch.randint(0, pool_objects.shape[0], (B,), **draw)
    goal_scores = torch.rand((B, N_GOAL_SCORE_ROWS, cfg.n_cells), **draw)
    return reset_from_pool_draws(cfg, k, perm, pick, goal_scores, pool_objects, pool_agent)


def reset_from_seed(cfg: EnvConfig, seed: int, batch_size: int,
                    device="cpu") -> EnvState:
    """Convenience: seed a generator on ``device`` and reset ``batch_size`` envs."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return reset(cfg, batch_size, generator, device)
