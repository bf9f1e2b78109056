"""Batched CraftingWorld step on the grid layout.

Counterpart of ``gym_craftingworld_tpu/core/step.py``, with the same semantics
(see that module's docstring for the reference lines):

  * action decode + movement clamp
  * pickup / drop
  * movement blocking + crafting
  * incremental task evaluation
  * reward / done

Semantic traps kept:
  - task evaluation runs on *every* move action (even blocked / edge no-ops),
    but never on pickup/drop;
  - GoToHouse and Move{Sticks,Axe,Hammer} bits are recomputed (can un-latch),
    the other five latch;
  - a no-op step yields reward -1 even if goals are already met;
  - drop requires all 8 object channels empty while pickup only checks the 3
    pickupable channels;
  - MoveSticks exempts "initial tree cell whose tree was already chopped".

The JAX step reads and writes the grid with dense one-hot selects, a
workaround for an XLA:TPU scatter miscompile. Here the two touched cells are
read with ``gather`` and written with ``scatter`` on the flat ``[B, H*W]``
grid. The task evaluation (``_evaluate_tasks``) and the success test are
shared with the slot engines (``core/slots.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.state import EnvState

i32 = torch.int32


class StepResult(NamedTuple):
    reward: torch.Tensor  # int32[B]
    done: torch.Tensor  # bool[B]
    changed: torch.Tensor  # bool[B] — reference `changed_state`


def _success(cfg: EnvConfig, achieved, desired, dim: int = -1) -> torch.Tensor:
    if cfg.reward_equal:
        return (achieved == desired).all(dim=dim)
    return (desired <= achieved).all(dim=dim)


def compute_reward(cfg: EnvConfig, achieved: torch.Tensor,
                   desired: torch.Tensor) -> torch.Tensor:
    """Batched reward: MAX_STEPS on success else -1 (craftingworld_ray.py:757-767)."""
    return torch.where(_success(cfg, achieved, desired), cfg.max_steps, -1).to(i32)


def _decode(cfg: EnvConfig, action, agent_r, agent_c):
    """(is_move, new_r, new_c, moved_pos) of an action int[B] from the agent's cell."""
    dr = (action == C.ACTION_DOWN).to(i32) - (action == C.ACTION_UP).to(i32)
    dc = (action == C.ACTION_RIGHT).to(i32) - (action == C.ACTION_LEFT).to(i32)
    new_r = (agent_r + dr).clamp(0, cfg.height - 1)
    new_c = (agent_c + dc).clamp(0, cfg.width - 1)
    moved_pos = (new_r != agent_r) | (new_c != agent_c)
    return action < C.ACTION_PICKUP, new_r, new_c, moved_pos


def _interactions(action, is_move, moved_pos, obj_here, obj_there, holding):
    """(move_ok, can_pickup, can_drop) from the codes at the two cells."""
    # Rock blocks unless holding hammer; tree blocks unless holding axe
    # (craftingworld_ray.py:401-405).
    blocked = ((obj_there == C.ROCK) & (holding != C.HOLD_HAMMER)) | (
        (obj_there == C.TREE) & (holding != C.HOLD_AXE))
    move_ok = is_move & moved_pos & ~blocked
    can_pickup = ((action == C.ACTION_PICKUP) & (obj_here >= C.STICKS)
                  & (obj_here <= C.HAMMER) & (holding == C.HOLD_NONE))
    can_drop = ((action == C.ACTION_DROP) & (holding != C.HOLD_NONE)
                & (obj_here == C.EMPTY))
    return move_ok, can_pickup, can_drop


def _evaluate_tasks(a, is_move, move_ok, obj_there, holding, cell_final, icode):
    """Incremental task evaluation, move actions only (craftingworld_ray.py:646-703).

    ``a`` is the sequence of the 9 achieved rows (int32, one value per env);
    ``cell_final`` is the object code under the agent after the step and
    ``icode`` the reset-time code of that cell (AGENT_INIT_MARK included).
    Returns the 9 new rows.
    """
    # Latching bits (craftingworld_ray.py:657-665, 686-688, 695-697).
    eat = move_ok & (obj_there == C.BREAD)
    chop_rock = move_ok & (obj_there == C.ROCK)
    chop_tree = move_ok & (obj_there == C.TREE)
    make_bread = move_ok & (obj_there == C.WHEAT) & (holding == C.HOLD_AXE)
    build_house = move_ok & (obj_there == C.STICKS) & (holding == C.HOLD_HAMMER)
    a_ctree = a[C.T_CHOP_TREE] | chop_tree  # updated value feeds MoveSticks below

    # MoveSticks: un-achieved on the sticks origin, and on a chopped tree's
    # origin (craftingworld_ray.py:674-684). Any other original content
    # (including the agent's own start cell) counts as moved.
    init_empty = icode == C.EMPTY
    one = torch.ones_like(icode)
    ms = torch.where(init_empty, one, torch.where(
        icode == C.STICKS, 0, torch.where((icode == C.TREE) & (a_ctree == 1), 0, one)))
    ma = torch.where(init_empty, one, torch.where(icode == C.AXE, 0, one))
    mh = torch.where(init_empty, one, torch.where(icode == C.HAMMER, 0, one))

    hold_sticks = holding == C.HOLD_STICKS
    hold_axe = holding == C.HOLD_AXE
    hold_hammer = holding == C.HOLD_HAMMER
    upd = [None] * C.N_TASKS
    upd[C.T_MAKE_BREAD] = torch.where(hold_axe, a[C.T_MAKE_BREAD] | make_bread,
                                      a[C.T_MAKE_BREAD])
    upd[C.T_EAT_BREAD] = a[C.T_EAT_BREAD] | eat
    upd[C.T_BUILD_HOUSE] = torch.where(hold_hammer, a[C.T_BUILD_HOUSE] | build_house,
                                       a[C.T_BUILD_HOUSE])
    upd[C.T_CHOP_TREE] = a_ctree
    upd[C.T_CHOP_ROCK] = a[C.T_CHOP_ROCK] | chop_rock
    # non-latching, recomputed from the agent's (possibly unmoved) cell
    upd[C.T_GO_TO_HOUSE] = (cell_final == C.HOUSE).to(i32)
    upd[C.T_MOVE_AXE] = torch.where(hold_axe, ma, a[C.T_MOVE_AXE])
    upd[C.T_MOVE_HAMMER] = torch.where(hold_hammer, mh, a[C.T_MOVE_HAMMER])
    upd[C.T_MOVE_STICKS] = torch.where(hold_sticks, ms, a[C.T_MOVE_STICKS])
    return [torch.where(is_move, u, r) for u, r in zip(upd, a)]


def _reward_done(cfg: EnvConfig, changed, success, step_num):
    """(reward int32, done, new step_num) (craftingworld_ray.py:361-367)."""
    reward = torch.where(changed & success, cfg.max_steps, -1).to(i32)
    step_num = torch.clamp(step_num + 1, max=cfg.max_steps).to(i32)
    done = (step_num >= cfg.max_steps) | (reward == cfg.max_steps)
    return reward, done, step_num


def scan(step_fn, state, actions: torch.Tensor):
    """Step ``state`` through ``actions`` [T, B] with ``step_fn(state, action_t)``.

    Returns ``(state, StepResult)`` with the per-step outputs stacked ``[T, B]``.
    """
    T, B = actions.shape
    dev = actions.device
    reward = torch.empty((T, B), dtype=i32, device=dev)
    done = torch.empty((T, B), dtype=torch.bool, device=dev)
    changed = torch.empty((T, B), dtype=torch.bool, device=dev)
    for t in range(T):
        state, res = step_fn(state, actions[t])
        reward[t], done[t], changed[t] = res
    return state, StepResult(reward=reward, done=done, changed=changed)


def step(cfg: EnvConfig, state: EnvState, action: torch.Tensor):
    """Batched step: ``(state[B], action int[B]) -> (state[B], StepResult[B])``.

    The input state is not modified: the new state's grid is a new tensor.
    """
    B = state.objects.shape[0]
    H, W = cfg.height, cfg.width
    action = action.to(i32)
    agent_r, agent_c = state.agent[:, 0], state.agent[:, 1]
    holding = state.holding
    is_move, new_r, new_c, moved_pos = _decode(cfg, action, agent_r, agent_c)

    flat = state.objects.reshape(B, H * W)
    here = (agent_r * W + agent_c).long()[:, None]
    there = (new_r * W + new_c).long()[:, None]
    obj_here = flat.gather(1, here)[:, 0].to(i32)
    obj_there = flat.gather(1, there)[:, 0].to(i32)
    move_ok, can_pickup, can_drop = _interactions(
        action, is_move, moved_pos, obj_here, obj_there, holding)

    here_val = torch.where(can_pickup, C.EMPTY, torch.where(can_drop, holding, obj_here))
    new_holding = torch.where(
        can_pickup, obj_here, torch.where(can_drop, C.HOLD_NONE, holding)).to(i32)

    # crafting effects on the object now underfoot (craftingworld_ray.py:416-438)
    eff = obj_there
    eff = torch.where(obj_there == C.ROCK, C.EMPTY, eff)  # ChopRock
    eff = torch.where(obj_there == C.TREE, C.STICKS, eff)  # ChopTree → sticks
    eff = torch.where(obj_there == C.BREAD, C.EMPTY, eff)  # EatBread
    eff = torch.where((obj_there == C.STICKS) & (holding == C.HOLD_HAMMER),
                      C.HOUSE, eff)  # BuildHouse
    eff = torch.where((obj_there == C.WHEAT) & (holding == C.HOLD_AXE),
                      C.BREAD, eff)  # MakeBread

    # write back the (at most two) touched cells: the agent's cell, then the
    # move target (move_ok implies the two are distinct; otherwise the second
    # write repeats the first)
    at_new = torch.where(move_ok[:, None], there, here)
    objects = flat.clone()
    objects.scatter_(1, here, here_val.to(torch.int8)[:, None])
    objects.scatter_(1, at_new, torch.where(move_ok, eff, here_val).to(torch.int8)[:, None])

    cell_final = torch.where(move_ok, eff, obj_here)
    icode = state.init_objects.reshape(B, H * W).gather(1, at_new)[:, 0].to(i32)
    a = state.achieved.to(i32)
    rows = _evaluate_tasks(a.unbind(1), is_move, move_ok, obj_there, holding,
                           cell_final, icode)
    achieved = torch.stack(rows, dim=1).to(torch.int8)

    changed = move_ok | can_pickup | can_drop
    reward, done, step_num = _reward_done(
        cfg, changed, _success(cfg, achieved, state.desired), state.step_num)
    agent = torch.where(move_ok[:, None], torch.stack([new_r, new_c], dim=1), state.agent)
    new_state = EnvState(
        objects=objects.view(B, H, W),
        agent=agent.to(i32),
        holding=new_holding,
        desired=state.desired,
        achieved=achieved,
        init_objects=state.init_objects,
        init_agent=state.init_agent,
        goal_objects=state.goal_objects,
        goal_agent=state.goal_agent,
        step_num=step_num,
        rng=state.rng,
    )
    return new_state, StepResult(reward=reward, done=done, changed=changed)
