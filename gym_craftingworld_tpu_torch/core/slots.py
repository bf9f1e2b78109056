"""Entity-slot state layout.

Counterpart of ``gym_craftingworld_tpu/core/slots.py``. A CraftingWorld world
never holds more than 8 objects (one of each is placed at reset and every
crafting rule converts or removes in place — nothing ever *adds* an object),
so the whole world state compresses to 8 entity slots per env:

  slot_type int32[B, 8]    current object code (1..8; may change: tree→sticks…)
  slot_pos  int32[B, 8, 2] cell of the slot
  slot_stat int32[B, 8]    0 = on grid, 1 = held by agent, 2 = removed

Every step is a handful of ``[B, 8]`` comparisons and selects, with the
semantics of the grid step (``core/step.py``, whose task evaluation it
shares). ``_step_fields`` writes that step once for both slot layouts: the
slot axis last (``step_slots``) or first (``ops/transposed_rollout.py``).

Invariant relied on (and preserved): at most one live object per cell — drops
require an empty cell, crafting converts in place (craftingworld_ray.py:329-341,
416-438).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.ops.keyed_draws import randint_cols
from gym_craftingworld_tpu_torch.core.step import (
    StepResult,
    _decode,
    _evaluate_tasks,
    _interactions,
    _reward_done,
    _success,
    scan,
)

i32 = torch.int32

ON_GRID = 0
HELD = 1
REMOVED = 2


class SlotState(NamedTuple):
    """Batched entity-slot environment state."""

    slot_type: torch.Tensor  # int32[B, 8]
    slot_pos: torch.Tensor  # int32[B, 8, 2]
    slot_stat: torch.Tensor  # int32[B, 8]
    agent: torch.Tensor  # int32[B, 2]
    desired: torch.Tensor  # int8[B, 9]
    achieved: torch.Tensor  # int8[B, 9]
    init_type: torch.Tensor  # int32[B, 8] — slot types at reset
    init_pos: torch.Tensor  # int32[B, 8, 2] — slot cells at reset
    init_agent: torch.Tensor  # int32[B, 2]
    step_num: torch.Tensor  # int32[B]
    rng: torch.Tensor  # int64[B, 2], per-env key data (see core/state.py)


def _find_codes(flat: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """First cell index of each code per env, -1 where absent: int64[B, len(codes)]."""
    m = flat[:, None, :] == codes[None, :, None]  # [B, 8, H*W]
    idx = torch.argmax(m.to(torch.int8), dim=2)  # argmax takes no bool
    return torch.where(m.any(dim=2), idx, -1)


def from_env_state(state: EnvState) -> SlotState:
    """Grid state → slot state. Requires the standard one-of-each world where
    ``init_objects`` records each object's reset cell (which reset() produces);
    live slots are located by their init type, so the conversion supports
    states straight out of reset, the only entry path used."""
    B, H, W = state.objects.shape
    device = state.objects.device
    codes = torch.arange(1, C.N_OBJECTS + 1, dtype=torch.int8, device=device)
    init_type = codes.to(torch.int32).expand(B, -1).contiguous()

    init_idx = _find_codes(state.init_objects.reshape(B, -1), codes)
    init_pos = torch.stack([init_idx // W, init_idx % W], dim=-1).to(torch.int32)

    live_idx = _find_codes(state.objects.reshape(B, -1), codes)
    held_mask = init_type == state.holding[:, None]
    on_grid = live_idx >= 0
    stat = torch.where(
        on_grid, ON_GRID, torch.where(held_mask, HELD, REMOVED)
    ).to(torch.int32)
    live = live_idx.clamp(min=0)
    pos = torch.stack([live // W, live % W], dim=-1).to(torch.int32)
    pos = torch.where(on_grid[..., None], pos, state.agent[:, None, :])
    return SlotState(
        slot_type=init_type.clone(),
        slot_pos=pos,
        slot_stat=stat,
        agent=state.agent,
        desired=state.desired,
        achieved=state.achieved,
        init_type=init_type,
        init_pos=init_pos,
        init_agent=state.init_agent,
        step_num=state.step_num,
        rng=state.rng,
    )


def holding_of(slots: SlotState) -> torch.Tensor:
    """Held object code per env (0 = none). At most one slot is ever HELD."""
    held = slots.slot_stat == HELD
    return (held * slots.slot_type).sum(dim=1).to(torch.int32)


def to_grid(slots: SlotState, cfg: EnvConfig):
    """Slot state → (objects int8[B,H,W], agent, holding) for obs/render."""
    B = slots.slot_type.shape[0]
    H, W = cfg.height, cfg.width
    on = slots.slot_stat == ON_GRID
    lin = slots.slot_pos[..., 0] * W + slots.slot_pos[..., 1]
    code = torch.where(on, slots.slot_type, 0).to(torch.int8)
    # dead slots park in one extra column past the grid, dropped afterwards
    lin = torch.where(on, lin, H * W).to(torch.int64)
    flat = torch.zeros((B, H * W + 1), dtype=torch.int8, device=code.device)
    flat.scatter_(1, lin, code)
    objects = flat[:, : H * W].reshape(B, H, W)
    return objects, slots.agent, holding_of(slots)


def _step_fields(cfg: EnvConfig, s: dict, action: torch.Tensor, dim: int):
    """One batched slot step on the fields of ``TSlotState`` (its names).

    Slot tensors (``slot_*``, ``init_type``, ``init_pos_*``) and the task
    tensors (``desired``, ``achieved``) carry their slot or task axis at
    ``dim`` (1: ``[B, 8]``, 0: ``[8, B]``); the per-env fields are ``[B]``.
    Returns ``(dict of the 8 fields a step changes, StepResult)``; ``achieved``
    keeps its dtype.
    """
    e = lambda x: x.unsqueeze(dim)  # per-env [B] against the slot axis
    action = action.to(i32)
    agent_r, agent_c = s["agent_r"], s["agent_c"]
    is_move, new_r, new_c, moved_pos = _decode(cfg, action, agent_r, agent_c)

    t, stat = s["slot_type"], s["slot_stat"]
    pos_r, pos_c = s["slot_pos_r"], s["slot_pos_c"]
    on = stat == ON_GRID
    held = stat == HELD
    # torch sums integers to int64 unless told otherwise
    holding = (held * t).sum(dim, dtype=i32)
    at_here = on & (pos_r == e(agent_r)) & (pos_c == e(agent_c))
    at_there = on & (pos_r == e(new_r)) & (pos_c == e(new_c))
    obj_here = (at_here * t).sum(dim, dtype=i32)
    obj_there = (at_there * t).sum(dim, dtype=i32)
    move_ok, can_pickup, can_drop = _interactions(
        action, is_move, moved_pos, obj_here, obj_there, holding)

    # crafting effect on the slot under the move target (craftingworld_ray.py:416-438)
    eff = torch.where(t == C.TREE, C.STICKS, t)
    eff = torch.where((t == C.STICKS) & e(holding == C.HOLD_HAMMER), C.HOUSE, eff)
    eff = torch.where((t == C.WHEAT) & e(holding == C.HOLD_AXE), C.BREAD, eff)
    removed = (t == C.ROCK) | (t == C.BREAD)

    hit = at_there & e(move_ok)
    slot_stat = torch.where(hit & removed, REMOVED, stat)
    # pickup / drop transitions
    slot_stat = torch.where(e(can_pickup) & at_here, HELD, slot_stat)
    dropping = e(can_drop) & held
    slot_stat = torch.where(dropping, ON_GRID, slot_stat)
    agent_r2 = torch.where(move_ok, new_r, agent_r)
    agent_c2 = torch.where(move_ok, new_c, agent_c)

    # post-effect object at the agent's (possibly unmoved) cell
    eff_there = (hit * torch.where(removed, 0, eff)).sum(dim, dtype=i32)
    cell_final = torch.where(move_ok, eff_there, obj_here)
    # initial contents of the agent's final cell: an init slot, else the
    # agent-start mark, else empty
    at_init = (s["init_pos_r"] == e(agent_r2)) & (s["init_pos_c"] == e(agent_c2))
    icode = (at_init * s["init_type"]).sum(dim, dtype=i32)
    at_start = (s["init_agent_r"] == agent_r2) & (s["init_agent_c"] == agent_c2)
    icode = torch.where((icode == 0) & at_start, C.AGENT_INIT_MARK, icode)
    rows = _evaluate_tasks(s["achieved"].to(i32).unbind(dim), is_move, move_ok,
                           obj_there, holding, cell_final, icode)
    achieved = torch.stack(rows, dim=dim).to(s["achieved"].dtype)

    changed = move_ok | can_pickup | can_drop
    reward, done, step_num = _reward_done(
        cfg, changed, _success(cfg, achieved, s["desired"], dim), s["step_num"])
    new = dict(
        slot_type=torch.where(hit, eff, t),
        slot_pos_r=torch.where(dropping, e(agent_r), pos_r),
        slot_pos_c=torch.where(dropping, e(agent_c), pos_c),
        slot_stat=slot_stat,
        agent_r=agent_r2,
        agent_c=agent_c2,
        achieved=achieved,
        step_num=step_num,
    )
    return new, StepResult(reward=reward, done=done, changed=changed)


def step_slots(cfg: EnvConfig, slots: SlotState, action: torch.Tensor):
    """Batched slot-layout step: ``(SlotState[B], action int[B]) -> (SlotState, StepResult)``.

    The input state is not modified.
    """
    fields = dict(
        slot_type=slots.slot_type,
        slot_pos_r=slots.slot_pos[..., 0],
        slot_pos_c=slots.slot_pos[..., 1],
        slot_stat=slots.slot_stat,
        agent_r=slots.agent[:, 0],
        agent_c=slots.agent[:, 1],
        desired=slots.desired,
        achieved=slots.achieved,
        init_type=slots.init_type,
        init_pos_r=slots.init_pos[..., 0],
        init_pos_c=slots.init_pos[..., 1],
        init_agent_r=slots.init_agent[:, 0],
        init_agent_c=slots.init_agent[:, 1],
        step_num=slots.step_num,
    )
    new, res = _step_fields(cfg, fields, action, dim=1)
    return slots._replace(
        slot_type=new["slot_type"],
        slot_pos=torch.stack([new["slot_pos_r"], new["slot_pos_c"]], dim=-1),
        slot_stat=new["slot_stat"],
        agent=torch.stack([new["agent_r"], new["agent_c"]], dim=-1),
        achieved=new["achieved"],
        step_num=new["step_num"],
    ), res


def random_actions(slots, key: torch.Tensor, num_steps: int, dtype=i32) -> torch.Tensor:
    """The random rollouts' actions on the slots' device: ``jax.random.randint(
    key, (T, B), 0, 6, dtype)`` from key data ``key`` int64[2], one launch of
    the counter kernel on the card."""
    B = slots.agent.shape[0]
    return randint_cols(key, (num_steps, B), 0, C.N_ACTIONS, device=slots.agent.device,
                        dtype=dtype)


def rollout_slots_random(cfg: EnvConfig, slots: SlotState, key: torch.Tensor, num_steps: int):
    """T steps of uniform-random actions over the slot layout.

    Returns ``(SlotState, StepResult)`` with ``[T, B]`` fields; the actions
    are ``random_actions`` of ``key``, int32 ``[T, B]``, as the JAX package
    draws them.
    """
    actions = random_actions(slots, key, num_steps)
    return scan(lambda s, a: step_slots(cfg, s, a), slots, actions)
