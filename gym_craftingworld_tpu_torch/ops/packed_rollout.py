"""Packed-key slot layout: the minimum-op stepping engine, in plain torch.

Counterpart of ``gym_craftingworld_tpu/ops/packed_rollout.py``; see that
module's docstring for the derivation from the reference semantics. In brief:

* each slot's (status, row, col) packs into ONE int16 key::

      key = row * W + col        while the object sits on the grid
      key = H*W                  while held by the agent
      key = H*W + 1              once removed from the world

  so one ``==`` against the agent's cell key tests "on grid AND here";
* the object code and reset-cell code at the agent's cell are carried as
  scalars (``obj_here``/``icode_here``); only the destination cell needs a
  slot reduction;
* ``achieved``/``desired`` are 9-bit masks, so task evaluation and the reward
  compare are scalar bit algebra.

These steps are the plain versions that the CUDA kernels of
``ops/packed_fused.py`` are held against. Every value fits int16 (keys <
H*W+2, codes < 16, masks 9 bits, and the step counter saturates at
``max_steps``), so the step gives the same bits in int16 and int32 at any
rollout length. torch promotes integer sums to int64, so every reduction here
names the state's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.slots import HELD, ON_GRID, REMOVED, SlotState, random_actions
from gym_craftingworld_tpu_torch.core.step import StepResult, scan
from gym_craftingworld_tpu_torch.ops.transposed_rollout import (
    TSlotState,
    transpose_in,
    transpose_out,
)

i16 = torch.int16


class PackedState(NamedTuple):
    """Transposed packed state: slot tensors int16[8, B], scalars int16[B]."""

    slot_key: torch.Tensor  # int16[8, B] — r*W+c | H*W (held) | H*W+1 (removed)
    slot_type: torch.Tensor  # int16[8, B]
    init_key: torch.Tensor  # int16[8, B] — reset cell of each slot (always on-grid)
    init_type: torch.Tensor  # int16[8, B]
    agent_r: torch.Tensor  # int16[B]
    agent_c: torch.Tensor  # int16[B]
    holding: torch.Tensor  # int16[B] — 0 none, 1..3 = sticks/axe/hammer
    obj_here: torch.Tensor  # int16[B] — object code at the agent's cell
    icode_here: torch.Tensor  # int16[B] — reset-cell code at the agent's cell
    achieved: torch.Tensor  # int16[B] — 9-bit task mask
    desired: torch.Tensor  # int16[B] — 9-bit task mask
    init_agent_key: torch.Tensor  # int16[B]
    step_num: torch.Tensor  # int16[B]


def _bits(device, dtype):
    return torch.arange(C.N_TASKS, dtype=dtype, device=device)[:, None]


def pack(cfg: EnvConfig, ts: TSlotState) -> PackedState:
    if cfg.height * cfg.width + 1 > 32767:  # pragma: no cover
        raise ValueError("grid too large for the int16 packed engine")
    W = cfg.width
    held_key = cfg.height * W
    key = torch.where(
        ts.slot_stat == ON_GRID,
        ts.slot_pos_r * W + ts.slot_pos_c,
        torch.where(ts.slot_stat == HELD, held_key, held_key + 1),
    ).to(i16)
    held = ts.slot_stat == HELD
    holding = (held * ts.slot_type).sum(dim=0, dtype=i16)
    init_key = (ts.init_pos_r * W + ts.init_pos_c).to(i16)
    cur_key = (ts.agent_r * W + ts.agent_c).to(i16)
    obj_here = ((key == cur_key) * ts.slot_type).sum(dim=0, dtype=i16)
    icode_here = ((init_key == cur_key) * ts.init_type).sum(dim=0, dtype=i16)
    bits = _bits(ts.agent_r.device, i16)
    to_mask = lambda v: (v.to(i16) << bits).sum(dim=0, dtype=i16)
    c16 = lambda x: x.to(i16)
    return PackedState(
        slot_key=key,
        slot_type=c16(ts.slot_type),
        init_key=init_key,
        init_type=c16(ts.init_type),
        agent_r=c16(ts.agent_r),
        agent_c=c16(ts.agent_c),
        holding=holding,
        obj_here=obj_here,
        icode_here=icode_here,
        achieved=to_mask(ts.achieved),
        desired=to_mask(ts.desired),
        init_agent_key=(ts.init_agent_r * W + ts.init_agent_c).to(i16),
        step_num=c16(ts.step_num),
    )


def unpack(cfg: EnvConfig, p: PackedState, desired_rows, init_rows) -> TSlotState:
    """Packed → transposed slot state.

    ``desired_rows``/``init_rows`` carry the original [9, B] desired rows and
    (init_pos_r, init_pos_c, init_type, init_agent_r, init_agent_c) — they are
    invariant through a rollout, so the caller passes them through.
    """
    W = cfg.width
    held_key = cfg.height * W
    key = p.slot_key.to(torch.int32)
    on = key < held_key
    held = key == held_key
    stat = torch.where(on, ON_GRID, torch.where(held, HELD, REMOVED)).to(torch.int32)
    pos_r = torch.where(on, key // W, 0)
    pos_c = torch.where(on, key % W, 0)
    ach = p.achieved.to(torch.int32)
    achieved_rows = (ach[None, :] >> _bits(ach.device, torch.int32)) & 1
    init_pos_r, init_pos_c, init_type, init_agent_r, init_agent_c = init_rows
    return TSlotState(
        slot_type=p.slot_type.to(torch.int32),
        slot_pos_r=pos_r,
        slot_pos_c=pos_c,
        slot_stat=stat,
        agent_r=p.agent_r.to(torch.int32),
        agent_c=p.agent_c.to(torch.int32),
        desired=desired_rows,
        achieved=achieved_rows,
        init_type=init_type,
        init_pos_r=init_pos_r,
        init_pos_c=init_pos_c,
        init_agent_r=init_agent_r,
        init_agent_c=init_agent_c,
        step_num=p.step_num.to(torch.int32),
    )


def _init_rows(ts: TSlotState):
    return (ts.init_pos_r, ts.init_pos_c, ts.init_type,
            ts.init_agent_r, ts.init_agent_c)


def _step_p(cfg: EnvConfig, s: PackedState, action: torch.Tensor, dtype=i16):
    """One batched step; ``action`` int[B]. ``s`` holds ``dtype`` tensors.

    Python-int operands never widen a tensor's dtype in torch, and every
    ``where`` below has a tensor branch of the state's dtype, so the state
    keeps ``dtype`` through the step.
    """
    dt = dtype
    b = lambda m: m.to(dt)
    W = cfg.width
    held_key = cfg.height * cfg.width

    dr = b(action == C.ACTION_DOWN) - b(action == C.ACTION_UP)
    dc = b(action == C.ACTION_RIGHT) - b(action == C.ACTION_LEFT)
    is_move = action < C.ACTION_PICKUP  # [B]

    new_r = torch.clamp(s.agent_r + dr, 0, cfg.height - 1)
    new_c = torch.clamp(s.agent_c + dc, 0, cfg.width - 1)
    moved_pos = (new_r != s.agent_r) | (new_c != s.agent_c)

    cur_key = s.agent_r * W + s.agent_c  # [B]
    new_key = new_r * W + new_c  # [B]

    # ---- the one slot reduction: codes at the destination cell --------------
    at_here = s.slot_key == cur_key  # [8, B] — needed for the pickup update
    at_there = s.slot_key == new_key
    at_init_there = b(s.init_key == new_key)
    v = b(at_there) * s.slot_type + (at_init_there * s.init_type << 4)
    codes = v.sum(dim=0, dtype=dt)
    obj_here = s.obj_here
    obj_there = codes & 15
    icode_there = (codes >> 4) & 15

    holding = s.holding
    blocked = ((obj_there == C.ROCK) & (holding != C.HOLD_HAMMER)) | (
        (obj_there == C.TREE) & (holding != C.HOLD_AXE)
    )
    move_ok = is_move & moved_pos & ~blocked

    can_pickup = (
        (action == C.ACTION_PICKUP)
        & (obj_here >= C.STICKS)
        & (obj_here <= C.HAMMER)
        & (holding == C.HOLD_NONE)
    )
    can_drop = (
        (action == C.ACTION_DROP)
        & (holding != C.HOLD_NONE)
        & (obj_here == C.EMPTY)
    )

    # ---- crafting effects on the scalar code (craftingworld_ray.py:416-438) --
    eff = obj_there
    eff = torch.where(obj_there == C.TREE, C.STICKS, eff)
    eff = torch.where((obj_there == C.STICKS) & (holding == C.HOLD_HAMMER),
                      C.HOUSE, eff)
    eff = torch.where((obj_there == C.WHEAT) & (holding == C.HOLD_AXE),
                      C.BREAD, eff)
    removed = (obj_there == C.ROCK) | (obj_there == C.BREAD)

    # ---- slot updates (each a single predicated select over [8, B]) ---------
    hit = at_there & move_ok
    slot_type = torch.where(hit, eff, s.slot_type)
    slot_key = torch.where(hit & removed, held_key + 1, s.slot_key)
    slot_key = torch.where(can_pickup & at_here, held_key, slot_key)
    dropping = can_drop & (s.slot_key == held_key)
    slot_key = torch.where(dropping, cur_key, slot_key)

    agent_r = torch.where(move_ok, new_r, s.agent_r)
    agent_c = torch.where(move_ok, new_c, s.agent_c)
    new_holding = torch.where(can_pickup, obj_here,
                              torch.where(can_drop, C.HOLD_NONE, holding))

    # ---- task evaluation as bit algebra (craftingworld_ray.py:646-703) ------
    a = s.achieved
    eat = move_ok & (obj_there == C.BREAD)
    chop_rock = move_ok & (obj_there == C.ROCK)
    chop_tree = move_ok & (obj_there == C.TREE)
    make_bread = move_ok & (obj_there == C.WHEAT) & (holding == C.HOLD_AXE)
    build_house = move_ok & (obj_there == C.STICKS) & (holding == C.HOLD_HAMMER)

    latched = a | (
        (b(make_bread) << C.T_MAKE_BREAD)
        | (b(eat) << C.T_EAT_BREAD)
        | (b(build_house) << C.T_BUILD_HOUSE)
        | (b(chop_tree) << C.T_CHOP_TREE)
        | (b(chop_rock) << C.T_CHOP_ROCK)
    )

    # GoToHouse: recomputed from the cell the agent ends the move on
    cell_final = torch.where(move_ok, torch.where(removed, 0, eff), obj_here)
    house = cell_final == C.HOUSE

    # Move{Axe,Hammer,Sticks}: carried item away from its reset cell
    icode = torch.where(move_ok, icode_there, s.icode_here)
    final_key = torch.where(move_ok, new_key, cur_key)
    marked = torch.where((icode == 0) & (final_key == s.init_agent_key),
                         C.AGENT_INIT_MARK, icode)
    a_ctree = ((latched >> C.T_CHOP_TREE) & 1) == 1
    init_empty = marked == C.EMPTY
    ms = init_empty | ~((marked == C.STICKS) | ((marked == C.TREE) & a_ctree))
    ma = init_empty | (marked != C.AXE)
    mh = init_empty | (marked != C.HAMMER)

    hold_sticks = holding == C.HOLD_STICKS
    hold_axe = holding == C.HOLD_AXE
    hold_hammer = holding == C.HOLD_HAMMER

    clear = (
        (1 << C.T_GO_TO_HOUSE)
        | (b(hold_axe) << C.T_MOVE_AXE)
        | (b(hold_hammer) << C.T_MOVE_HAMMER)
        | (b(hold_sticks) << C.T_MOVE_STICKS)
    )
    setb = (
        (b(house) << C.T_GO_TO_HOUSE)
        | (b(hold_axe & ma) << C.T_MOVE_AXE)
        | (b(hold_hammer & mh) << C.T_MOVE_HAMMER)
        | (b(hold_sticks & ms) << C.T_MOVE_STICKS)
    )
    upd = (latched & ~clear) | setb
    achieved = torch.where(is_move, upd, a)

    # carried here-codes: the agent's new cell is the move destination, or the
    # same cell with the object removed (pickup) / re-placed (drop)
    new_obj_here = torch.where(
        move_ok, cell_final,
        torch.where(can_pickup, 0, torch.where(can_drop, holding, obj_here)))
    new_icode_here = torch.where(move_ok, icode_there, s.icode_here)

    return _finish(cfg, s, dict(
        slot_key=slot_key,
        slot_type=slot_type,
        agent_r=agent_r,
        agent_c=agent_c,
        holding=new_holding,
        obj_here=new_obj_here,
        icode_here=new_icode_here,
        achieved=achieved,
    ), move_ok | can_pickup | can_drop)


def _finish(cfg: EnvConfig, s: PackedState, new: dict, changed):
    """Reward, done and the saturating step counter, shared by both steps."""
    achieved = new["achieved"]
    if cfg.reward_equal:
        success = achieved == s.desired
    else:
        success = (s.desired & ~achieved) == 0
    reward = torch.where(changed & success, cfg.max_steps, -1).to(torch.int32)
    # saturate at max_steps: done only needs the threshold, episodes always
    # reset at done, and saturation keeps arbitrarily long no-reset bench
    # rollouts safe in int16 (no wrap past 32767)
    step_num = torch.clamp(s.step_num + 1, max=cfg.max_steps)
    done = (step_num >= cfg.max_steps) | (reward == cfg.max_steps)
    return (s._replace(step_num=step_num, **new),
            StepResult(reward=reward, done=done, changed=changed))


# --------------------------------------------------------------------------
# Slot-unrolled step: same algebra with the slot axis unrolled and each
# slot's statically-known transition structure applied. Slot k starts as
# object code k+1 and the effect table only ever transforms tree→sticks,
# sticks→house, wheat→bread and removes rock/bread, hence:
#
#   slot 0 sticks  — type can change (→house); pickupable
#   slot 1 axe     — type constant; pickupable
#   slot 2 hammer  — type constant; pickupable
#   slot 3 rock    — type constant; removable only, never held
#   slot 4 tree    — type can change (→sticks→house); pickupable once sticks
#   slot 5 bread   — type constant; removable only
#   slot 6 house   — fully constant (never transforms, moves, or leaves)
#   slot 7 wheat   — type can change (→bread); removable once bread
#
# This is the step the CUDA kernels (csrc/packed_step.cuh) implement.
# --------------------------------------------------------------------------

_DYNTYPE_SLOTS = (0, 4, 7)  # sticks→house, tree→sticks→house, wheat→bread
_REMOVABLE_SLOTS = (3, 5, 7)  # rock, bread, wheat(→bread)
_PICKUP_SLOTS = (0, 1, 2, 4)  # sticks, axe, hammer, tree(→sticks)


def _step_p_unrolled(cfg: EnvConfig, s: PackedState, action: torch.Tensor,
                     dtype=i16):
    """Slot-unrolled `_step_p` (same signature, bit-identical results)."""
    dt = dtype
    b = lambda m: m.to(dt)
    W = cfg.width
    held_key = cfg.height * cfg.width

    dr = b(action == C.ACTION_DOWN) - b(action == C.ACTION_UP)
    dc = b(action == C.ACTION_RIGHT) - b(action == C.ACTION_LEFT)
    is_move = action < C.ACTION_PICKUP

    new_r = torch.clamp(s.agent_r + dr, 0, cfg.height - 1)
    new_c = torch.clamp(s.agent_c + dc, 0, cfg.width - 1)

    cur_key = s.agent_r * W + s.agent_c
    new_key = new_r * W + new_c
    # (row, col) ↔ key is a bijection, so one key compare replaces the
    # two-coordinate moved check
    moved_pos = new_key != cur_key

    key = list(s.slot_key.unbind(0))
    typ = list(s.slot_type.unbind(0))
    ikey = s.init_key.unbind(0)

    # destination-cell codes: fixed-type slots contribute their constant code
    at_there = [key[i] == new_key for i in range(8)]
    obj_there = sum(
        torch.where(at_there[i], typ[i], 0) if i in _DYNTYPE_SLOTS
        else b(at_there[i]) * (i + 1)
        for i in range(8)
    )
    icode_there = sum(b(ikey[i] == new_key) * (i + 1) for i in range(8))

    obj_here = s.obj_here
    holding = s.holding
    blocked = ((obj_there == C.ROCK) & (holding != C.HOLD_HAMMER)) | (
        (obj_there == C.TREE) & (holding != C.HOLD_AXE)
    )
    move_ok = is_move & moved_pos & ~blocked

    can_pickup = (
        (action == C.ACTION_PICKUP)
        & (obj_here >= C.STICKS)
        & (obj_here <= C.HAMMER)
        & (holding == C.HOLD_NONE)
    )
    can_drop = (
        (action == C.ACTION_DROP)
        & (holding != C.HOLD_NONE)
        & (obj_here == C.EMPTY)
    )

    eff = obj_there
    eff = torch.where(obj_there == C.TREE, C.STICKS, eff)
    eff = torch.where((obj_there == C.STICKS) & (holding == C.HOLD_HAMMER),
                      C.HOUSE, eff)
    eff = torch.where((obj_there == C.WHEAT) & (holding == C.HOLD_AXE),
                      C.BREAD, eff)
    removed = (obj_there == C.ROCK) | (obj_there == C.BREAD)

    # slot updates, restricted to each slot's statically-possible transitions
    new_typ = list(typ)
    new_keys = list(key)
    for i in _DYNTYPE_SLOTS:
        new_typ[i] = torch.where(at_there[i] & move_ok, eff, typ[i])
    for i in _REMOVABLE_SLOTS:
        new_keys[i] = torch.where(at_there[i] & move_ok & removed,
                                  held_key + 1, key[i])
    for i in _PICKUP_SLOTS:
        new_keys[i] = torch.where(can_pickup & (key[i] == cur_key), held_key,
                                  new_keys[i])
        new_keys[i] = torch.where(can_drop & (key[i] == held_key), cur_key,
                                  new_keys[i])

    agent_r = torch.where(move_ok, new_r, s.agent_r)
    agent_c = torch.where(move_ok, new_c, s.agent_c)
    new_holding = torch.where(can_pickup, obj_here,
                              torch.where(can_drop, C.HOLD_NONE, holding))

    # task evaluation as bit algebra (identical to _step_p)
    a = s.achieved
    eat = move_ok & (obj_there == C.BREAD)
    chop_rock = move_ok & (obj_there == C.ROCK)
    chop_tree = move_ok & (obj_there == C.TREE)
    make_bread = move_ok & (obj_there == C.WHEAT) & (holding == C.HOLD_AXE)
    build_house = move_ok & (obj_there == C.STICKS) & (holding == C.HOLD_HAMMER)

    latched = a | (
        (b(make_bread) << C.T_MAKE_BREAD)
        | (b(eat) << C.T_EAT_BREAD)
        | (b(build_house) << C.T_BUILD_HOUSE)
        | (b(chop_tree) << C.T_CHOP_TREE)
        | (b(chop_rock) << C.T_CHOP_ROCK)
    )

    cell_final = torch.where(move_ok, torch.where(removed, 0, eff), obj_here)
    house = cell_final == C.HOUSE

    icode = torch.where(move_ok, icode_there, s.icode_here)
    final_key = torch.where(move_ok, new_key, cur_key)
    marked = torch.where((icode == 0) & (final_key == s.init_agent_key),
                         C.AGENT_INIT_MARK, icode)
    a_ctree = ((latched >> C.T_CHOP_TREE) & 1) == 1
    init_empty = marked == C.EMPTY
    ms = init_empty | ~((marked == C.STICKS) | ((marked == C.TREE) & a_ctree))
    ma = init_empty | (marked != C.AXE)
    mh = init_empty | (marked != C.HAMMER)

    hold_sticks = holding == C.HOLD_STICKS
    hold_axe = holding == C.HOLD_AXE
    hold_hammer = holding == C.HOLD_HAMMER

    clear = (
        (1 << C.T_GO_TO_HOUSE)
        | (b(hold_axe) << C.T_MOVE_AXE)
        | (b(hold_hammer) << C.T_MOVE_HAMMER)
        | (b(hold_sticks) << C.T_MOVE_STICKS)
    )
    setb = (
        (b(house) << C.T_GO_TO_HOUSE)
        | (b(hold_axe & ma) << C.T_MOVE_AXE)
        | (b(hold_hammer & mh) << C.T_MOVE_HAMMER)
        | (b(hold_sticks & ms) << C.T_MOVE_STICKS)
    )
    upd = (latched & ~clear) | setb
    achieved = torch.where(is_move, upd, a)

    new_obj_here = torch.where(
        move_ok, cell_final,
        torch.where(can_pickup, 0, torch.where(can_drop, holding, obj_here)))
    new_icode_here = torch.where(move_ok, icode_there, s.icode_here)

    return _finish(cfg, s, dict(
        slot_key=torch.stack(new_keys),
        slot_type=torch.stack(new_typ),
        agent_r=agent_r,
        agent_c=agent_c,
        holding=new_holding,
        obj_here=new_obj_here,
        icode_here=new_icode_here,
        achieved=achieved,
    ), move_ok | can_pickup | can_drop)


def rollout_p(cfg: EnvConfig, slots: SlotState, actions, num_steps: int):
    """Step ``actions`` int[T, B] through the packed engine; SlotState I/O."""
    del num_steps
    ts = transpose_in(slots)
    p = pack(cfg, ts)
    p, out = scan(lambda s, a: _step_p(cfg, s, a), p, actions.to(i16))
    return transpose_out(unpack(cfg, p, ts.desired, _init_rows(ts)), slots.rng), out


def rollout_p_random(cfg: EnvConfig, slots: SlotState, key: torch.Tensor, num_steps: int):
    """T uniform-random-action steps in the packed engine; full outputs. The
    actions are JAX's ``randint(key, (T, B), 0, 6, jnp.int16)``, its int32
    draw cast."""
    return rollout_p(cfg, slots, random_actions(slots, key, num_steps, dtype=i16), num_steps)


def rollout_p_bench(cfg: EnvConfig, slots: SlotState, key: torch.Tensor, num_steps: int):
    """T random steps, returning only (state, int64 total reward).

    Draws the same actions as ``rollout_p_random`` from the same key, so the
    two agree on the final state and the reward sum.
    """
    ts = transpose_in(slots)
    p = pack(cfg, ts)
    actions = random_actions(slots, key, num_steps, dtype=i16)
    acc = torch.zeros((), dtype=torch.int64, device=actions.device)
    for t in range(num_steps):
        p, res = _step_p(cfg, p, actions[t])
        acc += res.reward.sum()
    state = transpose_out(unpack(cfg, p, ts.desired, _init_rows(ts)), slots.rng)
    return state, acc
