"""Transposed slot layout: slot axis first.

Counterpart of ``gym_craftingworld_tpu/ops/transposed_rollout.py``. Only the
layout and its two conversions are ported so far; they sit on the packed
engines' path (``ops/packed_rollout.py``). The transposed step ``_step_t``
comes later.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch.core.slots import SlotState


class TSlotState(NamedTuple):
    """Transposed slot state: slot axis first ([8, B]), scalars [B]."""

    slot_type: torch.Tensor  # int32[8, B]
    slot_pos_r: torch.Tensor  # int32[8, B]
    slot_pos_c: torch.Tensor  # int32[8, B]
    slot_stat: torch.Tensor  # int32[8, B]
    agent_r: torch.Tensor  # int32[B]
    agent_c: torch.Tensor  # int32[B]
    desired: torch.Tensor  # int32[9, B]
    achieved: torch.Tensor  # int32[9, B]
    init_type: torch.Tensor  # int32[8, B]
    init_pos_r: torch.Tensor  # int32[8, B]
    init_pos_c: torch.Tensor  # int32[8, B]
    init_agent_r: torch.Tensor  # int32[B]
    init_agent_c: torch.Tensor  # int32[B]
    step_num: torch.Tensor  # int32[B]


def transpose_in(slots: SlotState) -> TSlotState:
    i32t = lambda x: x.to(torch.int32).T.contiguous()
    i32 = lambda x: x.to(torch.int32).contiguous()
    return TSlotState(
        slot_type=i32t(slots.slot_type),
        slot_pos_r=i32t(slots.slot_pos[..., 0]),
        slot_pos_c=i32t(slots.slot_pos[..., 1]),
        slot_stat=i32t(slots.slot_stat),
        agent_r=i32(slots.agent[:, 0]),
        agent_c=i32(slots.agent[:, 1]),
        desired=i32t(slots.desired),
        achieved=i32t(slots.achieved),
        init_type=i32t(slots.init_type),
        init_pos_r=i32t(slots.init_pos[..., 0]),
        init_pos_c=i32t(slots.init_pos[..., 1]),
        init_agent_r=i32(slots.init_agent[:, 0]),
        init_agent_c=i32(slots.init_agent[:, 1]),
        step_num=i32(slots.step_num),
    )


def transpose_out(t: TSlotState, rng) -> SlotState:
    T = lambda x: x.T.contiguous()
    return SlotState(
        slot_type=T(t.slot_type),
        slot_pos=torch.stack([t.slot_pos_r.T, t.slot_pos_c.T], dim=-1),
        slot_stat=T(t.slot_stat),
        agent=torch.stack([t.agent_r, t.agent_c], dim=-1),
        desired=T(t.desired).to(torch.int8),
        achieved=T(t.achieved).to(torch.int8),
        init_type=T(t.init_type),
        init_pos=torch.stack([t.init_pos_r.T, t.init_pos_c.T], dim=-1),
        init_agent=torch.stack([t.init_agent_r, t.init_agent_c], dim=-1),
        step_num=t.step_num,
        rng=rng,
    )
