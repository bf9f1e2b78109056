"""Transposed slot layout: slot axis first.

Counterpart of ``gym_craftingworld_tpu/ops/transposed_rollout.py``: the slot
state stored as ``[8, B]`` (and the task vectors as ``[9, B]``, int32), its
two conversions, and a rollout over it. ``_step_t`` is the slot step of
``core/slots.py`` with the slot axis first; the packed engines
(``ops/packed_rollout.py``) and the transposed fused kernel
(``ops/fused_rollout_t.py``) start from this layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.slots import SlotState, _step_fields
from gym_craftingworld_tpu_torch.core.step import scan


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


def _step_t(cfg: EnvConfig, s: TSlotState, action: torch.Tensor):
    """One batched step in the transposed layout; ``action`` int[B]. ``s`` is not modified."""
    new, res = _step_fields(cfg, s._asdict(), action, dim=0)
    return s._replace(**new), res


def rollout_t_random(cfg: EnvConfig, slots: SlotState, generator: torch.Generator,
                     num_steps: int):
    """T random-action steps in the transposed layout; returns ``(SlotState, StepResult)``.

    The actions are ``torch.randint`` draws from ``generator``, int32 ``[T, B]``,
    as in ``core/slots.py::rollout_slots_random``.
    """
    B = slots.agent.shape[0]
    actions = torch.randint(0, C.N_ACTIONS, (num_steps, B), generator=generator,
                            device=slots.agent.device, dtype=torch.int32)
    ts, out = scan(lambda s, a: _step_t(cfg, s, a), transpose_in(slots), actions)
    return transpose_out(ts, slots.rng), out
