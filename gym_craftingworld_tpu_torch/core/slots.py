"""Entity-slot state layout.

Counterpart of ``gym_craftingworld_tpu/core/slots.py``. A CraftingWorld world
never holds more than 8 objects (one of each is placed at reset and every
crafting rule converts or removes in place — nothing ever *adds* an object),
so the whole world state compresses to 8 entity slots per env:

  slot_type int32[B, 8]    current object code (1..8; may change: tree→sticks…)
  slot_pos  int32[B, 8, 2] cell of the slot
  slot_stat int32[B, 8]    0 = on grid, 1 = held by agent, 2 = removed

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
    rng: torch.Tensor  # int64[B, 2], opaque (see core/state.py)


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
