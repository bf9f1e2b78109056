"""Carry states between the JAX package and this one, through numpy.

The JAX package's states arrive as dicts of numpy arrays keyed by field name
(``{k: np.asarray(v) ...}`` of an ``EnvState``, ``SlotState`` or
``PackedState``), and leave the same way. Every field keeps its dtype except
``rng``: the JAX package's uint32 key data becomes the port's opaque int64
field, and goes back to uint32 on the way out.

The headline slice has no model parameters, so there are no weights to
convert yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_craftingworld_tpu_torch.core.slots import SlotState
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.ops.packed_rollout import PackedState


def _tensors(names, d: dict, device) -> dict:
    out = {}
    for k in names:
        a = np.array(d[k], dtype=np.int64 if k == "rng" else None)  # a copy
        out[k] = torch.from_numpy(a).to(device)
    return out


def _arrays(items) -> dict:
    out = {}
    for k, v in items:
        a = v.detach().cpu().numpy()
        out[k] = a.astype(np.uint32) if k == "rng" else a
    return out


def env_state_from_numpy(d: dict, device="cpu") -> EnvState:
    names = [f.name for f in dataclasses.fields(EnvState)]
    return EnvState(**_tensors(names, d, device))


def slot_state_from_numpy(d: dict, device="cpu") -> SlotState:
    return SlotState(**_tensors(SlotState._fields, d, device))


def packed_state_from_numpy(d: dict, device="cpu") -> PackedState:
    return PackedState(**_tensors(PackedState._fields, d, device))


def env_state_to_numpy(state: EnvState) -> dict:
    return _arrays((f.name, getattr(state, f.name))
                   for f in dataclasses.fields(EnvState))


def slot_state_to_numpy(state: SlotState) -> dict:
    return _arrays(state._asdict().items())


def packed_state_to_numpy(state: PackedState) -> dict:
    return _arrays(state._asdict().items())
