"""Carry states between the JAX package and this one, through numpy.

The JAX package's states arrive as dicts of numpy arrays keyed by field name
(``{k: np.asarray(v) ...}`` of an ``EnvState``, ``SlotState``,
``TSlotState`` or ``PackedState``), and leave the same way. Every field keeps its dtype except
``rng``: the JAX package's uint32 key data becomes the port's opaque int64
field, and goes back to uint32 on the way out.

Weights cross the same way: the fast-PPO policy's ``MLPParams`` as a dict of
f32 numpy arrays under the JAX names (``w1 b1 w2 b2 wl bl wv bv``, JAX
layouts), and its Adam state as optax's ``ScaleByAdamState`` fields: a dict
``{"count": int32 scalar, "mu": {...}, "nu": {...}}`` with one such dict of
arrays per moment.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_craftingworld_tpu_torch.core.slots import SlotState
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.ops.packed_rollout import PackedState
from gym_craftingworld_tpu_torch.ops.transposed_rollout import TSlotState
from gym_craftingworld_tpu_torch.train.fast_ppo import PARAM_NAMES, AdamState, MLPParams


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


def env_state_from_numpy(d: dict, device="cuda") -> EnvState:
    names = [f.name for f in dataclasses.fields(EnvState)]
    return EnvState(**_tensors(names, d, device))


def slot_state_from_numpy(d: dict, device="cuda") -> SlotState:
    return SlotState(**_tensors(SlotState._fields, d, device))


def tslot_state_from_numpy(d: dict, device="cuda") -> TSlotState:
    return TSlotState(**_tensors(TSlotState._fields, d, device))


def packed_state_from_numpy(d: dict, device="cuda") -> PackedState:
    return PackedState(**_tensors(PackedState._fields, d, device))


def env_state_to_numpy(state: EnvState) -> dict:
    return _arrays((f.name, getattr(state, f.name))
                   for f in dataclasses.fields(EnvState))


def slot_state_to_numpy(state: SlotState) -> dict:
    return _arrays(state._asdict().items())


def tslot_state_to_numpy(state: TSlotState) -> dict:
    return _arrays(state._asdict().items())


def packed_state_to_numpy(state: PackedState) -> dict:
    return _arrays(state._asdict().items())


def mlp_params_from_numpy(d: dict, device="cuda") -> MLPParams:
    """The JAX ``MLPParams`` (a dict of numpy arrays) as the port's module."""
    H, F = np.shape(d["w1"])
    params = MLPParams(F, H, device=device)
    with torch.no_grad():
        for k in PARAM_NAMES:
            getattr(params, k).copy_(torch.from_numpy(np.array(d[k], dtype=np.float32)))
    return params


def mlp_params_to_numpy(params: MLPParams) -> dict:
    return {k: getattr(params, k).detach().cpu().numpy() for k in PARAM_NAMES}


def adam_state_from_numpy(d: dict, device="cuda") -> AdamState:
    """optax ``ScaleByAdamState`` fields (numpy) as the port's ``AdamState``."""
    moment = lambda m: {k: torch.from_numpy(np.array(m[k], dtype=np.float32)).to(device)
                        for k in PARAM_NAMES}
    count = torch.tensor(int(np.asarray(d["count"])), dtype=torch.int32, device=device)
    return AdamState(count, moment(d["mu"]), moment(d["nu"]))


def adam_state_to_numpy(state: AdamState) -> dict:
    moment = lambda m: {k: m[k].detach().cpu().numpy() for k in PARAM_NAMES}
    return {"count": np.int32(int(state.count)), "mu": moment(state.mu),
            "nu": moment(state.nu)}
