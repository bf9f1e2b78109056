"""Batched environment state and its bijection to the reference one-hot.

Counterpart of ``gym_craftingworld_tpu/core/state.py``. The reference stores
each cell as a 12-wide one-hot vector (``craftingworld_ray.py:94-98``):
channels 0-7 object, 8 agent, 9-11 held item. Here the same information is
packed into a few integer tensors per batch:

  objects  int8[B, H, W]   0 empty, 1..8 object code (= reference channel + 1)
  agent    int32[B, 2]     (row, col)
  holding  int32[B]        0 none, 1..3 = sticks/axe/hammer

plus goal/episode bookkeeping. Every field has leading batch axis B.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig


@dataclasses.dataclass
class EnvState:
    """Batched CraftingWorld state. All fields have leading batch axis B.

    Field names and dtypes are the JAX ``EnvState``'s, except ``rng``: there
    it holds JAX key data (uint32[B, 2]); here it is an opaque int64[B, 2]
    that the port carries but never reads. The port's auto-reset draws fresh
    worlds from a ``torch.Generator`` instead (``core/rollout.py``).
    """

    # Live world.
    objects: torch.Tensor  # int8[B, H, W]
    agent: torch.Tensor  # int32[B, 2]
    holding: torch.Tensor  # int32[B]

    # Goal bookkeeping (reference desired/achieved_goal_vector).
    desired: torch.Tensor  # int8[B, 9]
    achieved: torch.Tensor  # int8[B, 9]

    # Frozen reset-time snapshot (reference INIT_OBS_VECTOR), needed by the
    # Move{Sticks,Axe,Hammer} evaluation (craftingworld_ray.py:670-702).
    # Cell codes as `objects`, plus 9 = agent's initial cell.
    init_objects: torch.Tensor  # int8[B, H, W]
    init_agent: torch.Tensor  # int32[B, 2]

    # Imagined goal state (reference imagine_obs, craftingworld_ray.py:220-299),
    # stored packed and rendered on demand.
    goal_objects: torch.Tensor  # int8[B, H, W]
    goal_agent: torch.Tensor  # int32[B, 2]

    # Episode clock.
    step_num: torch.Tensor  # int32[B]

    # Per-env key, int64[B, 2], opaque (see above); the port's resets fill it
    # with zeros, and interop widens the JAX package's uint32 key data into it.
    rng: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.objects.shape[0]

    @property
    def grid_hw(self):
        return self.objects.shape[1], self.objects.shape[2]


def zeros_state(cfg: EnvConfig, batch_size: int, device="cpu") -> EnvState:
    """An all-empty state of the right shapes (useful as a shape template)."""
    B, H, W = batch_size, cfg.height, cfg.width
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    return EnvState(
        objects=z((B, H, W), torch.int8),
        agent=z((B, 2), torch.int32),
        holding=z((B,), torch.int32),
        desired=z((B, C.N_TASKS), torch.int8),
        achieved=z((B, C.N_TASKS), torch.int8),
        init_objects=z((B, H, W), torch.int8),
        init_agent=z((B, 2), torch.int32),
        goal_objects=z((B, H, W), torch.int8),
        goal_agent=z((B, 2), torch.int32),
        step_num=z((B,), torch.int32),
        rng=z((B, 2), torch.int64),
    )


# ---------------------------------------------------------------------------
# Bijection to/from the reference (H, W, 12) one-hot — used by parity
# harnesses. Host-side numpy.
# ---------------------------------------------------------------------------


def onehot_from_packed(
    objects: np.ndarray, agent: np.ndarray, holding: int
) -> np.ndarray:
    """Packed single-env state → reference ``(H, W, 12)`` int one-hot."""
    H, W = objects.shape
    out = np.zeros((H, W, C.N_CHANNELS), dtype=int)
    obj = np.asarray(objects, dtype=np.int64)
    mask = obj > 0
    rr, cc = np.nonzero(mask)
    out[rr, cc, obj[rr, cc] - 1] = 1
    ar, ac = int(agent[0]), int(agent[1])
    out[ar, ac, C.N_OBJECTS] = 1
    if holding != C.HOLD_NONE:
        out[ar, ac, C.N_OBJECTS + int(holding)] = 1
    return out


def packed_from_onehot(onehot: np.ndarray):
    """Reference ``(H, W, 12)`` one-hot → (objects int8[H,W], agent (r,c), holding)."""
    onehot = np.asarray(onehot)
    obj_ch = onehot[:, :, : C.N_OBJECTS]
    objects = np.where(
        obj_ch.any(axis=2), obj_ch.argmax(axis=2) + 1, 0
    ).astype(np.int8)
    ar, ac = [int(v[0]) for v in np.nonzero(onehot[:, :, C.N_OBJECTS])]
    hold_ch = onehot[ar, ac, C.N_OBJECTS + 1 :]
    holding = int(hold_ch.argmax() + 1) if hold_ch.any() else C.HOLD_NONE
    return objects, np.array([ar, ac], dtype=np.int32), holding


def init_codes_from_onehot(onehot: np.ndarray) -> np.ndarray:
    """Reference INIT one-hot → init-cell codes (0 empty, 1..8 object, 9 agent).

    Reset-time states never carry a held item (sample_state places only
    objects + agent, craftingworld_ray.py:599-628), so the agent's cell maps
    to the AGENT_INIT_MARK code.
    """
    onehot = np.asarray(onehot)
    obj_ch = onehot[:, :, : C.N_OBJECTS]
    codes = np.where(obj_ch.any(axis=2), obj_ch.argmax(axis=2) + 1, 0)
    codes = np.where(
        (codes == 0) & (onehot[:, :, C.N_OBJECTS] == 1), C.AGENT_INIT_MARK, codes
    )
    return codes.astype(np.int8)


def state_from_reference(
    cfg: EnvConfig,
    obs_one_hot: np.ndarray,
    init_obs_vector: np.ndarray,
    desired: np.ndarray,
    achieved: np.ndarray,
    goal_one_hot: np.ndarray | None = None,
    step_num: int = 0,
    device="cpu",
) -> EnvState:
    """Build a B=1 EnvState that mirrors a live reference env (parity harness)."""
    objects, agent, holding = packed_from_onehot(obs_one_hot)
    init_codes = init_codes_from_onehot(init_obs_vector)
    _, init_agent, _ = packed_from_onehot(init_obs_vector)
    if goal_one_hot is not None:
        g_obj, g_agent, _ = packed_from_onehot(goal_one_hot)
    else:
        g_obj, g_agent = objects, agent
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)[None]
    return EnvState(
        objects=t(objects),
        agent=t(agent),
        holding=t(np.int32(holding)),
        desired=t(np.reshape(desired, (C.N_TASKS,)).astype(np.int8)),
        achieved=t(np.reshape(achieved, (C.N_TASKS,)).astype(np.int8)),
        init_objects=t(init_codes),
        init_agent=t(init_agent),
        goal_objects=t(g_obj),
        goal_agent=t(g_agent),
        step_num=t(np.int32(step_num)),
        rng=torch.zeros((1, 2), dtype=torch.int64, device=device),
    )


def reference_onehot_from_state(state: EnvState, b: int = 0) -> np.ndarray:
    """EnvState (one env of the batch) → reference ``(H, W, 12)`` one-hot."""
    objects = state.objects[b].cpu().numpy()
    agent = state.agent[b].cpu().numpy()
    holding = int(state.holding[b])
    return onehot_from_packed(objects, agent, holding)
