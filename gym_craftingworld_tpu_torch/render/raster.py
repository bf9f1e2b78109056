"""Batched rendering on the state's device.

Counterpart of ``gym_craftingworld_tpu/render/raster.py``, with its outputs
byte for byte (``tests/test_torch_render.py``):

  * Ray/Flat 4x4-px tiles (`craftingworld_ray.py:442-520`): a palette lookup
    per cell, repeated 4x4, the agent as a white 2x2 block at cell px
    [1:3,1:3] and the held item's colour on that block's bottom row [2:3,1:3].
  * AltObs 3x3-px tiles + status strip (`craftingworld_altobs.py:489-595`):
    each of 9 channels maps to a fixed pixel slot in the tile
    (``OBJECT_ENCODING_M``/``COLORS_A_M``), held items add into slots 0-2 of
    the agent's tile (so a held item over the same object doubles the slot
    value, as the reference does), and a 3-px strip is appended at the bottom
    with px columns [3:6] set to 255 while holding.
  * OneHot (`carftingworld_onehot.py:84-103`): the raw 12-channel one-hot.

Output dtypes are the JAX package's: uint8 for Ray and OneHot, int16 for
AltObs. The agent overlays write the few pixels of each env's agent cell by
index, so a frame costs one pass over its pixels. ``jax.nn.one_hot(x - 1, n)``
is zero for ``x = 0``; here every such one-hot is a compare against
``1..n``, which gives the same rows for any ``x``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.core.state import EnvState

_PALETTE_NP = np.asarray(C.COLORS_N, np.uint8)  # [9, 3]; row 0 = black/empty


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """A constant table on ``device``, made once a device."""
    table = {"palette": _PALETTE_NP,
             "tile": np.asarray(C.CPV_TILE_COLORS, np.int16)}[name]  # [9, 3], [3, 3, 3]
    return torch.as_tensor(table, device=device)


def _onehot(x: torch.Tensor, n: int) -> torch.Tensor:
    """bool[..., n]: ``jax.nn.one_hot(x - 1, n)``, by compares."""
    return x[..., None] == torch.arange(1, n + 1, dtype=x.dtype, device=x.device)


def _agent_cell(agent: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """bool[B, H, W], true at each env's agent cell."""
    dev = agent.device
    at_r = torch.arange(H, device=dev)[None, :, None] == agent[:, 0, None, None]
    at_c = torch.arange(W, device=dev)[None, None, :] == agent[:, 1, None, None]
    return at_r & at_c


# ---------------------------------------------------------------------------
# Ray / Flat: 4x4-px tiles
# ---------------------------------------------------------------------------


def render_ray(objects, agent, holding):
    """Batched Ray-style pixels: uint8[B, 4H, 4W, 3]."""
    B, H, W = objects.shape
    dev = objects.device
    palette = _const("palette", dev)
    # codes outside 1..8 (the init grid's AGENT_INIT_MARK) render black, as
    # the JAX select-sum over the eight object codes does
    obj = objects.long()
    base = palette[torch.where(obj <= C.N_OBJECTS, obj, 0)]  # [B, H, W, 3]
    img = base[:, :, None, :, None, :].expand(B, H, 4, W, 4, 3).reshape(B, 4 * H, 4 * W, 3)
    # white 2x2 block at cell px [1:3, 1:3]; its bottom row takes the held
    # item's colour while holding (craftingworld_ray.py:483-486)
    b = torch.arange(B, device=dev)[:, None, None]
    mid = torch.arange(1, 3, device=dev)
    rows = 4 * agent[:, 0:1].long() + mid  # [B, 2]
    cols = 4 * agent[:, 1:2].long() + mid
    img[b, rows[:, :, None], cols[:, None, :]] = 255
    hold = holding.long()
    white = torch.full((B, 3), 255, dtype=torch.uint8, device=dev)
    bottom = torch.where((hold > 0)[:, None], palette[hold.clamp(0, 8)], white)
    img[b[:, :, 0], rows[:, 1:2], cols] = bottom[:, None, :]
    return img


# ---------------------------------------------------------------------------
# Host-side incremental repaint (reference render_edit)
# ---------------------------------------------------------------------------


def render_edit(img, objects, agent, holding, cells):
    """Repaint only ``cells`` of a Ray-style image, in place (host numpy).

    The batched path re-renders the whole batch on the device
    (:func:`render_ray`); this is the single-env *interactive* fast path
    mirroring the reference's incremental renderer
    (craftingworld_ray.py:522-557), which touches at most two 4x4-px tiles
    per step instead of the full frame. Byte-exact with ``render_ray`` on the
    repainted cells (tests/test_incremental_render.py).

    img:      uint8[4H, 4W, 3] — mutated in place and returned
    objects:  int[H, W] packed codes (0 = empty, 1..8 = object)
    agent:    (row, col) of the agent now
    holding:  packed held code 0..3
    cells:    iterable of (row, col) cell coordinates to repaint
    """
    ar, ac = int(agent[0]), int(agent[1])
    for r, c in cells:
        img[4 * r : 4 * r + 4, 4 * c : 4 * c + 4] = _PALETTE_NP[
            int(objects[r, c])
        ]
        if r == ar and c == ac:
            # white 2x2 agent block; held-item colour on its bottom row
            # (craftingworld_ray.py:483-486 / :545-557)
            img[4 * r + 1 : 4 * r + 3, 4 * c + 1 : 4 * c + 3] = 255
            if holding:
                img[4 * r + 2, 4 * c + 1 : 4 * c + 3] = _PALETTE_NP[int(holding)]
    return img


# ---------------------------------------------------------------------------
# AltObs: 3x3-px tiles + bottom status strip
# ---------------------------------------------------------------------------


def render_altobs(objects, agent, holding):
    """Batched AltObs pixels: int16[B, (H+1)*3, 3W, 3].

    int16, not uint8: a held item over the same object type doubles the tile
    slot value, so the reference emits pixel values up to 510 (2x255).
    """
    B, H, W = objects.shape
    dev = objects.device
    # 9-channel per-cell activation: objects (codes 1..8 → channels 0..7),
    # agent → channel 8, held item adds into channels 0..2 of the agent cell
    # (craftingworld_altobs.py:530-533).
    ch = _onehot(objects.to(torch.int16), 9).to(torch.int16)  # [B, H, W, 9]
    e_agent = torch.zeros(9, dtype=torch.int16, device=dev)
    e_agent[8] = 1
    held = _onehot(holding.to(torch.int16), 9).to(torch.int16)  # [B, 9]
    cell = _agent_cell(agent, H, W)[..., None].to(torch.int16)
    ch = ch + cell * (e_agent + held)[:, None, None, :]

    # channel k renders at tile pixel (k // 3, k % 3) scaled by its colour
    vals = ch.view(B, H, W, 3, 3).permute(0, 1, 3, 2, 4).reshape(B, 3 * H, 3 * W)
    tile = _const("tile", dev).repeat(H, W, 1)  # [3H, 3W, 3]
    img = vals[..., None] * tile[None]

    # bottom status strip: zeros, px columns [3:6] = 255 while holding
    # (craftingworld_altobs.py:543,557-559)
    strip = torch.zeros((B, 3, 3 * W, 3), dtype=torch.int16, device=dev)
    strip[:, :, 3:6] = torch.where(holding > 0, 255, 0).to(torch.int16)[:, None, None, None]
    return torch.cat([img, strip], dim=1)


# ---------------------------------------------------------------------------
# OneHot: the 12-channel reference encoding
# ---------------------------------------------------------------------------


def render_onehot(objects, agent, holding):
    """Batched one-hot obs: uint8[B, H, W, 12]."""
    B, H, W = objects.shape
    obj = _onehot(objects, C.N_OBJECTS)
    cell = _agent_cell(agent, H, W)[..., None]  # [B, H, W, 1]
    held = _onehot(holding, len(C.PICKUPABLE))[:, None, None, :]
    return torch.cat([obj, cell, cell & held], dim=-1).to(torch.uint8)


# ---------------------------------------------------------------------------
# State-level helpers (current / init / goal views)
# ---------------------------------------------------------------------------


def _init_views(state: EnvState):
    """Strip the agent-init marker: init grid codes 9 → empty for rendering."""
    init_obj = torch.where(
        state.init_objects == C.AGENT_INIT_MARK,
        torch.zeros_like(state.init_objects),
        state.init_objects,
    )
    return init_obj, state.init_agent


def state_images_ray(state: EnvState):
    """The reference Ray observation dict, rendered on demand
    (craftingworld_ray.py:194-196,359-360): observation == achieved_goal."""
    zeros = torch.zeros_like(state.holding)
    cur = render_ray(state.objects, state.agent, state.holding)
    init_obj, init_agent = _init_views(state)
    return {
        "observation": cur,
        "achieved_goal": cur,
        "desired_goal": render_ray(state.goal_objects, state.goal_agent, zeros),
        "init_observation": render_ray(init_obj, init_agent, zeros),
    }


def state_images_altobs(state: EnvState, stacked: bool = False):
    zeros = torch.zeros_like(state.holding)
    cur = render_altobs(state.objects, state.agent, state.holding)
    init_obj, init_agent = _init_views(state)
    out = {
        "observation": cur,
        "achieved_goal": cur,
        "desired_goal": render_altobs(state.goal_objects, state.goal_agent, zeros),
        "init_observation": render_altobs(init_obj, init_agent, zeros),
    }
    if stacked:
        # (B, 4, ph, pw, 3) — reference stacks the four images on a new axis 0
        # for a single env (craftingworld_altobs.py:258-259,408-411).
        return torch.stack(
            [out["observation"], out["desired_goal"], out["achieved_goal"],
             out["init_observation"]],
            dim=1,
        )
    return out


def state_obs_onehot(state: EnvState):
    """Reference OneHot observation dict (carftingworld_onehot.py:202-207):
    desired_goal is the imagined final one-hot *state*, not a render."""
    zeros = torch.zeros_like(state.holding)
    cur = render_onehot(state.objects, state.agent, state.holding)
    init_obj, init_agent = _init_views(state)
    return {
        "observation": cur,
        "achieved_goal": cur,
        "desired_goal": render_onehot(state.goal_objects, state.goal_agent, zeros),
        "init_observation": render_onehot(init_obj, init_agent, zeros),
    }
