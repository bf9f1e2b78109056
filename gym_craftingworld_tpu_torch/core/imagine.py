"""Batched goal-state synthesis ("imagine_obs").

Counterpart of ``gym_craftingworld_tpu/core/imagine.py``, batched over B.
The reference builds the hypothetical *final* state from the init state by
applying each desired task's effect, with random choices for which bread /
stick / house / empty cell (``craftingworld_ray.py:220-299``). The
application order is task-index order 0,1,3,8,2,4,5,6,7 (MakeBread, EatBread,
ChopTree, MoveSticks, BuildHouse, ChopRock, GoToHouse, MoveAxe, MoveHammer);
later edits see earlier edits' objects.

Quirks preserved:
  - MakeBread / ChopTree / ChopRock / MoveAxe / MoveHammer act on the *first*
    matching cell in row-major order;
  - MoveSticks searches empty cells over channels ``[:9]`` (excludes the
    agent's cell) but MoveAxe/MoveHammer over ``[:8]`` (the agent's cell is
    eligible) — craftingworld_ray.py:252 vs :282,:293;
  - GoToHouse moves the agent onto a random house (:269-276).

The random choices take explicit float32 score rows ``scores[B, 7, H*W]``
instead of a key, in the order the JAX function consumes its keys: rows 0-5
come from ``split(key, 6)[0..5]`` and row 6 from ``fold_in(keys[5], 1)``.
"A uniformly random matching cell" is the argmax of the masked scores, and
argmax takes the lowest index on ties, as XLA's does.
"""

from __future__ import annotations

import torch

from gym_craftingworld_tpu_torch import constants as C

N_GOAL_SCORE_ROWS = 7


def _first_cell(mask: torch.Tensor) -> torch.Tensor:
    """Smallest row-major index where ``mask[b]`` is True (argmax takes no bool)."""
    return torch.argmax(mask.to(torch.int8), dim=1)


def _random_cell(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Index of the highest-scoring True cell per row."""
    return torch.argmax(torch.where(mask, scores, -1.0), dim=1)


def _cond_set(cond, flat, idx, val):
    """flat[b, idx[b]] <- val, only where ``cond[b]``."""
    cells = torch.arange(flat.shape[1], device=flat.device)
    hit = cells[None, :] == idx[:, None]
    return torch.where(cond[:, None] & hit, val, flat)


def imagine_goal(
    scores: torch.Tensor,  # float32[B, 7, H*W]
    init_objects_flat: torch.Tensor,  # int8[B, H*W], 0/1..8 codes (no agent mark)
    agent_idx: torch.Tensor,  # int[B] linear index of the agent's init cell
    desired: torch.Tensor,  # int8[B, 9]
):
    """Batched goal synthesis.

    Returns ``(goal_objects_flat int8[B, H*W], goal_agent_idx int32[B])``.
    """
    g = init_objects_flat.to(torch.int32)
    a_idx = agent_idx.to(torch.int32)
    d = desired.to(torch.bool)
    cells = torch.arange(g.shape[1], device=g.device)

    # MakeBread: first wheat cell → bread (craftingworld_ray.py:226-231).
    c = _first_cell(g == C.WHEAT)
    g = _cond_set(d[:, C.T_MAKE_BREAD], g, c, C.BREAD)

    # EatBread: random bread cell (possibly the one just made) → empty (:232-237).
    c = _random_cell(scores[:, 0], g == C.BREAD)
    g = _cond_set(d[:, C.T_EAT_BREAD], g, c, C.EMPTY)

    # ChopTree: first tree cell → sticks (:238-243).
    c = _first_cell(g == C.TREE)
    g = _cond_set(d[:, C.T_CHOP_TREE], g, c, C.STICKS)

    # MoveSticks: random stick → random empty cell, where "empty" excludes the
    # agent's cell (channels [:9] in the reference, :244-257).
    src = _random_cell(scores[:, 1], g == C.STICKS)
    not_agent = cells[None, :] != a_idx[:, None]
    dst = _random_cell(scores[:, 2], (g == C.EMPTY) & not_agent)
    moved = _cond_set(d[:, C.T_MOVE_STICKS], g, src, C.EMPTY)
    g = _cond_set(d[:, C.T_MOVE_STICKS], moved, dst, C.STICKS)

    # BuildHouse: random stick cell → house, in place (:258-264).
    c = _random_cell(scores[:, 3], g == C.STICKS)
    g = _cond_set(d[:, C.T_BUILD_HOUSE], g, c, C.HOUSE)

    # ChopRock: first rock cell → empty (:265-268).
    c = _first_cell(g == C.ROCK)
    g = _cond_set(d[:, C.T_CHOP_ROCK], g, c, C.EMPTY)

    # GoToHouse: the agent relocates onto a random house (:269-276).
    house = _random_cell(scores[:, 4], g == C.HOUSE)
    a_idx = torch.where(d[:, C.T_GO_TO_HOUSE], house.to(torch.int32), a_idx)

    # MoveAxe: first axe → random empty cell over channels [:8] — the agent's
    # cell *is* eligible here (:277-286).
    src = _first_cell(g == C.AXE)
    dst = _random_cell(scores[:, 5], g == C.EMPTY)
    moved = _cond_set(d[:, C.T_MOVE_AXE], g, src, C.EMPTY)
    g = _cond_set(d[:, C.T_MOVE_AXE], moved, dst, C.AXE)

    # MoveHammer: same pattern (:287-297), with the row the JAX function draws
    # from fold_in(keys[5], 1).
    src = _first_cell(g == C.HAMMER)
    dst = _random_cell(scores[:, 6], g == C.EMPTY)
    moved = _cond_set(d[:, C.T_MOVE_HAMMER], g, src, C.EMPTY)
    g = _cond_set(d[:, C.T_MOVE_HAMMER], moved, dst, C.HAMMER)

    return g.to(torch.int8), a_idx
