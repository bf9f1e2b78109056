"""What the two CPV tools share: the expert's task order and the world edit
that puts a fresh world into the state a stacked run reaches after some tasks.

The JAX package's ``tools/cpv_canonical.py`` and ``tools/cpv_matrix.py`` each
carry their own copy; the port keeps one:

* ``ORDER`` and ``RANK``: the scripted expert's execution order
  (``agents/expert._TASK_ORDER``); predecessors of a task are always of
  lower rank, so handoff states are the ones a stacked run visits;
* ``EFFECT``, ``MOVE_ITEM``, ``TOOL_OF``, ``MOVE_BIT``: the crafting effect
  table (craftingworld_ray.py:416-438) as world edits;
* ``apply_predecessors_np``: the edit itself on bare numpy arrays;
* ``failure_kind``: the class of a failed episode, as JAX's
  ``tools/cpv_debug.py`` names it (``cpv_canonical --trace`` and
  ``cpv_debug``).

All of it is numpy: drawn from the same ``np.random.RandomState`` in the
same order, it edits a world bit for bit as the JAX tools do.
"""

from __future__ import annotations

import numpy as np

from gym_craftingworld_tpu_torch import constants as C

ORDER = [
    C.T_MAKE_BREAD, C.T_EAT_BREAD, C.T_CHOP_ROCK, C.T_CHOP_TREE,
    C.T_MOVE_STICKS, C.T_BUILD_HOUSE, C.T_MOVE_AXE, C.T_MOVE_HAMMER,
    C.T_GO_TO_HOUSE,
]
RANK = {t: i for i, t in enumerate(ORDER)}

EFFECT = {  # task -> (consumed object, produced object)
    C.T_MAKE_BREAD: (C.WHEAT, C.BREAD),
    C.T_EAT_BREAD: (C.BREAD, C.EMPTY),
    C.T_BUILD_HOUSE: (C.STICKS, C.HOUSE),
    C.T_CHOP_TREE: (C.TREE, C.STICKS),
    C.T_CHOP_ROCK: (C.ROCK, C.EMPTY),
}
MOVE_ITEM = {C.T_MOVE_AXE: C.AXE, C.T_MOVE_HAMMER: C.HAMMER,
             C.T_MOVE_STICKS: C.STICKS}
TOOL_OF = {C.T_MAKE_BREAD: C.AXE, C.T_CHOP_TREE: C.AXE,
           C.T_CHOP_ROCK: C.HAMMER, C.T_BUILD_HOUSE: C.HAMMER,
           **MOVE_ITEM}
MOVE_BIT = {C.STICKS: C.T_MOVE_STICKS, C.AXE: C.T_MOVE_AXE,
            C.HAMMER: C.T_MOVE_HAMMER}
STALL_TAIL, STALL_DISTINCT = 12, 4  # a stall: the last 12 states take <= 4 values


def apply_predecessors_np(objects, achieved, agent, holding, S, rng):
    """In-place world edit putting ``objects`` into the post-``S`` handoff
    state; returns ``(ok, agent, holding)``.

    Each completed predecessor's world effect is applied to the live grid
    (never to the init grid, which the Move* evaluation still compares
    against, craftingworld_ray.py:670-702) and its achieved bit set; the
    agent moves to a random empty cell half the time (real handoffs end
    wherever the previous task finished); the last predecessor's tool stays
    in hand 70% of the time (success fires mid-carry, :361-367), which keeps
    that tool's Move* bit latched. Draws, in order: the effects, the move
    (``rand() < 0.5``), the tool (``rand() < 0.7``). ``ok`` is False if an
    effect's source object is missing.
    """
    for i in S:
        if i in EFFECT:
            src, dst = EFFECT[i]
            hits = np.argwhere(objects == src)
            if not len(hits):
                return False, agent, holding
            objects[tuple(hits[rng.randint(len(hits))])] = dst
        else:  # Move*: relocate the item to a random empty cell
            item = MOVE_ITEM[i]
            hits = np.argwhere(objects == item)
            empties = np.argwhere(objects == C.EMPTY)
            if not len(hits) or not len(empties):
                return False, agent, holding
            objects[tuple(hits[rng.randint(len(hits))])] = C.EMPTY
            objects[tuple(empties[rng.randint(len(empties))])] = item
        achieved[i] = 1
    if rng.rand() < 0.5:
        empties = np.argwhere(objects == C.EMPTY)
        if len(empties):
            r, c = empties[rng.randint(len(empties))]
            agent = (int(r), int(c))
    if S:
        tool = TOOL_OF.get(S[-1])
        if tool is not None and rng.rand() < 0.7:
            hits = np.argwhere(objects == tool)
            if len(hits):
                objects[tuple(hits[rng.randint(len(hits))])] = C.EMPTY
                holding = tool  # object codes 1..3 == holding codes
                achieved[MOVE_BIT[tool]] = 1
    return True, agent, holding


def failure_kind(wrong_latch: bool, states) -> str:
    """A failed episode's class: ``wrong_latch`` if an undesired latching bit
    got set (unrecoverable), else ``stall`` if the last ``STALL_TAIL`` of its
    ``states`` (hashable, in step order) take at most ``STALL_DISTINCT``
    values (a limit cycle until the timeout), else ``timeout`` (distinct
    states until the step cap)."""
    if wrong_latch:
        return "wrong_latch"
    return "stall" if len(set(list(states)[-STALL_TAIL:])) <= STALL_DISTINCT else "timeout"
