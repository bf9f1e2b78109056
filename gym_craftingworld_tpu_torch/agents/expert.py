"""Scripted expert agent.

A host-side planner that completes CraftingWorld goal sets, used as an eval
baseline and as living proof that every skill is completable under the exact
reference semantics. (The reference ships no agents; this is framework-native.)

Planning model:
  * one task at a time, in a dependency-aware order;
  * BFS pathfinding over the grid with a *forbidden set* of cells whose
    traversal would latch an undesired achievement or destroy a needed object
    (bread underfoot is eaten, wheat+axe becomes bread, sticks+hammer becomes
    a house, rock/tree+tool latch their chop bits);
  * tools are fetched on demand and returned to their origin cell afterwards
    when their Move* bit is not desired (carrying a tool over any non-origin
    cell sets the bit; stepping back onto the origin clears it, and dropping
    freezes it — eval only runs on move actions).

The expert operates on the packed numpy view of a single env (the API shim's
attributes), emitting one action per call.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from gym_craftingworld_tpu_torch import constants as C

_TOOL_FOR = {  # task → required held item
    C.T_CHOP_ROCK: C.HOLD_HAMMER,
    C.T_CHOP_TREE: C.HOLD_AXE,
    C.T_MAKE_BREAD: C.HOLD_AXE,
    C.T_BUILD_HOUSE: C.HOLD_HAMMER,
}
_TARGET_FOR = {  # task → object code to step onto
    C.T_EAT_BREAD: C.BREAD,
    C.T_CHOP_ROCK: C.ROCK,
    C.T_CHOP_TREE: C.TREE,
    C.T_MAKE_BREAD: C.WHEAT,
    C.T_BUILD_HOUSE: C.STICKS,
    C.T_GO_TO_HOUSE: C.HOUSE,
}
_MOVE_ITEM = {  # Move* task → item code
    C.T_MOVE_AXE: C.AXE,
    C.T_MOVE_HAMMER: C.HAMMER,
    C.T_MOVE_STICKS: C.STICKS,
}
# execution order: crafting chains first; MoveSticks BEFORE BuildHouse (which
# consumes the sticks — moving first freezes the bit and leaves the relocated
# sticks available for conversion); GoToHouse last (final agent position)
_TASK_ORDER = [
    C.T_MAKE_BREAD,
    C.T_EAT_BREAD,
    C.T_CHOP_ROCK,
    C.T_CHOP_TREE,
    C.T_MOVE_STICKS,
    C.T_BUILD_HOUSE,
    C.T_MOVE_AXE,
    C.T_MOVE_HAMMER,
    C.T_GO_TO_HOUSE,
]

_STEPS = [(-1, 0, C.ACTION_UP), (0, 1, C.ACTION_RIGHT), (1, 0, C.ACTION_DOWN),
          (0, -1, C.ACTION_LEFT)]


class ExpertPolicy:
    """Greedy scripted solver for one env (batch_size == 1 API shims)."""

    def __init__(self, env):
        self.env = env
        self._plan: list[int] = []

    # -- world helpers -----------------------------------------------------

    def _world(self):
        onehot = np.asarray(self.env.obs_one_hot)
        obj_ch = onehot[:, :, : C.N_OBJECTS]
        objects = np.where(obj_ch.any(2), obj_ch.argmax(2) + 1, 0)
        r, c = self.env.agent_pos
        hold_ch = onehot[r, c, C.N_OBJECTS + 1 :]
        holding = int(hold_ch.argmax() + 1) if hold_ch.any() else 0
        return objects, (int(r), int(c)), holding

    def _forbidden(self, objects, holding, desired, achieved, allow=()):
        """Cells that must not be entered in transit."""
        bad = np.zeros_like(objects, bool)
        bad |= objects == C.ROCK  # blocked or undesired latch
        bad |= objects == C.TREE
        # bread underfoot is always eaten
        if not (desired[C.T_EAT_BREAD] and not achieved[C.T_EAT_BREAD]):
            bad |= objects == C.BREAD
        else:
            # eating desired: still avoid eating *extra* bread before its turn
            bad |= objects == C.BREAD
        if holding == C.HOLD_AXE:
            bad |= objects == C.WHEAT
        if holding == C.HOLD_HAMMER:
            bad |= objects == C.STICKS
        # while carrying an item whose Move* bit is desired and set, crossing
        # its origin cell would clear the bit (craftingworld_ray.py:670-702)
        if holding:
            move_bit = {C.HOLD_STICKS: C.T_MOVE_STICKS, C.HOLD_AXE: C.T_MOVE_AXE,
                        C.HOLD_HAMMER: C.T_MOVE_HAMMER}[holding]
            if desired[move_bit]:
                origin = self._tool_origin(holding)
                if origin is not None:
                    bad[origin] = True
                if holding == C.HOLD_STICKS:
                    # chopped-tree origin also counts as a sticks origin
                    tree_origin = self._tool_origin(C.TREE)
                    if tree_origin is not None:
                        bad[tree_origin] = True
        for cell in allow:
            bad[cell] = False
        return bad

    def _bfs_step(self, objects, start, goal_cells, bad):
        """First action of a shortest path from start to any goal cell."""
        H, W = objects.shape
        if not goal_cells:
            return None
        goals = set(goal_cells)
        if start in goals:
            return "arrived"
        prev = {start: None}
        q = deque([start])
        while q:
            cur = q.popleft()
            for dr, dc, act in _STEPS:
                nxt = (cur[0] + dr, cur[1] + dc)
                if not (0 <= nxt[0] < H and 0 <= nxt[1] < W):
                    continue
                if nxt in prev:
                    continue
                if bad[nxt] and nxt not in goals:
                    continue
                prev[nxt] = (cur, act)
                if nxt in goals:
                    # walk back to the first hop
                    node = nxt
                    while prev[node][0] != start:
                        node = prev[node][0]
                    return prev[node][1]
                q.append(nxt)
        return None

    # -- task routines -----------------------------------------------------

    def _cells_of(self, objects, code):
        return [tuple(x) for x in np.argwhere(objects == code)]

    def _tool_origin(self, tool_code):
        init = np.asarray(self.env._state.init_objects[0])
        hits = np.argwhere(init == tool_code)
        return tuple(hits[0]) if len(hits) else None

    def _protected_cells(self, holding=0):
        """Origin cells of pickupables (+ the tree's): never drop *foreign*
        items there — an object parked on another tool's origin makes that
        tool unreturnable, so its undesired Move* bit could never be cleared.
        The held item's own origin(s) are exempt: dropping it there is exactly
        how it is returned (sticks also return to a chopped tree's origin)."""
        own = {holding}
        if holding == C.HOLD_STICKS:
            own.add(C.TREE)
        cells = []
        for code in (C.STICKS, C.AXE, C.HAMMER, C.TREE):
            if code in own:
                continue
            origin = self._tool_origin(code)
            if origin is not None:
                cells.append(origin)
        return cells

    def _drop_targets(self, objects, holding):
        protected = set(self._protected_cells(holding))
        return [
            cell for cell in self._cells_of(objects, C.EMPTY)
            if cell not in protected
        ]

    def _goto(self, objects, agent, holding, desired, achieved, targets):
        bad = self._forbidden(objects, holding, desired, achieved, allow=targets)
        return self._bfs_step(objects, agent, targets, bad)

    def _fetch_tool(self, objects, agent, holding, desired, achieved, tool):
        """Actions to end up holding `tool` (code in HOLD_* space)."""
        if holding == tool:
            return None  # already have it
        if holding != 0:
            move_bit = {C.HOLD_STICKS: C.T_MOVE_STICKS, C.HOLD_AXE: C.T_MOVE_AXE,
                        C.HOLD_HAMMER: C.T_MOVE_HAMMER}[holding]
            if not desired[move_bit]:
                # dropping anywhere but the origin freezes the Move* bit at 1
                # (any move while carrying sets it) — carry the item home
                act = self._return_tool(objects, agent, holding, desired, achieved)
                if act is not None:
                    return act
            # drop current item on an empty, non-foreign-origin cell
            if objects[agent] == C.EMPTY and agent not in set(
                self._protected_cells(holding)
            ):
                return C.ACTION_DROP
            step = self._goto(
                objects, agent, holding, desired, achieved,
                self._drop_targets(objects, holding),
            )
            return step if step != "arrived" else C.ACTION_DROP
        item_code = tool  # HOLD_* codes == object codes for pickupables
        cells = self._cells_of(objects, item_code)
        if not cells:
            return None
        step = self._goto(objects, agent, holding, desired, achieved, cells)
        if step == "arrived":
            return C.ACTION_PICKUP
        return step

    def _return_tool(self, objects, agent, holding, desired, achieved):
        """Carry the held tool back to its origin and drop it there."""
        origin = self._tool_origin(holding)
        if origin is None:
            return C.ACTION_DROP if objects[agent] == C.EMPTY else None
        if agent == origin:
            return C.ACTION_DROP if objects[agent] == C.EMPTY else None
        step = self._goto(objects, agent, holding, desired, achieved, [origin])
        return step if step != "arrived" else None

    # -- main policy -------------------------------------------------------

    def action(self):
        """Next action for the current env state (None = no useful move)."""
        env = self.env
        objects, agent, holding = self._world()
        desired = np.asarray(env.desired_goal_vector).reshape(-1)
        achieved = np.asarray(env.achieved_goal_vector).reshape(-1)

        # 1. pending crafting/goto tasks in order
        for task in _TASK_ORDER:
            if not desired[task] or achieved[task]:
                continue
            if task == C.T_GO_TO_HOUSE and holding:
                # return an undesired-set tool BEFORE parking on the house —
                # walking off afterwards would clear the GoToHouse bit again
                move_bit = {
                    C.HOLD_STICKS: C.T_MOVE_STICKS,
                    C.HOLD_AXE: C.T_MOVE_AXE,
                    C.HOLD_HAMMER: C.T_MOVE_HAMMER,
                }[holding]
                if not desired[move_bit]:
                    act = self._return_tool(
                        objects, agent, holding, desired, achieved
                    )
                    if act is not None:
                        return act
            if task in _MOVE_ITEM:
                item = _MOVE_ITEM[task]
                if holding == item:
                    # step anywhere off the item's origin; bit will set
                    for dr, dc, act in _STEPS:
                        nxt = (agent[0] + dr, agent[1] + dc)
                        if (
                            0 <= nxt[0] < objects.shape[0]
                            and 0 <= nxt[1] < objects.shape[1]
                            and not self._forbidden(
                                objects, holding, desired, achieved
                            )[nxt]
                        ):
                            return act
                    return None
                act = self._fetch_tool(
                    objects, agent, holding, desired, achieved, item
                )
                if act is not None:
                    return act
                continue
            tool = _TOOL_FOR.get(task)
            if tool is not None and holding != tool:
                act = self._fetch_tool(
                    objects, agent, holding, desired, achieved, tool
                )
                if act is not None:
                    return act
                continue
            targets = self._cells_of(objects, _TARGET_FOR[task])
            if not targets:
                continue
            step = self._goto(objects, agent, holding, desired, achieved, targets)
            if step == "arrived":
                continue  # landing on the cell already applied the effect
            if step is not None:
                return step

        # 2. cleanup: clear undesired live bits
        #    (a) holding a tool whose Move* bit is set but undesired → return it
        if holding:
            move_bit = {C.HOLD_STICKS: C.T_MOVE_STICKS, C.HOLD_AXE: C.T_MOVE_AXE,
                        C.HOLD_HAMMER: C.T_MOVE_HAMMER}[holding]
            if not desired[move_bit]:
                act = self._return_tool(objects, agent, holding, desired, achieved)
                if act is not None:
                    return act
        #    (b) standing on a house with GoToHouse undesired → step off
        if achieved[C.T_GO_TO_HOUSE] and not desired[C.T_GO_TO_HOUSE]:
            for dr, dc, act in _STEPS:
                nxt = (agent[0] + dr, agent[1] + dc)
                if (
                    0 <= nxt[0] < objects.shape[0]
                    and 0 <= nxt[1] < objects.shape[1]
                    and objects[nxt] == C.EMPTY
                ):
                    return act
        return None

    def run_episode(self, max_steps=None):
        """Drive the env until success, stall, or step cap. Returns reward."""
        env = self.env
        limit = max_steps or env.MAX_STEPS
        reward = -1
        for _ in range(limit):
            act = self.action()
            if act is None:
                # stall: burn a step with a harmless move (eval may settle)
                act = C.ACTION_UP
            _, reward, done, _ = env.step(int(act))
            if done:
                break
        return reward
