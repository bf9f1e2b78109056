"""World constants for the TPU-native CraftingWorld engine.

Mirrors the world definition of the reference implementation
(`gym_craftingworld/envs/craftingworld_ray.py:20-46`), but uses a
*packed integer* encoding instead of the reference's per-cell 12-channel one-hot:

  - cell object code (int8): 0 = empty, 1..8 = OBJECTS[code-1]
    (i.e. reference channel ``c`` maps to packed code ``c + 1``)
  - holding code (int32):    0 = empty-handed, 1..3 = PICKUPABLE[code-1]
  - init-cell code (int8):   like object code, plus 9 = "agent started here"

The packed form is what lives on TPU: an ``int8[B, H, W]`` grid plus a couple of
small per-env scalars, so tens of thousands of env instances step in lockstep
under ``jit``/``vmap`` with no per-cell Python.
"""

from __future__ import annotations

import numpy as np

# --- object / task vocabulary (reference craftingworld_ray.py:20-21,40-41) ---

PICKUPABLE = ("sticks", "axe", "hammer")
OBJECTS = ("sticks", "axe", "hammer", "rock", "tree", "bread", "house", "wheat")

TASK_LIST = (
    "MakeBread",
    "EatBread",
    "BuildHouse",
    "ChopTree",
    "ChopRock",
    "GoToHouse",
    "MoveAxe",
    "MoveHammer",
    "MoveSticks",
)
N_TASKS = len(TASK_LIST)

# Packed object codes (0 = empty cell).
EMPTY = 0
STICKS = 1
AXE = 2
HAMMER = 3
ROCK = 4
TREE = 5
BREAD = 6
HOUSE = 7
WHEAT = 8
AGENT_INIT_MARK = 9  # only valid inside `init_objects`: "agent started on this cell"

N_OBJECTS = len(OBJECTS)  # 8
N_CHANNELS = N_OBJECTS + 1 + len(PICKUPABLE)  # 12-channel reference one-hot width

# Packed holding codes (0 = not holding).
HOLD_NONE = 0
HOLD_STICKS = 1
HOLD_AXE = 2
HOLD_HAMMER = 3

# Task bit indices (order of TASK_LIST).
T_MAKE_BREAD = 0
T_EAT_BREAD = 1
T_BUILD_HOUSE = 2
T_CHOP_TREE = 3
T_CHOP_ROCK = 4
T_GO_TO_HOUSE = 5
T_MOVE_AXE = 6
T_MOVE_HAMMER = 7
T_MOVE_STICKS = 8

# --- actions (reference craftingworld_ray.py:130-133) ---

ACTION_UP = 0
ACTION_RIGHT = 1
ACTION_DOWN = 2
ACTION_LEFT = 3
ACTION_PICKUP = 4
ACTION_DROP = 5
N_ACTIONS = 6

ACTION_NAMES = ("up", "right", "down", "left", "pickup", "drop")

# Row/col deltas for the four movement actions, padded with (0, 0) for
# pickup/drop so the table can be indexed by any action id under jit.
ACTION_DELTAS = np.array(
    [[-1, 0], [0, 1], [1, 0], [0, -1], [0, 0], [0, 0]], dtype=np.int32
)

# --- default sizes (craftingworld_ray.py:43-46 / craftingworld_flat.py:40-43) ---

DEFAULT_SIZE = (21, 21)
DEFAULT_MAX_STEPS = 300
FLAT_SIZE = (8, 8)
FLAT_MAX_STEPS = 100

# --- render palettes (craftingworld_ray.py:26-38) ---

# Per-object RGB, indexed by reference channel 0..7.
COLORS = np.array(
    [
        (110, 69, 39),
        (255, 105, 180),
        (100, 100, 200),
        (100, 100, 100),
        (0, 128, 0),
        (205, 133, 63),
        (197, 91, 97),
        (240, 230, 140),
    ],
    dtype=np.int64,
)

# Palette with black prepended: directly indexable by *packed* object code 0..8.
COLORS_N = np.concatenate([np.zeros((1, 3), dtype=np.int64), COLORS], axis=0)

# Holding-stripe palette; chosen by the reference such that 255 - COLORS_H[i]
# equals COLORS_N[i + 1] for the three pickupable items (craftingworld_ray.py:31).
COLORS_H = np.array([[145, 186, 216], [0, 150, 75], [155, 155, 55]], dtype=np.int64)

# --- AltObs variant palette (craftingworld_altobs.py:26-53) ---

CPV_COLORS = np.array(
    [
        (45, 82, 160),
        (255, 102, 102),
        (204, 204, 0),
        (211, 211, 211),
        (34, 133, 34),
        (0, 215, 255),
        (153, 52, 255),
        (10, 215, 100),
        (0, 0, 255),
    ],
    dtype=np.int64,
)
# 3x3 tile of per-slot colors: channel k renders at pixel (k // 3, k % 3).
CPV_TILE_COLORS = CPV_COLORS.reshape(3, 3, 3)
