"""Frozen, hashable environment configuration.

A copy of ``gym_craftingworld_tpu/config.py``: the port never imports the JAX
package, so it carries its own ``EnvConfig``, pinned field for field to the
JAX one by ``tests/test_torch_scaffold.py``.

Mirrors the reference constructor knobs
(``gym_craftingworld/envs/craftingworld_ray.py:59-60``):
``size, fixed_init_state, max_steps, store_gif, render_save_rate, task_list,
selected_tasks, number_of_tasks, stacking, reward_style`` — minus the
host-side-only GIF knobs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from gym_craftingworld_tpu_torch import constants as C


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment parameters.

    Attributes:
      height, width: grid size (reference ``STATE_W, STATE_H``; 21x21 Ray / 8x8 Flat).
      max_steps: episode cap; also the success reward value
        (craftingworld_ray.py:757-767 returns ``MAX_STEPS`` on success).
      stacking: if True, each reset samples 1..number_of_tasks tasks, else 1
        (craftingworld_ray.py:169).
      selected_task_indices: indices into the canonical 9-entry TASK_LIST that may
        be sampled as goals (reference ``selected_tasks`` resolved to indices).
      number_of_tasks: max number of simultaneous goal tasks.
      reward_equal: True → exact achieved==desired match required
        (``compute_reward_equal``); False → desired ⊆ achieved suffices
        (``compute_reward_subset``), i.e. reference ``reward_style`` non-None.
    """

    height: int = C.DEFAULT_SIZE[0]
    width: int = C.DEFAULT_SIZE[1]
    max_steps: int = C.DEFAULT_MAX_STEPS
    stacking: bool = True
    selected_task_indices: Tuple[int, ...] = tuple(range(C.N_TASKS))
    number_of_tasks: int = C.N_TASKS
    reward_equal: bool = True

    def __post_init__(self):
        if self.number_of_tasks > len(self.selected_task_indices):
            # Reference clamps (craftingworld_ray.py:80-81).
            object.__setattr__(
                self, "number_of_tasks", len(self.selected_task_indices)
            )
        if self.height * self.width < C.N_OBJECTS + 1:
            raise ValueError("grid too small to place one of each object + agent")

    @property
    def n_cells(self) -> int:
        return self.height * self.width

    @property
    def n_tasks(self) -> int:
        return C.N_TASKS

    def replace(self, **kw) -> "EnvConfig":
        return dataclasses.replace(self, **kw)


def ray_config(**kw) -> EnvConfig:
    """Defaults of ``craftingworld-v3`` (21x21, 300 steps)."""
    return EnvConfig(**kw)


def flat_config(**kw) -> EnvConfig:
    """Defaults of ``craftingworldflat-v3`` (8x8, 100 steps;
    craftingworld_flat.py:40-43)."""
    base = dict(height=C.FLAT_SIZE[0], width=C.FLAT_SIZE[1], max_steps=C.FLAT_MAX_STEPS)
    base.update(kw)
    return EnvConfig(**base)


def resolve_selected_tasks(selected_tasks) -> Tuple[int, ...]:
    """Map task-name strings (reference ``selected_tasks`` kwarg) to indices."""
    return tuple(C.TASK_LIST.index(t) for t in selected_tasks)
