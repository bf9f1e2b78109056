"""Step outputs.

Counterpart of ``gym_craftingworld_tpu/core/step.py``. Only ``StepResult`` is
ported so far: the packed engines (``ops/packed_rollout.py``,
``ops/packed_fused.py``) return it. The grid-layout ``step`` comes with the
grid-core slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StepResult(NamedTuple):
    reward: torch.Tensor  # int32[B]
    done: torch.Tensor  # bool[B]
    changed: torch.Tensor  # bool[B] — reference `changed_state`
