from gym_craftingworld_tpu_torch.core.reset import (
    reset,
    reset_from_draws,
    reset_from_seed,
)
from gym_craftingworld_tpu_torch.core.slots import SlotState, from_env_state, to_grid
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import StepResult

__all__ = [
    "EnvState",
    "SlotState",
    "StepResult",
    "from_env_state",
    "reset",
    "reset_from_draws",
    "reset_from_seed",
    "to_grid",
]
