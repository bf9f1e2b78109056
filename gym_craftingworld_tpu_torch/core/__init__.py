from gym_craftingworld_tpu_torch.core.reset import (
    generate_pool,
    reset,
    reset_from_draws,
    reset_from_pool,
    reset_from_seed,
)
from gym_craftingworld_tpu_torch.core.rollout import rollout, rollout_random
from gym_craftingworld_tpu_torch.core.slots import (
    SlotState,
    from_env_state,
    rollout_slots_random,
    step_slots,
    to_grid,
)
from gym_craftingworld_tpu_torch.core.state import EnvState, state_from_reference
from gym_craftingworld_tpu_torch.core.step import StepResult, compute_reward, step
from gym_craftingworld_tpu_torch.core.validate import assert_valid_state, check_state

__all__ = [
    "EnvState",
    "SlotState",
    "StepResult",
    "assert_valid_state",
    "check_state",
    "compute_reward",
    "from_env_state",
    "generate_pool",
    "reset",
    "reset_from_draws",
    "reset_from_pool",
    "reset_from_seed",
    "rollout",
    "rollout_random",
    "rollout_slots_random",
    "state_from_reference",
    "step",
    "step_slots",
    "to_grid",
]
