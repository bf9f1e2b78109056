from gym_craftingworld_tpu_torch.ops.fused_rollout import (
    fused_rollout,
    fused_rollout_actions,
)
from gym_craftingworld_tpu_torch.ops.packed_fused import (
    fused_action_stream,
    fused_rollout_packed,
    fused_rollout_packed_bench,
)
from gym_craftingworld_tpu_torch.ops.packed_rollout import (
    rollout_p,
    rollout_p_bench,
    rollout_p_random,
)

__all__ = [
    "fused_action_stream",
    "fused_rollout",
    "fused_rollout_actions",
    "fused_rollout_packed",
    "fused_rollout_packed_bench",
    "rollout_p",
    "rollout_p_bench",
    "rollout_p_random",
]
