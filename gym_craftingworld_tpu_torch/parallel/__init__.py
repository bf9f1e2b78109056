from gym_craftingworld_tpu_torch.parallel.mesh import (
    ENV_AXIS,
    env_sharding,
    initialize_distributed,
    make_env_mesh,
    replicated,
    reset_sharded,
    scaling_report,
    shard_state,
)

__all__ = [
    "ENV_AXIS",
    "env_sharding",
    "initialize_distributed",
    "make_env_mesh",
    "replicated",
    "reset_sharded",
    "scaling_report",
    "shard_state",
]
