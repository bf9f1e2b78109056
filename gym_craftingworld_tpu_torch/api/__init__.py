from gym_craftingworld_tpu_torch.api.gym_env import (
    CraftingWorldEnvAltObs,
    CraftingWorldEnvFlat,
    CraftingWorldEnvOneHot,
    CraftingWorldEnvRay,
)
from gym_craftingworld_tpu_torch.api.registry import make, register, register_gymnasium
from gym_craftingworld_tpu_torch.api.vector import CraftingWorldVectorEnv

__all__ = [
    "CraftingWorldEnvAltObs",
    "CraftingWorldEnvFlat",
    "CraftingWorldEnvOneHot",
    "CraftingWorldEnvRay",
    "CraftingWorldVectorEnv",
    "make",
    "register",
    "register_gymnasium",
]
