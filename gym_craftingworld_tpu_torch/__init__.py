"""CraftingWorld on PyTorch and CUDA: the port of ``gym_craftingworld_tpu``.

The JAX package beside this one is the reference; this package imports
``torch``, numpy and the standard library only, and mirrors the JAX package's
module paths and public names. Batched state lives as integer tensors on an
explicit ``device``, and random draws come from an explicit
``torch.Generator``.

Ported so far: the headline path — reset a batch of worlds
(:mod:`.core.reset`), convert to the slot and packed layouts
(:mod:`.core.slots`, :mod:`.ops.packed_rollout`) and run the fused packed
rollout (:mod:`.ops.packed_fused`), whose CUDA kernels live in ``csrc/``.
The grid-layout ``step`` and ``rollout`` come with the grid-core slice.
"""

from gym_craftingworld_tpu_torch.config import EnvConfig, flat_config, ray_config
from gym_craftingworld_tpu_torch.core.reset import reset, reset_from_seed
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import StepResult

__version__ = "0.1.0"

__all__ = [
    "EnvConfig",
    "EnvState",
    "StepResult",
    "flat_config",
    "ray_config",
    "reset",
    "reset_from_seed",
]
