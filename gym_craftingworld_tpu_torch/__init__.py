"""CraftingWorld on PyTorch and CUDA: the port of ``gym_craftingworld_tpu``.

The JAX package beside this one is the reference; this package imports
``torch``, numpy and the standard library only, and mirrors the JAX package's
module paths and public names. Batched state lives as integer tensors on an
explicit ``device``, and random draws come from JAX's key data
(``ops/threefry``, ``ops/keyed_draws``), bit for bit as ``jax.random`` draws
them, or, in the tools still queued, from an explicit ``torch.Generator``.

Ported so far:

- the grid core: reset (:mod:`.core.reset`, pools included), ``step``
  (:mod:`.core.step`), ``rollout`` with auto-reset (:mod:`.core.rollout`) and
  the state checks (:mod:`.core.validate`);
- the engine ladder above it: the slot layout (:mod:`.core.slots`), the
  transposed layout (:mod:`.ops.transposed_rollout`), the packed layout
  (:mod:`.ops.packed_rollout`), and the fused rollouts over the slot layouts
  (:mod:`.ops.fused_rollout`, :mod:`.ops.fused_rollout_t`) and the packed
  layout (:mod:`.ops.packed_fused`);
- the fast-PPO trainer (:mod:`.train.fast_ppo`) with its world-pool and
  gradient kernels (:mod:`.ops.fused_reset`, :mod:`.ops.fused_update`);
- the front end: the renderers (:mod:`.render`), the observation-interleaved
  rollout (:mod:`.ops.obs_rollout`), the policy features
  (:mod:`.models.actor_critic`, features only), the four Gym env variants,
  the vector env and the registry (:mod:`.api`), and parity-mode resets with
  the reference oracle's loader and gym shim (:mod:`.parity`);
- pixel PPO (:mod:`.train.fast_pixel_ppo`), the flax policy families
  (:mod:`.models`) with their PPO trainer and evaluator (:mod:`.train.ppo`,
  :mod:`.train.evaluate`);
- the imitation path: snapshot demos (:mod:`.train.demos`), BC and DAgger of
  the grid policy and the CPV family (:mod:`.train.dagger`,
  :mod:`.models.grid_policy`, :mod:`.models.cpv`), the flat BC path
  (:mod:`.train.bc`), and recurrent PPO (:mod:`.models.rnn`,
  :mod:`.train.ppo_rnn`).

The CUDA kernels live in ``csrc/``.
"""

from gym_craftingworld_tpu_torch.config import EnvConfig, flat_config, ray_config
from gym_craftingworld_tpu_torch.core.reset import reset, reset_from_seed
from gym_craftingworld_tpu_torch.core.rollout import rollout, rollout_random
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import StepResult, step

__version__ = "0.1.0"

__all__ = [
    "EnvConfig",
    "EnvState",
    "StepResult",
    "flat_config",
    "ray_config",
    "reset",
    "reset_from_seed",
    "rollout",
    "rollout_random",
    "step",
]
