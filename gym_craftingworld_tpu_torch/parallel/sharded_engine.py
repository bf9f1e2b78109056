"""The throughput engines and trainers over the env mesh.

Counterpart of ``gym_craftingworld_tpu/parallel/sharded_engine.py``. The
slot and packed layouts put the env batch on the last axis ([8, B] slot
arrays, [B] scalars; ``SlotState`` is batch-leading): a rank holds its
columns of each and runs the unsharded function on them. Stepping needs no
collective, so every sharded rollout equals the same columns of the
unsharded one, bit for bit.

The bench kernel draws its actions from a Philox stream keyed by the env's
index in the batch (``ops/packed_fused.py``), not by a seed per block as the
TPU kernel is: a rank passes the index of its first env (``env0``) and
draws the stream of the whole batch's envs. Its checksum is an int64
``all_reduce`` sum, the counterpart of JAX's ``psum``.

The trainers keep their gradient kernel under a mesh (JAX turns it off
there only because its raw ``pallas_call`` is not ``shard_map``-wrapped);
each rank launches its own. The auto-reset pool follows JAX's choice
(``gym_craftingworld_tpu/parallel/sharded_engine.py:83``): over several
ranks the keyed ``fresh_packed_batch``, drawn whole on each rank from the
replicated key, since its windows move across every column; on one rank the
pool kernel. Every rank holds the same key data and splits it alike; the
per-env draws (the Gumbel uniforms) are the rank's columns only, the same
values as the whole draw's there (``ops/keyed_draws.uniform_cols``).
"""

from __future__ import annotations

import torch

from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.slots import SlotState
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops.packed_rollout import PackedState, rollout_p
from gym_craftingworld_tpu_torch.parallel.mesh import (
    EnvMesh,
    Sharding,
    env_sharding,
    tree_map,
)


def shard_slots(slots: SlotState, mesh: EnvMesh) -> SlotState:
    """This rank's envs of a whole ``SlotState`` batch (batch-leading leaves)."""
    return tree_map(env_sharding(mesh).shard, slots)


def packed_lane_sharding(mesh: EnvMesh) -> PackedState:
    """Per-field shardings of a ``PackedState`` batch: the batch is the last
    axis of every field ([8, B] slot arrays, [B] scalars)."""
    return PackedState(*(Sharding(mesh, -1) for _ in PackedState._fields))


def shard_packed(env: PackedState, mesh: EnvMesh) -> PackedState:
    """This rank's columns of a whole ``PackedState`` batch."""
    return PackedState(*(s.shard(x) for s, x in zip(packed_lane_sharding(mesh), env)))


def _local_actions(actions: torch.Tensor, batch: int, mesh: EnvMesh) -> torch.Tensor:
    """This rank's columns of the whole batch's actions [T, B] (a shard's own
    actions [T, B / world] pass as they are)."""
    if actions.shape[-1] == batch:
        return actions
    if actions.shape[-1] != batch * mesh.size:
        raise ValueError(f"actions for {actions.shape[-1]} envs on a shard of {batch}")
    return actions[:, mesh.cols(actions.shape[-1])]


def rollout_p_sharded(cfg: EnvConfig, slots: SlotState, actions, num_steps: int,
                      mesh: EnvMesh):
    """The packed scan over this rank's envs: ``slots`` is its shard,
    ``actions`` int[T, B] of the whole batch or of the shard."""
    B = slots.agent.shape[0]
    return rollout_p(cfg, slots, _local_actions(actions, B, mesh), num_steps)


def fused_rollout_packed_sharded(cfg: EnvConfig, slots: SlotState, actions,
                                 num_steps: int, *, mesh: EnvMesh):
    """The actions kernel over this rank's envs; (SlotState, rewards, dones)
    of the shard."""
    B = slots.agent.shape[0]
    return pf.fused_rollout_packed(cfg, slots, _local_actions(actions, B, mesh).contiguous(),
                                   num_steps)


def fused_rollout_packed_bench_sharded(cfg: EnvConfig, slots: SlotState, seed: int,
                                       num_steps: int, *, mesh: EnvMesh):
    """The bench kernel over this rank's envs; (this rank's SlotState, the
    whole batch's int64 checksum).

    The shard's column ``b`` draws the stream of env ``rank * B_local + b``,
    so the checksum and the final states equal the unsharded run's.
    """
    B = slots.agent.shape[0]
    state, acc = pf.fused_rollout_packed_bench(cfg, slots, seed, num_steps,
                                               env0=mesh.rank * B)
    return state, mesh.all_reduce(acc)


def fast_train_step_sharded(cfg: EnvConfig, fppo, mesh: EnvMesh):
    """``train/fast_ppo.train_step_fast`` over this rank's columns of the
    packed batch; returns ``step(ts, env, key) -> (ts, env, key, metrics)``."""
    from gym_craftingworld_tpu_torch.train.fast_ppo import train_step_fast

    def step(ts, env, key):
        return train_step_fast(cfg, fppo, ts, env, key, mesh=mesh)

    return step


def pixel_train_step_sharded(cfg: EnvConfig, pppo, mesh: EnvMesh):
    """``train/fast_pixel_ppo.train_step_pixel`` over this rank's columns."""
    from gym_craftingworld_tpu_torch.train.fast_pixel_ppo import train_step_pixel

    def step(ts, env, key):
        return train_step_pixel(cfg, pppo, ts, env, key, mesh=mesh)

    return step
