"""Fused rollout in the transposed ``[8, B]`` slot layout: a CUDA kernel and its plain version.

Counterpart of ``gym_craftingworld_tpu/ops/fused_rollout_t.py``, whose Pallas
kernel becomes ``cw_fused_rollout_t`` in ``csrc/fused_rollout.cu``: the step
of ``ops/fused_rollout.py``'s kernel over the ``TSlotState`` layout, one
thread per env, actions from the Philox stream of ``ops/packed_fused.py``.

``rollout_t_seeded`` launches the kernel for a CUDA tensor and runs its plain
version ``rollout_t_seeded_plain`` (T steps of
``ops/transposed_rollout.py::_step_t``) for a CPU tensor; it counts its
launches in ``launches``, the plain version its calls in ``calls``. The entry
point ``fused_rollout_t`` keeps the JAX signature, minus the block size, and
runs ``transpose_in`` and ``transpose_out`` around the wrapper; the input
state is not modified.
"""

from __future__ import annotations

import torch

from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.slots import SlotState
from gym_craftingworld_tpu_torch.core.step import scan
from gym_craftingworld_tpu_torch.ops import _build
from gym_craftingworld_tpu_torch.ops.packed_fused import (
    _on_cuda,
    _stream,
    action_stream_plain,
)
from gym_craftingworld_tpu_torch.ops.philox import MASK32
from gym_craftingworld_tpu_torch.ops.transposed_rollout import (
    TSlotState,
    _step_t,
    transpose_in,
    transpose_out,
)

# the 8 fields a step changes, the kernel's outputs in this order
_OUT_FIELDS = ("slot_type", "slot_pos_r", "slot_pos_c", "slot_stat", "agent_r",
               "agent_c", "achieved", "step_num")


def rollout_t_seeded_plain(cfg: EnvConfig, ts: TSlotState, seed: int, num_steps: int):
    """T steps of ``_step_t`` over the Philox stream: (TSlotState, reward, done)."""
    rollout_t_seeded_plain.calls += 1
    B = ts.agent_r.shape[0]
    actions = action_stream_plain(B, seed, num_steps, ts.agent_r.device)
    ts, out = scan(lambda s, a: _step_t(cfg, s, a), ts, actions)
    return ts, out.reward, out.done


rollout_t_seeded_plain.calls = 0


def _check_t(ts: TSlotState) -> int:
    """Validate a transposed state for the kernel; returns B."""
    B = ts.agent_r.shape[0]
    for f in TSlotState._fields:
        x = getattr(ts, f)
        rows = {"desired": 9, "achieved": 9}.get(f, 8)
        shape = (B,) if x.dim() == 1 else (rows, B)
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{f}: want int32{list(shape)}, got {x.dtype}{list(x.shape)}")
        if not x.is_contiguous() or x.device != ts.agent_r.device:
            raise ValueError(f"{f}: must be contiguous on {ts.agent_r.device}")
    return B


def rollout_t_seeded(cfg: EnvConfig, ts: TSlotState, seed: int, num_steps: int):
    """T Philox-action steps; (TSlotState, reward int32[T, B], done bool[T, B])."""
    if not _on_cuda(ts.agent_r):
        return rollout_t_seeded_plain(cfg, ts, seed, num_steps)
    B = _check_t(ts)
    dev = ts.agent_r.device
    lib = _build.load()
    out = {f: torch.empty_like(getattr(ts, f)) for f in _OUT_FIELDS}
    reward = torch.empty((num_steps, B), dtype=torch.int32, device=dev)
    done = torch.empty((num_steps, B), dtype=torch.bool, device=dev)
    code = lib.cw_fused_rollout_t(
        _build.pointer_array(list(ts)), _build.pointer_array([out[f] for f in _OUT_FIELDS]),
        reward.data_ptr(), done.data_ptr(), B, num_steps, cfg.height, cfg.width,
        cfg.max_steps, int(cfg.reward_equal), seed & MASK32, _stream(dev))
    _build.check("cw_fused_rollout_t", code)
    rollout_t_seeded.launches += 1
    return ts._replace(**out), reward, done


rollout_t_seeded.launches = 0


def fused_rollout_t(cfg: EnvConfig, slots: SlotState, seed: int, num_steps: int):
    """T random-action steps in one transposed-layout kernel launch.

    Returns ``(new_slots, rewards int32[T, B], dones bool[T, B])``; the actions
    are the Philox stream of ``seed``, as in ``fused_rollout``.
    """
    ts, rewards, dones = rollout_t_seeded(cfg, transpose_in(slots), seed, num_steps)
    return transpose_out(ts, slots.rng), rewards, dones
