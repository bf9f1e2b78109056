"""Fused rollouts over the ``[B, 8]`` slot layout: a CUDA kernel and its plain versions.

Counterpart of ``gym_craftingworld_tpu/ops/fused_rollout.py``, whose two
Pallas kernels become one CUDA kernel template in ``csrc/fused_rollout.cu``
(one thread per env, the whole slot state in registers for all T steps):

* ``fused_rollout``         — T steps with actions from the Philox stream of
  ``ops/packed_fused.py`` (the action of env ``b`` at step ``t`` depends on
  ``(seed, b, t)`` alone); final state + rewards and dones per step;
* ``fused_rollout_actions`` — T steps over a given action slab.

Each wrapper (``rollout_slots_seeded``, ``rollout_slots_actions``) launches
the kernel for a CUDA tensor and runs its plain version (``*_plain``, T steps
of ``core/slots.py::step_slots``) for a CPU tensor; there is no other
dispatch and no fallback. Each counts its kernel launches in its plain
integer attribute ``launches``, and each plain version its calls in ``calls``.

The entry points keep the JAX signatures, minus the block size: any B works.
They return ``(SlotState, rewards int32[T, B], dones bool[T, B])`` with the
dtypes of the JAX ``_unpack_outputs``; the input state is not modified.
"""

from __future__ import annotations

import torch

from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.slots import SlotState, step_slots
from gym_craftingworld_tpu_torch.core.step import scan
from gym_craftingworld_tpu_torch.ops import _build
from gym_craftingworld_tpu_torch.ops.packed_fused import (
    _on_cuda,
    _stream,
    action_stream_plain,
)
from gym_craftingworld_tpu_torch.ops.philox import MASK32

# the kernel's inputs and outputs, in the order of csrc/slot_step.cuh RowsLayout
_IN_FIELDS = ("slot_type", "slot_pos", "slot_stat", "agent", "desired", "achieved",
              "init_type", "init_pos", "init_agent", "step_num")
_OUT_FIELDS = ("slot_type", "slot_pos", "slot_stat", "agent", "achieved", "step_num")


# byte alignment of the fields the kernel reads and writes as vectors
_ALIGN = dict(slot_type=16, slot_pos=16, slot_stat=16, init_type=16, init_pos=16,
              agent=8, init_agent=8)


def _shapes(B: int) -> dict:
    i32, i8 = torch.int32, torch.int8
    return dict(slot_type=(i32, (B, 8)), slot_pos=(i32, (B, 8, 2)),
                slot_stat=(i32, (B, 8)), agent=(i32, (B, 2)), desired=(i8, (B, 9)),
                achieved=(i8, (B, 9)), init_type=(i32, (B, 8)),
                init_pos=(i32, (B, 8, 2)), init_agent=(i32, (B, 2)),
                step_num=(i32, (B,)))


# --------------------------------------------------------------------------
# Plain versions: the CPU path, and what the kernel is held against.
# --------------------------------------------------------------------------


def rollout_slots_actions_plain(cfg: EnvConfig, slots: SlotState, actions: torch.Tensor):
    """T steps of ``step_slots`` over ``actions`` int[T, B]: (SlotState, reward, done)."""
    rollout_slots_actions_plain.calls += 1
    slots, out = scan(lambda s, a: step_slots(cfg, s, a), slots, actions)
    return slots, out.reward, out.done


def rollout_slots_seeded_plain(cfg: EnvConfig, slots: SlotState, seed: int,
                               num_steps: int):
    """As ``rollout_slots_actions_plain`` over the Philox action stream of ``seed``."""
    rollout_slots_seeded_plain.calls += 1
    B = slots.agent.shape[0]
    actions = action_stream_plain(B, seed, num_steps, slots.agent.device)
    slots, out = scan(lambda s, a: step_slots(cfg, s, a), slots, actions)
    return slots, out.reward, out.done


rollout_slots_actions_plain.calls = 0
rollout_slots_seeded_plain.calls = 0


# --------------------------------------------------------------------------
# Wrappers: kernel for a CUDA tensor, plain version for a CPU tensor.
# --------------------------------------------------------------------------


def _check_slots(slots: SlotState) -> int:
    """Validate a slot state for the kernel; returns B."""
    B = slots.agent.shape[0]
    dev = slots.agent.device
    for f, (dtype, shape) in _shapes(B).items():
        x = getattr(slots, f)
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{f}: want {dtype}{list(shape)}, got {x.dtype}{list(x.shape)}")
        if not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{f}: must be contiguous on {dev}")
        if x.data_ptr() % _ALIGN.get(f, 1):
            raise ValueError(f"{f}: must be {_ALIGN[f]}-byte aligned")
    return B


def _launch(cfg: EnvConfig, slots: SlotState, actions, seed: int, T: int):
    B = _check_slots(slots)
    dev = slots.agent.device
    lib = _build.load()
    out = {f: torch.empty_like(getattr(slots, f)) for f in _OUT_FIELDS}
    reward = torch.empty((T, B), dtype=torch.int32, device=dev)
    done = torch.empty((T, B), dtype=torch.bool, device=dev)
    code = lib.cw_fused_rollout(
        _build.pointer_array([getattr(slots, f) for f in _IN_FIELDS]),
        _build.pointer_array([out[f] for f in _OUT_FIELDS]),
        None if actions is None else actions.data_ptr(), reward.data_ptr(),
        done.data_ptr(), B, T, cfg.height, cfg.width, cfg.max_steps,
        int(cfg.reward_equal), seed & MASK32, _stream(dev))
    _build.check("cw_fused_rollout", code)
    return slots._replace(**out), reward, done


def rollout_slots_seeded(cfg: EnvConfig, slots: SlotState, seed: int, num_steps: int):
    """T Philox-action steps; (SlotState, reward int32[T, B], done bool[T, B])."""
    if not _on_cuda(slots.agent):
        return rollout_slots_seeded_plain(cfg, slots, seed, num_steps)
    result = _launch(cfg, slots, None, seed, num_steps)
    rollout_slots_seeded.launches += 1
    return result


def rollout_slots_actions(cfg: EnvConfig, slots: SlotState, actions: torch.Tensor):
    """Step actions int32[T, B]; (SlotState, reward int32[T, B], done bool[T, B])."""
    if not _on_cuda(slots.agent):
        return rollout_slots_actions_plain(cfg, slots, actions)
    T, B = actions.shape
    if actions.dtype != torch.int32 or B != slots.agent.shape[0]:
        raise ValueError(f"actions: want int32[T, {slots.agent.shape[0]}], got "
                         f"{actions.dtype}{list(actions.shape)}")
    if not actions.is_contiguous() or actions.device != slots.agent.device:
        raise ValueError(f"actions: must be contiguous on {slots.agent.device}")
    result = _launch(cfg, slots, actions, 0, T)
    rollout_slots_actions.launches += 1
    return result


rollout_slots_seeded.launches = 0
rollout_slots_actions.launches = 0


# --------------------------------------------------------------------------
# Entry points, with the JAX signatures.
# --------------------------------------------------------------------------


def _canonical(slots: SlotState) -> SlotState:
    """The fields in the kernel's dtypes, contiguous and aligned (the JAX
    ``_pack_inputs`` casts); a field already so is passed as it is."""
    def one(f, dtype):
        x = getattr(slots, f).to(dtype).contiguous()
        return x.clone() if x.data_ptr() % _ALIGN.get(f, 1) else x

    B = slots.agent.shape[0]
    return slots._replace(**{f: one(f, dtype) for f, (dtype, _) in _shapes(B).items()})


def fused_rollout_actions(cfg: EnvConfig, slots: SlotState, actions: torch.Tensor):
    """Fused rollout consuming an explicit ``actions int[T, B]`` tensor.

    Returns ``(new_slots, rewards int32[T, B], dones bool[T, B])``.
    """
    return rollout_slots_actions(cfg, _canonical(slots),
                                 actions.to(torch.int32).contiguous())


def fused_rollout(cfg: EnvConfig, slots: SlotState, seed: int, num_steps: int):
    """Run ``num_steps`` random-action steps in one kernel launch.

    Returns ``(new_slots, rewards int32[T, B], dones bool[T, B])``. The
    actions are the Philox stream of ``seed`` (``fused_action_stream``), so
    ``fused_rollout_actions`` fed that stream gives the same result.
    """
    return rollout_slots_seeded(cfg, _canonical(slots), seed, num_steps)
