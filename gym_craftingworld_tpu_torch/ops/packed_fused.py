"""Fused rollouts over the packed-key int16 layout: CUDA kernels and their plain versions.

Counterpart of ``gym_craftingworld_tpu/ops/packed_fused.py``, whose three
Pallas kernels become the CUDA kernels of ``csrc/packed_fused.cu`` (one
thread per env, the whole packed state in registers for all T steps):

* ``rollout_packed_bench``   — T steps with actions from the Philox stream;
  final state + one int32 reward sum per env (the headline bench);
* ``rollout_packed_actions`` — T steps over a given action slab; rewards and
  dones per step;
* ``fused_action_stream``    — the bench kernel's action stream alone.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (``*_plain``, beside it) for a CPU tensor; there is no other
dispatch and no fallback. Each counts its kernel launches in its plain
integer attribute ``launches``, and each plain version its calls in ``calls``.

The public entry points keep the JAX signatures, minus ``interpret=`` and
``block=``: they run ``transpose_in`` → ``pack`` → wrapper → ``unpack`` →
``transpose_out`` in plain torch around the launch.

The action of env ``b`` at step ``t`` is word ``t % 4`` of Philox4x32-10
(``ops/philox.py``) with counter ``(t // 4, b, 0, 0)`` and key
``(seed, ACTION_KEY)``, reduced ``% 6``: it depends on ``(seed, b, t)`` only,
so the plain versions reproduce the kernels' draws exactly. ``b`` is the
env's index in the whole batch: a shard whose first env is ``env0`` of the
batch passes ``env0`` and draws env ``env0 + b``'s stream for its column
``b`` (``parallel/sharded_engine.py``). It is not the
TPU kernels' stream, so the bench checksum is comparable to JAX ``rollout_p``
fed this stream, not to the TPU's checksum.
"""

from __future__ import annotations

import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.slots import SlotState
from gym_craftingworld_tpu_torch.core.step import scan
from gym_craftingworld_tpu_torch.ops import _build
from gym_craftingworld_tpu_torch.ops.packed_rollout import (
    PackedState,
    _init_rows,
    _step_p_unrolled,
    pack,
    unpack,
)
from gym_craftingworld_tpu_torch.ops.philox import MASK32, philox4x32
from gym_craftingworld_tpu_torch.ops.transposed_rollout import (
    transpose_in,
    transpose_out,
)

# second Philox key word of the action stream ("CWOR"); csrc/philox.cuh
ACTION_KEY = 0x43574F52

_SLOT_FIELDS = ("slot_key", "slot_type", "init_key", "init_type")
_CONST_FIELDS = ("init_key", "init_type", "desired", "init_agent_key")
# the 9 mutable fields, the kernels' outputs in this order
_OUT_FIELDS = tuple(f for f in PackedState._fields if f not in _CONST_FIELDS)


# --------------------------------------------------------------------------
# Plain versions: the CPU path, and what the kernels are held against.
# --------------------------------------------------------------------------


def action_stream_plain(batch_size: int, seed: int, num_steps: int,
                        device="cpu", env0: int = 0) -> torch.Tensor:
    """The Philox action stream of envs ``env0 .. env0 + B - 1`` as
    int32[T, B], in plain torch."""
    action_stream_plain.calls += 1
    n4 = (num_steps + 3) // 4
    t4 = torch.arange(n4, dtype=torch.int64, device=device)[:, None]
    env = torch.arange(env0, env0 + batch_size, dtype=torch.int64, device=device)[None, :]
    t4, env = torch.broadcast_tensors(t4, env)
    zero = torch.zeros_like(t4)
    words = philox4x32((t4, env, zero, zero), (seed & MASK32, ACTION_KEY))
    stream = torch.stack(words, dim=1).reshape(4 * n4, batch_size)[:num_steps]
    return (stream % C.N_ACTIONS).to(torch.int32)


def rollout_packed_actions_plain(cfg: EnvConfig, p: PackedState,
                                 actions: torch.Tensor):
    """Plain version of the actions kernel: (PackedState, reward int32[T, B], done bool[T, B])."""
    rollout_packed_actions_plain.calls += 1
    p, out = scan(lambda s, a: _step_p_unrolled(cfg, s, a), p, actions)
    return p, out.reward, out.done


def rollout_packed_bench_plain(cfg: EnvConfig, p: PackedState, seed: int,
                               num_steps: int, env0: int = 0):
    """Plain version of the bench kernel: (PackedState, int32[B] reward sums)."""
    rollout_packed_bench_plain.calls += 1
    B = p.agent_r.shape[0]
    actions = action_stream_plain(B, seed, num_steps, p.agent_r.device, env0)
    acc = torch.zeros((B,), dtype=torch.int32, device=p.agent_r.device)
    for t in range(num_steps):
        p, res = _step_p_unrolled(cfg, p, actions[t])
        acc += res.reward
    return p, acc


action_stream_plain.calls = 0
rollout_packed_actions_plain.calls = 0
rollout_packed_bench_plain.calls = 0


# --------------------------------------------------------------------------
# Wrappers: kernel for a CUDA tensor, plain version for a CPU tensor.
# --------------------------------------------------------------------------


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _check_packed(p: PackedState) -> int:
    """Validate a packed state for the kernels; returns B."""
    B = p.agent_r.shape[0]
    for f in PackedState._fields:
        x = getattr(p, f)
        shape = (8, B) if f in _SLOT_FIELDS else (B,)
        if x.dtype != torch.int16 or tuple(x.shape) != shape:
            raise ValueError(f"{f}: want int16{list(shape)}, got "
                             f"{x.dtype}{list(x.shape)}")
        if not x.is_contiguous() or x.device != p.agent_r.device:
            raise ValueError(f"{f}: must be contiguous on {p.agent_r.device}")
    return B


def _kernel_io(p: PackedState):
    """(new state sharing the const fields, host arrays of in/out pointers)."""
    out = p._replace(**{f: torch.empty_like(getattr(p, f)) for f in _OUT_FIELDS})
    ins = _build.pointer_array([getattr(p, f) for f in PackedState._fields])
    outs = _build.pointer_array([getattr(out, f) for f in _OUT_FIELDS])
    return out, ins, outs


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def rollout_packed_bench(cfg: EnvConfig, p: PackedState, seed: int,
                         num_steps: int, env0: int = 0):
    """T Philox-action steps; (PackedState, int32[B] per-env reward sums).

    Column ``b`` draws the stream of env ``env0 + b`` of the whole batch.
    """
    if not _on_cuda(p.agent_r):
        return rollout_packed_bench_plain(cfg, p, seed, num_steps, env0)
    if not 0 <= env0 <= MASK32 - p.agent_r.shape[0]:
        raise ValueError(f"env0 {env0} out of the stream's 32-bit env range")
    B = _check_packed(p)
    lib = _build.load()
    out, ins, outs = _kernel_io(p)
    checksum = torch.empty((B,), dtype=torch.int32, device=p.agent_r.device)
    code = lib.cw_packed_bench(
        ins, outs, checksum.data_ptr(), B, num_steps, cfg.height, cfg.width,
        cfg.max_steps, int(cfg.reward_equal), seed & MASK32, env0,
        _stream(p.agent_r.device))
    _build.check("cw_packed_bench", code)
    rollout_packed_bench.launches += 1
    return out, checksum


def rollout_packed_actions(cfg: EnvConfig, p: PackedState, actions: torch.Tensor):
    """Step actions int[T, B]; (PackedState, reward int32[T, B], done bool[T, B])."""
    if not _on_cuda(p.agent_r):
        return rollout_packed_actions_plain(cfg, p, actions)
    B = _check_packed(p)
    T = actions.shape[0]
    if actions.dtype != torch.int32 or tuple(actions.shape) != (T, B):
        raise ValueError(f"actions: want int32[T, {B}], got "
                         f"{actions.dtype}{list(actions.shape)}")
    if not actions.is_contiguous() or actions.device != p.agent_r.device:
        raise ValueError(f"actions: must be contiguous on {p.agent_r.device}")
    lib = _build.load()
    out, ins, outs = _kernel_io(p)
    reward = torch.empty((T, B), dtype=torch.int32, device=actions.device)
    done = torch.empty((T, B), dtype=torch.bool, device=actions.device)
    code = lib.cw_packed_actions(
        ins, outs, actions.data_ptr(), reward.data_ptr(), done.data_ptr(), B, T,
        cfg.height, cfg.width, cfg.max_steps, int(cfg.reward_equal),
        _stream(actions.device))
    _build.check("cw_packed_actions", code)
    rollout_packed_actions.launches += 1
    return out, reward, done


def fused_action_stream(B: int, seed: int, num_steps: int, device="cuda"):
    """The bench kernel's action stream, as int32[T, B] on ``device`` (the card
    unless asked for the CPU)."""
    device = torch.device(device)
    if device.type == "cpu":
        return action_stream_plain(B, seed, num_steps, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((num_steps, B), dtype=torch.int32, device=device)
    code = _build.load().cw_action_stream(out.data_ptr(), B, num_steps, seed & MASK32,
                                _stream(device))
    _build.check("cw_action_stream", code)
    fused_action_stream.launches += 1
    return out


rollout_packed_bench.launches = 0
rollout_packed_actions.launches = 0
fused_action_stream.launches = 0


# --------------------------------------------------------------------------
# Entry points, with the JAX signatures.
# --------------------------------------------------------------------------


def fused_rollout_packed_bench(cfg: EnvConfig, slots: SlotState, seed: int,
                               num_steps: int, env0: int = 0):
    """T random steps; returns (SlotState, int64 reward checksum).

    The checksum is the sum over envs and steps of the rewards, taken in
    int64 (the JAX version's int32 sum wraps at large B*T). ``env0``: the
    batch index of the first env, when ``slots`` is a shard of a batch.
    """
    ts = transpose_in(slots)
    p = pack(cfg, ts)
    p, acc = rollout_packed_bench(cfg, p, seed, num_steps, env0)
    state = transpose_out(unpack(cfg, p, ts.desired, _init_rows(ts)), slots.rng)
    return state, acc.sum(dtype=torch.int64)


def fused_rollout_packed(cfg: EnvConfig, slots: SlotState, actions: torch.Tensor,
                         num_steps: int):
    """Step given actions int[T, B]; returns (SlotState, rewards, dones)."""
    del num_steps
    ts = transpose_in(slots)
    p = pack(cfg, ts)
    p, reward, done = rollout_packed_actions(
        cfg, p, actions.to(torch.int32).contiguous())
    state = transpose_out(unpack(cfg, p, ts.desired, _init_rows(ts)), slots.rng)
    return state, reward, done
