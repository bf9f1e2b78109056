"""The port's fused packed rollouts on the CPU, where they take their plain
versions, against the JAX package.

The CUDA kernels cannot run here; chip_smoke.py holds each one against its
plain version on the card. Every value is an integer: comparisons are exact.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.core import slots as jsm
from gym_craftingworld_tpu.ops import packed_rollout as jpr
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core import slots as tsm
from gym_craftingworld_tpu_torch.ops import _build
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops import philox

from test_torch_packed_rollout import (
    assert_tree_equal,
    crafting_actions,
    jax_and_port_slots,
    np_tree,
    tcfg,
)
from test_torch_reset import port_reset_like_jax

jpf = importlib.import_module("gym_craftingworld_tpu.ops.packed_fused")

torch.set_num_threads(1)


@pytest.mark.parametrize("cfg,seed,B,T", [
    (jcw.ray_config(), 0, 256, 64),
    (jcw.flat_config(reward_equal=False), 1, 256, 64),
    (jcw.ray_config(), 2, 128, 1),  # the collect's one step a launch
    (jcw.flat_config(reward_equal=False), 3, 128, 7),  # T not a multiple of 4
])
def test_fused_rollout_packed_equals_jax_kernel(cfg, seed, B, T):
    """Against the JAX Pallas kernel in interpret mode, on the same actions
    (that kernel takes B a multiple of 128 only)."""
    jsl, tsl = jax_and_port_slots(cfg, seed, B)
    actions = crafting_actions(seed, T, B)
    jst, jrew, jdone = jpf.fused_rollout_packed(
        cfg, jsl, jnp.asarray(actions), T, interpret=True, block=128)
    tst, trew, tdone = pf.fused_rollout_packed(tcfg(cfg), tsl, torch.as_tensor(actions), T)
    assert trew.dtype == torch.int32 and tdone.dtype == torch.bool
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    assert_tree_equal(interop.slot_state_to_numpy(tst), np_tree(jst))


@pytest.mark.parametrize("B,T", [
    (256, 96),
    (200, 99),  # B not a multiple of 128, T not a multiple of 4
    (131, 1),
])
def test_bench_equals_jax_rollout_p_over_stream(B, T):
    """The bench's checksum and final state equal JAX ``rollout_p`` fed the
    port's own action stream, and so do the actions path's rewards and dones
    (JAX ``rollout_p`` is the scan its Pallas kernels are held to, and takes
    any B)."""
    cfg = jcw.ray_config()
    seed = 7
    jsl, tsl = jax_and_port_slots(cfg, 2, B)
    tst, checksum = pf.fused_rollout_packed_bench(tcfg(cfg), tsl, seed, T)
    stream = pf.fused_action_stream(B, seed, T, device="cpu")
    jst, jout = jpr.rollout_p(cfg, jsl, jnp.asarray(stream.numpy()), T)
    assert checksum.dtype == torch.int64
    assert int(checksum) == int(np.asarray(jout.reward, np.int64).sum())
    assert_tree_equal(interop.slot_state_to_numpy(tst), np_tree(jst))
    ast, rew, done = pf.fused_rollout_packed(tcfg(cfg), tsl, stream, T)
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jout.reward))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jout.done))
    assert_tree_equal(interop.slot_state_to_numpy(ast), np_tree(jst))
    again_st, again = pf.fused_rollout_packed_bench(tcfg(cfg), tsl, seed, T)
    assert int(again) == int(checksum)


def test_action_stream_definition():
    """stream[t, b] is word t % 4 of Philox((t // 4, b, 0, 0), (seed, KEY)) % 6,
    so it depends on (seed, b, t) alone."""
    seed = 0xDEADBEEF1  # wider than 32 bits: only the low word is the key
    s = pf.fused_action_stream(64, seed, 37, device="cpu")
    assert s.dtype == torch.int32 and tuple(s.shape) == (37, 64)
    for t, b in [(0, 0), (3, 5), (4, 63), (36, 17)]:
        words = philox.philox4x32([torch.tensor(t // 4), torch.tensor(b), 0, 0],
                                  (seed & philox.MASK32, pf.ACTION_KEY))
        assert int(s[t, b]) == int(words[t % 4]) % 6
    assert torch.equal(pf.fused_action_stream(4, seed, 5, device="cpu"), s[:5, :4])


def test_action_stream_uniform_and_seeded():
    a = pf.fused_action_stream(2048, 12345, 1024, device="cpu")
    assert torch.equal(a, pf.fused_action_stream(2048, 12345, 1024, device="cpu"))
    assert int(a.min()) >= 0 and int(a.max()) <= 5
    freq = np.bincount(a.numpy().ravel(), minlength=6) / a.numel()
    np.testing.assert_allclose(freq, 1 / 6, atol=2e-3)
    a1 = pf.fused_action_stream(2048, 1, 256, device="cpu")
    a2 = pf.fused_action_stream(2048, 2, 256, device="cpu")
    agree = float((a1 == a2).float().mean())
    assert 0.15 < agree < 0.18, agree  # independent streams agree 1/6 of the time


def test_whole_slice_equals_jax():
    """reset → from_env_state → bench rollout → to_grid, against the JAX
    pipeline fed the same draws and the same actions."""
    cfg = jcw.ray_config()
    B, T, seed = 128, 96, 3
    jst0 = jcw.reset_from_seed(cfg, 9, B)
    tst0 = port_reset_like_jax(cfg, 9, B)
    tsl, checksum = pf.fused_rollout_packed_bench(
        tcfg(cfg), tsm.from_env_state(tst0), seed, T)
    stream = pf.fused_action_stream(B, seed, T, device="cpu").numpy()
    jsl, jout = jpr.rollout_p(cfg, jsm.from_env_state(jst0), jnp.asarray(stream), T)
    assert int(checksum) == int(np.asarray(jout.reward, np.int64).sum())
    for got, want in zip(tsm.to_grid(tsl, tcfg(cfg)), jsm.to_grid(jsl, cfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tsl.step_num == T).all()


def test_cpu_tensors_take_plain_versions():
    """A CPU tensor never reaches a kernel: the launch counters stay put, and
    the results are the plain versions'."""
    cfg = tcfg(jcw.flat_config())
    _, tsl = jax_and_port_slots(jcw.flat_config(), 4, 32)
    before = (pf.rollout_packed_bench.launches, pf.rollout_packed_actions.launches,
              pf.fused_action_stream.launches)
    st, checksum = pf.fused_rollout_packed_bench(cfg, tsl, 5, 20)
    actions = pf.fused_action_stream(32, 5, 20, device="cpu")
    st2, rew, _ = pf.fused_rollout_packed(cfg, tsl, actions, 20)
    assert int(rew.sum()) == int(checksum)
    for f in tsm.SlotState._fields:
        assert torch.equal(getattr(st, f), getattr(st2, f)), f
    after = (pf.rollout_packed_bench.launches, pf.rollout_packed_actions.launches,
             pf.fused_action_stream.launches)
    assert before == after
    with pytest.raises(ValueError):
        pf.fused_action_stream(8, 0, 4, device="meta")


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No nvcc means an error, never a silent fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("PATH", str(tmp_path))
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError):
        _build.build()
    assert not (tmp_path / "kernels").exists() or not any((tmp_path / "kernels").iterdir())
