"""The port's slot and packed engines against the JAX package's.

JAX states come across through ``interop`` as numpy; actions are made with
numpy from a seed and given to both. Every value is an integer, so every
comparison is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
import gym_craftingworld_tpu_torch as tcw
from gym_craftingworld_tpu.core import slots as jsm
from gym_craftingworld_tpu.ops import packed_rollout as jpr
from gym_craftingworld_tpu.ops import transposed_rollout as jtr
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core import slots as tsm
from gym_craftingworld_tpu_torch.ops import packed_rollout as tpr
from gym_craftingworld_tpu_torch.ops import transposed_rollout as ttr

torch.set_num_threads(1)

CONFIGS = {
    "ray": jcw.ray_config(),
    "flat": jcw.flat_config(),
    "ray_subset_reward": jcw.ray_config(reward_equal=False),
}


def tcfg(cfg):
    return tcw.EnvConfig(**dataclasses.asdict(cfg))


def np_tree(x):
    if dataclasses.is_dataclass(x):
        return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def jax_and_port_slots(cfg, seed, B):
    st = jcw.reset_from_seed(cfg, seed, B)
    port = tsm.from_env_state(interop.env_state_from_numpy(np_tree(st), device="cpu"))
    return jsm.from_env_state(st), port


def crafting_actions(seed, T, B):
    """Random moves with regular pickups and drops, so crafting fires."""
    moves = np.random.default_rng(seed).integers(0, 6, (T, B), dtype=np.int32)
    t = np.arange(T, dtype=np.int32)[:, None]
    return np.where(t % 7 == 6, 4, np.where(t % 11 == 10, 5, moves % 4)).astype(np.int32)


def assert_tree_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["ray", "flat"])
def test_layouts_equal_jax(name):
    cfg = CONFIGS[name]
    jsl, tsl = jax_and_port_slots(cfg, 7, 64)
    assert_tree_equal(interop.slot_state_to_numpy(tsl), np_tree(jsl))
    assert_tree_equal(interop.slot_state_to_numpy(
        interop.slot_state_from_numpy(np_tree(jsl), device="cpu")), np_tree(jsl))

    jts, tts = jtr.transpose_in(jsl), ttr.transpose_in(tsl)
    assert_tree_equal({k: v.numpy() for k, v in tts._asdict().items()}, np_tree(jts))

    jp, tp = jpr.pack(cfg, jts), tpr.pack(tcfg(cfg), tts)
    assert_tree_equal(interop.packed_state_to_numpy(tp), np_tree(jp))
    again = interop.packed_state_from_numpy(np_tree(jp), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, tp))

    back = tpr.unpack(tcfg(cfg), tp, tts.desired, tpr._init_rows(tts))
    assert_tree_equal({k: v.numpy() for k, v in back._asdict().items()},
                      np_tree(jpr.unpack(cfg, jp, jts.desired, tpr._init_rows(jts))))

    for got, want in zip(tsm.to_grid(tsl, tcfg(cfg)), jsm.to_grid(jsl, cfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unrolled_step_bit_identical(name):
    """`_step_p_unrolled` equals `_step_p` field for field, every step, in
    int16 and int32 (tests/test_packed_rollout.py:107-148)."""
    cfg = tcfg(CONFIGS[name])
    B, T = 32, 300
    _, sl = jax_and_port_slots(CONFIGS[name], 1, B)
    p0 = tpr.pack(cfg, ttr.transpose_in(sl))
    actions = torch.as_tensor(crafting_actions(2, T, B))
    for dtype in (torch.int16, torch.int32):
        pa = pb = tpr.PackedState(*(x.to(dtype) for x in p0))
        for t in range(T):
            a = actions[t].to(dtype)
            pa, ra = tpr._step_p(cfg, pa, a, dtype=dtype)
            pb, rb = tpr._step_p_unrolled(cfg, pb, a, dtype=dtype)
            for f, x, y in zip(tpr.PackedState._fields, pa, pb):
                assert x.dtype == y.dtype == dtype, f
                assert torch.equal(x, y), f"{f} t={t} dtype={dtype}"
            for f, x, y in zip(("reward", "done", "changed"), ra, rb):
                assert torch.equal(x, y), f"{f} t={t} dtype={dtype}"
    assert pa.achieved.any(), "some task bits latch under the crafting mix"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rollout_p_equals_jax(name):
    cfg = CONFIGS[name]
    B, T = 256, 64
    jsl, tsl = jax_and_port_slots(cfg, 3, B)
    actions = crafting_actions(4, T, B)
    jst, jout = jpr.rollout_p(cfg, jsl, jnp.asarray(actions), T)
    tst, tout = tpr.rollout_p(tcfg(cfg), tsl, torch.as_tensor(actions), T)
    assert_tree_equal(interop.slot_state_to_numpy(tst), np_tree(jst))
    assert_tree_equal({k: v.numpy() for k, v in tout._asdict().items()}, np_tree(jout))


def test_rollout_p_bench_matches_random():
    cfg = tcw.ray_config()
    sl = tsm.from_env_state(tcw.reset_from_seed(cfg, 3, 16, device="cpu"))
    gen = lambda: torch.Generator().manual_seed(11)
    sa, out = tpr.rollout_p_random(cfg, sl, gen(), 200)
    sb, acc = tpr.rollout_p_bench(cfg, sl, gen(), 200)
    assert acc.dtype == torch.int64 and int(out.reward.sum()) == int(acc)
    for f in tsm.SlotState._fields:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f


def test_long_rollout_past_int16_wrap_point():
    """step_num saturates at max_steps, so a no-reset rollout of T > 32767
    stays valid in int16 and still equals JAX (tests/test_packed_rollout.py:151-171)."""
    cfg = CONFIGS["flat"]
    B, T = 8, 33000
    jsl, tsl = jax_and_port_slots(cfg, 3, B)
    actions = np.random.default_rng(11).integers(0, 6, (T, B), dtype=np.int32)
    jst, jout = jpr.rollout_p(cfg, jsl, jnp.asarray(actions), T)
    tst, tout = tpr.rollout_p(tcfg(cfg), tsl, torch.as_tensor(actions), T)
    d = tout.done.numpy()
    assert d[cfg.max_steps - 1:].all(), "done must stay latched past max_steps"
    np.testing.assert_array_equal(d, np.asarray(jout.done))
    np.testing.assert_array_equal(tout.reward.numpy(), np.asarray(jout.reward))
    assert int(tst.step_num.max()) == cfg.max_steps
    assert_tree_equal(interop.slot_state_to_numpy(tst), np_tree(jst))
