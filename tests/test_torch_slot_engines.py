"""The port's slot engines (``step_slots``, ``_step_t`` and their random
rollouts) against the JAX package's, and against the port's own grid step.

States and actions are made with numpy from a seed and given to both
packages; every value is an integer, so every comparison is exact, dtypes
included.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
import gym_craftingworld_tpu_torch as tcw
from gym_craftingworld_tpu.core import slots as jsm
from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core import slots as tsm
from gym_craftingworld_tpu_torch.ops import transposed_rollout as ttr
from gym_craftingworld_tpu_torch.ops.keyed_draws import randint_cols
from gym_craftingworld_tpu_torch.ops.threefry import prng_key

from test_torch_packed_rollout import assert_tree_equal, np_tree, tcfg

jtr = importlib.import_module("gym_craftingworld_tpu.ops.transposed_rollout")

torch.set_num_threads(1)


def synthetic_slots(seed, B, H, W):
    """Random synthetic slot states as numpy SlotState fields: any slot types
    (repeats included), slots crowded onto a few cells, the agent on a slot's
    cell half the time, any status mix (several held, removed), any
    achieved/desired bits, the agent's start cell sometimes its own cell."""
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, H * W, size=(B, 4))  # four hot cells per env
    pos = cells[np.arange(B)[:, None], rng.randint(0, 4, size=(B, 8))]
    pos = np.where(rng.rand(B, 8) < 0.3, rng.randint(0, H * W, size=(B, 8)), pos)
    agent = np.where(rng.rand(B) < 0.5, cells[:, 0], rng.randint(0, H * W, size=B))
    init_pos = np.where(rng.rand(B, 8) < 0.5, pos, rng.randint(0, H * W, size=(B, 8)))
    init_agent = np.where(rng.rand(B) < 0.4, agent, rng.randint(0, H * W, size=B))
    rc = lambda lin: np.stack([lin // W, lin % W], axis=-1).astype(np.int32)
    achieved = rng.randint(0, 2, size=(B, 9)).astype(np.int8)
    desired = rng.randint(0, 2, size=(B, 9)).astype(np.int8)
    same = rng.rand(B) < 0.3
    desired[same] = achieved[same]  # so that successes fire
    stat = rng.choice([0, 0, 0, 0, 1, 2], size=(B, 8)).astype(np.int32)
    return dict(
        slot_type=rng.randint(1, 9, size=(B, 8)).astype(np.int32),
        slot_pos=rc(pos),
        slot_stat=stat,
        agent=rc(agent),
        desired=desired,
        achieved=achieved,
        init_type=np.stack([rng.permutation(8) + 1 for _ in range(B)]).astype(np.int32),
        init_pos=rc(init_pos),
        init_agent=rc(init_agent),
        step_num=rng.randint(0, 12, size=B).astype(np.int32),
        rng=np.zeros((B, 2), np.uint32),
    )


def jax_slots(d):
    return jsm.SlotState(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_result_equal(got, want):
    for f in ("reward", "done", "changed"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("reward_equal", [True, False])
def test_slot_steps_fuzz_equal_jax(reward_equal):
    """``step_slots`` and ``_step_t`` from 400 synthetic states, each of the 6
    actions, against JAX ``step_slots`` and ``_step_t``."""
    cfg = jcw.ray_config(height=9, width=9, max_steps=12, reward_equal=reward_equal)
    d = synthetic_slots(3, 400, 9, 9)
    successes = 0
    for action in range(C.N_ACTIONS):
        a = np.full(400, action, np.int32)
        jsl, jres = jsm.step_slots(cfg, jax_slots(d), jnp.asarray(a))
        tsl, tres = tsm.step_slots(tcfg(cfg), interop.slot_state_from_numpy(d, device="cpu"), torch.as_tensor(a))
        assert_tree_equal(interop.slot_state_to_numpy(tsl), np_tree(jsl))
        assert_result_equal(tres, jres)

        jts, jres_t = jtr._step_t(cfg, jtr.transpose_in(jax_slots(d)), jnp.asarray(a))
        tts, tres_t = ttr._step_t(tcfg(cfg), ttr.transpose_in(interop.slot_state_from_numpy(d, device="cpu")),
                                  torch.as_tensor(a))
        assert_tree_equal(interop.tslot_state_to_numpy(tts), np_tree(jts))
        assert_result_equal(tres_t, jres_t)
        successes += int((np.asarray(jres.reward) == cfg.max_steps).sum())
    assert successes > 0


def test_step_slots_leaves_its_input_alone():
    d = synthetic_slots(4, 64, 9, 9)
    cfg = tcw.ray_config(height=9, width=9)
    for action in (C.ACTION_PICKUP, C.ACTION_DROP, C.ACTION_UP):
        sl = interop.slot_state_from_numpy(d, device="cpu")
        tsm.step_slots(cfg, sl, torch.full((64,), action))
        ttr._step_t(cfg, ttr.transpose_in(sl), torch.full((64,), action))
        assert_tree_equal(interop.slot_state_to_numpy(sl), d)


@pytest.mark.parametrize("cfg,seed,steps", [
    (tcw.ray_config(), 0, 300),
    (tcw.flat_config(), 2, 400),  # 8x8: dense interactions, many collisions
    (tcw.EnvConfig(height=4, width=3, max_steps=1000), 3, 600),  # pathological
], ids=["ray", "flat", "4x3"])
def test_slot_engines_equal_grid_step(cfg, seed, steps):
    """Both slot layouts against the port's grid step, every step
    (tests/test_slots_equivalence.py, on the port)."""
    B = 16
    grid = tcw.reset_from_seed(cfg, seed, B, device="cpu")
    sl = tsm.from_env_state(grid)
    ts = ttr.transpose_in(sl)
    rng = np.random.RandomState(seed + 500)
    for t in range(steps):
        a = torch.as_tensor(rng.randint(6, size=B).astype(np.int32))
        grid, gres = tcw.step(cfg, grid, a)
        sl, sres = tsm.step_slots(cfg, sl, a)
        ts, tres = ttr._step_t(cfg, ts, a)
        for res in (sres, tres):
            for x, y in zip(res, gres):
                assert torch.equal(x, y), f"t={t}"
        assert torch.equal(sl.achieved, grid.achieved), f"t={t}"
        if t % 10 == 0 or t == steps - 1:
            for layout in (sl, ttr.transpose_out(ts, sl.rng)):
                for x, y in zip(tsm.to_grid(layout, cfg), (grid.objects, grid.agent, grid.holding)):
                    assert torch.equal(x, y), f"t={t}"


def test_random_rollouts_agree():
    """``rollout_slots_random``, ``rollout_t_random`` and the grid's
    ``rollout_random`` draw the same int32 actions from one key,
    ``randint(key, (T, B), 0, 6)``, and agree with the grid ``rollout`` of
    those actions."""
    cfg = tcw.flat_config()
    B, T = 32, 128
    grid = tcw.reset_from_seed(cfg, 9, B, device="cpu")
    sl = tsm.from_env_state(grid)
    actions = randint_cols(prng_key(4), (T, B), 0, 6)
    assert torch.equal(tsm.random_actions(sl, prng_key(4), T), actions)
    g_st, g_out = tcw.rollout(cfg, grid, actions)
    k_st, k_out = tcw.rollout_random(cfg, grid, prng_key(4), T)
    assert torch.equal(k_out.reward, g_out.reward) and torch.equal(k_st.objects, g_st.objects)
    s_st, s_out = tsm.rollout_slots_random(cfg, sl, prng_key(4), T)
    t_st, t_out = ttr.rollout_t_random(cfg, sl, prng_key(4), T)
    for out in (s_out, t_out):
        assert torch.equal(out.reward, g_out.reward) and torch.equal(out.done, g_out.done)
        assert out.reward.dtype == torch.int32 and out.changed.shape == (T, B)
    assert_tree_equal(interop.slot_state_to_numpy(t_st), interop.slot_state_to_numpy(s_st))
    for x, y in zip(tsm.to_grid(s_st, cfg), (g_st.objects, g_st.agent, g_st.holding)):
        assert torch.equal(x, y)


def test_transposed_layout_equals_jax():
    """``transpose_in``/``transpose_out`` and the TSlotState interop, dtypes
    included (JAX returns desired/achieved as int8 and the rest as int32)."""
    cfg = jcw.ray_config()
    st = jcw.reset_from_seed(cfg, 5, 16)
    jsl = jsm.from_env_state(st)
    tsl = tsm.from_env_state(interop.env_state_from_numpy(np_tree(st), device="cpu"))
    jts, tts = jtr.transpose_in(jsl), ttr.transpose_in(tsl)
    assert_tree_equal(interop.tslot_state_to_numpy(tts), np_tree(jts))
    again = interop.tslot_state_from_numpy(np_tree(jts), device="cpu")
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(again, tts))
    assert_tree_equal(interop.slot_state_to_numpy(ttr.transpose_out(tts, tsl.rng)),
                      np_tree(jtr.transpose_out(jts, jsl.rng)))
