"""The port's Gym façade (``api/gym_env.py``) against the JAX package's.

In parity mode both façades draw their resets from the reference's
RandomState sequence on the host, so with one seed and one action sequence
(from a numpy RandomState) every episode must match step for step: every
observation image byte for byte, rewards, dones and infos exactly. Fast mode
draws from another stream; there every reset must pass ``core/validate.py``.
"""

import inspect

import numpy as np
import pytest
import torch

from gym_craftingworld_tpu.api import gym_env as jge
from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.api import gym_env as tge
from gym_craftingworld_tpu_torch.core import validate
from gym_craftingworld_tpu_torch.parity import ParityReset
from gym_craftingworld_tpu_torch.utils.coordinates import Coord

torch.set_num_threads(1)

CLASSES = {
    "ray": "CraftingWorldEnvRay",
    "flat": "CraftingWorldEnvFlat",
    "onehot": "CraftingWorldEnvOneHot",
    "altobs": "CraftingWorldEnvAltObs",
}


def pair(variant, seed, **kw):
    """(JAX env, port env on the CPU), both in parity mode."""
    name = CLASSES[variant]
    return (getattr(jge, name)(seed=seed, rng_mode="parity", **kw),
            getattr(tge, name)(seed=seed, rng_mode="parity", device="cpu", **kw))


def assert_same(got, want, what=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what} {k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


def run_episodes(j, t, episodes, steps, seed):
    """Reset and step both envs alike; returns the steps taken."""
    taken = 0
    for ep in range(episodes):
        assert_same(t.reset(), j.reset(), f"ep {ep} reset")
        rng = np.random.RandomState(seed + ep)
        for i in range(steps):
            a = int(rng.randint(6))
            jo, jr, jd, ji = j.step(a)
            to, tr, td, ti = t.step(a)
            what = f"ep {ep} step {i}"
            assert type(tr) is int and type(td) is bool, what
            assert (tr, td) == (jr, jd), what
            assert_same(to, jo, what)
            assert_same(ti, ji, what)
            taken += 1
            if jd:
                break
    return taken


@pytest.mark.parametrize("seed", [0, 23])
@pytest.mark.parametrize("variant", list(CLASSES))
def test_parity_episodes_equal_jax(variant, seed):
    """Two episodes: 60 steps on 21x21, a whole 8x8 Flat episode."""
    j, t = pair(variant, seed)
    steps = 100 if variant == "flat" else 60
    taken = run_episodes(j, t, episodes=2, steps=steps, seed=seed)
    assert taken >= 2 * min(steps, 10)
    assert (t.ep_no, t.step_num) == (j.ep_no, j.step_num)


@pytest.mark.parametrize("variant", list(CLASSES))
def test_reference_methods_equal_jax(variant):
    j, t = pair(variant, 5)
    j.reset(), t.reset()
    rng = np.random.RandomState(5)
    for _ in range(15):
        a = int(rng.randint(6))
        j.step(a), t.step(a)
    assert_same(t.observation_vector, j.observation_vector, "observation_vector")
    assert_same(t.imagine_obs(), j.imagine_obs(), "imagine_obs")
    assert_same(t.render(), j.render(), "render")
    assert t.agent_pos == j.agent_pos
    for name in ("obs_one_hot", "desired_goal_vector", "achieved_goal_vector", "INIT_OBS_VECTOR"):
        assert_same(getattr(t, name), getattr(j, name), name)

    # sample_state and generate_fixed_states draw from the parity RandomState
    (ts, tc), (js, jc) = t.sample_state(), j.sample_state()
    assert_same(ts, js, "sample_state")
    assert isinstance(tc, Coord) and tc.tuple() == jc.tuple()
    assert (tc.max_row, tc.max_col) == (jc.max_row, jc.max_col)
    for a, b in zip(t.generate_fixed_states(3), j.generate_fixed_states(3)):
        assert_same(a, b, "generate_fixed_states")
    assert_same(t.render(state=ts), j.render(state=js), "render(state=onehot)")
    held = ts.copy()
    r, c = tc.tuple()
    held[r, c, C.N_OBJECTS + 2] = 1  # the agent holds the axe
    assert_same(t.render(state=held), j.render(state=held), "render(state) holding")

    for got, want in ((t.desired_goal_vector, j.desired_goal_vector),
                      (np.ones((1, 9), np.int8), j.desired_goal_vector),
                      (np.zeros(9, np.int8), np.zeros(9, np.int8))):
        assert t.compute_reward(got, want) == j.compute_reward(got, want)
    sub_t = getattr(tge, CLASSES[variant])(seed=5, reward_style="subset", device="cpu")
    sub_j = getattr(jge, CLASSES[variant])(seed=5, reward_style="subset")
    ones, des = np.ones(9, np.int8), j.desired_goal_vector
    assert sub_t.compute_reward(ones, des) == sub_j.compute_reward(ones, des) == sub_t.MAX_STEPS
    assert t.compute_reward(ones, des) == j.compute_reward(ones, des)

    a = np.arange(20)
    for b in (a.copy(), np.r_[a[:17], 0, a[18:]], np.r_[a[:19], 7]):
        for n in (1, 3, 4):
            assert t.short_circuit_check(a, b, n) == j.short_circuit_check(a, b, n)


@pytest.mark.parametrize("seed", [1, 6])
def test_eval_task_edit_equals_jax(seed):
    """eval_task_edit from the live state, with each cell's old contents and
    None, then further steps: the achieved vectors stay equal."""
    j, t = pair("ray", seed, size=(8, 8))
    j.reset(), t.reset()
    rng = np.random.RandomState(seed)
    for i in range(80):
        a = int(rng.choice([0, 1, 2, 3, 4, 4, 5]))
        _, _, jd, _ = j.step(a)
        t.step(a)
        if jd:
            j.reset(), t.reset()
        row = j.obs_one_hot[j.agent_pos] if i % 3 else None
        if i % 5 == 0:
            old = np.zeros(12, np.int64)
            old[rng.randint(8)] = 1
            row = old
        j.eval_task_edit(row)
        t.eval_task_edit(row)
        assert_same(t.achieved_goal_vector, j.achieved_goal_vector, f"step {i}")
        assert t.state.achieved.dtype == torch.int8


def test_fixed_init_state_equals_jax():
    j, t = pair("ray", 3, fixed_init_state=4)
    assert len(t._parity.fixed_pool) == 4
    run_episodes(j, t, episodes=3, steps=20, seed=3)


@pytest.mark.parametrize("variant", ["ray", "flat"])
def test_incremental_render_equals_full_render(variant):
    """The render_edit path against the JAX façade's full render, every step."""
    name = CLASSES[variant]
    j = getattr(jge, name)(seed=2, rng_mode="parity", size=(8, 8), max_steps=60)
    t = getattr(tge, name)(seed=2, rng_mode="parity", size=(8, 8), max_steps=60,
                           incremental_render=True, device="cpu")
    run_episodes(j, t, episodes=2, steps=60, seed=9)
    assert t._inc is not None


def test_stacked_altobs_equals_jax():
    j, t = pair("altobs", 4, stacked_obs=True)
    run_episodes(j, t, episodes=1, steps=30, seed=4)
    assert t.observation_space.shape == j.observation_space.shape == (4, 66, 63, 3)


def test_parity_mode_validation():
    with pytest.raises(ValueError):
        tge.CraftingWorldEnvRay(seed=0, rng_mode="parity", batch_size=2, device="cpu")
    with pytest.raises(ValueError):
        tge.CraftingWorldEnvRay(seed=0, rng_mode="warp", device="cpu")
    with pytest.raises(ValueError):
        tge.CraftingWorldEnvOneHot(seed=0, incremental_render=True, device="cpu")
    with pytest.raises(NotImplementedError):
        tge.CraftingWorldEnvRay(seed=0, task_list=list(reversed(C.TASK_LIST)), device="cpu")


@pytest.mark.parametrize("variant", list(CLASSES))
def test_fast_mode_resets_are_valid(variant):
    """Fast-mode resets (from the env's generator; a fixed pool for the
    non-Flat variants) pass core/validate.py, and batched obs carry B."""
    kw = {} if variant == "flat" else {"fixed_init_state": 3}
    for extra in ({}, kw):
        env = getattr(tge, CLASSES[variant])(seed=11, batch_size=8, device="cpu", **extra)
        for _ in range(3):
            obs = env.reset()
            validate.assert_valid_state(env.cfg, env.state)
            assert env.state.objects.device.type == "cpu"
            first = obs if not isinstance(obs, dict) else obs["observation"]
            assert first.shape[0] == 8 and isinstance(first, np.ndarray)
            obs, reward, done, info = env.step(np.arange(8) % 6)
            assert reward.shape == (8,) and done.dtype == bool
            validate.assert_valid_state(env.cfg, env.state)


def test_fast_mode_is_seeded_and_one_env_unbatches():
    a = tge.CraftingWorldEnvRay(seed=3, device="cpu")
    b = tge.CraftingWorldEnvRay(seed=3, device="cpu")
    assert_same(a.reset(), b.reset())
    assert a.reset()["observation"].shape == (84, 84, 3)
    obs, reward, done, info = a.step(2)
    assert type(reward) is int and type(done) is bool
    assert info["achieved_goal"].shape == (1, 9)
    state, coord = a.sample_state()
    assert state.shape == (21, 21, 12) and state[coord.tuple()][C.N_OBJECTS] == 1
    assert state[:, :, : C.N_OBJECTS].sum() == C.N_OBJECTS


def test_default_device_is_the_card():
    """The variants take ``device`` from the Ray class, whose default is the
    card; without one, each raises torch's own error (no silent CPU)."""
    sig = inspect.signature(tge.CraftingWorldEnvRay.__init__)
    assert sig.parameters["device"].default == "cuda"
    assert inspect.signature(ParityReset.reset_state).parameters["device"].default == "cuda"
    for name in CLASSES.values():
        if torch.cuda.is_available():
            assert getattr(tge, name)(seed=0).device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                getattr(tge, name)(seed=0)


def test_gif_recording(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    env = tge.CraftingWorldEnvFlat(seed=0, store_gif=True, device="cpu")
    assert 0 <= env.env_id < 1_000_000
    env.reset()
    for a in (1, 2, 3):
        env.step(a)
    env.reset()  # writes the first episode (Flat saves episode 0)
    gifs = list((tmp_path / "renders" / f"env{env.env_id}").glob("*.gif"))
    assert len(gifs) == 1 and gifs[0].name.startswith("E0(3)_")


def test_returned_arrays_do_not_alias_the_state():
    """``.numpy()`` of a CPU tensor is a view of it: what the façade hands out
    must be a copy, as the JAX façade's arrays are."""
    env = tge.CraftingWorldEnvRay(seed=1, device="cpu")
    env.reset()
    _, _, _, info = env.step(0)
    desired, achieved = env.state.desired.clone(), env.state.achieved.clone()
    for arr in (info["desired_goal"], info["achieved_goal"], env.desired_goal_vector,
                env.achieved_goal_vector):
        arr[...] = 7
    env.obs_one_hot[...] = 7
    assert torch.equal(env.state.desired, desired) and torch.equal(env.state.achieved, achieved)
