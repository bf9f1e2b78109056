"""The port's grid core against the JAX package: step, compute_reward,
rollout (with and without auto-reset), the state checks and the pool reset.

States and actions are made with numpy from a seed and given to both
packages; every value is an integer, so every comparison is exact, dtypes
included.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
import gym_craftingworld_tpu_torch as tcw
from gym_craftingworld_tpu.core import validate as jval
from gym_craftingworld_tpu.core.state import EnvState as JEnvState
from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core import validate as tval
from gym_craftingworld_tpu_torch.ops.keyed_draws import split_keys
from gym_craftingworld_tpu_torch.ops.threefry import prng_key

from test_torch_packed_rollout import crafting_actions, np_tree, tcfg
from test_torch_reset import _chi2

# the packages re-export the `reset` function, shadowing the module name
jreset = importlib.import_module("gym_craftingworld_tpu.core.reset")
treset = importlib.import_module("gym_craftingworld_tpu_torch.core.reset")
trollout = importlib.import_module("gym_craftingworld_tpu_torch.core.rollout")

torch.set_num_threads(1)


def synthetic_states(seed, B, H, W):
    """Random synthetic worlds as numpy EnvState fields (tests/test_step_fuzz.py:34-60):
    dense clusters of up to 10 objects with repeats, the agent on an object
    cell half the time and on an edge a quarter of the time, any held item,
    a one-of-each init layout and arbitrary achieved/desired bits."""
    rng = np.random.RandomState(seed)
    n = H * W
    objects = np.zeros((B, n), np.int8)
    init = np.zeros((B, n), np.int8)
    agent = np.zeros((B, 2), np.int32)
    for b in range(B):
        n_obj = rng.randint(0, 11)
        cells = rng.choice(n, size=n_obj + 1, replace=False)
        objects[b, cells[:n_obj]] = rng.randint(1, 9, size=n_obj)
        a = cells[0] if n_obj and rng.rand() < 0.5 else cells[n_obj]
        agent[b] = a // W, a % W
        if rng.rand() < 0.25:
            agent[b, rng.randint(2)] = rng.choice([0, H - 1])
        icells = rng.choice(n, size=9, replace=False)
        init[b, icells[:8]] = np.arange(1, 9)
        init[b, icells[8]] = C.AGENT_INIT_MARK
    achieved = rng.randint(0, 2, size=(B, 9)).astype(np.int8)
    desired = rng.randint(0, 2, size=(B, 9)).astype(np.int8)
    same = rng.rand(B) < 0.3
    desired[same] = achieved[same]  # so that successes fire
    return dict(
        objects=objects.reshape(B, H, W),
        agent=agent,
        holding=rng.randint(0, 4, size=B).astype(np.int32),
        desired=desired,
        achieved=achieved,
        init_objects=init.reshape(B, H, W),
        init_agent=agent[rng.permutation(B)],
        goal_objects=objects.reshape(B, H, W),
        goal_agent=agent,
        step_num=rng.randint(0, 12, size=B).astype(np.int32),
        rng=np.zeros((B, 2), np.uint32),
    )


def jax_state(d):
    return JEnvState(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_state_equal(port, jax_st, skip=("rng",)):
    got, want = interop.env_state_to_numpy(port), np_tree(jax_st)
    for k in want:
        if k in skip:
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("reward_equal", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_step_fuzz_equals_jax(seed, reward_equal):
    """One step from 400 synthetic states, for each of the 6 actions."""
    cfg = jcw.ray_config(height=9, width=9, max_steps=12, reward_equal=reward_equal)
    d = synthetic_states(seed, 400, 9, 9)
    successes = 0
    for action in range(C.N_ACTIONS):
        a = np.full(400, action, np.int32)
        jst, jres = jcw.step(cfg, jax_state(d), jnp.asarray(a))
        tst, tres = tcw.step(tcfg(cfg), interop.env_state_from_numpy(d, device="cpu"), torch.as_tensor(a))
        assert_state_equal(tst, jst)
        for f in ("reward", "done", "changed"):
            got, want = getattr(tres, f).numpy(), np.asarray(getattr(jres, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f"{f} action {action}")
        successes += int((np.asarray(jres.reward) == cfg.max_steps).sum())
    assert successes > 0


def test_step_leaves_its_input_alone():
    cfg = tcw.flat_config()
    st = tcw.reset_from_seed(cfg, 1, 32, device="cpu")
    before = interop.env_state_to_numpy(st)
    tcw.step(cfg, st, torch.full((32,), C.ACTION_PICKUP))
    tcw.step(cfg, st, torch.zeros(32, dtype=torch.int64))
    after = interop.env_state_to_numpy(st)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


@pytest.mark.parametrize("reward_equal", [True, False])
def test_compute_reward_equals_jax(reward_equal):
    cfg = jcw.flat_config(reward_equal=reward_equal)
    rng = np.random.RandomState(3)
    achieved = rng.randint(0, 2, size=(512, 9)).astype(np.int8)
    desired = np.where(rng.rand(512, 9) < 0.5, achieved, rng.randint(0, 2, size=(512, 9)))
    desired = desired.astype(np.int8)
    want = np.asarray(jcw.core.compute_reward(cfg, jnp.asarray(achieved), jnp.asarray(desired)))
    got = tcw.core.compute_reward(tcfg(cfg), torch.as_tensor(achieved), torch.as_tensor(desired))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.tolist())) == 2


@pytest.mark.parametrize("cfg", [jcw.ray_config(), jcw.flat_config(reward_equal=False)],
                         ids=["ray", "flat_subset"])
def test_rollout_equals_jax(cfg):
    B, T = 64, 120
    jst0 = jcw.reset_from_seed(cfg, 4, B)
    tst0 = interop.env_state_from_numpy(np_tree(jst0), device="cpu")
    actions = crafting_actions(5, T, B)
    tst, tout = tcw.rollout(tcfg(cfg), tst0, torch.as_tensor(actions))
    jst, jout = jcw.rollout(cfg, jst0, jnp.asarray(actions))
    assert_state_equal(tst, jst)
    for f in ("reward", "done"):
        got, want = getattr(tout, f).numpy(), np.asarray(getattr(jout, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_rollout_random_draws_int32_actions_from_the_generator():
    """The actions of ``rollout_random(key)`` are JAX's ``randint(key, (T,
    B), 0, 6)``, int32."""
    cfg = tcw.flat_config()
    st = tcw.reset_from_seed(cfg, 2, 16, device="cpu")
    actions = torch.as_tensor(np.asarray(jax.random.randint(jax.random.PRNGKey(8), (40, 16), 0, 6)))
    assert actions.dtype == torch.int32
    a, out_a = tcw.rollout_random(cfg, st, prng_key(8), 40)
    b, out_b = tcw.rollout(cfg, st, actions)
    assert torch.equal(out_a.reward, out_b.reward) and torch.equal(out_a.done, out_b.done)
    assert torch.equal(a.objects, b.objects)


def test_auto_reset():
    """Up to each env's first done the auto-reset rollout equals the plain one;
    a done env restarts from the fresh world of its own key, at step 0 with
    no task achieved, and every state stays valid."""
    cfg = tcw.EnvConfig(height=8, width=8, max_steps=20, reward_equal=False)
    B, T = 4096, 20
    st0 = tcw.reset_from_seed(cfg, 6, B, device="cpu")
    actions = torch.as_tensor(crafting_actions(7, T, B))
    before, head = tcw.rollout(cfg, st0, actions[:-1], auto_reset=True)
    st, last_step = tcw.rollout(cfg, before, actions[-1:], auto_reset=True)
    out = trollout.RolloutOut(*(torch.cat(x) for x in zip(head, last_step)))
    _, ref = tcw.rollout(cfg, st0, actions)

    done = out.done.numpy()
    first = np.where(done.any(axis=0), done.argmax(axis=0), T)
    upto = np.arange(T)[:, None] <= first[None, :]
    np.testing.assert_array_equal(out.reward.numpy()[upto], ref.reward.numpy()[upto])
    np.testing.assert_array_equal(done[upto], ref.done.numpy()[upto])
    assert (first < cfg.max_steps - 1).any(), "some env succeeds before the step limit"

    # an env done at the last step holds the fresh world of the key it held
    fresh = treset.reset(cfg, before.rng)
    last = out.done[-1]
    assert last.float().mean() > 0.5
    for f in dataclasses.fields(fresh):
        assert torch.equal(getattr(st, f.name)[last], getattr(fresh, f.name)[last]), f.name
    assert not st.step_num[last].any() and not st.achieved[last].any()
    assert not st.holding[last].any()
    assert tval.check_state(cfg, st).all()

    n = int(last.sum())
    objects = st.objects[last].numpy().reshape(n, -1)
    agent = (st.agent[:, 0] * cfg.width + st.agent[:, 1])[last].numpy()
    for code in range(1, C.N_OBJECTS + 1):
        assert ((objects == code).sum(axis=1) == 1).all()
        # chi-square with 63 dof: 99.99th percentile ≈ 113.5
        assert _chi2(np.bincount((objects == code).argmax(axis=1), minlength=64), n / 64) < 114
    assert (objects[np.arange(n), agent] == 0).all()
    assert _chi2(np.bincount(agent, minlength=64), n / 64) < 114

    # mid-rollout: an env last done at step t has taken T - 1 - t steps since
    T2 = 27
    actions = torch.as_tensor(crafting_actions(8, T2, B))
    st, out = tcw.rollout(cfg, st0, actions, auto_reset=True)
    d = out.done.numpy()
    last = np.where(d.any(axis=0), T2 - 1 - d[::-1].argmax(axis=0), -1)
    want = np.where(last >= 0, T2 - 1 - last, np.minimum(T2, cfg.max_steps))
    np.testing.assert_array_equal(st.step_num.numpy(), want)
    assert tval.check_state(cfg, st).all()


def _corrupt(d):
    """Valid states, then one corrupted field per env (env 0 stays valid)."""
    bad = {k: v.copy() for k, v in d.items()}
    bad["holding"][1] = 7
    bad["agent"][2] = (-1, 0)
    bad["agent"][3] = (0, 21)
    bad["objects"][4, 0, 0] = 9
    bad["achieved"][5, 3] = 2
    bad["desired"][6, 8] = 3
    flat = bad["objects"][7].reshape(-1)
    flat[np.flatnonzero(flat == 0)[:3]] = 1  # 11 objects on the grid
    bad["holding"][8] = 1  # 8 on the grid + 1 held
    return bad


def test_check_state_equals_jax():
    cfg = jcw.ray_config()
    valid = np_tree(jcw.reset_from_seed(cfg, 3, 12))
    for state in (valid, _corrupt(valid)):
        want = jval.check_state(cfg, jax_state(state))
        got = tval.check_state(tcfg(cfg), interop.env_state_from_numpy(state, device="cpu"))
        assert got.dtype == want.dtype == np.bool_
        np.testing.assert_array_equal(got, want)
    assert want[0] and not want[1:9].any() and want[9:].all()
    with pytest.raises(AssertionError) as jerr:
        jval.assert_valid_state(cfg, jax_state(state))
    with pytest.raises(AssertionError) as terr:
        tval.assert_valid_state(tcfg(cfg), interop.env_state_from_numpy(state, device="cpu"))
    assert str(terr.value) == str(jerr.value)
    tval.assert_valid_state(tcfg(cfg), tcw.reset_from_seed(tcfg(cfg), 0, 8, device="cpu"))


def jax_pool_draws(cfg, pool_seed, P, seed, B):
    """The draws of JAX ``generate_pool`` and ``reset_from_pool``, replayed
    split for split (core/reset.py:102-161)."""
    n, n_sel = cfg.n_cells, len(cfg.selected_task_indices)
    pool_keys = jax.random.split(jax.random.PRNGKey(pool_seed), P)
    scores = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(pool_keys)

    def one(key):
        k_task, k_pick, k_goal, _ = jax.random.split(key, 4)
        k_num, k_perm = jax.random.split(k_task)
        if cfg.stacking:
            k = jax.random.randint(k_num, (), 0, cfg.number_of_tasks) + 1
        else:
            k = jnp.int32(1)
        perm = jax.random.permutation(k_perm, n_sel)
        pick = jax.random.randint(k_pick, (), 0, P)
        gk = jax.random.split(k_goal, 6)
        rows = [jax.random.uniform(gk[i], (n,)) for i in range(6)]
        rows.append(jax.random.uniform(jax.random.fold_in(gk[5], 1), (n,)))
        return k, perm, pick, jnp.stack(rows)

    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return np.array(scores), [np.array(x) for x in jax.vmap(one)(keys)], keys


@pytest.mark.parametrize("cfg", [jcw.ray_config(), jcw.flat_config(stacking=False)],
                         ids=["ray", "flat_single_task"])
def test_pool_reset_equals_jax(cfg):
    P, B = 24, 64
    scores, (k, perm, pick, goal), keys = jax_pool_draws(cfg, 1, P, 2, B)
    jobj, jagent = jreset.generate_pool(cfg, jax.random.PRNGKey(1), P)
    tobj, tagent = treset.generate_pool_from_scores(tcfg(cfg), torch.as_tensor(scores))
    for got, want in ((tobj, jobj), (tagent, jagent)):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jst = jreset.reset_from_pool(cfg, keys, jobj, jagent)
    t = torch.as_tensor
    tst = treset.reset_from_pool_draws(tcfg(cfg), t(k), t(perm), t(pick), t(goal), tobj, tagent)
    assert_state_equal(tst, jst)


def test_generator_pool_reset():
    cfg = tcw.flat_config()
    pobj, pagent = tcw.core.generate_pool(cfg, prng_key(3), 16)
    assert pobj.dtype == torch.int8 and pagent.dtype == torch.int32
    st = tcw.core.reset_from_pool(cfg, split_keys(prng_key(4), 256), pobj, pagent)
    flat = st.objects.reshape(256, -1)
    match = (flat[:, None, :] == pobj.reshape(1, 16, -1)).all(dim=2)
    assert (match.sum(dim=1) >= 1).all(), "every world comes from the pool"
    assert len(set(match.int().argmax(dim=1).tolist())) > 8
    agent = st.agent[:, 0] * cfg.width + st.agent[:, 1]
    init = st.init_objects.reshape(256, -1)
    assert (init.gather(1, agent[:, None].long()) == C.AGENT_INIT_MARK).all()
    assert tval.check_state(cfg, st).all()
    assert not st.step_num.any() and (st.desired.sum(dim=1) >= 1).all()

