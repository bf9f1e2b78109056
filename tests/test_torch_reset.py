"""The port's reset against the JAX reset.

``reset_from_draws`` is fed the draws that JAX ``reset_from_seed`` takes from
its keys, replayed split for split, and must give the JAX state field for
field (exact: every field is an integer). The generator-driven ``reset`` uses
torch's own stream, so it is held to the invariants and the chi-square
bounds of tests/test_reset_distribution.py instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
import gym_craftingworld_tpu_torch as tcw
from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core.reset import reset_from_draws

torch.set_num_threads(1)


def jax_reset_draws(cfg, seed, B):
    """The draws of JAX ``reset_from_seed(cfg, seed, B)``, as numpy arrays.

    Replays core/reset.py:74-76 and :32-42 and core/imagine.py:66, :113:
    k_task, k_world, k_goal, k_next = split(key, 4); k_num, k_perm =
    split(k_task); keys = split(k_goal, 6); row 6 from fold_in(keys[5], 1).
    """
    n, n_sel = cfg.n_cells, len(cfg.selected_task_indices)

    def one(key):
        k_task, k_world, k_goal, _ = jax.random.split(key, 4)
        k_num, k_perm = jax.random.split(k_task)
        if cfg.stacking:
            k = jax.random.randint(k_num, (), 0, cfg.number_of_tasks) + 1
        else:
            k = jnp.int32(1)
        perm = jax.random.permutation(k_perm, n_sel)
        world = jax.random.uniform(k_world, (n,))
        gk = jax.random.split(k_goal, 6)
        rows = [jax.random.uniform(gk[i], (n,)) for i in range(6)]
        rows.append(jax.random.uniform(jax.random.fold_in(gk[5], 1), (n,)))
        return k, perm, world, jnp.stack(rows)

    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return [np.array(x) for x in jax.vmap(one)(keys)]


def port_reset_like_jax(cfg, seed, B):
    """The port's reset fed the JAX draws (torch EnvState)."""
    k, perm, world, goal = jax_reset_draws(cfg, seed, B)
    t = torch.as_tensor
    return reset_from_draws(tcw.EnvConfig(**dataclasses.asdict(cfg)),
                            t(k), t(perm), t(world), t(goal))


CONFIGS = {
    "ray": jcw.ray_config(),
    "flat": jcw.flat_config(),
    "ray_single_task": jcw.ray_config(stacking=False),
    "ray_selected_1_4": jcw.ray_config(selected_task_indices=(1, 4)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reset_from_draws_equals_jax(name):
    cfg = CONFIGS[name]
    B = 64
    ref = jcw.reset_from_seed(cfg, 5, B)
    got = interop.env_state_to_numpy(port_reset_like_jax(cfg, 5, B))
    for f in dataclasses.fields(ref):
        if f.name == "rng":
            continue
        want = np.asarray(getattr(ref, f.name))
        assert got[f.name].dtype == want.dtype, f.name
        np.testing.assert_array_equal(got[f.name], want, err_msg=f.name)


def _chi2(counts, expected):
    return float(((counts - expected) ** 2 / expected).sum())


def test_generator_reset_invariants_and_distribution():
    cfg = tcw.flat_config()  # 8x8
    B, n = 4096, cfg.n_cells
    st = tcw.reset_from_seed(cfg, 0, B)
    again = tcw.reset_from_seed(cfg, 0, B)
    np.testing.assert_array_equal(st.objects.numpy(), again.objects.numpy())
    assert not torch.equal(st.objects, tcw.reset_from_seed(cfg, 1, B).objects)

    objects = st.objects.numpy().reshape(B, n)
    agent = st.agent.numpy()
    agent_lin = agent[:, 0] * cfg.width + agent[:, 1]
    # one of each object on distinct cells, the agent on an empty one
    assert ((objects > 0).sum(axis=1) == C.N_OBJECTS).all()
    for code in range(1, C.N_OBJECTS + 1):
        assert ((objects == code).sum(axis=1) == 1).all()
    assert (objects[np.arange(B), agent_lin] == 0).all()
    init = st.init_objects.numpy().reshape(B, n)
    assert (init[np.arange(B), agent_lin] == C.AGENT_INIT_MARK).all()
    init[np.arange(B), agent_lin] = 0
    np.testing.assert_array_equal(init, objects)
    np.testing.assert_array_equal(st.init_agent.numpy(), agent)
    assert not st.holding.any() and not st.step_num.any() and not st.achieved.any()
    goal = st.goal_objects.numpy()
    assert goal.min() >= 0 and goal.max() <= C.N_OBJECTS
    assert st.goal_agent.min() >= 0 and st.goal_agent.max() < cfg.height

    # chi-square with 63 dof: 99.99th percentile ≈ 113.5
    expected = B / n
    assert _chi2(np.bincount(agent_lin, minlength=n), expected) < 114
    for code in range(1, C.N_OBJECTS + 1):
        pos = (objects == code).argmax(axis=1)
        assert _chi2(np.bincount(pos, minlength=n), expected) < 114, code
    # task count k ~ 1 + Uniform{0..8}; 8 dof: 99.99th percentile ≈ 31.8
    ks = st.desired.numpy().sum(axis=1)
    assert ks.min() >= 1 and ks.max() <= C.N_TASKS
    assert _chi2(np.bincount(ks, minlength=10)[1:10], B / 9) < 32


def test_generator_reset_respects_selection():
    cfg = tcw.EnvConfig(height=5, width=5, max_steps=10,
                        selected_task_indices=(1, 4, 7), number_of_tasks=3)
    desired = tcw.reset_from_seed(cfg, 3, 512).desired.numpy()
    allowed = np.zeros(C.N_TASKS, np.int8)
    allowed[[1, 4, 7]] = 1
    assert (desired <= allowed[None]).all()
    assert (desired.sum(axis=1) >= 1).all()
    single = tcw.reset_from_seed(cfg.replace(stacking=False), 3, 512).desired
    assert (single.sum(dim=1) == 1).all()


def test_state_helpers_equal_jax():
    """zeros_state and the one-hot bijection (core/state.py:67-174)."""
    from gym_craftingworld_tpu.core import state as jstate
    from gym_craftingworld_tpu_torch.core import state as tstate

    cfg = jcw.flat_config()
    jz = jstate.zeros_state(cfg, 3)
    tz = interop.env_state_to_numpy(tstate.zeros_state(tcw.flat_config(), 3))
    for f in dataclasses.fields(jz):
        want = np.asarray(getattr(jz, f.name))
        assert tz[f.name].shape == want.shape and tz[f.name].dtype == want.dtype, f.name
        assert not tz[f.name].any(), f.name

    ref = jcw.reset_from_seed(cfg, 2, 4)
    port = port_reset_like_jax(cfg, 2, 4)
    for b in range(4):
        onehot = jstate.reference_onehot_from_state(ref, b)
        np.testing.assert_array_equal(tstate.reference_onehot_from_state(port, b), onehot)
        init = jstate.onehot_from_packed(np.asarray(ref.init_objects[b]) % C.AGENT_INIT_MARK,
                                         np.asarray(ref.init_agent[b]), 0)
        kw = dict(desired=np.asarray(ref.desired[b]), achieved=np.asarray(ref.achieved[b]),
                  step_num=7)
        want = jstate.state_from_reference(cfg, onehot, init, **kw)
        got = interop.env_state_to_numpy(tstate.state_from_reference(
            tcw.flat_config(), onehot, init, **kw))
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(got[f.name], np.asarray(getattr(want, f.name)),
                                          err_msg=f.name)
            assert got[f.name].dtype == np.asarray(getattr(want, f.name)).dtype, f.name
