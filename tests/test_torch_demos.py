"""Expert demonstrations and behavioral cloning (``train/demos``,
``train/bc``) against the JAX package's, on the CPU.

The lockstep collection runs from JAX's reset states (carried by
``interop``) and must give JAX's ``SnapDataset`` column for column; the
façade's collection in parity mode must give JAX's ``Demos`` exactly; BC
training from the same parameters and permutations gives JAX's per-epoch
losses within the tolerance stated at its test.
"""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.reset import reset as jreset
from gym_craftingworld_tpu.models import actor_critic as jac
from gym_craftingworld_tpu.models import cpv as jcpv
from gym_craftingworld_tpu.train import bc as jbc
from gym_craftingworld_tpu.train import demos as jdemos
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.models import actor_critic as tac
from gym_craftingworld_tpu_torch.models import cpv as tcpv
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import bc as tbc
from gym_craftingworld_tpu_torch.train import demos as tdemos

from test_torch_packed_rollout import np_tree, tcfg

torch.set_num_threads(1)

CFG = EnvConfig(height=8, width=8, max_steps=100)
ENV = dict(size=(8, 8), max_steps=100, rng_mode="parity")


def host(tree):
    return jax.tree.map(np.asarray, tree)


def jax_resets(cfg, num_episodes, seed, batch):
    """The reset state JAX's ``collect_expert_demos`` draws for each batch."""
    out = []
    for bi in range(-(-num_episodes // batch)):
        B = min(batch, num_episodes - bi * batch)
        keys = jax.random.split(jax.random.PRNGKey(seed + 7919 * bi), B)
        out.append(np_tree(jreset(cfg, keys)))
    return out


@pytest.fixture(scope="module")
def snaps():
    """JAX's and the port's lockstep collection from the same resets: 24
    episodes on 8x8 in batches of 12, DART noise 0.1."""
    want = jdemos.collect_expert_demos(CFG, num_episodes=24, seed=0, noise_eps=0.1, batch=12)
    resets = [interop.env_state_from_numpy(d, device="cpu") for d in jax_resets(CFG, 24, 0, 12)]
    calls = pf.rollout_packed_actions_plain.calls
    got = tdemos.collect_expert_demos(tcfg(CFG), num_episodes=24, seed=0, noise_eps=0.1,
                                      batch=12, device="cpu", resets=resets)
    assert pf.rollout_packed_actions_plain.calls == calls  # the grid step, no kernel
    return got, want


def test_collect_expert_demos_equals_jax(snaps):
    got, want = snaps
    assert got.num_episodes == want.num_episodes >= 20 and got.num_rows == want.num_rows > 100
    for k in tdemos.SnapDataset._fields:
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


def test_snap_dataset_save_load_concat(snaps):
    d, _ = snaps
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "d.npz")
        d.save(path)
        d2 = tdemos.SnapDataset.load(path)
    for k in tdemos.SnapDataset._fields:
        np.testing.assert_array_equal(getattr(d, k), getattr(d2, k))
    both = tdemos.SnapDataset.concat(d, d2)
    assert both.num_rows == 2 * d.num_rows and both.num_episodes == 2 * d.num_episodes
    assert d._replace(action=d.action * 0).num_rows == d.num_rows  # no __len__: _replace works


def test_collect_expert_demos_draws_its_own_resets():
    """Without ``resets`` the port resets each batch from JAX's keys
    ``split(PRNGKey(seed + 7919 * bi), B)``: the same seed gives the same
    dataset, and the expert solves nearly every episode (JAX's own
    dataset: tests/test_torch_keyed_imitation.py)."""
    kw = dict(num_episodes=10, seed=5, noise_eps=0.05, batch=6, device="cpu")
    a = tdemos.collect_expert_demos(tcfg(CFG), **kw)
    b = tdemos.collect_expert_demos(tcfg(CFG), **kw)
    assert a.num_episodes >= 8 and set(np.unique(a.action)) <= set(range(6))
    for k in tdemos.SnapDataset._fields:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.fixture(scope="module")
def demos():
    """The façade's expert episodes in parity mode, with random warm-up moves,
    through each package."""
    kw = dict(num_episodes=4, seed=1, random_warmup=3, **ENV)
    return tbc.collect_demos(device="cpu", **kw), jbc.collect_demos(**kw)


def test_bc_collect_demos_equals_jax(demos):
    got, want = demos
    assert got.num_episodes == want.num_episodes >= 3
    for k in tbc.Demos._fields:
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    init = tbc.collect_demos(num_episodes=1, seed=2, feature_fn=tac.obs_features_init,
                             device="cpu", **ENV)
    jinit = jbc.collect_demos(num_episodes=1, seed=2, feature_fn=jac.obs_features_init, **ENV)
    np.testing.assert_array_equal(init.features, jinit.features)
    aug = tbc.augment_stacked_goals(got, 8, 8, 0, 5)
    jaug = jbc.augment_stacked_goals(want, 8, 8, 0, 5)
    cat, jcat = tbc.concat_demos(got, aug), jbc.concat_demos(want, jaug)
    for a, b in ((aug, jaug), (cat, jcat)):
        for k in tbc.Demos._fields:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_bc_train_matches_jax(demos):
    """``bc_train`` from JAX's parameters with JAX's per-epoch permutations:
    cross-entropy, plain Adam (no clip). Per-epoch losses within rtol 1e-3
    (measured max rel 5.7e-7) and the final accuracy within 2 rows of
    JAX's (measured equal)."""
    got_d, want_d = demos
    model = jac.ActorCritic(hidden=32)
    v = jax.jit(model.init)(jax.random.PRNGKey(4), jax.numpy.zeros((1, jac.feature_dim(8, 8))))
    key = jax.random.PRNGKey(5)
    jmodel, jparams, jm = jbc.bc_train(want_d, key, 8, 8, epochs=3, batch_size=64, lr=1e-3,
                                       model_and_params=(model, v))
    # the permutations bc_train draws from ``key``
    key, _ = jax.random.split(key)
    perms = []
    for _ in range(3):
        key, k = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(k, want_d.actions.shape[0])))
    port = interop.actor_critic_from_numpy(host(v), device="cpu")
    out, tm = tbc.bc_train(got_d, prng_key(5), 8, 8, epochs=3, batch_size=64, lr=1e-3,
                           model=port, perms=perms)
    assert out is port and len(tm["loss"]) == 3
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-3)
    n = want_d.actions.shape[0]
    assert abs(tm["accuracy"] - jm["accuracy"]) * n <= 2
    assert tm["loss"][-1] < tm["loss"][0]
    with pytest.raises(ValueError, match="feature width"):
        tbc.bc_train(got_d, prng_key(5), 7, 7, epochs=1)


def test_bc_train_fresh_and_evaluate(demos):
    """A fresh clone drawn from the key (the default ``ActorCritic`` and a
    ``CPVPolicy``) learns; greedy evaluation of the same parameters through
    each package's façade in parity mode gives JAX's summary."""
    got_d, _ = demos
    model, m = tbc.bc_train(got_d, prng_key(0), 8, 8, hidden=32, epochs=4, batch_size=64)
    assert m["loss"][-1] < m["loss"][0] and 0.0 <= m["accuracy"] <= 1.0
    assert m["accuracy"] == tbc.bc_accuracy(model, got_d)
    jmodel = jac.ActorCritic(hidden=32)
    v = interop.flax_params_to_numpy(model)
    want = jbc.evaluate_bc(jmodel, v, 2, seed=3, **ENV)
    assert tbc.evaluate_bc(model, 2, seed=3, device="cpu", **ENV) == want
    stacked = tbc.evaluate_bc_stacked(model, 1, seed=3, device="cpu", **ENV)
    assert stacked["episodes"] == 1 and 0.0 <= stacked["success_rate"] <= 1.0
    cpv_model, cm = tbc.bc_train(got_d, prng_key(2), 8, 8, epochs=2, batch_size=64,
                                 model=tcpv.init_cpv(prng_key(1), 8, 8, embed_dim=8, hidden=32))
    assert cm["loss"][-1] < cm["loss"][0]
    jcpv_model = jcpv.CPVPolicy(height=8, width=8, embed_dim=8, hidden=32)
    assert jbc.bc_accuracy(jcpv_model, interop.flax_params_to_numpy(cpv_model), got_d) == \
        pytest.approx(cm["accuracy"], abs=2 / got_d.actions.shape[0])
