"""The CPV family (``models/cpv``) against the JAX package's, on the CPU.

``CPVPolicy`` on the flat features (with and without the init view) and
``CPVGridPolicy`` on the grid planes, with parameters carried by ``interop``;
CPVGridPolicy's protocol purity (the goal enters only through the plan
vector) and the plan vector's additivity in the port. bf16 forwards within
the tolerance stated at each test, beside the error measured when it was
written.
"""

import jax
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.models import actor_critic as jac
from gym_craftingworld_tpu.models import cpv as jcpv
from gym_craftingworld_tpu.models import grid_policy as jgp
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.models import actor_critic as tac
from gym_craftingworld_tpu_torch.models import cpv as tcpv
from gym_craftingworld_tpu_torch.models import grid_policy as tgp
from gym_craftingworld_tpu_torch.ops.threefry import prng_key

from test_torch_packed_rollout import np_tree, tcfg

torch.set_num_threads(1)

CFG = jcw.EnvConfig(height=8, width=8, max_steps=100)


def host(tree):
    return jax.tree.map(np.asarray, tree)


def cpv_init(seed, embed_dim, hidden, with_init=False):
    """``init_cpv``'s (model, variables), the init jitted."""
    model = jcpv.CPVPolicy(height=8, width=8, embed_dim=embed_dim, hidden=hidden,
                           with_init=with_init)
    dim = jac.feature_dim_init(8, 8) if with_init else jac.feature_dim(8, 8)
    return model, jax.jit(model.init)(jax.random.PRNGKey(seed), jax.numpy.zeros((1, dim)))


def cpv_grid_init(seed, channels, hidden, embed_dim):
    """``init_cpv_grid``'s (model, variables), the init jitted."""
    model = jcpv.CPVGridPolicy(channels=channels, hidden=hidden, embed_dim=embed_dim)
    dummy = (jax.numpy.zeros((1, 8, 8, jgp.N_PLANES), jax.numpy.bfloat16),
             jax.numpy.zeros((1, jgp.N_EXTRAS), jax.numpy.bfloat16))
    return model, jax.jit(model.init)(jax.random.PRNGKey(seed), *dummy)


def mid_episode(seed=2, steps=30, batch=16):
    st = jcw.reset_from_seed(CFG, seed, batch)
    st, _ = jcw.rollout_random(CFG, st, jax.random.PRNGKey(seed), steps)
    return st, interop.env_state_from_numpy(np_tree(st), device="cpu")


@pytest.mark.parametrize("with_init", [False, True])
def test_cpv_policy_matches_flax(with_init):
    """The flat family on ``obs_features`` (``obs_features_init`` with the init
    view): the residual plan vector, an f32 product rounded to bf16, joins
    the bf16 torso. rtol 2e-2 / atol 2e-2 (measured max 1.8e-7 and 2.4e-7:
    the same rounding points)."""
    st, tst = mid_episode()
    model, v = cpv_init(2, embed_dim=8, hidden=64, with_init=with_init)
    feats = (jac.obs_features_init if with_init else jac.obs_features)(st)
    jl, jv = jax.jit(model.apply)(v, feats)
    port = interop.cpv_policy_from_numpy(host(v), 8, 8, with_init=with_init, device="cpu")
    tfeats = (tac.obs_features_init if with_init else tac.obs_features)(tst)
    np.testing.assert_array_equal(tfeats.numpy(), np.asarray(feats))
    with torch.no_grad():
        tl, tv = port(tfeats)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-2, atol=2e-2)
    # the wrong width raises, as flax's module does
    other = tac.obs_features(tst) if with_init else tac.obs_features_init(tst)
    with pytest.raises(ValueError, match="obs width"):
        port(other)


def test_cpv_grid_policy_matches_flax():
    """The grid family on the planes and extras of the grid policy. rtol 2e-2
    / atol 2e-2 (measured max 1.5e-8)."""
    st, tst = mid_episode(seed=4)
    model, v = cpv_grid_init(1, channels=16, hidden=64, embed_dim=8)
    jl, jv = jax.jit(model.apply)(v, *jgp.planes_from_state(CFG, st))
    port = interop.cpv_grid_policy_from_numpy(host(v), device="cpu")
    with torch.no_grad():
        tl, tv = port(*tgp.planes_from_state(tcfg(CFG), tst))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-2, atol=2e-2)


def test_cpv_grid_policy_reads_goal_only_through_plan_vector():
    """As ``tests/test_round5_models.py`` holds flax's module: scrambling the
    goal and residual planes (channels 18+) or the residual scalars
    (``extras[22:-2]``) changes nothing, flipping a desired bit does."""
    cfg = tcfg(CFG)
    port = tcpv.init_cpv_grid(prng_key(0), cfg, channels=8, hidden=32)
    _, tst = mid_episode(seed=1, steps=0, batch=4)
    planes, extras = tgp.planes_from_state(cfg, tst)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        logits, _ = port(planes, extras)
        assert tuple(logits.shape) == (4, C.N_ACTIONS)
        scrambled = planes.clone()
        scrambled[..., 18:] = torch.rand(scrambled[..., 18:].shape, generator=g).to(torch.bfloat16)
        assert torch.equal(port(scrambled, extras)[0], logits)
        ex = extras.clone()
        ex[..., 22:-2] = torch.rand(ex[..., 22:-2].shape, generator=g).to(torch.bfloat16)
        assert torch.equal(port(planes, ex)[0], logits)
        ex = extras.clone()
        ex[..., 4:13] = 1.0 - ex[..., 4:13]
        assert not torch.equal(port(planes, ex)[0], logits)


def test_plan_of_matches_jax_and_adds_up():
    """``plan_of`` equals JAX's on the same embedding, and plans compose:
    plan({A, B}) = plan({A}) + plan({B}), finishing A leaves plan({B})."""
    model, v = cpv_init(3, embed_dim=8, hidden=32)
    port = interop.cpv_policy_from_numpy(host(v), 8, 8, device="cpu")
    rng = np.random.default_rng(3)
    des = rng.integers(0, 2, (5, C.N_TASKS)).astype(np.int8)
    ach = (des & rng.integers(0, 2, (5, C.N_TASKS))).astype(np.int8)
    want = np.asarray(jcpv.plan_of(model, v, des, ach))
    got = tcpv.plan_of(port, des, ach)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    a, b, none = (np.eye(C.N_TASKS, dtype=np.int8)[[0]], np.eye(C.N_TASKS, dtype=np.int8)[[5]],
                  np.zeros((1, C.N_TASKS), np.int8))
    both = tcpv.plan_of(port, a | b, none)
    torch.testing.assert_close(both, tcpv.plan_of(port, a, none) + tcpv.plan_of(port, b, none))
    torch.testing.assert_close(tcpv.plan_of(port, a | b, a), tcpv.plan_of(port, b, none))


ROUND_TRIPS = {
    "cpv": (lambda: cpv_init(0, 8, 32)[1],
            lambda t: interop.cpv_policy_from_numpy(t, 8, 8, device="cpu"),
            lambda g: tcpv.init_cpv(g, 8, 8, 8, 32)),
    "cpv_with_init": (lambda: cpv_init(0, 8, 32, True)[1],
                      lambda t: interop.cpv_policy_from_numpy(t, 8, 8, True, device="cpu"),
                      lambda g: tcpv.init_cpv(g, 8, 8, 8, 32, True)),
    "cpv_grid": (lambda: cpv_grid_init(0, 8, 32, 8)[1],
                 lambda t: interop.cpv_grid_policy_from_numpy(t, device="cpu"),
                 lambda g: tcpv.init_cpv_grid(g, tcfg(CFG), 8, 32, 8)),
}


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_flax_tree_round_trips(name):
    """A flax tree into the port's module and back, exactly; the port's own
    initialiser gives every parameter the tree's name and shape, the task
    embedding drawn from a standard normal."""
    make_jax, from_numpy, make_port = ROUND_TRIPS[name]
    tree = host(make_jax())
    back = interop.flax_params_to_numpy(from_numpy(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)
    drawn = make_port(prng_key(0))
    assert jax.tree.map(np.shape, interop.flax_params_to_numpy(drawn)) == \
        jax.tree.map(np.shape, tree)
    E = drawn.task_embed.detach()
    assert 0.5 < float(E.std()) < 1.5 and not torch.equal(E, torch.zeros_like(E))
