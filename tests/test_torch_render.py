"""The port's renderers (``render/raster.py``) against the JAX package's.

States come from JAX resets and random steps, or are made with numpy from a
seed (the agent on every edge and corner, every held item, a held item over
an object of the same kind); both packages render the same state, and every
image must match byte for byte, dtype included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.core.state import EnvState as JEnvState
from gym_craftingworld_tpu.render import raster as jr
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.render import raster as tr

from test_torch_packed_rollout import np_tree

torch.set_num_threads(1)

SHAPES = [(21, 21), (8, 8), (7, 11)]
RENDERERS = ["render_ray", "render_altobs", "render_onehot"]


def stepped_state(H, W, seed, B=6, steps=40):
    """A JAX reset after ``steps`` random steps (pickups, crafting, held items)."""
    cfg = jcw.ray_config(height=H, width=W, max_steps=1000)
    st = jcw.reset_from_seed(cfg, seed, B)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        st, _ = jcw.step(cfg, st, jnp.asarray(rng.randint(6, size=B), jnp.int32))
    return st


def edge_cases(H, W, seed):
    """(objects int8[B,H,W], agent int32[B,2], holding int32[B]) with the agent
    on each corner and edge and inside, each held code 0..3, random objects,
    and at every other spot the agent's cell holding the held item's own kind
    (AltObs then doubles that tile slot, up to 510)."""
    rng = np.random.RandomState(seed)
    spots = [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1), (0, W // 2),
             (H - 1, W // 2), (H // 2, 0), (H // 2, W - 1), (H // 2, W // 2)]
    B = len(spots) * 4
    agent = np.array([spots[i // 4] for i in range(B)], np.int32)
    holding = np.array([i % 4 for i in range(B)], np.int32)
    objects = np.where(rng.rand(B, H, W) < 0.3, rng.randint(1, 9, (B, H, W)), 0).astype(np.int8)
    same = ((np.arange(B) // 4) % 2 == 1) & (holding > 0)
    objects[np.arange(B)[same], agent[same, 0], agent[same, 1]] = holding[same]
    return objects, agent, holding


def render_both(name, objects, agent, holding):
    want = np.asarray(getattr(jr, name)(jnp.asarray(objects), jnp.asarray(agent),
                                        jnp.asarray(holding)))
    got = getattr(tr, name)(torch.as_tensor(objects), torch.as_tensor(agent),
                            torch.as_tensor(holding))
    return got.numpy(), want


@pytest.mark.parametrize("name", RENDERERS)
@pytest.mark.parametrize("H,W", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_renderer_equals_jax(name, H, W):
    st = stepped_state(H, W, seed=H * W)
    cases = [(np.array(st.objects), np.array(st.agent), np.array(st.holding)),
             edge_cases(H, W, seed=H + W)]
    for objects, agent, holding in cases:
        got, want = render_both(name, objects, agent, holding)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if name == "render_altobs":
        assert int(got.max()) > 255  # a held item over its own kind doubles a slot


@pytest.mark.parametrize("H,W", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_state_images_equal_jax(H, W):
    """The three observation dicts (current, goal and init views), the init
    marker stripped, and the stacked AltObs."""
    st = stepped_state(H, W, seed=7, steps=25)
    port = interop.env_state_from_numpy(np_tree(st), device="cpu")
    assert (np.asarray(st.init_objects) == 9).any()  # the agent-init marker is there
    for name in ("state_images_ray", "state_images_altobs", "state_obs_onehot"):
        want = getattr(jr, name)(JEnvState(**{k: jnp.asarray(v) for k, v in np_tree(st).items()}))
        got = getattr(tr, name)(port)
        assert set(got) == set(want)
        for k in want:
            g, w = got[k].numpy(), np.asarray(want[k])
            assert g.dtype == w.dtype, (name, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {k}")
        assert got["observation"] is got["achieved_goal"]
    got = tr.state_images_altobs(port, stacked=True).numpy()
    want = np.asarray(jr.state_images_altobs(st, stacked=True))
    assert got.shape == (st.objects.shape[0], 4, 3 * (H + 1), 3 * W, 3)
    np.testing.assert_array_equal(got, want)


def test_render_edit_equals_full_render():
    """Repainting the cells a step changed gives the full render of the new
    state, the JAX package's render_ray, at every step."""
    cfg = jcw.ray_config(height=8, width=8, max_steps=1000)
    st = jcw.reset_from_seed(cfg, 6, 1)
    rng = np.random.RandomState(6)  # this walk picks items up and drops them
    t = lambda s: tr.render_ray(*(torch.as_tensor(np.array(x)) for x in
                                  (s.objects, s.agent, s.holding)))[0].numpy()
    img = t(st).copy()
    objects, agent = np.asarray(st.objects[0]), tuple(np.asarray(st.agent[0]).tolist())
    held = 0
    for _ in range(120):
        st, _ = jcw.step(cfg, st, jnp.asarray([rng.choice([0, 1, 2, 3, 4, 4, 5])], jnp.int32))
        new_obj, new_agent = np.asarray(st.objects[0]), tuple(np.asarray(st.agent[0]).tolist())
        changed = {new_agent, agent} | set(map(tuple, np.argwhere(new_obj != objects).tolist()))
        tr.render_edit(img, new_obj, new_agent, int(st.holding[0]), changed)
        want = np.asarray(jr.render_ray(st.objects, st.agent, st.holding))[0]
        np.testing.assert_array_equal(img, want)
        np.testing.assert_array_equal(img, t(st))
        objects, agent = new_obj, new_agent
        held += int(st.holding[0]) > 0
    assert held > 0


def test_renders_stay_on_the_state_device_and_leave_it_alone():
    objects, agent, holding = edge_cases(8, 8, seed=1)
    o, a, h = (torch.as_tensor(x) for x in (objects, agent, holding))
    for name in RENDERERS:
        out = getattr(tr, name)(o, a, h)
        assert out.device == o.device
    np.testing.assert_array_equal(o.numpy(), objects)
    np.testing.assert_array_equal(h.numpy(), holding)
    st = dataclasses.replace(interop.env_state_from_numpy(np_tree(stepped_state(8, 8, 2)),
                                                          device="cpu"))
    before = st.init_objects.clone()
    tr.state_images_ray(st)
    assert torch.equal(st.init_objects, before)


@pytest.mark.parametrize("H,W", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_policy_features_equal_jax(H, W):
    """``models.actor_critic``'s features (the vector env's ``features`` mode),
    with and without the init-grid one-hot, and their widths."""
    from gym_craftingworld_tpu.models import actor_critic as jac
    from gym_craftingworld_tpu_torch.models import actor_critic as tac

    st = stepped_state(H, W, seed=3, steps=30)
    port = interop.env_state_from_numpy(np_tree(st), device="cpu")
    for name, width in (("obs_features", "feature_dim"), ("obs_features_init", "feature_dim_init")):
        got, want = getattr(tac, name)(port), np.asarray(getattr(jac, name)(st))
        assert got.dtype == torch.float32 and got.shape[1] == getattr(tac, width)(H, W)
        assert getattr(tac, width)(H, W) == getattr(jac, width)(H, W)
        np.testing.assert_array_equal(got.numpy(), want)
