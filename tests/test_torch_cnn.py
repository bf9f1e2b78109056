"""The CNN family (``models/cnn.py``) against the JAX package's flax modules, on the CPU.

Both packages run the same flax parameters (moved across with ``interop``)
on the same pixels. The observation builders must match byte for byte; the
forward passes within the tolerance stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.models import cnn as jcnn
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.models import cnn as tcnn
from gym_craftingworld_tpu_torch.ops.threefry import prng_key

from test_torch_packed_rollout import np_tree
from test_torch_render import stepped_state

torch.set_num_threads(1)


def host(v):
    return jax.tree.map(np.asarray, v)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("hw", [8, 21])
def test_pixel_actor_critic_matches_flax(hw):
    """21x21 meets the (1, 2) SAME pad of the 4x4/2 conv. Logits and values
    at rtol 2e-2 / atol 2e-2, the tolerance of a bf16 conv stack (measured
    max 3e-8 on 8x8, 4.8e-4 on 21x21)."""
    model, v = jcnn.init_params(jax.random.PRNGKey(hw), hw, hw, hidden=64)
    rng = np.random.default_rng(hw)
    px = rng.integers(0, 256, (4, 4 * hw, 4 * hw, 3)).astype(np.uint8)
    goal = (rng.random((4, 18)) < 0.5).astype(np.float32)
    jl, jv = model.apply(v, px, goal)
    port = interop.pixel_actor_critic_from_numpy(host(v), device="cpu")
    with torch.no_grad():
        tl, tv = port(torch.as_tensor(px), torch.as_tensor(goal))
    assert tl.dtype == tv.dtype == torch.float32 and tuple(tv.shape) == (4,)
    close(tl, jl, 2e-2, 2e-2)
    close(tv, jv, 2e-2, 2e-2)


@pytest.mark.parametrize("hw", [8, 21])
def test_pixel_distill_student_matches_flax(hw):
    """The 4x4/4 stem, three 3x3 convs, the 1x1 squeeze and two dense layers
    at narrow widths. rtol 2e-2 / atol 2e-2 (measured max 7.5e-9 on 8x8 and
    on 21x21)."""
    cfg = jcw.ray_config(height=hw, width=hw)
    model, v = jcnn.init_student(jax.random.PRNGKey(hw + 1), cfg, channels=16, hidden=64, stem=8)
    images = np.random.default_rng(hw).integers(0, 256, (3, 4 * hw, 4 * hw, 9)).astype(np.uint8)
    jl, jv = model.apply(v, images)
    port = interop.pixel_distill_student_from_numpy(host(v), device="cpu")
    with torch.no_grad():
        tl, tv = port(torch.as_tensor(images))
    close(tl, jl, 2e-2, 2e-2)
    close(tv, jv, 2e-2, 2e-2)


def test_pixel_obs_and_student_images_byte_exact():
    """On a stepped 21x21 state with every held code 0..3 in the batch."""
    st = stepped_state(21, 21, seed=3)
    st = st.replace(holding=jnp.arange(st.holding.shape[0], dtype=jnp.int32) % 4)
    port = interop.env_state_from_numpy(np_tree(st), device="cpu")
    for got, want in zip(tcnn.pixel_obs(port), jcnn.pixel_obs(st)):
        assert got.dtype == {np.uint8: torch.uint8, np.float32: torch.float32}[np.asarray(want).dtype.type]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fields = ("objects", "agent", "holding", "goal_objects", "goal_agent", "init_objects",
              "init_agent")
    want = jcnn.student_images(None, *(getattr(st, f) for f in fields))
    got = tcnn.student_images(None, *(getattr(port, f) for f in fields))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (6, 84, 84, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_params_draw_flax_shapes():
    """The port's initialisers give every parameter the flax tree's name and
    shape, on the key's device."""
    g = prng_key(0)
    for port, (_, v) in ((tcnn.init_params(g, 8, 8, 32), jcnn.init_params(jax.random.PRNGKey(0), 8, 8, 32)),
                         (tcnn.init_student(g, jcw.flat_config(), 16, 64, 8),
                          jcnn.init_student(jax.random.PRNGKey(0), jcw.flat_config(), 16, 64, 8))):
        got = jax.tree.map(np.shape, interop.flax_params_to_numpy(port))
        assert got == jax.tree.map(np.shape, host(v))
