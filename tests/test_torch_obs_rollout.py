"""The port's observation-interleaved rollout (``ops/obs_rollout.py``) against
the JAX package's.

The port draws its actions from JAX's key data as JAX does
(``jax.random.randint(key, (T, B), 0, 6)``, ``tests/test_torch_keyed_ladder.py``
holds the whole rollouts); its body also takes explicit actions, so JAX's
own draw goes through both packages. Checksums and final slot states must
match bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.core import slots as jsm
from gym_craftingworld_tpu.ops import obs_rollout as jobr
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core import slots as tsm
from gym_craftingworld_tpu_torch.ops import obs_rollout as tobr
from gym_craftingworld_tpu_torch.ops.keyed_draws import randint_cols
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.render import raster as tr

from test_torch_packed_rollout import assert_tree_equal, jax_and_port_slots, np_tree, tcfg

torch.set_num_threads(1)


def test_slots_to_codes_equals_to_grid_and_jax():
    cfg = jcw.ray_config()
    js, ts = jax_and_port_slots(cfg, 0, 8)
    js, _ = jsm.rollout_slots_random(cfg, js, jax.random.PRNGKey(7), 120)
    ts = interop.slot_state_from_numpy(np_tree(js), device="cpu")
    got = tobr.slots_to_codes(tcfg(cfg), ts)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 21, 21)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jobr.slots_to_codes(cfg, js)))
    assert torch.equal(got, tsm.to_grid(ts, tcfg(cfg))[0].to(torch.int32))
    assert int((ts.slot_stat != tsm.ON_GRID).sum()) > 0  # held or removed slots leave no code


@pytest.mark.parametrize("obs_mode", ["ray", "altobs", "onehot"])
def test_body_on_jax_actions_equals_jax(obs_mode):
    """The port's body on JAX's action draw gives JAX's checksum and final slots."""
    cfg = jcw.flat_config()
    key = jax.random.PRNGKey(11)
    B, T = 6, 40
    js, ts = jax_and_port_slots(cfg, 2, B)
    actions = np.array(jax.random.randint(key, (T, B), 0, 6, dtype=jnp.int32))
    j_final, j_sum = jobr.rollout_obs_random(cfg, js, key, T, obs_mode)
    t_final, t_sum = tobr._rollout_obs(tcfg(cfg), ts, torch.as_tensor(actions), obs_mode)
    assert t_sum.dtype == torch.int64 and t_sum.shape == ()
    assert int(t_sum) == int(j_sum)
    assert_tree_equal(interop.slot_state_to_numpy(t_final), np_tree(j_final))


@pytest.mark.parametrize("obs_mode", ["ray", "altobs", "onehot"])
def test_checksum_equals_stepwise_recompute(obs_mode):
    """The checksum is the sum mod 2**32 of every pixel of every step's
    observation plus the rewards (tests/test_obs_rollout.py, on the port)."""
    cfg = tcfg(jcw.flat_config())
    _, s = jax_and_port_slots(jcw.flat_config(), 4, 5)
    T = 30
    _, checksum = tobr.rollout_obs_random(cfg, s, prng_key(2), T, obs_mode)
    actions = randint_cols(prng_key(2), (T, 5), 0, 6)
    render = {"ray": tr.render_ray, "altobs": tr.render_altobs, "onehot": tr.render_onehot}[obs_mode]
    expect = 0
    for t in range(T):
        s, res = tsm.step_slots(cfg, s, actions[t])
        objects, agent, holding = tsm.to_grid(s, cfg)
        expect += int(render(objects, agent, holding).to(torch.int64).sum())
        expect += int(res.reward.to(torch.int64).sum())
    assert int(checksum) == expect % (1 << 32)


def test_final_state_equals_slot_rollout_from_one_generator_state():
    """From one key the observation rollout and the slot rollout draw the
    same actions and reach the same final state."""
    cfg = tcfg(jcw.flat_config())
    _, s = jax_and_port_slots(jcw.flat_config(), 1, 16)
    a, _ = tsm.rollout_slots_random(cfg, s, prng_key(3), 150)
    b, _ = tobr.rollout_obs_random(cfg, s, prng_key(3), 150, "onehot")
    assert_tree_equal(interop.slot_state_to_numpy(b), interop.slot_state_to_numpy(a))
    assert int((a.step_num == 100).sum()) == 16
