"""The port's vector env (``api/vector.py``) against the JAX package's.

Both envs step from one shared state (a JAX state carried across with
``interop``) on one action batch. Envs that are not done must give JAX's
observations and infos exactly; every env gives JAX's reward, terminated and
truncated. Done envs restart from fresh worlds drawn from each package's own
stream, so there they are held to ``step_num == 0`` and valid worlds.
"""

import numpy as np
import pytest
import torch

from gym_craftingworld_tpu.api.vector import CraftingWorldVectorEnv as JVec
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.api.vector import CraftingWorldVectorEnv as TVec
from gym_craftingworld_tpu_torch.core import validate

from test_torch_packed_rollout import np_tree

torch.set_num_threads(1)

MODES = {"onehot": ((8, 8, 12), torch.uint8), "pixels": ((32, 32, 3), torch.uint8),
         "features": ((8 * 8 * 12 + 18,), torch.float32)}


@pytest.mark.parametrize("mode", list(MODES))
def test_contract(mode):
    shape, dtype = MODES[mode]
    t = TVec(6, size=(8, 8), max_steps=20, obs_mode=mode, seed=1, device="cpu")
    j = JVec(6, size=(8, 8), max_steps=20, obs_mode=mode, seed=1)
    for a, b in ((t.single_observation_space, j.single_observation_space),
                 (t.single_action_space, j.single_action_space), (t.action_space, j.action_space)):
        assert (type(a).__name__, a.shape, a.dtype) == (type(b).__name__, b.shape, b.dtype)
    assert t.single_observation_space.shape == shape and t.action_space.n == 6
    obs, info = t.reset()
    assert info == {} and obs.shape == (6,) + shape and obs.dtype == dtype
    assert obs.device.type == "cpu" and isinstance(obs, torch.Tensor)
    obs, rew, term, trunc, infos = t.step(np.arange(6) % 6)
    assert obs.shape == (6,) + shape and obs.dtype == dtype
    assert rew.dtype == torch.int32 and term.dtype == trunc.dtype == torch.bool
    assert all(x.device.type == "cpu" for x in (rew, term, trunc, *infos.values()))
    assert set(infos) == {"achieved_goal", "desired_goal"}
    with pytest.raises(ValueError):
        TVec(2, obs_mode="rgb", device="cpu")


@pytest.mark.parametrize("mode", list(MODES))
def test_step_from_a_shared_state_equals_jax(mode):
    B, T = 32, 4
    j = JVec(B, size=(8, 8), max_steps=10, obs_mode=mode, seed=3)
    t = TVec(B, size=(8, 8), max_steps=10, obs_mode=mode, seed=3, device="cpu")
    j.reset()
    t.reset()
    rng = np.random.RandomState(3)
    dones = 0
    for step in range(T):
        state = {k: np.array(v) for k, v in np_tree(j.state).items()}  # writable copies
        if step == 0:  # half the envs one step from their cap
            state["step_num"][: B // 2] = 9
            j._state = type(j.state)(**state)
        t._state = interop.env_state_from_numpy(state, device="cpu")
        actions = rng.randint(6, size=B).astype(np.int32)
        jo, jr, jt, jtr, ji = j.step(actions)
        to, tr, tt, ttr, ti = t.step(actions)
        for got, want in ((tr, jr), (tt, jt), (ttr, jtr)):
            assert got.numpy().dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        done = np.asarray(jt) | np.asarray(jtr)
        live = ~done
        np.testing.assert_array_equal(to.numpy()[live], np.asarray(jo)[live])
        for k in ji:
            np.testing.assert_array_equal(ti[k].numpy()[live], np.asarray(ji[k])[live])
        np.testing.assert_array_equal(t.state.step_num.numpy()[live],
                                      np.asarray(j.state.step_num)[live])
        assert (t.state.step_num.numpy()[done] == 0).all()
        assert validate.check_state(t.cfg, t.state).all()
        dones += int(done.sum())
    assert dones >= B // 2


def test_autoreset_counts():
    """tests/test_vector_env.py's count, on the port."""
    env = TVec(8, size=(5, 5), max_steps=3, seed=2, device="cpu")
    env.reset()
    truncs = 0
    for _ in range(9):
        _, _, term, trunc, _ = env.step(np.zeros(8, np.int32))
        truncs += int(trunc.sum())
    assert truncs >= 16  # 3 full cycles x 8 envs - successes
    assert int(env.state.step_num.max()) <= 3


def test_reset_seed_and_default_device():
    a = TVec(4, size=(8, 8), seed=5, device="cpu")
    b = TVec(4, size=(8, 8), seed=9, device="cpu")
    oa, _ = a.reset()
    ob, _ = b.reset(seed=5)
    assert torch.equal(oa, ob)
    import inspect

    assert inspect.signature(TVec).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TVec(4)
