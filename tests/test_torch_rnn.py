"""The GRU family and recurrent PPO (``models/rnn``, ``train/ppo_rnn``)
against the JAX package's, on the CPU.

Parameters and optimizer states cross through ``interop``; env states,
Gumbel noise and env-axis permutations as numpy. Bit-exact where the result
is an integer; bf16 forwards and a whole update within the tolerance stated
at each test, beside the error measured when it was written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.models import actor_critic as jac
from gym_craftingworld_tpu.models import rnn as jrnn
from gym_craftingworld_tpu.train import ppo as jppo
from gym_craftingworld_tpu.train import ppo_rnn as jpr
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core.reset import reset as treset
from gym_craftingworld_tpu_torch.models import rnn as trnn
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops.keyed_draws import split_keys
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import ppo as tppo
from gym_craftingworld_tpu_torch.train import ppo_rnn as tpr

from test_torch_packed_rollout import np_tree, tcfg

torch.set_num_threads(1)

CFG = jcw.flat_config()  # 8x8, max_steps 100
D = jac.feature_dim(8, 8)


def host(tree):
    return jax.tree.map(np.asarray, tree)


def rnn_init(seed, hidden, batch_size=1):
    """``init_params``'s (model, variables), the init jitted."""
    model = jrnn.RecurrentActorCritic(hidden=hidden)
    h0 = model.initial_state(batch_size)
    return model, jax.jit(model.init)(jax.random.PRNGKey(seed), h0,
                                      jnp.zeros((batch_size, D)), jnp.zeros((batch_size,), bool))


def to_port(st):
    return interop.env_state_from_numpy(np_tree(st), device="cpu")


def test_gru_matches_flax_over_a_sequence_with_dones():
    """Eight steps of ``RecurrentActorCritic`` on the flat features of a
    random rollout, the hidden state carried and reset where ``done``, against
    flax's apply. rtol 2e-2 / atol 2e-2 on the hidden state, logits and value
    (measured max 1.5e-3 on h, 8.1e-4 on the logits, 1.1e-3 on the value:
    XLA's bf16 tanh and sigmoid round a gate one place apart now and then, and
    the carried state keeps it)."""
    model, v = rnn_init(0, hidden=32, batch_size=16)
    port = interop.recurrent_actor_critic_from_numpy(host(v), device="cpu")
    st = jcw.reset_from_seed(CFG, 0, 16)
    rng = np.random.default_rng(0)
    h, th = model.initial_state(16), port.initial_state(16)
    assert th.dtype == torch.float32 and tuple(th.shape) == (16, 32)
    apply = jax.jit(model.apply)
    for t in range(8):
        st, _ = jcw.rollout_random(CFG, st, jax.random.PRNGKey(t), 3)
        done = rng.random(16) < 0.25
        obs = jac.obs_features(st)
        h, jl, jv = apply(v, h, obs, jnp.asarray(done))
        with torch.no_grad():
            th, tl, tv = port(th, torch.as_tensor(np.asarray(obs)), torch.as_tensor(done))
        assert th.dtype == tl.dtype == tv.dtype == torch.float32
        for got, want in ((th, h), (tl, jl), (tv, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


def test_flax_tree_round_trips():
    """A flax tree into the port's module and back, exactly; the port's own
    initialiser gives every parameter the tree's name and shape, the
    recurrent kernels orthogonal and unbiased as flax draws them."""
    _, v = rnn_init(1, hidden=16)
    tree = host(v)
    back = interop.flax_params_to_numpy(interop.recurrent_actor_critic_from_numpy(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)
    drawn = trnn.init_params(prng_key(0), D, hidden=16)
    assert jax.tree.map(np.shape, interop.flax_params_to_numpy(drawn)) == \
        jax.tree.map(np.shape, tree)
    for name in ("hr", "hz", "hn"):
        k = getattr(drawn.gru, name).kernel.detach()
        torch.testing.assert_close(k @ k.T, torch.eye(16), rtol=0, atol=1e-5)
    assert drawn.gru.hr.bias is None and drawn.gru.hn.bias is not None


def _jax_rnn_state(seed, B, hidden):
    """A JAX ``RnnTrainState`` as ``init_rnn_train_state`` makes it, and the
    port's copy of it."""
    p = jppo.PPOConfig(rollout_steps=6, update_epochs=2, num_minibatches=2, hidden=hidden)
    model, v = rnn_init(seed, hidden, B)
    ts = jpr.RnnTrainState(params=v, opt_state=jppo.make_optimizer(p).init(v),
                           hidden=model.initial_state(B), prev_done=jnp.zeros((B,), bool),
                           update_idx=jnp.int32(0))
    d = host(ts._asdict())
    return p, ts, interop.rnn_train_state_from_numpy(d, device="cpu")


def test_train_step_rnn_matches_jax():
    """One whole ``train_step_rnn`` of JAX's and of the port's from the same
    parameters and env state, with JAX's Gumbel draws and env permutations
    passed in. No env finishes within T (asserted), so auto-reset draws no
    world. The rollout (final grid, dones) is bit-exact; the metrics within
    rtol 2e-3 / atol 2e-3 (measured max 5.1e-6 on the loss); the hidden state
    within atol 1e-2 (measured 2.0e-3, one bf16 place). After the 4 Adam steps
    each kernel is within 2e-3 relative L2 of JAX's (measured max 4.2e-4). A
    coordinate whose gradient is near zero can take its first Adam steps with
    the other sign (the step is lr * m / sqrt(v), about lr whatever the
    gradient's size), so in each tensor at most 5% of the coordinates end more
    than lr / 2 apart (measured max 3.1%, a gate bias) and none more than 5 lr
    (measured 3.9 lr). The Adam count is exact."""
    B, hidden = 8, 32
    p, jts, tts = _jax_rnn_state(2, B, hidden)
    tp = tppo.PPOConfig(**p._asdict())
    st = jcw.reset_from_seed(CFG, 2, B)
    tst = to_port(st)
    key = jax.random.PRNGKey(3)
    # the draws train_step_rnn makes from ``key``
    _, k_roll, k_perm = jax.random.split(key, 3)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (B, 6)))
                      for k in jax.random.split(k_roll, p.rollout_steps)])
    perms = np.stack([np.asarray(jax.random.permutation(k, B))
                      for k in jax.random.split(k_perm, p.update_epochs)])
    jts2, jst2, _, jm = jpr.train_step_rnn(CFG, p, jts, st, key)
    g = prng_key(3)  # the same key data; the noise and permutations passed in
    calls = pf.rollout_packed_actions_plain.calls
    tts2, tst2, _, tm = tpr.train_step_rnn(tcfg(CFG), tp, tts, tst, g, torch.as_tensor(noise),
                                           torch.as_tensor(perms))
    assert pf.rollout_packed_actions_plain.calls == calls  # the grid step, no kernel
    assert not np.asarray(jts2.prev_done).any()  # no env finished within T
    np.testing.assert_array_equal(interop.env_state_to_numpy(tst2)["objects"],
                                  np.asarray(jst2.objects))
    np.testing.assert_array_equal(tts2.prev_done.numpy(), np.asarray(jts2.prev_done))
    assert tts2.update_idx == int(jts2.update_idx) == 1
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=2e-3, err_msg=k)
    np.testing.assert_allclose(tts2.hidden.numpy(), np.asarray(jts2.hidden), rtol=0, atol=1e-2)
    want = interop._flat_tree(host(jts2.params["params"]))
    got = {k: v.detach().numpy() for k, v in tts2.params.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        off = np.abs(got[k] - w)
        assert off.max() <= 5 * p.lr and (off > p.lr / 2).mean() <= 0.05, k
        if k.endswith("kernel"):
            assert np.linalg.norm(got[k] - w) / np.linalg.norm(w) <= 2e-3, k
    assert int(tts2.opt_state.count) == int(jts2.opt_state[1][0].count) == 4


def test_train_step_rnn_draws_and_resets():
    """The port's own draws: Gumbel noise and permutations from the step's
    key, auto-reset from the envs' keys (envs started near
    ``max_steps`` finish within T); every kernel changes and the metrics are
    finite."""
    cfg = tcfg(CFG)
    p = tppo.PPOConfig(rollout_steps=6, num_minibatches=2, hidden=16)
    ts = tpr.init_rnn_train_state(prng_key(4), cfg, p, 8)
    assert not ts.prev_done.any() and not ts.hidden.any()
    before = {k: v.detach().clone() for k, v in ts.params.named_parameters()}
    st = treset(cfg, split_keys(prng_key(4), 8))
    st.step_num[:] = CFG.max_steps - 2
    ts, st, key, m = tpr.train_step_rnn(cfg, p, ts, st, prng_key(5))
    assert bool((st.step_num < 6).all())  # every env restarted within T
    assert set(m) == {"loss", "reward_mean", "success_rate"}
    assert all(np.isfinite(float(x)) for x in m.values())
    after = dict(ts.params.named_parameters())
    assert all(not torch.equal(before[k], after[k]) for k in before if k.endswith("kernel"))
    with pytest.raises(ValueError):
        tpr.train_step_rnn(cfg, p._replace(num_minibatches=3), ts, st, key)
