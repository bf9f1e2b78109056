"""The PPO trainers' own draws from JAX's key chain, against JAX's, on the CPU.

One update of each trainer from the same key and the same carried
parameters, the port drawing for itself (``train_step_fast`` with the keyed
pool, ``train_step_pixel``, ``train_step``, ``train_step_rnn``). Bit for
bit: the next key, the pool of 2B worlds and the pool kernel's seeds, the
Gumbel uniforms and the epoch permutations. Within the stated tolerance:
``train/ppo.py``'s and the GRU's Gumbel noise (torch's logarithms against
XLA's: ``tests/test_torch_threefry.py``). The actions equal JAX's where the
Gumbel argmax is decided by a margin the logits' float differences cannot
flip (every draw here), and then the updated parameters and metrics agree
within the existing suites' tolerances, and each parameter's change over the
update with JAX's change within ``MOVE_TOL``. JAX's steps, collects, pools and
inits are jitted (eagerly they compile op by op), the steps once a file
(``jax_steps``); the wrappers run their plain versions here.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.train import fast_pixel_ppo as jfx
from gym_craftingworld_tpu.train import fast_ppo as jfp
from gym_craftingworld_tpu.train import ppo as jppo
from gym_craftingworld_tpu.train import ppo_rnn as jpr
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx
from gym_craftingworld_tpu_torch.train import fast_ppo as fp
from gym_craftingworld_tpu_torch.train import ppo as tppo
from gym_craftingworld_tpu_torch.train import ppo_rnn as tpr

from test_torch_fast_pixel_ppo import port_params as pixel_params
from test_torch_fast_pixel_ppo import port_ppo as pixel_ppo
from test_torch_fast_ppo import jax_gumbel_uniforms, port_fppo, port_params, to_port
from test_torch_packed_rollout import assert_tree_equal, np_tree, tcfg
from test_torch_rnn import _jax_rnn_state, host

torch.set_num_threads(1)

SINGLE = dataclasses.replace(jcw.flat_config(), stacking=False)
KEY = 21
# Gumbel noise of train/ppo.py and the GRU: torch's log of log against XLA's
# (measured max 1 ulp of max(|x|, 1), tests/test_torch_threefry.py)
NOISE_ULPS = 2
TRAJ = ("action", "done", "reward")
# Relative L2 of each parameter's change over the update from JAX's change
# (``check_moves``); measured max: fast PPO's f32 products 4.8e-6, the flax
# mlp 2.6e-3, pixel PPO's bf16 convolutions 5.3e-2, the GRU's bf16 Dense 0.103
MOVE_TOL = {"fast": 1e-4, "ppo": 1e-2, "pixel": 0.1, "rnn": 0.2}


def host_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@functools.lru_cache(maxsize=None)
def jax_steps():
    """JAX's four steps, jitted once (not donating their inputs)."""
    fast = jax.jit(jfp.train_step_fast.__wrapped__, static_argnums=(0, 1),
                   static_argnames=("fused_pool", "fused_update"))
    pixel = jax.jit(jfx.train_step_pixel.__wrapped__, static_argnums=(0, 1))
    ppo = jax.jit(jppo.train_step.__wrapped__, static_argnums=(0, 1))
    rnn = jax.jit(jpr.train_step_rnn.__wrapped__, static_argnums=(0, 1))
    return fast, pixel, ppo, rnn


jax_fresh = jax.jit(jfp.fresh_packed_batch, static_argnums=(0, 2))  # eager, it compiles op by op


@functools.partial(jax.jit, static_argnums=(0, 1))
def jax_fast_collect(cfg, fppo, params, env, pool, k_roll):
    """JAX's fast-PPO collect, with each stored feature's logits."""
    env, traj = jfp._collect(cfg, fppo, params, env, pool, k_roll)
    return env, traj, jax.vmap(lambda f: jfp.apply_policy(params, f)[0])(traj.feat)


@functools.partial(jax.jit, static_argnums=(0, 1))
def jax_ppo_collect(cfg, ppo, params, env, k_roll):
    """``train/ppo.py``'s collect, with each stored snapshot's logits."""
    _, apply_fn = jppo.make_policy(ppo)
    _, traj = jppo._collect(cfg, ppo, apply_fn, params, env, k_roll)
    return traj, jax.vmap(lambda o: apply_fn(params, o)[0])(traj.obs)


@functools.partial(jax.jit, static_argnums=(0, 1))
def jax_pixel_collect(cfg, ppo, params, env, pool, k_roll):
    """JAX's pixel-PPO collect, with each stored state's logits."""
    env, traj = jfx._collect_pixel(cfg, ppo, params, env, pool, k_roll)
    return env, traj, jax.vmap(lambda st: jfx._policy_tb(params, cfg, st, ppo.stride1)[0])(
        traj.state)


def same(got: torch.Tensor, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


def same_bits(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want, np.float32).view(np.int32))


def noise_ulps(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    step = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    return float((np.abs(got.numpy().astype(np.float64) - want) / step).max())


def margins(logits, noise, axis):
    """The gap of the two best noisy logits of each draw."""
    g = np.sort(np.asarray(logits) + np.asarray(noise), axis=axis)
    return np.take(g, -1, axis=axis) - np.take(g, -2, axis=axis)


def check_params(got: dict, want: dict, atol: float):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)


def check_moves(got: dict, want: dict, before: dict, rtol: float):
    """Each parameter's change over the update against JAX's: the relative
    L2 of the port's change from JAX's at most ``rtol``, and every tensor
    that JAX moved moved (an update that changed nothing is 100% off)."""
    assert sorted(got) == sorted(want) == sorted(before)
    errs = {}
    for k, w in want.items():
        dw = np.asarray(w, np.float64) - before[k]
        dg = np.asarray(got[k], np.float64) - before[k]
        assert np.linalg.norm(dw) > 0, k
        errs[k] = float(np.linalg.norm(dg - dw) / np.linalg.norm(dw))
    assert max(errs.values()) <= rtol, errs


# ---------------------------------------------------------------------------
# fast PPO and pixel PPO: bit-exact draws, then one whole update
# ---------------------------------------------------------------------------


def test_train_step_fast_draws_and_update_equal_jax():
    """``train_step_fast`` with the keyed pool (JAX's ``fused_pool=False``)
    and autograd: the key chain, the pool, the pool kernel's seeds, the
    uniforms and the permutations bit for bit; the collect's actions,
    dones and rewards equal; the metrics within ``test_update_phase_
    matches_jax_autodiff``'s rtol 2e-3 / atol 2e-4 and the parameters within
    2 lr a minibatch step."""
    cfg = SINGLE
    fppo = jfp.FastPPOConfig(rollout_steps=8, num_minibatches=2, update_epochs=2, hidden=32)
    B = 128
    key = jax.random.PRNGKey(KEY)
    jts = jfp.init_fast_train_state(jax.random.PRNGKey(1), cfg, fppo)
    jenv = jax_fresh(cfg, jax.random.PRNGKey(2), B)
    jenv = jenv._replace(step_num=jax.random.randint(jax.random.PRNGKey(3), (B,), 92, 100)
                         .astype(jnp.int16))  # auto-resets within T
    tcf, tp = tcfg(cfg), port_fppo(fppo)
    params = port_params(jts.params)
    ts = fp.FastTrainState(params, fp.make_optimizer(tp).init(params.tensors()), 0)
    env = to_port(jenv)
    init_w = {k: np.array(v) for k, v in jts.params._asdict().items()}

    nxt, k_pool, k_roll, k_perm = jax.random.split(key, 4)
    tkey = torch.as_tensor(np.asarray(key).astype(np.int64))
    tk = kd.split_keys(tkey, 4)
    same(tk, jax.random.split(key, 4))
    pool = fp._fresh_pool(tcf, tk[1], 2 * B, fused=False)
    assert_tree_equal(interop.packed_state_to_numpy(pool),
                      np_tree(jax_fresh(cfg, k_pool, 2 * B)))
    same(kd.randint(tk[1], (2,), 0, 2**31 - 1), jax.random.randint(k_pool, (2,), 0, 2**31 - 1))
    u = jax_gumbel_uniforms(k_roll, fppo.rollout_steps, B)
    same_bits(fp.gumbel_uniforms(tk[2], fppo.rollout_steps, B), u)

    t_env, r, t_next = fp.rollout_phase(tcf, tp, ts, env, tkey, fused_pool=False)
    same(t_next, nxt)
    NB = fppo.rollout_steps * B // jfp.shuffle_block(fppo.rollout_steps, B, fppo.num_minibatches)
    same(r.perms, np.stack([np.asarray(jax.random.permutation(k, NB))
                            for k in jax.random.split(k_perm, fppo.update_epochs)]))
    j_env, jtraj, logits = jax_fast_collect(cfg, fppo, jts.params, jenv,
                                            jax_fresh(cfg, k_pool, 2 * B), k_roll)
    assert margins(logits, -np.log(-np.log(u)), 1).min() > 1e-4
    assert int(np.asarray(jtraj.done).sum()) >= B  # every env restarted from the pool
    for name in TRAJ:
        same(getattr(r.traj, name), getattr(jtraj, name))
    assert_tree_equal(interop.packed_state_to_numpy(t_env), np_tree(j_env))

    fast = jax_steps()[0]
    jts2, jenv2, jnext, jm = fast(cfg, fppo, jts, jenv, key, fused_pool=False, fused_update=False)
    ts2, env2, tnext, tm = fp.train_step_fast(tcf, tp, ts, env, tkey, fused_pool=False,
                                              fused_update=False)
    same(tnext, jnext)
    assert_tree_equal(interop.packed_state_to_numpy(env2), np_tree(jenv2))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=2e-4, err_msg=k)
    steps = fppo.update_epochs * fppo.num_minibatches
    want = {k: np.array(v) for k, v in jts2.params._asdict().items()}
    check_params(interop.mlp_params_to_numpy(ts2.params), want, 2 * fppo.lr * steps)
    check_moves(interop.mlp_params_to_numpy(ts2.params), want, init_w, MOVE_TOL["fast"])


def test_init_params_from_keys():
    """He-normal init from ``split(key, 4)`` / ``split(key, 5)``: each weight
    within 128 ulps of 1 (1.5e-5) of JAX's, its scale below 1 (torch's
    ``erfinv`` against XLA's: the unit normal within 91 ulps of max(|x|, 1)
    measured, ``tests/test_torch_threefry.py``), zero biases exact."""
    cfg = jcw.ray_config()
    fppo = jfp.FastPPOConfig(hidden=64)
    want = jax.jit(jfp.init_params, static_argnums=(1, 2))(jax.random.PRNGKey(4), cfg, fppo)
    got = interop.mlp_params_to_numpy(fp.init_params(prng_key(4), tcfg(cfg), port_fppo(fppo)))
    for k, w in want._asdict().items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=0, atol=128 * 2**-23, err_msg=k)
    ppo = jfx.PixelPPOConfig(conv1=8, conv2=16, hidden=32)
    want = jax.jit(jfx.init_pixel_params, static_argnums=(1, 2))(jax.random.PRNGKey(4), cfg, ppo)
    got = fx.init_pixel_params(prng_key(4), tcfg(cfg), pixel_ppo(ppo))
    for k in fx.CONV_NAMES:
        np.testing.assert_allclose(getattr(got, k).detach().numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=128 * 2**-23, err_msg=k)


def test_train_step_pixel_draws_and_update_equal_jax():
    """``train_step_pixel`` from the same key: the pool of
    ``fresh_packed_batch``, the uniforms and the permutations bit for bit
    (the pool and the actions show in the trajectory and the env), the
    metrics within rtol 2e-3 / atol 2e-4 and the parameters within 2 lr a
    minibatch step (``tests/test_torch_pixel_learning.py``'s tolerances)."""
    cfg = SINGLE
    ppo = jfx.PixelPPOConfig(rollout_steps=8, num_minibatches=2, update_epochs=1, conv1=8,
                             conv2=8, hidden=32)
    B = 64
    key = jax.random.PRNGKey(KEY + 1)
    jts = jfx.init_pixel_train_state(jax.random.PRNGKey(5), cfg, ppo)
    jenv = jax_fresh(cfg, jax.random.PRNGKey(6), B)
    jenv = jenv._replace(step_num=jnp.full((B,), 95, jnp.int16))
    tcf, tp = tcfg(cfg), pixel_ppo(ppo)
    params = pixel_params(jts.params)
    ts = fx.PixelTrainState(params, fx.make_optimizer(tp.as_fast).init(params.tensors()), 0)
    env = to_port(jenv)
    tkey = torch.as_tensor(np.asarray(key).astype(np.int64))
    before = {k: np.array(getattr(jts.params, k)) for k in fx.CONV_NAMES}

    _, k_pool, k_roll, k_perm = jax.random.split(key, 4)
    t_env, (traj, _, _, perms), _ = fx.rollout_phase(tcf, tp, ts, env, tkey)
    NB = ppo.rollout_steps * B // fx.BLK
    same(perms, np.stack([np.asarray(jax.random.permutation(k, NB))
                          for k in jax.random.split(k_perm, ppo.update_epochs)]))
    u = jax_gumbel_uniforms(k_roll, ppo.rollout_steps, B)
    j_env, jtraj, logits = jax_pixel_collect(cfg, ppo, jts.params, jenv,
                                             jax_fresh(cfg, k_pool, 2 * B), k_roll)
    assert margins(logits, -np.log(-np.log(u)), 1).min() > 1e-4
    assert int(np.asarray(jtraj.done).sum()) >= B
    for name in TRAJ:
        same(getattr(traj, name), getattr(jtraj, name))
    assert_tree_equal(interop.packed_state_to_numpy(t_env), np_tree(j_env))

    pixel = jax_steps()[1]
    jts2, jenv2, jnext, jm = pixel(cfg, ppo, jts, jenv, key)
    ts2, env2, tnext, tm = fx.train_step_pixel(tcf, tp, ts, env, tkey)
    same(tnext, jnext)
    assert_tree_equal(interop.packed_state_to_numpy(env2), np_tree(jenv2))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=2e-4, err_msg=k)
    steps = ppo.update_epochs * ppo.num_minibatches
    for k in fx.CONV_NAMES:
        np.testing.assert_allclose(getattr(ts2.params, k).detach().numpy(),
                                   np.asarray(getattr(jts2.params, k)), rtol=0,
                                   atol=2 * ppo.lr * steps, err_msg=k)
    check_moves({k: getattr(ts2.params, k).detach().numpy() for k in fx.CONV_NAMES},
                {k: np.asarray(getattr(jts2.params, k)) for k in fx.CONV_NAMES}, before,
                MOVE_TOL["pixel"])


# ---------------------------------------------------------------------------
# train/ppo.py and the GRU: bit-exact keys and permutations, noise within
# its tolerance, then one whole update
# ---------------------------------------------------------------------------


def test_train_step_draws_and_update_equal_jax():
    """``train/ppo.py`` (mlp): the chain ``k, k_act = split(k)`` on the key's
    device, each step's noise within ``NOISE_ULPS`` of ``gumbel(k_act, (B,
    6))``, a rank's envs of it the whole draw's, the permutations over T*B
    bit for bit, the actions equal; the metrics within the mlp tolerance
    (rtol 2e-3 / atol 2e-4, ``tests/test_torch_resume.py``) and the
    parameters within 2 lr a minibatch step."""
    cfg = jcw.EnvConfig(height=6, width=6, max_steps=16)
    ppo = jppo.PPOConfig(rollout_steps=8, num_minibatches=4, hidden=16)
    B = 32
    key = jax.random.PRNGKey(KEY + 2)
    jts = jax.jit(jppo.init_train_state, static_argnums=(1, 2))(jax.random.PRNGKey(3), cfg, ppo)
    h = host_tree(jts)
    ts = interop.ppo_train_state_from_numpy(h.params, h.opt_state, h.update_idx, device="cpu")
    tcf, tp = tcfg(cfg), tppo.PPOConfig(**ppo._asdict())
    tkey = torch.as_tensor(np.asarray(key).astype(np.int64))
    before = interop._flat_tree(host(jts.params["params"]))

    _, k_roll, k_perm = jax.random.split(key, 3)
    k, noise = k_roll, []
    for _ in range(ppo.rollout_steps):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.gumbel(k_act, (B, 6))))
    noise = np.stack(noise)
    t_roll = kd.split_keys(tkey, 3)[1]
    assert noise_ulps(tppo.collect_noise(t_roll, ppo.rollout_steps, B), noise) <= NOISE_ULPS
    got = tppo.collect_noise(t_roll, ppo.rollout_steps, B, slice(8, 24))
    assert torch.equal(got, tppo.collect_noise(t_roll, ppo.rollout_steps, B)[:, 8:24])

    env = jcw.reset_from_seed(cfg, 3, B)
    jtraj, logits = jax_ppo_collect(cfg, ppo, jts.params, env, k_roll)
    assert margins(logits, noise, 2).min() > 1e-4
    tenv = interop.env_state_from_numpy(np_tree(env), device="cpu")
    _, (traj, _, _, perms), t_next = tppo.rollout_phase(tcf, tp, ts, tenv, tkey)
    same(perms, np.stack([np.asarray(jax.random.permutation(k, ppo.rollout_steps * B))
                          for k in jax.random.split(k_perm, ppo.update_epochs)]))
    for name in TRAJ:
        same(getattr(traj, name), getattr(jtraj, name))

    step = jax_steps()[2]
    jts2, jenv2, jnext, jm = step(cfg, ppo, jts, env, key)
    ts2, tenv2, tnext, tm = tppo.train_step(tcf, tp, ts, tenv, tkey)
    same(tnext, jnext)
    same(t_next, jnext)
    for k, v in interop.env_state_to_numpy(tenv2).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jenv2, k)), err_msg=k)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=2e-4, err_msg=k)
    steps = ppo.update_epochs * ppo.num_minibatches
    want = interop._flat_tree(host(jts2.params["params"]))
    got = {k: v.detach().numpy() for k, v in ts2.params.named_parameters()}
    check_params(got, want, 2 * ppo.lr * steps)
    check_moves(got, want, before, MOVE_TOL["ppo"])


def test_train_step_rnn_draws_and_update_equal_jax():
    """``train_step_rnn`` drawing for itself: the noise of ``split(k_roll,
    T)`` in one launch within ``NOISE_ULPS``, the permutations over B bit
    for bit; the metrics and parameters within
    ``test_train_step_rnn_matches_jax``'s tolerances (rtol 2e-3 / atol 2e-3;
    a parameter at most 5 lr off, at most 5% of a tensor more than lr / 2)."""
    B, hidden = 8, 32
    p, jts, tts = _jax_rnn_state(2, B, hidden)
    cfg = jcw.flat_config()
    tp = tppo.PPOConfig(**p._asdict())
    st = jcw.reset_from_seed(cfg, 2, B)
    key = jax.random.PRNGKey(KEY + 3)
    tkey = torch.as_tensor(np.asarray(key).astype(np.int64))
    before = interop._flat_tree(host(jts.params["params"]))
    _, k_roll, k_perm = jax.random.split(key, 3)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (B, 6)))
                      for k in jax.random.split(k_roll, p.rollout_steps)])
    t_roll = kd.split_keys(tkey, 3)[1]
    assert noise_ulps(tppo.gumbel_noise(t_roll, B, planes=p.rollout_steps), noise) <= NOISE_ULPS
    same(fp.epoch_perms(kd.split_keys(tkey, 3)[2], p.update_epochs, B),
         np.stack([np.asarray(jax.random.permutation(k, B))
                   for k in jax.random.split(k_perm, p.update_epochs)]))

    rnn = jax_steps()[3]
    jts2, jst2, jnext, jm = rnn(cfg, p, jts, st, key)
    tts2, tst2, tnext, tm = tpr.train_step_rnn(tcfg(cfg), tp, tts,
                                               interop.env_state_from_numpy(np_tree(st), "cpu"),
                                               tkey)
    same(tnext, jnext)
    np.testing.assert_array_equal(interop.env_state_to_numpy(tst2)["objects"],
                                  np.asarray(jst2.objects))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=2e-3, err_msg=k)
    want = interop._flat_tree(host(jts2.params["params"]))
    got = {k: v.detach().numpy() for k, v in tts2.params.named_parameters()}
    for k, w in want.items():
        off = np.abs(got[k] - w)
        assert off.max() <= 5 * p.lr and (off > p.lr / 2).mean() <= 0.05, k
    check_moves(got, want, before, MOVE_TOL["rnn"])
