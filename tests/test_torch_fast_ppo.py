"""The port's fast-PPO trainer against the JAX package's, on the CPU.

Draws cross from JAX to the port as numpy (placement scores, task draws,
Gumbel uniforms, epoch permutations), and so do weights and optimizer state
(``interop``). Integer results must match bit for bit; float results within
the tolerance stated at each test. The wrappers run their plain versions
here; chip_smoke.py drives the same path through the kernels on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.ops import packed_rollout as jpr
from gym_craftingworld_tpu.train import fast_ppo as jfp
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.ops import fused_reset as fr
from gym_craftingworld_tpu_torch.ops import fused_update as fu
from gym_craftingworld_tpu_torch.ops import packed_rollout as tpr
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import fast_ppo as fp

from test_torch_packed_rollout import assert_tree_equal, crafting_actions, np_tree, tcfg

torch.set_num_threads(1)

SINGLE = dataclasses.replace(jcw.flat_config(), stacking=False)
CONFIGS = {
    "ray": jcw.ray_config(),
    "flat_single": SINGLE,
    "flat_sel14": dataclasses.replace(jcw.flat_config(), selected_task_indices=(1, 4)),
}


def port_fppo(fppo):
    return fp.FastPPOConfig(**fppo._asdict())


def to_port(p):
    """A JAX PackedState as the port's."""
    return interop.packed_state_from_numpy(np_tree(p), device="cpu")


def port_params(jparams):
    return interop.mlp_params_from_numpy({k: np.asarray(v) for k, v in jparams._asdict().items()}, device="cpu")


def f32(x):
    return np.asarray(x, np.float32)


def jax_pool_draws(cfg, key, n):
    """The draws of JAX ``fresh_packed_batch(cfg, key, n)`` (fast_ppo.py:110-120)."""
    k_place, k_task = jax.random.split(key)
    scores = jax.random.uniform(k_place, (n, cfg.n_cells))

    def one(k):
        k_num, k_perm = jax.random.split(k)
        if cfg.stacking:
            num = jax.random.randint(k_num, (), 0, cfg.number_of_tasks) + 1
        else:
            num = jnp.int32(1)
        return num, jax.random.permutation(k_perm, len(cfg.selected_task_indices))

    k, perm = jax.vmap(one)(jax.random.split(k_task, n))
    return [torch.as_tensor(np.array(x)) for x in (scores, k, perm)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fresh_packed_from_draws_equals_jax(name):
    cfg = CONFIGS[name]
    key = jax.random.PRNGKey(11)
    want = jfp.fresh_packed_batch(cfg, key, 300)
    got = fp.fresh_packed_from_draws(tcfg(cfg), *jax_pool_draws(cfg, key, 300))
    assert_tree_equal(interop.packed_state_to_numpy(got), np_tree(want))
    assert all(x.is_contiguous() for x in got)


def stepped_states(cfg, B=96, T=40):
    """JAX packed states along a crafting-heavy rollout (holding, achieved set)."""
    p = jfp.fresh_packed_batch(cfg, jax.random.PRNGKey(5), B)
    out = [p]
    for a in crafting_actions(3, T, B):
        p, _ = jpr._step_p_unrolled(cfg, p, jnp.asarray(a, jnp.int16))
        out.append(p)
    return out[::8]


@pytest.mark.parametrize("name", ["ray", "flat_sel14"])
def test_features_bit_exact(name):
    cfg = CONFIGS[name]
    states = stepped_states(cfg)
    assert any(int(np.asarray(s.achieved).max()) > 0 for s in states)
    for s in states:
        want = f32(jfp.features(cfg, s))
        got = fp.features(tcfg(cfg), to_port(s))
        assert got.dtype == torch.bfloat16 and got.shape[0] == fp.feature_rows(tcfg(cfg))
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


def test_apply_policy_parity():
    """Both layouts at rtol 1e-5 (atol 1e-6): same bf16 operands, f32 sums in another order."""
    cfg = jcw.ray_config()
    fppo = jfp.FastPPOConfig(hidden=128)
    jparams = jfp.init_params(jax.random.PRNGKey(0), cfg, fppo)
    params = port_params(jparams)
    s = stepped_states(cfg)[-1]
    jfeat = jfp.features(cfg, s)
    feat = fp.features(tcfg(cfg), to_port(s))
    for got, want in [(fp.apply_policy(params, feat), jfp.apply_policy(jparams, jfeat)),
                      (fp.apply_policy_bm(params, feat.T), jfp.apply_policy_bm(jparams, jfeat.T))]:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), f32(w), rtol=1e-5, atol=1e-6)


def test_losses_match_jax():
    """``_loss`` (feature-major) and ``_loss_bm`` against JAX's on one batch, at
    rtol 1e-5 (atol 1e-6): the same rounding points, f32 sums in another order."""
    cfg = jcw.ray_config()
    fppo = jfp.FastPPOConfig(hidden=64)
    jparams = jfp.init_params(jax.random.PRNGKey(1), cfg, fppo)
    params = port_params(jparams)
    s = stepped_states(cfg)[-1]
    rng = np.random.default_rng(4)
    n = np.asarray(s.agent_r).shape[0]
    vecs = (rng.integers(0, 6, n).astype(np.int32),
            (-np.abs(rng.standard_normal(n)) - 1.5).astype(np.float32),
            *(rng.standard_normal(n).astype(np.float32) for _ in range(3)))
    jfeat = jfp.features(cfg, s)
    feat = fp.features(tcfg(cfg), to_port(s))
    tv = tuple(torch.as_tensor(v) for v in vecs)
    for jfn, tfn, jf, tf in [(jfp._loss, fp._loss, jfeat, feat),
                             (jfp._loss_bm, fp._loss_bm, jfeat.T, feat.T)]:
        jl, jaux = jfn(fppo, jparams, (jf,) + tuple(jnp.asarray(v) for v in vecs))
        with torch.no_grad():
            tl, taux = tfn(port_fppo(fppo), params, (tf,) + tv)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
        for k in jaux:
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_gae_parity():
    """rtol 1e-6, atol 1e-6: one f32 ulp at the advantages' scale (~2), where
    XLA's fused multiply-adds round once and torch's mul-then-add twice."""
    T, B = 12, 64
    rng = np.random.default_rng(0)
    fppo = jfp.FastPPOConfig()
    value = rng.standard_normal((T, B)).astype(np.float32)
    reward = rng.choice([1.0, -1.0 / 300], (T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.1
    last = rng.standard_normal(B).astype(np.float32)
    z = np.zeros((T, B), np.float32)
    jtraj = jfp._Traj(z, z, z, value, reward, done, z)
    jadv, jret = jfp._gae(fppo, jtraj, jnp.asarray(last))
    t = torch.as_tensor
    ttraj = fp._Traj(None, None, None, t(value), t(reward), t(done), None)
    adv, ret = fp._gae(port_fppo(fppo), ttraj, t(last))
    np.testing.assert_allclose(adv.numpy(), f32(jadv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), f32(jret), rtol=1e-6, atol=1e-6)


def jax_collect_setup(cfg, fppo, B, seed=0):
    """JAX params, env (some envs near max_steps, so auto-reset fires), pool."""
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    jparams = jfp.init_params(k[0], cfg, fppo)
    env = jfp.fresh_packed_batch(cfg, k[1], B)
    near_end = jax.random.randint(k[2], (B,), cfg.max_steps - 12, cfg.max_steps)
    env = env._replace(step_num=near_end.astype(jnp.int16))
    pool = jfp.fresh_packed_batch(cfg, k[3], 2 * B)
    return jparams, env, pool


def jax_gumbel_uniforms(key, T, B):
    """The uniforms of JAX ``_collect`` (fast_ppo.py:298, :331)."""
    keys = jax.random.split(key, T)
    return np.stack([np.asarray(jax.random.uniform(k, (6, B), minval=1e-7, maxval=1.0))
                     for k in keys])


def test_collect_from_jax_uniforms_equals_jax():
    cfg = SINGLE
    fppo = jfp.FastPPOConfig(rollout_steps=16, hidden=64)
    B = 192
    jparams, jenv, jpool = jax_collect_setup(cfg, fppo, B)
    k_roll = jax.random.PRNGKey(9)
    jenv2, jtraj = jfp._collect(cfg, fppo, jparams, jenv, jpool, k_roll)
    u = torch.as_tensor(jax_gumbel_uniforms(k_roll, fppo.rollout_steps, B))
    params = port_params(jparams)
    with torch.no_grad():
        env2, traj = fp._collect(tcfg(cfg), port_fppo(fppo), params, to_port(jenv), to_port(jpool), u)
        # the Gumbel argmax is decided by a margin the f32 sum order cannot flip
        logits = torch.stack([fp.apply_policy(params, f)[0] for f in traj.feat])
    g = (logits - torch.log(-torch.log(u))).sort(dim=1, descending=True).values
    assert float((g[:, 0] - g[:, 1]).min()) > 1e-4

    assert int(np.asarray(jtraj.done).sum()) > 0  # auto-reset fired
    for name in ("action", "done", "raw_reward", "reward"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(), np.asarray(getattr(jtraj, name)), name)
    np.testing.assert_array_equal(traj.feat.to(torch.float32).numpy(), f32(jtraj.feat))
    for name in ("log_prob", "value"):
        np.testing.assert_allclose(getattr(traj, name).numpy(), f32(getattr(jtraj, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert_tree_equal(interop.packed_state_to_numpy(env2), np_tree(jenv2))


def test_optimizer_matches_optax():
    """Clip + Adam by hand against optax at rtol 1e-6: one clipped step, one not.

    atol 1e-10 (3e-7 of lr) covers entries near zero, where the second step's
    moment ``0.9 * mu + 0.1 * g`` cancels and one rounding of difference
    (XLA fuses it into a multiply-add) is amplified."""
    cfg = jcw.ray_config()
    fppo = jfp.FastPPOConfig(hidden=64)
    jparams = jfp.init_params(jax.random.PRNGKey(0), cfg, fppo)
    params = port_params(jparams)
    opt_j = jfp.make_optimizer(fppo)
    opt_t = fp.make_optimizer(port_fppo(fppo))
    state_j = opt_j.init(jparams)
    state_t = opt_t.init(params.tensors())
    rng = np.random.default_rng(3)
    for scale in (1.0, 1e-3):  # global norm ~10 (clipped), then ~0.01 (kept)
        g = {k: (scale * rng.standard_normal(np.shape(v))).astype(np.float32)
             for k, v in jparams._asdict().items()}
        upd_j, state_j = opt_j.update(jfp.MLPParams(**g), state_j, jparams)
        jparams = optax.apply_updates(jparams, upd_j)
        upd_t, state_t = opt_t.update({k: torch.as_tensor(v) for k, v in g.items()}, state_t)
        fp.apply_updates(params, upd_t)
        for k in fp.PARAM_NAMES:
            np.testing.assert_allclose(upd_t[k].numpy(), f32(getattr(upd_j, k)), rtol=1e-6, atol=1e-10)
    adam_j = state_j[1][0]
    got = interop.adam_state_to_numpy(state_t)
    assert int(got["count"]) == int(adam_j.count) == 2
    for m in ("mu", "nu"):
        for k in fp.PARAM_NAMES:
            np.testing.assert_allclose(got[m][k], f32(getattr(getattr(adam_j, m), k)),
                                       rtol=1e-6, atol=1e-10)
    back = interop.adam_state_from_numpy(got, device="cpu")
    assert all(torch.equal(back.mu[k], state_t.mu[k]) for k in fp.PARAM_NAMES)
    got_p = interop.mlp_params_to_numpy(params)
    for k, v in jparams._asdict().items():
        np.testing.assert_allclose(got_p[k], f32(v), rtol=1e-6, atol=1e-10, err_msg=k)


@pytest.mark.parametrize("fused", [None, False])
def test_update_phase_matches_jax_autodiff(fused):
    """One update phase from JAX's trajectory and permutations: the port's
    gradient wrapper (plain version here) and its autograd path both track
    JAX's autodiff update. Losses at rtol 2e-3 / atol 2e-4, params at atol 2*lr."""
    cfg = SINGLE
    fppo = jfp.FastPPOConfig(rollout_steps=16, num_minibatches=2, update_epochs=2,
                             hidden=64)
    B = 256
    jparams, jenv, jpool = jax_collect_setup(cfg, fppo, B, seed=1)
    ts = jfp.FastTrainState(jparams, jfp.make_optimizer(fppo).init(jparams), jnp.int32(0))
    _, jtraj = jfp._collect(cfg, fppo, jparams, jenv, jpool, jax.random.PRNGKey(2))
    _, last_value = jfp.apply_policy(jparams, jfp.features(cfg, jenv))
    adv, ret = jfp._gae(fppo, jtraj, last_value)
    k_perm = jax.random.PRNGKey(3)
    p_j, _, losses_j, aux_j = jfp._update_phase(fppo, ts, jtraj, adv, ret, k_perm,
                                                use_fused_kernel=False)
    NB = fppo.rollout_steps * B // jfp.shuffle_block(fppo.rollout_steps, B, fppo.num_minibatches)
    perms = torch.as_tensor(np.stack([np.asarray(jax.random.permutation(k, NB))
                                      for k in jax.random.split(k_perm, fppo.update_epochs)]))

    t = lambda x: torch.as_tensor(np.array(x))
    traj = fp._Traj(t(jtraj.feat.astype(jnp.float32)).to(torch.bfloat16),
                    *(t(getattr(jtraj, k)) for k in fp._Traj._fields[1:]))
    params = port_params(jparams)
    tts = fp.FastTrainState(params, fp.make_optimizer(port_fppo(fppo)).init(params.tensors()), 0)
    p_t, opt_t, losses_t, aux_t = fp._update_phase(port_fppo(fppo), tts, traj, t(adv), t(ret),
                                                   perms, use_fused_kernel=fused)
    assert tuple(losses_t.shape) == (2, 2) and int(opt_t.count) == 4
    np.testing.assert_allclose(losses_t.numpy(), f32(losses_j), rtol=2e-3, atol=2e-4)
    for k in aux_j:
        np.testing.assert_allclose(aux_t[k].numpy(), f32(aux_j[k]), rtol=2e-3, atol=2e-4, err_msg=k)
    for k in fp.PARAM_NAMES:
        np.testing.assert_allclose(getattr(p_t, k).detach().numpy(), f32(getattr(p_j, k)),
                                   rtol=0, atol=2 * fppo.lr, err_msg=k)


def test_autoreset_pulls_fresh_state():
    cfg = tcfg(jcw.flat_config())  # max_steps 100
    g = torch.Generator().manual_seed(0)
    B = 64
    env = fp.fresh_packed_batch(cfg, prng_key(0), B)
    env = env._replace(step_num=torch.full((B,), cfg.max_steps - 1, dtype=torch.int16))
    pool = fp.fresh_packed_batch(cfg, prng_key(1), 128)
    st, res = tpr._step_p(cfg, env, torch.zeros((B,), dtype=torch.int16))
    assert bool(res.done.all())
    idx = torch.randint(0, 128, (B,), generator=g)
    st = fp._autoreset(st, fp._pool_take(pool, idx), res.done)
    assert int(st.step_num.max()) == 0
    assert int(st.achieved.abs().max()) == 0
    assert torch.equal(st.slot_key, pool.slot_key[:, idx])
    window = fp._pool_slice(pool, 100, B)  # a view into the pool, never clamped
    assert torch.equal(window.desired, pool.desired[100:100 + B])


@pytest.mark.parametrize("fused", [None, False])
def test_train_step_fast_runs_and_updates(fused):
    cfg = tcfg(jcw.ray_config())
    fppo = fp.FastPPOConfig(rollout_steps=8, num_minibatches=2, update_epochs=1, hidden=64)
    env = fp.fresh_packed_batch(cfg, prng_key(1), 128)
    ts = fp.init_fast_train_state(prng_key(0), cfg, fppo)
    w0 = ts.params.w1.detach().clone()
    pool_calls, grad_calls = fr.fresh_packed_plain.calls, fu.ppo_grads_plain.calls
    ts, env, key, metrics = fp.train_step_fast(cfg, fppo, ts, env, prng_key(2),
                                               fused_pool=fused, fused_update=fused)
    # the default path runs the kernels' wrappers: their plain versions here
    assert fr.fresh_packed_plain.calls - pool_calls == (fused is None)
    assert fu.ppo_grads_plain.calls - grad_calls == (2 if fused is None else 0)
    for k in ["loss", "reward_mean", "episode_done_frac", "success_rate",
              "entropy", "pg_loss", "v_loss"]:
        assert np.isfinite(float(metrics[k])), k
    assert not torch.equal(w0, ts.params.w1)
    assert ts.update_idx == 1
    assert abs(float(metrics["entropy"]) - np.log(6)) < 0.05


def test_throughput_preset_trains():
    cfg = tcfg(SINGLE)
    fppo = fp.FastPPOConfig.throughput(rollout_steps=8, num_minibatches=2, hidden=48)
    assert fppo.update_epochs == 1 and fp.FastPPOConfig.throughput().hidden == 384
    ts = fp.init_fast_train_state(prng_key(0), cfg, fppo)
    env = fp.fresh_packed_batch(cfg, prng_key(1), 256)
    ts, env, key, m = fp.train_step_fast(cfg, fppo, ts, env, prng_key(2))
    assert np.isfinite(float(m["loss"]))


def test_shuffle_block_keeps_minibatches_mixed():
    assert fp.shuffle_block(64, 16384, 8) == 2048
    blk = fp.shuffle_block(64, 256, 8)
    assert blk * 8 <= 2048
    assert fp.shuffle_block(16, 64, 2) == 128
    for T, B, M in [(64, 16384, 8), (64, 256, 8), (16, 64, 2), (32, 512, 4)]:
        assert fp.shuffle_block(T, B, M) == jfp.shuffle_block(T, B, M)
    with pytest.raises(ValueError):
        fp.shuffle_block(3, 5, 1)


def test_fast_ppo_learns_single_task():
    """On single-task 8x8 worlds the policy beats its own first updates."""
    cfg = tcfg(SINGLE)
    fppo = fp.FastPPOConfig(rollout_steps=32, num_minibatches=4, update_epochs=2,
                            hidden=128, lr=1e-3, ent_coef=0.003)
    env = fp.fresh_packed_batch(cfg, prng_key(1), 512)
    ts = fp.init_fast_train_state(prng_key(0), cfg, fppo)
    ts, env, key, m = fp.train_many_fast(cfg, fppo, ts, env, 64, prng_key(2))
    rm, sps = m["reward_mean"].numpy(), m["success_per_step"].numpy()
    assert rm.shape == (64,) and np.isfinite(rm).all()
    early, late = rm[:16].mean(), rm[-16:].mean()
    assert late > early, f"no improvement: first16={early:.4f} last16={late:.4f}"
    assert sps[-16:].mean() > 1.2 * sps[:16].mean(), (sps[:16].mean(), sps[-16:].mean())
