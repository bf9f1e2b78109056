"""The port's pixel-observation PPO (``train/fast_pixel_ppo.py``) against the
JAX package's, on the CPU.

Draws cross from JAX to the port as numpy (pool worlds, Gumbel uniforms,
epoch permutations), and so do weights and optimizer state (``interop``).
Renders, actions and states must match bit for bit; the bf16 convolutions sum
in another order in oneDNN than in XLA's CPU backend, so logits, losses and
gradients match within the tolerance stated at each test, beside the error
measured when it was written. The collect's step is the actions kernel's
plain version here; chip_smoke.py drives the kernel on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.core import slots as jsm
from gym_craftingworld_tpu.ops import packed_rollout as jpr
from gym_craftingworld_tpu.ops.transposed_rollout import transpose_in
from gym_craftingworld_tpu.train import fast_pixel_ppo as jfx
from gym_craftingworld_tpu.train import fast_ppo as jfp
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx

from test_torch_fast_ppo import SINGLE, f32, jax_gumbel_uniforms, to_port
from test_torch_packed_rollout import assert_tree_equal, crafting_actions, np_tree, tcfg

torch.set_num_threads(1)

NARROW = dict(conv1=8, conv2=16, hidden=32)
PRESETS = {"default": jfx.PixelPPOConfig(), "throughput": jfx.PixelPPOConfig.throughput()}


def port_ppo(ppo):
    return fx.PixelPPOConfig(**ppo._asdict())


def port_params(jparams):
    return interop.conv_params_from_numpy({k: np.asarray(v) for k, v in jparams._asdict().items()},
                                          device="cpu")


def to_jax(p):
    """A port PackedState as the JAX package's."""
    return jpr.PackedState(**{k: jnp.asarray(v) for k, v in interop.packed_state_to_numpy(p).items()})


def random_packed(cfg, seed, B, steps=90, crafting=24):
    """A JAX packed state after ``steps`` random steps from a reset, then
    ``crafting`` steps with regular pickups and drops (held items)."""
    st = jcw.reset_from_seed(cfg, seed, B)
    st, _ = jcw.rollout_random(cfg, st, jax.random.PRNGKey(seed), steps)
    p = jpr.pack(cfg, transpose_in(jsm.from_env_state(st)))
    step = jax.jit(jpr._step_p_unrolled, static_argnums=0)
    for a in crafting_actions(seed, crafting, B):
        p, _ = step(cfg, p, jnp.asarray(a, jnp.int16))
    return p


def rel_l2(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.detach().numpy() - want) / np.linalg.norm(want))


@pytest.mark.parametrize("cfg", [jcw.ray_config(), jcw.flat_config()], ids=["21x21", "8x8"])
def test_render_grid_obs_bit_exact(cfg):
    p = random_packed(cfg, 11, 32, crafting=0)
    # every held code in the batch (21x21 worlds rarely pick anything up)
    p = p._replace(holding=jnp.arange(32, dtype=jnp.int16) % 4)
    want = jfx.render_grid_obs(cfg, p)
    got = fx.render_grid_obs(tcfg(cfg), to_port(p))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.to(torch.float32).numpy(), f32(w))


def test_config_and_shapes_equal_jax():
    cfg = jcw.ray_config()
    for ppo in PRESETS.values():
        assert fx.PixelPPOConfig(**ppo._asdict()) == port_ppo(ppo)
        assert port_ppo(ppo).as_fast._asdict() == ppo.as_fast._asdict()
        assert fx._flat_dim(tcfg(cfg), port_ppo(ppo)) == jfx._flat_dim(cfg, ppo)
        got = fx.init_pixel_params(prng_key(0), tcfg(cfg), port_ppo(ppo))
        want = jfx.init_pixel_params(jax.random.PRNGKey(0), cfg, ppo)
        for k in fx.CONV_NAMES:
            assert tuple(getattr(got, k).shape) == getattr(want, k).shape, k
    assert fx.PixelPPOConfig.throughput() == port_ppo(jfx.PixelPPOConfig.throughput())


@pytest.mark.parametrize("preset", list(PRESETS))
def test_apply_pixel_policy_matches_jax(preset):
    """Both presets at full width on 21x21. Logits and values at rtol 2e-2 /
    atol 2e-2, a bf16 conv stack's tolerance (measured max 0.0 in both: the
    same rounding points)."""
    cfg, ppo = jcw.ray_config(), PRESETS[preset]
    jparams = jfx.init_pixel_params(jax.random.PRNGKey(3), cfg, ppo)
    p = random_packed(cfg, 5, 32)
    want = jfx._policy_tb(jparams, cfg, p, ppo.stride1)
    with torch.no_grad():
        got = fx._policy_tb(port_params(jparams), tcfg(cfg), to_port(p), ppo.stride1)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), f32(w), rtol=2e-2, atol=2e-2)


def random_batch(p, seed):
    n = np.asarray(p.agent_r).shape[0]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 6, n).astype(np.int32),
            (-np.abs(rng.standard_normal(n)) - 1.5).astype(np.float32),
            *(rng.standard_normal(n).astype(np.float32) for _ in range(3)))


@pytest.mark.parametrize("preset", list(PRESETS))
def test_pixel_loss_and_grad_match_jax(preset):
    """``_pixel_loss`` and its autograd gradient against ``jax.value_and_grad``
    on one minibatch of 128 stored states. Loss terms at rtol 2e-3 / atol
    2e-4 (measured max abs 1.6e-5); each gradient tensor within 2e-2
    relative L2 (measured max 1.4e-2)."""
    cfg, ppo = jcw.ray_config(), PRESETS[preset]
    jparams = jfx.init_pixel_params(jax.random.PRNGKey(4), cfg, ppo)
    p = random_packed(cfg, 6, 128)
    vecs = random_batch(p, 1)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda q, b: jfx._pixel_loss(ppo, q, cfg, b), has_aux=True))(
        jparams, (p,) + tuple(jnp.asarray(v) for v in vecs))
    batch = (to_port(p),) + tuple(torch.as_tensor(v) for v in vecs)
    grads, aux = fx._pixel_grads(port_ppo(ppo), port_params(jparams), tcfg(cfg), batch)
    np.testing.assert_allclose(float(aux["loss"]), float(jl), rtol=2e-3, atol=2e-4)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=2e-3, atol=2e-4, err_msg=k)
    for k in fx.CONV_NAMES:
        assert rel_l2(grads[k], getattr(jg, k)) <= 2e-2, k


def jax_update_phase(cfg, ppo, params, opt_state, traj, adv, ret, perms):
    """JAX's update phase as ``train_step_pixel`` writes it
    (``fast_pixel_ppo.py:322-378``), with the epochs' permutations passed in."""
    T, B = traj.action.shape
    BLK = 128
    NB = (T * B) // BLK
    blk_state = jax.tree.map(
        lambda x: jnp.moveaxis(x, 0, -2).reshape(x.shape[1:-1] + (NB, BLK))
        if x.ndim == 3 else x.reshape(NB, BLK), traj.state)
    rest = tuple(x.reshape(NB, BLK) for x in (traj.action, traj.log_prob, traj.value, adv, ret))
    optimizer = jfp.make_optimizer(ppo.as_fast)

    @jax.jit
    def minibatch(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(lambda q: jfx._pixel_loss(ppo, q, cfg, batch),
                                              has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    nbm = NB // ppo.num_minibatches
    mb = nbm * BLK
    losses = []
    for perm in perms:
        shuf_state = jax.tree.map(lambda x: x[..., perm, :] if x.ndim == 3 else x[perm],
                                  blk_state)
        shuf_rest = tuple(x[perm] for x in rest)
        for i in range(ppo.num_minibatches):
            st_mb = jax.tree.map(lambda x: jax.lax.dynamic_slice_in_dim(
                x, i * nbm, nbm, axis=x.ndim - 2).reshape(x.shape[:-2] + (mb,)), shuf_state)
            rest_mb = tuple(jax.lax.dynamic_slice_in_dim(x, i * nbm, nbm).reshape(mb)
                            for x in shuf_rest)
            params, opt_state, loss = minibatch(params, opt_state, (st_mb,) + rest_mb)
            losses.append(float(loss))
    return params, opt_state, np.asarray(losses, np.float32)


def collect_setup(cfg, ppo, B, seed=0):
    """JAX params, env (some envs near max_steps, so auto-reset fires), pool."""
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    jparams = jfx.init_pixel_params(k[0], cfg, ppo)
    fresh = jax.jit(jfp.fresh_packed_batch, static_argnums=(0, 2))
    env = fresh(cfg, k[1], B)
    near_end = jax.random.randint(k[2], (B,), cfg.max_steps - 6, cfg.max_steps)
    env = env._replace(step_num=near_end.astype(jnp.int16))
    return jparams, env, fresh(cfg, k[3], 2 * B)


def test_update_phase_matches_jax():
    """One update phase (2 epochs x 2 minibatches of 256 rows) from JAX's
    trajectory and JAX's permutations of the 128-row blocks. Losses at rtol
    2e-3 / atol 2e-4 (measured max abs 7.9e-7); parameters within 2*lr per
    optimizer step of JAX's (measured max 5.1e-4 after 4 steps: Adam turns
    a near-zero gradient's rounding into a step of up to lr); the Adam count
    equal."""
    cfg = SINGLE
    ppo = jfx.PixelPPOConfig(rollout_steps=8, num_minibatches=2, **NARROW)
    B = 64
    jparams, jenv, jpool = collect_setup(cfg, ppo, B, seed=1)
    jenv2, jtraj = jfx._collect_pixel(cfg, ppo, jparams, jenv, jpool, jax.random.PRNGKey(2))
    _, last_value = jfx._policy_tb(jparams, cfg, jenv2, ppo.stride1)
    adv, ret = jfp._gae(ppo.as_fast, jtraj, last_value)
    NB = ppo.rollout_steps * B // fx.BLK
    perms = np.stack([np.asarray(jax.random.permutation(k, NB))
                      for k in jax.random.split(jax.random.PRNGKey(3), ppo.update_epochs)])
    opt0 = jfp.make_optimizer(ppo.as_fast).init(jparams)
    p_j, opt_j, losses_j = jax_update_phase(cfg, ppo, jparams, opt0, jtraj, adv, ret, perms)

    t = lambda x: torch.as_tensor(np.array(x))
    traj = fx._PTraj(to_port(jtraj.state), *(t(getattr(jtraj, k)) for k in fx._PTraj._fields[1:]))
    params = port_params(jparams)
    ts = fx.PixelTrainState(params, fx.make_optimizer(port_ppo(ppo).as_fast).init(params.tensors()), 0)
    p_t, opt_t, losses_t, aux_t = fx._update_phase(tcfg(cfg), port_ppo(ppo), ts, traj, t(adv),
                                                   t(ret), torch.as_tensor(perms))
    steps = ppo.update_epochs * ppo.num_minibatches
    assert tuple(losses_t.shape) == (2, 2) and set(aux_t) == {"pg_loss", "v_loss", "entropy"}
    assert int(opt_t.count) == int(opt_j[1][0].count) == steps
    np.testing.assert_allclose(losses_t.reshape(-1).numpy(), losses_j, rtol=2e-3, atol=2e-4)
    for k in fx.CONV_NAMES:
        np.testing.assert_allclose(getattr(p_t, k).detach().numpy(), f32(getattr(p_j, k)),
                                   rtol=0, atol=2 * ppo.lr * steps, err_msg=k)


def test_optimizer_state_and_interop_across_two_steps():
    """The hand-written clip + Adam on the ``ConvParams`` names against optax,
    one clipped step and one not, at rtol 1e-6 / atol 1e-10 (as the
    fast-PPO test); then the parameters and the Adam state round-trip
    exactly through ``interop``."""
    cfg, ppo = SINGLE, jfx.PixelPPOConfig(**NARROW)
    jparams = jfx.init_pixel_params(jax.random.PRNGKey(0), cfg, ppo)
    params = port_params(jparams)
    opt_j, opt_t = jfp.make_optimizer(ppo.as_fast), fx.make_optimizer(port_ppo(ppo).as_fast)
    state_j, state_t = opt_j.init(jparams), opt_t.init(params.tensors())
    rng = np.random.default_rng(3)
    for scale in (1.0, 1e-3):  # a global norm far above 0.5 (clipped), then below
        g = {k: (scale * rng.standard_normal(np.shape(v))).astype(np.float32)
             for k, v in jparams._asdict().items()}
        upd_j, state_j = opt_j.update(jfx.ConvParams(**g), state_j, jparams)
        jparams = optax.apply_updates(jparams, upd_j)
        upd_t, state_t = opt_t.update({k: torch.as_tensor(v) for k, v in g.items()}, state_t)
        fx.apply_updates(params, upd_t)
        for k in fx.CONV_NAMES:
            np.testing.assert_allclose(upd_t[k].numpy(), f32(getattr(upd_j, k)), rtol=1e-6,
                                       atol=1e-10, err_msg=k)
    adam_j = state_j[1][0]
    got = interop.adam_state_to_numpy(state_t)
    assert int(got["count"]) == int(adam_j.count) == 2
    for m in ("mu", "nu"):
        for k in fx.CONV_NAMES:
            np.testing.assert_allclose(got[m][k], f32(getattr(getattr(adam_j, m), k)),
                                       rtol=1e-6, atol=1e-10)
    back = interop.adam_state_from_numpy(got, device="cpu")
    assert all(torch.equal(back.mu[k], state_t.mu[k]) and torch.equal(back.nu[k], state_t.nu[k])
               for k in fx.CONV_NAMES)
    arrays = interop.conv_params_to_numpy(params)
    again = interop.conv_params_to_numpy(interop.conv_params_from_numpy(arrays, device="cpu"))
    assert_tree_equal(again, arrays)
    for k, v in jparams._asdict().items():
        np.testing.assert_allclose(arrays[k], f32(v), rtol=1e-6, atol=1e-10, err_msg=k)


def test_collect_replays_jax_step_by_step():
    """The port's collect, replayed step by step through JAX: at each t, JAX's
    policy on the port's stored state gives the port's logits (rtol 2e-2 /
    atol 2e-2; measured max 0.0), the port's action is the argmax of its
    logits plus its Gumbel noise, and JAX's ``_step_p_unrolled`` and
    ``_autoreset`` on the port's state and action give the port's next
    state, reward and done bit for bit."""
    cfg = SINGLE
    ppo = jfx.PixelPPOConfig(rollout_steps=12, **NARROW)
    B = 128
    jparams, jenv, jpool = collect_setup(cfg, ppo, B)
    u = torch.as_tensor(jax_gumbel_uniforms(jax.random.PRNGKey(9), ppo.rollout_steps, B))
    params = port_params(jparams)
    calls = pf.rollout_packed_actions_plain.calls
    with torch.no_grad():
        env2, traj = fx._collect_pixel(tcfg(cfg), port_ppo(ppo), params, to_port(jenv),
                                       to_port(jpool), u)
    assert pf.rollout_packed_actions_plain.calls - calls == ppo.rollout_steps
    assert int(traj.done.sum()) > 0  # auto-reset fired
    states = [fx.PackedState(*(x[t] for x in traj.state)) for t in range(ppo.rollout_steps)]
    for t, st in enumerate(states):
        with torch.no_grad():
            logits, value = fx._policy_tb(params, tcfg(cfg), st, ppo.stride1)
        js = to_jax(st)
        jl, jv = jfx._policy_tb(jparams, cfg, js, ppo.stride1)
        np.testing.assert_allclose(logits.numpy(), f32(jl), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(value.numpy(), f32(jv), rtol=2e-2, atol=2e-2)
        assert torch.equal(value, traj.value[t])
        gumbel = logits - torch.log(-torch.log(u[t]))
        assert torch.equal(torch.argmax(gumbel, dim=0).to(torch.int32), traj.action[t])
        js2, res = jpr._step_p_unrolled(cfg, js, jnp.asarray(traj.action[t].numpy(), jnp.int16))
        off = (t * 12007) % B
        js2 = jfp._autoreset(js2, jfp._pool_slice(jpool, off, B), res.done)
        nxt = states[t + 1] if t + 1 < len(states) else env2
        assert_tree_equal(interop.packed_state_to_numpy(nxt), np_tree(js2))
        np.testing.assert_array_equal(traj.done[t].numpy(), np.asarray(res.done))
        np.testing.assert_array_equal(traj.raw_reward[t].numpy(), np.asarray(res.reward))
        np.testing.assert_array_equal(
            traj.reward[t].numpy(),
            np.where(np.asarray(res.reward) == cfg.max_steps, 1.0, -1.0 / cfg.max_steps)
            .astype(np.float32))


def test_train_many_pixel_equals_sequential_steps():
    """Three updates in ``train_many_pixel`` equal three ``train_step_pixel``
    calls from the same key, exactly (as tests/test_fast_pixel_ppo.py holds
    JAX's); every draw comes from the key chain."""
    cfg = tcfg(jcw.flat_config())
    ppo = fx.PixelPPOConfig(rollout_steps=4, num_minibatches=2, update_epochs=1, conv1=8,
                            conv2=8, hidden=32)
    runs = []
    for many in (True, False):
        g = prng_key(7)
        ts = fx.init_pixel_train_state(g, cfg, ppo)
        env = fx.fresh_packed_batch(cfg, prng_key(8), 64)
        if many:
            ts, env, g, m = fx.train_many_pixel(cfg, ppo, ts, env, 3, g)
        else:
            hist = []
            for _ in range(3):
                ts, env, g, mi = fx.train_step_pixel(cfg, ppo, ts, env, g)
                hist.append(mi)
            m = {k: torch.stack([h[k] for h in hist]) for k in hist[0]}
        runs.append((ts, env, m))
    (ts_a, env_a, m_a), (ts_b, env_b, m_b) = runs
    assert ts_a.update_idx == ts_b.update_idx == 3
    assert all(v.shape == (3,) and bool(torch.isfinite(v).all()) for v in m_a.values())
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for k in fx.CONV_NAMES:
        assert torch.equal(getattr(ts_a.params, k), getattr(ts_b.params, k)), k
    assert all(torch.equal(a, b) for a, b in zip(env_a, env_b))


def test_throughput_preset_trains():
    """The ``throughput()`` preset (stride-3 first conv, 16/32 channels,
    hidden 192, one epoch) trains on 21x21 at a small batch."""
    cfg = tcfg(jcw.ray_config())
    ppo = fx.PixelPPOConfig.throughput(rollout_steps=8)
    assert (ppo.stride1, ppo.conv1, ppo.conv2, ppo.hidden, ppo.update_epochs,
            ppo.num_minibatches) == (3, 16, 32, 192, 1, 8)
    g = prng_key(0)
    ts = fx.init_pixel_train_state(g, cfg, ppo)
    w0 = ts.params.w1.detach().clone()
    env = fx.fresh_packed_batch(cfg, prng_key(1), 128)
    ts, env, g, m = fx.train_step_pixel(cfg, ppo, ts, env, g)
    assert ts.update_idx == 1 and int(ts.opt_state.count) == 8
    assert all(np.isfinite(float(v)) for v in m.values())
    assert abs(float(m["entropy"]) - np.log(6)) < 0.05
    assert not torch.equal(w0, ts.params.w1)
    assert bool(((env.slot_key >= 0) & (env.slot_key <= cfg.n_cells + 1)).all())
    with pytest.raises(ValueError):
        fx.train_step_pixel(cfg, ppo, ts, fx.fresh_packed_batch(cfg, g, 100), g)
