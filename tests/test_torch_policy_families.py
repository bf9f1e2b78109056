"""The flax policy families, the parity-grade PPO trainer and the evaluator
(``models/actor_critic``, ``models/vit``, ``train/ppo``, ``train/evaluate``)
against the JAX package's, on the CPU.

Parameters cross as flax variable trees through ``interop``; states, Gumbel
noise and permutations as numpy. Steps and summaries must match exactly;
bf16 forwards within the tolerance stated at each test, beside the error
measured when it was written.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.core.reset import _reset_one, reset as jreset
from gym_craftingworld_tpu.core.state import EnvState as JEnvState
from gym_craftingworld_tpu.core.step import _step_one
from gym_craftingworld_tpu.models import actor_critic as jac
from gym_craftingworld_tpu.models import cnn as jcnn
from gym_craftingworld_tpu.models import vit as jvit
from gym_craftingworld_tpu.train import evaluate as jev
from gym_craftingworld_tpu.train import ppo as jppo
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core.reset import reset as treset
from gym_craftingworld_tpu_torch.models import actor_critic as tac
from gym_craftingworld_tpu_torch.models import cnn as tcnn
from gym_craftingworld_tpu_torch.models import vit as tvit
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops.keyed_draws import split_keys
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import evaluate as tev
from gym_craftingworld_tpu_torch.train import ppo as tppo

from test_torch_packed_rollout import assert_tree_equal, np_tree, tcfg

torch.set_num_threads(1)

CFG = jcw.flat_config()  # 8x8, max_steps 100
FAMILIES = ["mlp", "cnn", "vit"]
FROM_FLAX = {"mlp": interop.actor_critic_from_numpy, "cnn": interop.pixel_actor_critic_from_numpy,
             "vit": interop.grid_actor_critic_from_numpy}
JAX_INIT = {"mlp": jac.init_params, "cnn": jcnn.init_params, "vit": jvit.init_params}


def host(tree):
    return jax.tree.map(np.asarray, tree)


def to_port(st):
    return interop.env_state_from_numpy(np_tree(st), device="cpu")


def to_jax(st):
    return JEnvState(**{k: jnp.asarray(v) for k, v in interop.env_state_to_numpy(st).items()})


def family(policy, seed=0, hidden=32):
    """(JAX PPOConfig, port PPOConfig, flax variables, the port's module)."""
    ppo = jppo.PPOConfig(rollout_steps=4, num_minibatches=2, hidden=hidden, policy=policy)
    _, v = JAX_INIT[policy](jax.random.PRNGKey(seed), CFG.height, CFG.width, hidden)
    return ppo, tppo.PPOConfig(**ppo._asdict()), v, FROM_FLAX[policy](host(v), device="cpu")


def stepped(seed, B=16, steps=30):
    st = jcw.reset_from_seed(CFG, seed, B)
    st, _ = jcw.rollout_random(CFG, st, jax.random.PRNGKey(seed), steps)
    return st


def test_actor_critic_matches_flax():
    """bf16 torso, f32 heads, on the flat one-hot features. rtol 2e-2 / atol
    2e-2 (measured max 1.5e-8: the same rounding points)."""
    model, v = jac.init_params(jax.random.PRNGKey(1), 8, 8, hidden=64)
    st = stepped(1)
    jl, jv = jax.jit(model.apply)(v, jac.obs_features(st))
    port = interop.actor_critic_from_numpy(host(v), device="cpu")
    with torch.no_grad():
        tl, tv = port(tac.obs_features(to_port(st)))
    assert tl.dtype == tv.dtype == torch.float32 and tuple(tv.shape) == (16,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-2, atol=2e-2)


def test_grid_actor_critic_matches_flax():
    """Cell tokens, the goal token at position 0, two pre-LN blocks of
    4-head attention, against flax run op by op. rtol 2e-2 / atol 2e-2
    (measured max 6.1e-3: products summed in another order round a bf16
    activation one place apart now and then)."""
    model, v = jvit.init_params(jax.random.PRNGKey(2), 8, 8, hidden=32)
    st = stepped(2)
    jl, jv = model.apply(v, *jvit.grid_tokens(st))
    port = interop.grid_actor_critic_from_numpy(host(v), device="cpu")
    cells, bits = tvit.grid_tokens(to_port(st))
    for got, want in zip((cells, bits), jvit.grid_tokens(st)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with torch.no_grad():
        tl, tv = port(cells, bits)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-2, atol=2e-2)


ROUND_TRIPS = {
    "actor_critic": (lambda: jac.init_params(jax.random.PRNGKey(0), 8, 8, 32)[1],
                     interop.actor_critic_from_numpy,
                     lambda g: tac.init_params(g, 8, 8, 32)),
    "pixel_actor_critic": (lambda: jcnn.init_params(jax.random.PRNGKey(0), 8, 8, 32)[1],
                           interop.pixel_actor_critic_from_numpy,
                           lambda g: tcnn.init_params(g, 8, 8, 32)),
    "pixel_distill_student": (
        lambda: jcnn.init_student(jax.random.PRNGKey(0), CFG, 16, 64, 8)[1],
        interop.pixel_distill_student_from_numpy,
        lambda g: tcnn.init_student(g, tcfg(CFG), 16, 64, 8)),
    "grid_actor_critic": (lambda: jvit.init_params(jax.random.PRNGKey(0), 8, 8, 32)[1],
                          interop.grid_actor_critic_from_numpy,
                          lambda g: tvit.init_params(g, 8, 8, 32)),
}


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_flax_tree_round_trips(name):
    """A flax tree into the port's module and back, exactly; the port's own
    initialiser gives every parameter the flax tree's name and shape."""
    make_jax, from_numpy, make_port = ROUND_TRIPS[name]
    tree = host(make_jax())
    port = from_numpy(tree, device="cpu")
    back = interop.flax_params_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    drawn = interop.flax_params_to_numpy(make_port(prng_key(0)))
    assert jax.tree.map(np.shape, drawn) == jax.tree.map(np.shape, tree)


# loss tolerance (rtol, atol): vit's four bf16 layers of attention and MLP move
# its loss terms by up to 3.7e-3 between JAX's own jit and eager runs on this
# batch (pg_loss 2.3e-3, v_loss 2.8e-3)
LOSS_TOL = {"mlp": (2e-3, 2e-4), "cnn": (2e-3, 2e-4), "vit": (5e-3, 5e-3)}


@pytest.mark.parametrize("policy", FAMILIES)
def test_ppo_loss_and_grad_match_jax(policy):
    """``_ppo_loss`` and its autograd gradient against JAX's (jitted)
    ``value_and_grad``, on one minibatch of 16 snapshots.

    Loss terms at ``LOSS_TOL`` (measured max abs 1.2e-7 mlp, 2.4e-7 cnn,
    2.2e-3 vit). Each weight tensor (kernels, ``pos``) within 2e-2 relative
    L2 (measured max below 1e-4 mlp, 1.7e-3 cnn, 1.6e-2 vit, where JAX's own jit
    and eager runs differ by up to 1.7e-2). Bias and LayerNorm vectors sum
    bf16 cotangents over the batch and every position, with cancellation:
    within 5e-2 (measured max 6.9e-3 mlp, 3.1e-2 cnn, 4.0e-2 vit; JAX's own
    jit and eager differ by up to 2.3e-2 on vit's). Skipped: vectors whose
    gradient is below 1e-4 of the largest tensor's, all roundoff (the
    attention key biases, whose exact gradient is zero, and here vit's value
    bias)."""
    ppo, tp, v, params = family(policy)
    st = stepped(3)
    rng = np.random.default_rng(3)
    B = 16
    vecs = (rng.integers(0, 6, B).astype(np.int32),
            (-np.abs(rng.standard_normal(B)) - 1.5).astype(np.float32),
            *(rng.standard_normal(B).astype(np.float32) for _ in range(3)))
    _, apply_j = jppo.make_policy(ppo)
    batch_j = (jppo.snapshot(st),) + tuple(jnp.asarray(x) for x in vecs)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda q, b: jppo._ppo_loss(ppo, apply_j, q, b), has_aux=True))(v, batch_j)
    _, apply_t = tppo.make_policy(tp)
    batch_t = (tppo.snapshot(to_port(st)),) + tuple(torch.as_tensor(x) for x in vecs)
    grads, aux = tppo._grads(tp, apply_t, params, batch_t)
    rtol, atol = LOSS_TOL[policy]
    np.testing.assert_allclose(float(aux["loss"]), float(jl), rtol=rtol, atol=atol)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=rtol, atol=atol, err_msg=k)
    want = interop._flat_tree(host(jg["params"]))
    assert sorted(grads) == sorted(want)
    top = max(np.linalg.norm(w) for w in want.values())
    for k, g in grads.items():
        norm = np.linalg.norm(want[k])
        vector = k.endswith(("bias", "scale"))
        if vector and norm < 1e-4 * top:
            continue
        err = np.linalg.norm(g.numpy() - want[k]) / norm
        assert err <= (5e-2 if vector else 2e-2), (k, err)


@pytest.mark.parametrize("policy", FAMILIES)
def test_train_step_runs_and_updates(policy):
    cfg = tcfg(CFG)
    _, tp, _, _ = family(policy)
    ts = tppo.init_train_state(prng_key(0), cfg, tp)
    before = {k: p.detach().clone() for k, p in ts.params.named_parameters()}
    st = treset(cfg, split_keys(prng_key(0), 32))
    calls = pf.rollout_packed_actions_plain.calls
    ts, st, key, m = tppo.train_step(cfg, tp, ts, st, prng_key(1))
    assert pf.rollout_packed_actions_plain.calls == calls  # the grid step, no kernel
    assert ts.update_idx == 1 and int(ts.opt_state.count) == 4
    assert set(m) == {"loss", "reward_mean", "episode_done_frac", "success_rate", "pg_loss",
                      "v_loss", "entropy"}
    assert all(np.isfinite(float(x)) for x in m.values())
    after = dict(ts.params.named_parameters())
    assert all(not torch.equal(before[k], after[k]) for k in before if k.endswith("kernel"))
    assert tuple(st.objects.shape) == (32, 8, 8)


@pytest.mark.parametrize("policy", FAMILIES)
def test_collect_replays_jax_step_by_step(policy):
    """The port's collect, replayed through JAX one step at a time from envs
    near ``max_steps`` (so auto-reset fires): at each t, JAX's policy on the
    port's snapshot gives the port's logits (rtol 2e-2 / atol 2e-2; measured
    max 1.5e-8 mlp, 1.8e-6 cnn, 1.2e-2 vit), the port's action is the argmax of its logits plus the Gumbel
    noise (``jax.random.gumbel`` draws), and JAX's batched ``_step_one`` on
    the port's state and action, with done envs taking JAX's ``_reset_one``
    of their own keys (JAX ``ppo.py:180``), gives the port's next state,
    reward and done bit for bit. A T-step collect equals the T one-step
    collects."""
    ppo, tp, v, params = family(policy, seed=4)
    cfg, T, B = tcfg(CFG), 6, 24
    st0 = jcw.reset_from_seed(CFG, 4, B)
    st0 = st0.replace(step_num=jnp.asarray(
        np.random.default_rng(4).integers(CFG.max_steps - 4, CFG.max_steps, B), jnp.int32))
    noise = torch.as_tensor(np.asarray(jax.random.gumbel(jax.random.PRNGKey(5), (T, B, 6))))
    _, apply_j = jppo.make_policy(ppo)
    _, apply_t = tppo.make_policy(tp)
    step_j = jax.jit(jax.vmap(partial(_step_one, CFG)))
    reset_one = jax.jit(jax.vmap(partial(_reset_one, CFG)))
    st = to_port(st0)
    one = tp._replace(rollout_steps=1)
    trs, dones = [], 0
    for t in range(T):
        with torch.no_grad():
            logits, _ = apply_t(params, tppo.snapshot(st))
        jl, _ = apply_j(v, jppo.snapshot(to_jax(st)))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
        nxt, tr = tppo._collect(cfg, one, apply_t, params, st, noise[t:t + 1])
        action = tr.action[0]
        assert torch.equal(action, torch.argmax(noise[t] + logits, dim=-1).to(torch.int32))
        js2, res = step_j(to_jax(st), jnp.asarray(action.numpy()))
        done = np.asarray(res.done)
        fresh = reset_one(jax.vmap(jax.random.wrap_key_data)(js2.rng))
        want = {k: np.where(done.reshape((-1,) + (1,) * (a.ndim - 1)), f, a) for (k, a), f in
                zip(np_tree(js2).items(), np_tree(fresh).values())}
        assert_tree_equal(interop.env_state_to_numpy(nxt), want)
        np.testing.assert_array_equal(tr.done[0].numpy(), done)
        np.testing.assert_array_equal(tr.reward[0].numpy(), np.where(
            np.asarray(res.reward) == CFG.max_steps, 1.0, -1.0 / CFG.max_steps).astype(np.float32))
        assert_tree_equal({k: x[0].numpy() for k, x in tr.obs._asdict().items()},
                          np_tree(jppo.snapshot(to_jax(st))))
        dones += int(done.sum())
        trs.append(tr)
        st = nxt
    assert dones > 0
    whole_end, whole = tppo._collect(cfg, tp._replace(rollout_steps=T), apply_t, params,
                                     to_port(st0), noise)
    for k in tppo.Transition._fields[1:]:
        assert torch.equal(getattr(whole, k), torch.cat([getattr(tr, k) for tr in trs])), k
    assert_tree_equal(interop.env_state_to_numpy(whole_end), interop.env_state_to_numpy(st))


@pytest.mark.parametrize("policy", FAMILIES)
def test_evaluate_matches_jax_eval_batch(policy):
    """Greedy episodes from JAX's reset state and the same parameters: the
    port's summary equals JAX's ``summarize(_eval_batch(...))``; the port's
    ``evaluate_policy`` (its own reset) summarises every episode."""
    ppo, tp, v, params = family(policy, seed=7)
    keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(7), 24))
    want = jev.summarize(jev._eval_batch(CFG, ppo, v, keys))
    state = to_port(jreset(CFG, keys))
    got = tev.summarize(tev._eval_batch(tcfg(CFG), tp, params, state))
    assert got == want
    out = tev.evaluate_policy(tcfg(CFG), tp, params, 8, seed=1)
    assert out["episodes"] == 8 and 0 < out["mean_episode_steps"] <= CFG.max_steps
    assert set(out["skill_completion"]) == set(want["skill_completion"])


def test_evaluate_expert_matches_jax():
    """The numpy expert through each package's Ray façade in parity mode, on
    the same seeds: the same summary."""
    want = jev.evaluate_expert(num_episodes=2, seed=3, rng_mode="parity")
    got = tev.evaluate_expert(num_episodes=2, seed=3, rng_mode="parity", device="cpu")
    assert got == want and got["episodes"] == 2
