"""Fast PPO's training loop in lockstep with the JAX package's, on the CPU.

Six updates of single-task 8x8 at 256 envs (the shapes of
``tests/test_fused_update.py::test_fused_kernel_end_to_end_curve``) run in
the JAX package, and the port replays each update from JAX's draws: the pool
of 2B worlds drawn from ``k_pool`` (carried across by ``interop``), the
Gumbel uniforms of ``k_roll`` and the epoch permutations of ``k_perm``. A
fault that compounds across updates (the optimizer's state, GAE's bootstrap
at a done, the auto-reset, the sampler) shows as a trajectory or parameters
that leave JAX's. ``chip_smoke.py`` phase 22 repeats the check in
distribution at full width on the card. The gradient kernel's wrapper runs
its plain version here.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.ops import fused_update as jfu
from gym_craftingworld_tpu.train import fast_ppo as jfp
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.tools import fast_ppo_sweep as sweep
from gym_craftingworld_tpu_torch.train import fast_ppo as fp

from test_torch_fast_ppo import jax_gumbel_uniforms, port_fppo, port_params, to_port
from test_torch_packed_rollout import assert_tree_equal, np_tree, tcfg

torch.set_num_threads(1)

SINGLE = dataclasses.replace(jcw.flat_config(), stacking=False)
FPPO = jfp.FastPPOConfig(rollout_steps=16, num_minibatches=2, update_epochs=1, hidden=64)
B = 256
UPDATES = 6
TRAJ = ("action", "done", "raw_reward", "reward")
# ulps of -log(-log u) (up to ~16.1, where an f32 ulp is 1.9e-6) by which
# torch's and XLA's logarithms may differ
GUMBEL_SLACK = 1e-5
SEED = 40  # see test_six_updates_in_lockstep_with_jax


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _jax_update(cfg, fppo, use_fused, ts, env, key):
    """One update of ``train_step_fast`` written out (the JAX tool's loop);
    returns what the port replays and what it must match, with the logits of
    the collect's features under the parameters it collected with."""
    key, k_pool, k_roll, k_perm = jax.random.split(key, 4)
    pool = jfp.fresh_packed_batch(cfg, k_pool, 2 * env.agent_r.shape[-1])
    env, traj = jfp._collect(cfg, fppo, ts.params, env, pool, k_roll)
    logits = jax.vmap(lambda f: jfp.apply_policy(ts.params, f)[0])(traj.feat)
    _, last_value = jfp.apply_policy(ts.params, jfp.features(cfg, env))
    adv, ret = jfp._gae(fppo, traj, last_value)
    params, opt_state, _, _ = jfp._update_phase(fppo, ts, traj, adv, ret, k_perm,
                                                use_fused_kernel=use_fused)
    sps = (traj.raw_reward == cfg.max_steps).sum() / traj.action.size
    ts = jfp.FastTrainState(params, opt_state, ts.update_idx + 1)
    return ts, env, key, pool, k_roll, k_perm, traj, logits, sps


@functools.lru_cache(maxsize=2)
def jax_run(use_fused: bool, seed: int = SEED):
    """The JAX run, through its gradient kernel in interpret mode
    (``use_fused``) or through autodiff: the initial params and env, then
    per update the draws, the trajectory, the logits, the success per step
    and the parameters after the update. Params, env and training draw from
    ``PRNGKey(seed)``, ``seed + 1`` and ``seed + 2``."""
    cfg, fppo = SINGLE, FPPO
    ts = jfp.init_fast_train_state(jax.random.PRNGKey(seed), cfg, fppo)
    env = jfp.fresh_packed_batch(cfg, jax.random.PRNGKey(seed + 1), B)
    key = jax.random.PRNGKey(seed + 2)
    start = (ts.params, np_tree(env))
    NB = fppo.rollout_steps * B // jfp.shuffle_block(fppo.rollout_steps, B, fppo.num_minibatches)
    updates = []
    indexed = jfu.fused_minibatch_grads_indexed
    jfu.fused_minibatch_grads_indexed = functools.partial(indexed, interpret=True)
    try:
        for _ in range(UPDATES):
            ts, env, key, pool, k_roll, k_perm, traj, logits, sps = _jax_update(
                cfg, fppo, use_fused, ts, env, key)
            updates.append(dict(
                pool=np_tree(pool),
                u=jax_gumbel_uniforms(k_roll, fppo.rollout_steps, B),
                perms=np.stack([np.asarray(jax.random.permutation(k, NB))
                                for k in jax.random.split(k_perm, fppo.update_epochs)]),
                traj={k: np.asarray(getattr(traj, k)) for k in TRAJ},
                logits=np.array(logits, np.float32), sps=float(sps), env=np_tree(env),
                params={k: np.asarray(v, np.float32) for k, v in ts.params._asdict().items()}))
    finally:
        jfu.fused_minibatch_grads_indexed = indexed
    return start, updates


@pytest.mark.parametrize("fused", [True, False])
def test_six_updates_in_lockstep_with_jax(fused, seed=SEED):
    """Each update from JAX's draws: actions, rewards, dones, the env and
    success per step equal JAX's, and the parameters lie within ``2 * lr`` of
    JAX's (``test_update_phase_matches_jax_autodiff``'s tolerance). The
    gradient kernel's wrapper (its plain version here; ``fused``) against
    JAX's kernel in interpret mode, and autograd against JAX's autodiff: the
    kernel's arithmetic is not autodiff's, and Adam's first steps, near
    ``lr * sign(g)``, turn a gradient entry near 0 that the two compute with
    opposite signs into a parameter ``2 * lr`` apart.

    Every Gumbel argmax must be decided by a margin that the two packages'
    logits cannot flip: at each draw the gap of the two best noisy logits
    exceeds twice the draw's largest logit difference from JAX's plus
    ``GUMBEL_SLACK``, so a near-tie fails here and cannot pass by luck.
    ``test_collect_from_jax_uniforms_equals_jax`` asks a fixed 1e-4 of its
    3,072 draws; the least gap of these 24,576 draws a run is 3e-6 to 6e-5.
    From ``PRNGKey(10)``, ``20`` and ``30`` one of the two runs meets such a
    tie (gaps 2.5e-6, 1.0e-5 and 7.9e-6 against logit differences of 6.3e-6,
    1.3e-6 and 1.7e-5), so ``SEED`` is 40, the first of 10, 20, 30, 40
    without one.
    """
    (jparams, jenv), updates = jax_run(fused, seed)
    cfg, fppo = tcfg(SINGLE), port_fppo(FPPO)
    params = port_params(jparams)
    ts = fp.FastTrainState(params, fp.make_optimizer(fppo).init(params.tensors()), 0)
    env = interop.packed_state_from_numpy(jenv, device="cpu")
    assert sum(int(u["traj"]["done"].sum()) for u in updates) > 0  # auto-reset fired
    assert max(u["sps"] for u in updates) > 0  # some episode succeeded
    for i, want in enumerate(updates):
        pool = interop.packed_state_from_numpy(want["pool"], device="cpu")
        u = torch.as_tensor(want["u"])
        with torch.no_grad():
            env, traj = fp._collect(cfg, fppo, ts.params, env, pool, u)
            logits = torch.stack([fp.apply_policy(ts.params, f)[0] for f in traj.feat])
            _, last_value = fp.apply_policy(ts.params, fp.features(cfg, env))
            adv, ret = fp._gae(fppo, traj, last_value)
        g = (logits - torch.log(-torch.log(u))).sort(dim=1, descending=True).values
        margin = g[:, 0] - g[:, 1]  # [T, B]
        drift = (logits - torch.as_tensor(want["logits"])).abs().amax(dim=1)  # [T, B]
        worst = int((margin - 2 * drift).argmin())
        assert bool((margin > 2 * drift + GUMBEL_SLACK).all()), (
            f"update {i}: a near-tie of the Gumbel argmax: margin {margin.view(-1)[worst]:.3e} "
            f"against logits {drift.view(-1)[worst]:.3e} from JAX's")
        for name in TRAJ:
            np.testing.assert_array_equal(getattr(traj, name).numpy(), want["traj"][name],
                                          f"update {i}: {name}")
        assert_tree_equal(interop.packed_state_to_numpy(env), want["env"])
        params, opt_state, losses, auxes = fp._update_phase(
            fppo, ts, traj, adv, ret, torch.as_tensor(want["perms"]), use_fused_kernel=fused)
        ts = fp.FastTrainState(params, opt_state, ts.update_idx + 1)
        metrics = fp.rollout_metrics(cfg, traj, losses, auxes)
        assert float(metrics["success_per_step"]) == pytest.approx(want["sps"], rel=0, abs=0)
        for k in fp.PARAM_NAMES:
            np.testing.assert_allclose(getattr(params, k).detach().numpy(), want["params"][k],
                                       rtol=0, atol=2 * fppo.lr, err_msg=f"update {i}: {k}")
    assert int(ts.opt_state.count) == UPDATES * fppo.update_epochs * fppo.num_minibatches


def test_fused_kernel_end_to_end_curve():
    """The port's counterpart of ``tests/test_fused_update.py::
    test_fused_kernel_end_to_end_curve``: 24 updates on single-task 8x8 at 256
    envs from the same seeds, through the gradient kernel's plain version and
    through autograd (``tools/fast_ppo_sweep.learning_curve``, both paths
    taking the same draws); the tails of the last 8 updates agree within that
    test's band, max(0.25 x the larger tail (at least 1e-3), 0.01)."""
    fppo = port_fppo(FPPO)
    curve_k = np.asarray(sweep.learning_curve(fppo, 0, 24, B, "cpu", fused_update=True))
    curve_a = np.asarray(sweep.learning_curve(fppo, 0, 24, B, "cpu", fused_update=False))
    assert curve_k.shape == curve_a.shape == (24,)
    assert np.isfinite(curve_k).all() and np.isfinite(curve_a).all()
    tail_k, tail_a = curve_k[-8:].mean(), curve_a[-8:].mean()
    band = max(0.25 * max(tail_k, tail_a, 1e-3), 0.01)
    assert abs(tail_k - tail_a) <= band, (tail_k, tail_a)
