"""The sharded trainers against the unsharded port, over two CPU ranks.

Fast PPO, pixel PPO and ``train/ppo.py`` (mlp) take one update each on two
gloo ranks (``torch_ranks.sharded_train_run``) and in this process without
a mesh, from the same seeds. The collect must give the unsharded
trajectory's columns and final env bit for bit; the first minibatch's
gradients and loss terms, and the update's metrics, agree within the
tolerances below, since only the order of the sums over the ranks differs.
The unsharded trainers are held to the JAX package's by
``test_torch_fast_ppo.py``, ``test_torch_fast_pixel_ppo.py`` and
``test_torch_policy_families.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.parallel import mesh as pm
from gym_craftingworld_tpu_torch.parallel import sharded_engine as se
from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx
from gym_craftingworld_tpu_torch.train import fast_ppo as fp

import torch_ranks

torch.set_num_threads(1)

TRAINERS = ["fast", "pixel", "ppo"]
# Relative L2 of each gradient against the unsharded one. Fast PPO's kernel
# path sums f32 row terms (measured max 1.7e-7); pixel PPO's and the flax
# families' autograd rounds each rank's weight gradients to bf16 before the
# ranks sum them (bf16 matmuls, as in JAX), 2.4e-3 and 3.1e-3 measured.
GRAD_TOL = {"fast": 1e-5, "pixel": 1e-2, "ppo": 1e-2}
# The first minibatch's loss terms, rtol / atol (measured max abs 1.2e-7; the
# first pg_loss is ~1e-7 itself, its advantages being normalised).
LOSS_TOL = (1e-5, 1e-6)
# The update's metrics: later minibatches see parameters that differ in their
# last bits (measured max abs 2.1e-6, relative 1.5e-3 on a pg_loss of 1e-4).
METRIC_TOL = (1e-3, 1e-5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    torch_ranks.spawn("torch_ranks:train_checks", 2, out)
    return torch_ranks.sharded_train_run(None), [torch_ranks.load(out, r) for r in range(2)]


def fields(x):
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return x._asdict()


def joined(parts, axis):
    """The ranks' columns of a state or trajectory, put side by side on the
    batch axis ``axis`` (nested states too)."""
    out = {}
    for k, v in fields(parts[0]).items():
        out[k] = (torch.cat([fields(p)[k] for p in parts], dim=axis) if isinstance(v, torch.Tensor)
                  else joined([fields(p)[k] for p in parts], axis))
    return out


def assert_equal(got: dict, want):
    for k, v in fields(want).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert_equal(got[k], v)


@pytest.mark.parametrize("name", TRAINERS)
def test_sharded_collect_is_the_unsharded_trajectory(runs, name):
    whole, ranks = runs
    env_axis = 0 if name == "ppo" else -1  # EnvState is batch-leading, PackedState lane-major
    for key in ("env", "env_step"):
        assert_equal(joined([r[name][key] for r in ranks], env_axis), whole[name][key])
    # train/ppo.py's snapshots [T, B, ...]; the fast trainers' [T, ..., B]
    assert_equal(joined([r[name]["traj"] for r in ranks], 1 if name == "ppo" else -1),
                 whole[name]["traj"])


def rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


@pytest.mark.parametrize("name", TRAINERS)
def test_sharded_first_minibatch_gradient_and_losses(runs, name):
    """Within ``GRAD_TOL`` and ``LOSS_TOL``; every rank holds the same sums."""
    whole, ranks = runs
    for r in ranks:
        for k, g in whole[name]["grads"].items():
            err = rel_l2(r[name]["grads"][k], g)
            assert err <= GRAD_TOL[name], (k, err)
        for k, v in whole[name]["aux"].items():
            np.testing.assert_allclose(float(r[name]["aux"][k]), float(v), *LOSS_TOL, err_msg=k)
    for k in whole[name]["grads"]:
        assert torch.equal(ranks[0][name]["grads"][k], ranks[1][name]["grads"][k]), k


@pytest.mark.parametrize("name", TRAINERS)
def test_sharded_update_metrics(runs, name):
    """The whole update's metrics: the rates exactly, the loss means (whose
    later minibatches see parameters that differ in their last bits) within
    ``METRIC_TOL``."""
    whole, ranks = runs
    for r in ranks:
        m, want = r[name]["metrics"], whole[name]["metrics"]
        assert set(m) == set(want)
        for k in want:
            np.testing.assert_allclose(float(m[k]), float(want[k]), *METRIC_TOL, err_msg=k)
        for k in ("reward_mean", "episode_done_frac", "success_rate"):
            assert float(m[k]) == float(want[k]), k


@pytest.mark.parametrize("name", TRAINERS)
def test_sharded_draws_are_the_rank_s_columns(runs, name):
    """Each rank's per-env draws (the fast trainers' Gumbel uniforms [T, 6,
    B], ``train/ppo.py``'s noise [T, B, 6]) are its columns of the whole
    draw, bit for bit, and the rank's rollout phase drew, of the counters,
    the unsharded phase's less the other rank's columns of those draws: the
    keys, the pool and the permutations whole, B / W envs' uniforms."""
    whole, ranks = runs
    axis = 1 if name == "ppo" else -1
    want = whole[name]["draws"]
    assert torch.equal(torch.cat([r[name]["draws"] for r in ranks], dim=axis), want)
    for r in ranks:
        assert r[name]["draws"].numel() * len(ranks) == want.numel()
        assert whole[name]["drawn"] - r[name]["drawn"] == want.numel() - r[name]["draws"].numel()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_fast_ppo_default_pool_follows_jax_s_sharded_step(world):
    """Fast PPO's default pool under a mesh: the keyed ``fresh_packed_batch``
    over several ranks (JAX's sharded step, ``parallel/sharded_engine.py``),
    the pool kernel on one; an explicit ``fused_pool`` is kept. The ranks of
    ``runs`` take the default and draw the unsharded keyed pool's counters
    (``test_sharded_draws_are_the_rank_s_columns``)."""
    mesh = pm.EnvMesh(0, world, torch.device("cpu"))
    assert fp.pool_choice(None, mesh) is (False if world > 1 else None)
    assert fp.pool_choice(None, None) is None
    assert fp.pool_choice(True, mesh) is True and fp.pool_choice(False, mesh) is False


@pytest.mark.parametrize("trainer", ["fast", "pixel"])
def test_sharded_step_raises_unless_blocks_lie_on_one_rank(trainer):
    cfg = cw.flat_config()
    mesh = pm.EnvMesh(0, 2, torch.device("cpu"))  # the raise comes before any collective
    g = prng_key(0)
    env = fp.fresh_packed_batch(cfg, g, 64)  # a rank's 64 envs, blocks of 128 rows
    if trainer == "fast":
        fppo = fp.FastPPOConfig(rollout_steps=16, num_minibatches=2, hidden=32)
        ts, step = fp.init_fast_train_state(g, cfg, fppo), se.fast_train_step_sharded(cfg, fppo, mesh)
    else:
        px = fx.PixelPPOConfig(rollout_steps=8, num_minibatches=2, conv1=8, conv2=8, hidden=32)
        ts, step = fx.init_pixel_train_state(g, cfg, px), se.pixel_train_step_sharded(cfg, px, mesh)
    with pytest.raises(ValueError, match="whole shuffle blocks of 128 rows"):
        step(ts, env, g)
