"""Each reference agrees with the port at tiny sizes on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import keys as K
from benchmark.reference import world as W
from benchmark.run import run_cell
from benchmark.tests.conftest import tiny
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops import threefry as tf
from gym_craftingworld_tpu_torch.ops.fused_reset import fresh_packed_fused
from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fpp
from gym_craftingworld_tpu_torch.train import fast_ppo as fp

CFG = EnvConfig()


def host(p) -> dict:
    return {k: getattr(p, k).numpy() for k in W.FIELDS}


def test_threefry_draws_equal_the_port_s():
    k = K.key_data(2**33 + 12345)
    assert torch.equal(K.split(k, 7), tf.split(k, 7))
    assert torch.equal(K.uniform(K.split(k, 3), (6, 50), 1e-7, 1.0),
                       fp.gumbel_uniforms(k, 3, 50))
    assert torch.equal(K.randint(k, (2,), 0, 2**31 - 1), tf.randint(k, (2,), 0, 2**31 - 1))
    assert torch.equal(K.permutation(k, 2048), tf.permutation(k, 2048).long())


def test_worlds_and_steps_equal_the_port_s():
    p = fresh_packed_fused(CFG, 1234, 300, seed2=5678, device="cpu")
    env = W.pool(1234, 5678, 300, 21, 21, 9, "cpu")
    assert not W.mismatched(host(p), env).any()
    k = K.key_data(99)
    assert not W.mismatched(host(fp.fresh_packed_batch(CFG, k, 257)),
                            W.keyed_batch(k, 257, 21, 21, 9)).any()
    rng = np.random.default_rng(0)
    for _ in range(350):  # past max_steps, so episodes end
        a = rng.integers(0, 6, 300).astype(np.int32)
        p, reward, done = pf.rollout_packed_actions(CFG, p, torch.from_numpy(a)[None])
        env, r, d = W.step(env, a, 21, 21, 300)
        assert not W.mismatched(host(p), env).any()
        assert np.array_equal(reward[0].numpy(), r) and np.array_equal(done[0].numpy(), d)


def test_policy_inputs_and_bench_actions_equal_the_port_s():
    p = fresh_packed_fused(CFG, 7, 64, seed2=8, device="cpu")
    te = W.to_torch(host(p), "cpu")
    assert torch.equal(W.features(te, 21, 21, 300), fp.features(CFG, p))
    for a, b in zip(W.render(te, 21, 21), fpp.render_grid_obs(CFG, p)):
        assert torch.equal(a, b)
    assert np.array_equal(W.bench_actions(987654, np.arange(70), 37),
                          pf.action_stream_plain(70, 987654, 37).numpy())


@pytest.mark.parametrize("workload", ["fastppo-mlp512-ray21.train64k",
                                      "pixelppo-conv32-ray21.train16k",
                                      "fastppo-mlp512-ray21.rollout16k"])
def test_a_sound_tiny_run_is_correct(bench, workload):
    result, lines = run_cell(bench, workload, 2**31 + 77, 0.01, False, "cpu", tiny(bench, workload))
    assert result["correct"], lines
    assert list(result)[-1] == "checks"
