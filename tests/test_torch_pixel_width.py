"""The pixel policy's chunked forward (``train/fast_pixel_ppo.
apply_pixel_policy_chunked``), on the CPU.

On the card the collect runs the conv policy in chunks of one fixed width,
the last zero-padded, so that a rank of a mesh holding part of the batch gives
the unsharded run's columns bit for bit (cuDNN and cuBLAS pick their kernel,
and with it the order of each sum, by the batch's width), replayed there
from a CUDA graph. The card's checks are ``chip_smoke.py`` phases 17 (the
graph against its chunks) and 21. Here a small chunk width runs the same
chunking and padding: a column's result must not depend on which batch it
came in, and the chunked policy must still be JAX's.
"""

import jax
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.train import fast_pixel_ppo as jfx
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx

from test_torch_fast_pixel_ppo import (
    NARROW,
    PRESETS,
    collect_setup,
    port_params,
    port_ppo,
    random_packed,
)
from test_torch_fast_ppo import SINGLE, f32, jax_gumbel_uniforms, to_port
from test_torch_packed_rollout import tcfg

torch.set_num_threads(1)

CHUNK = 64


def columns(st, lo, hi):
    """Columns lo:hi of a port PackedState."""
    return type(st)(*(x[..., lo:hi] for x in st))


@pytest.mark.parametrize("preset", list(PRESETS))
def test_chunked_policy_is_width_independent(preset):
    """Chunks of 64 rows: the columns of a batch of 256 equal, bit for bit,
    the same columns computed as two halves and as a ragged 200 + 56 (each
    part's last chunk zero-padded)."""
    cfg, ppo = jcw.ray_config(), port_ppo(PRESETS[preset])
    params = fx.init_pixel_params(prng_key(4), tcfg(cfg), ppo)
    st = to_port(random_packed(cfg, 6, 256))
    with torch.no_grad():
        policy = lambda s: fx._policy_tb(params, tcfg(cfg), s, ppo.stride1, chunk=CHUNK)
        whole = policy(st)
        for cuts in ((0, 128, 256), (0, 200, 256)):
            parts = [policy(columns(st, lo, hi)) for lo, hi in zip(cuts, cuts[1:])]
            for i, name in enumerate(("logits", "value")):
                got = torch.cat([p[i] for p in parts], dim=-1)
                assert torch.equal(got, whole[i]), (name, cuts)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_chunked_policy_matches_jax(preset):
    """Both presets at full width on 21x21, 100 worlds in chunks of 64 (one
    padded): logits and values against JAX's ``_policy_tb`` at rtol 2e-2 /
    atol 2e-2, ``test_apply_pixel_policy_matches_jax``'s tolerance."""
    cfg, ppo = jcw.ray_config(), PRESETS[preset]
    jparams = jfx.init_pixel_params(jax.random.PRNGKey(3), cfg, ppo)
    p = random_packed(cfg, 5, 100)
    want = jfx._policy_tb(jparams, cfg, p, ppo.stride1)
    with torch.no_grad():
        got = fx._policy_tb(port_params(jparams), tcfg(cfg), to_port(p), ppo.stride1,
                            chunk=CHUNK)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), f32(w), rtol=2e-2, atol=2e-2)


def test_chunked_forward_pads_a_narrow_batch(monkeypatch):
    """A batch narrower than one chunk is one call of the chunk's width (zero
    rows padded), and its rows are the unchunked forward's."""
    cfg, ppo = jcw.flat_config(), port_ppo(PRESETS["throughput"])
    params = fx.init_pixel_params(prng_key(1), tcfg(cfg), ppo)
    grid, bits = fx.render_grid_obs(tcfg(cfg), to_port(random_packed(cfg, 2, 10)))
    seen, real = [], fx.apply_pixel_policy

    def spy(p, g, b, stride1):
        seen.append(g.shape[0])
        return real(p, g, b, stride1)

    monkeypatch.setattr(fx, "apply_pixel_policy", spy)
    with torch.no_grad():
        logits, value = fx.apply_pixel_policy_chunked(params, grid, bits, ppo.stride1, 16)
        w_logits, w_value = real(params, grid, bits, ppo.stride1)
    assert seen == [16]
    assert tuple(logits.shape) == (10, 6) and tuple(value.shape) == (10,)
    np.testing.assert_allclose(logits.numpy(), w_logits.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(value.numpy(), w_value.numpy(), rtol=2e-2, atol=2e-2)


def test_collect_runs_its_forward_in_the_given_chunks(monkeypatch):
    """``_collect_pixel(chunk=48)`` at B = 128 (chunks 48 + 48 + 32, the last
    padded): every step's forward is chunked at 48, and each stored value is
    the chunked policy's on that step's stored state, bit for bit."""
    cfg = SINGLE
    ppo = jfx.PixelPPOConfig(rollout_steps=4, **NARROW)
    B = 128
    jparams, jenv, jpool = collect_setup(cfg, ppo, B)
    u = torch.as_tensor(jax_gumbel_uniforms(jax.random.PRNGKey(9), ppo.rollout_steps, B))
    params = port_params(jparams)
    chunks, real = [], fx.apply_pixel_policy_chunked

    def spy(p, g, b, stride1, chunk):
        chunks.append(chunk)
        return real(p, g, b, stride1, chunk)

    monkeypatch.setattr(fx, "apply_pixel_policy_chunked", spy)
    with torch.no_grad():
        _, traj = fx._collect_pixel(tcfg(cfg), port_ppo(ppo), params, to_port(jenv),
                                    to_port(jpool), u, chunk=48)
        assert chunks == [48] * ppo.rollout_steps
        for t in range(ppo.rollout_steps):
            st = fx.PackedState(*(x[t] for x in traj.state))
            logits, value = fx._policy_tb(params, tcfg(cfg), st, ppo.stride1, chunk=48)
            assert torch.equal(value, traj.value[t]), t
