"""The port's PPO-gradient kernel on the CPU, where it takes its plain version,
against autograd of the port's ``_loss_bm`` and against the JAX kernel in
interpret mode.

Tolerances are the JAX suite's (tests/test_fused_update.py): bf16 operands
with f32 sums in another order give a max error under 3e-2 of the largest
gradient entry and a cosine above 0.999 per parameter; losses agree at
rtol 2e-3 / atol 2e-4. The indexed form runs the same arithmetic on the same
rows as the gathered one, so it must match at rtol 1e-6. chip_smoke.py holds
the CUDA kernel against this plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.ops import fused_update as jfu
from gym_craftingworld_tpu.train import fast_ppo as jfp
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.ops import fused_update as fu
from gym_craftingworld_tpu_torch.train import fast_ppo as fp

torch.set_num_threads(1)

FIELDS = fp.PARAM_NAMES


def numpy_batch(seed, n, F):
    """The JAX suite's random minibatch, as numpy."""
    rng = np.random.default_rng(seed)
    feat = (rng.random((n, F)) < 0.3).astype(np.float32)
    old_v = rng.standard_normal(n).astype(np.float32)
    return (feat, rng.integers(0, 6, n).astype(np.int32),
            (-np.abs(rng.standard_normal(n)) - 0.5).astype(np.float32), old_v,
            rng.standard_normal(n).astype(np.float32),
            (old_v + 0.5 * rng.standard_normal(n)).astype(np.float32))


def jax_batch(b):
    return (jnp.asarray(b[0], jnp.bfloat16),) + tuple(jnp.asarray(x) for x in b[1:])


def torch_batch(b):
    return (torch.as_tensor(b[0]).to(torch.bfloat16),) + tuple(torch.as_tensor(x) for x in b[1:])


def params_pair(seed, cfg, hidden):
    """(JAX config, JAX params, port config, the same params in the port)."""
    fppo = jfp.FastPPOConfig(hidden=hidden)
    jp = jfp.init_params(jax.random.PRNGKey(seed), cfg, fppo)
    params = interop.mlp_params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()})
    return fppo, jp, fp.FastPPOConfig(**fppo._asdict()), params


def assert_grads_close(got: dict, want: dict, what=""):
    for name in FIELDS:
        g = np.asarray(got[name], np.float64)
        r = np.asarray(want[name], np.float64)
        assert g.shape == r.shape, (what, name)
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-6)
        assert err < 3e-2, f"{what} {name}: rel err {err:.4f}"
        cos = (g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r) + 1e-12)
        assert cos > 0.999, f"{what} {name}: cosine {cos:.5f}"


def assert_losses_close(got: dict, want: dict):
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-3, atol=2e-4, err_msg=k)


def port_autograd(fppo, params, batch):
    grads, aux = fp._autograd_grads(fppo, params, batch)
    return {k: v.numpy() for k, v in grads.items()}, aux


@pytest.mark.parametrize("n", [2 * jfu.TILE, jfu.TILE + 640, 700])
def test_plain_matches_autograd_and_jax_kernel(n):
    """Aligned, pad-to-two-tiles and sub-tile row counts."""
    cfg = jcw.flat_config()
    fppo, jparams, tfppo, params = params_pair(0, cfg, 128)
    b = numpy_batch(n, n, jfp.feature_rows(cfg))
    grads, aux = fu.fused_minibatch_grads(tfppo, params, torch_batch(b))
    assert set(grads) == set(FIELDS) and all(g.dtype == torch.float32 for g in grads.values())
    for k in FIELDS:
        assert grads[k].shape == getattr(params, k).shape, k

    ag, aaux = port_autograd(tfppo, params, torch_batch(b))
    assert_grads_close(grads, ag, "vs port autograd")
    assert_losses_close(aux, aaux)

    jg, jaux = jfu.fused_minibatch_grads(fppo, jparams, jax_batch(b), interpret=True)
    assert_grads_close(grads, jg._asdict(), "vs JAX kernel")
    assert_losses_close(aux, jaux)


def test_port_autograd_matches_jax_autodiff():
    """Autograd of the port's ``_loss_bm`` against ``jax.value_and_grad`` of JAX's."""
    cfg = jcw.ray_config()
    fppo, jparams, tfppo, params = params_pair(3, cfg, 64)
    b = numpy_batch(9, 1024, jfp.feature_rows(cfg))
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: jfp._loss_bm(fppo, p, jax_batch(b)), has_aux=True)(jparams)
    ag, aaux = port_autograd(tfppo, params, torch_batch(b))
    assert_grads_close(ag, jg._asdict(), "port autograd vs JAX autodiff")
    assert_losses_close(aaux, {"loss": jloss, **jaux})


def test_indexed_equals_gathered():
    cfg = jcw.ray_config()
    _, _, fppo, params = params_pair(0, cfg, 64)
    rng = np.random.default_rng(1)
    NB, BLK, nbm, F = 8, 256, 4, jfp.feature_rows(cfg)
    featb = torch.as_tensor(rng.standard_normal((NB, BLK, F)).astype(np.float32)).to(torch.bfloat16)
    ids = torch.tensor([5, 0, 3, 6], dtype=torch.int32)
    N = nbm * BLK
    rest = (torch.as_tensor(rng.integers(0, 6, N)),) + tuple(
        torch.as_tensor(rng.standard_normal(N).astype(np.float32)) for _ in range(4))
    g_idx, aux_idx = fu.fused_minibatch_grads_indexed(fppo, params, featb, ids, rest)
    g_ref, aux_ref = fu.fused_minibatch_grads(
        fppo, params, (featb[ids.long()].reshape(N, F),) + rest)
    for k in FIELDS:
        np.testing.assert_allclose(g_idx[k].numpy(), g_ref[k].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(aux_idx["loss"]), float(aux_ref["loss"]), rtol=1e-6)


def test_advantage_std_has_ddof_zero():
    """jnp.std divides by N; torch.std by N - 1 unless told otherwise."""
    adv = np.random.default_rng(2).standard_normal(37).astype(np.float32)
    want = (adv - adv.mean()) / (adv.std() + 1e-8)  # numpy std: ddof 0, as jnp
    np.testing.assert_allclose(fu.normalize_adv(torch.as_tensor(adv)).numpy(), want, rtol=1e-5)


def test_wrapper_counts_and_input_checks():
    cfg = jcw.ray_config()
    _, _, fppo, params = params_pair(0, cfg, 32)
    b = torch_batch(numpy_batch(0, 64, jfp.feature_rows(cfg)))
    before = fu.ppo_grads_plain.calls
    fu.fused_minibatch_grads(fppo, params, b)
    assert fu.ppo_grads_plain.calls == before + 1
    assert fu.fused_minibatch_grads.launches == 0
    w = fu.weights(params)
    with pytest.raises(ValueError):  # the kernel takes int32 actions
        fu.ppo_grads_kernel(fppo, w, b[0], None, 1, b[1].to(torch.int64), *b[2:])
