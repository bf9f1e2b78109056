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

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.ops import fused_update as jfu
from gym_craftingworld_tpu.train import fast_ppo as jfp
import gym_craftingworld_tpu_torch as tcw
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core import state as tstate
from gym_craftingworld_tpu_torch.ops import fused_reset as fr
from gym_craftingworld_tpu_torch.ops import fused_update as fu
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
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
    params = interop.mlp_params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
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


def test_out_of_range_block_ids_follow_jax_gather():
    """Block ids past either end read ``featb[ids]`` as JAX gathers it (a
    negative id wraps once, then clamps), held against the JAX kernel on
    JAX's own gather. JAX's indexed Pallas path in interpret mode refuses
    such ids instead, so it cannot be the yardstick here."""
    cfg = jcw.ray_config()
    fppo, jparams, tfppo, params = params_pair(2, cfg, 64)
    rng = np.random.default_rng(8)
    NB, BLK, F = 8, 256, jfp.feature_rows(cfg)
    feat = rng.standard_normal((NB, BLK, F)).astype(np.float32)
    ids = np.array([NB, NB + 5, -1, -NB - 3], dtype=np.int32)
    N = len(ids) * BLK
    rest = (rng.integers(0, 6, N).astype(np.int32),) + tuple(
        rng.standard_normal(N).astype(np.float32) for _ in range(4))
    jfeatb = jnp.asarray(feat, jnp.bfloat16)
    jids = np.array(jnp.arange(NB)[jnp.asarray(ids)])
    np.testing.assert_array_equal(fu.block_ids(torch.as_tensor(ids), NB).numpy(), jids)
    assert jids.tolist() == [NB - 1, NB - 1, NB - 1, 0]

    featb = torch.as_tensor(feat).to(torch.bfloat16)
    x_pad, _ = fu.pad_features_plain(featb.view(NB * BLK, F), torch.as_tensor(ids), BLK)
    np.testing.assert_array_equal(x_pad[:, :F].float().numpy(),
                                  featb[torch.as_tensor(jids).long()].reshape(N, F).float().numpy())

    trest = tuple(torch.as_tensor(x) for x in rest)
    grads, aux = fu.fused_minibatch_grads_indexed(tfppo, params, featb, torch.as_tensor(ids), trest)
    jbatch = (jfeatb[jnp.asarray(ids)].reshape(N, F),) + tuple(jnp.asarray(x) for x in rest)
    jg, jaux = jfu.fused_minibatch_grads(fppo, jparams, jbatch, interpret=True)
    assert_grads_close(grads, jg._asdict(), "out-of-range ids vs JAX kernel on featb[ids]")
    assert_losses_close(aux, jaux)
    with pytest.raises(Exception, match="Out-of-bounds block index"):
        jfu.fused_minibatch_grads_indexed(fppo, jparams, jfeatb, jnp.asarray(ids),
                                          tuple(jnp.asarray(x) for x in rest), interpret=True)


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


# --------------------------------------------------------------------------
# The kernel's pad pass, product core and split plan, through their plain
# versions and plain Python (the CUDA kernels themselves run in chip_smoke.py).
# --------------------------------------------------------------------------


@pytest.mark.parametrize("indexed", [False, True])
def test_pad_features_plain(indexed):
    """x_pad is featb[ids] (or x) zero-padded to 128 columns; x_pad_t its transpose."""
    rng = np.random.default_rng(4)
    NB, BLK, F = 6, 64, 67
    feat = rng.standard_normal((NB * BLK, F)).astype(np.float32)
    ids = np.array([4, 1, 5], dtype=np.int32)
    rows = feat.reshape(NB, BLK, F)[ids].reshape(-1, F) if indexed else feat
    want = np.zeros((rows.shape[0], 128), np.float32)
    want[:, :F] = torch.as_tensor(rows).to(torch.bfloat16).float().numpy()
    x_pad, x_pad_t = fu.pad_features_plain(
        torch.as_tensor(feat).to(torch.bfloat16), torch.as_tensor(ids) if indexed else None, BLK)
    assert x_pad.dtype == x_pad_t.dtype == torch.bfloat16 and x_pad_t.is_contiguous()
    np.testing.assert_array_equal(x_pad.float().numpy(), want)
    np.testing.assert_array_equal(x_pad_t.float().numpy(), want.T)


def test_plain_on_padded_features_matches_jax_kernel():
    """Zero-padded features and w1 give the unpadded gradients, zero in the
    padded columns of gw1, within the file's tolerances of the JAX kernel."""
    cfg = jcw.ray_config()
    fppo, jparams, tfppo, params = params_pair(5, cfg, 64)
    F, n = jfp.feature_rows(cfg), 700
    b = numpy_batch(11, n, F)
    tb = torch_batch(b)
    w = fu.weights(params)
    x_pad, _ = fu.pad_features_plain(tb[0])
    w_pad = w._replace(w1=torch.nn.functional.pad(w.w1, (0, 128 - F)))
    g_pad, *rows = fu.ppo_grads_plain(tfppo, w_pad, x_pad, *fu._rest(*tb[1:]))
    assert g_pad["w1"].shape == (64, 128) and not g_pad["w1"][:, F:].any()
    g_pad["w1"] = g_pad["w1"][:, :F]
    grads, aux = fu._finish(tfppo, n, g_pad, *rows)
    g_ref, aux_ref = fu.fused_minibatch_grads(tfppo, params, tb)
    assert_grads_close(grads, g_ref, "padded vs unpadded")
    assert_losses_close(aux, aux_ref)
    jg, jaux = jfu.fused_minibatch_grads(fppo, jparams, jax_batch(b), interpret=True)
    assert_grads_close(grads, jg._asdict(), "padded vs JAX kernel")
    assert_losses_close(aux, jaux)


def test_gemm_bf16_plain_matches_jax_mm():
    """The product core's plain version is the JAX kernel's ``_mm`` contracting
    the K axis of two K-major operands; the card's tolerance is 1e-5 of sum |a b|."""
    rng = np.random.default_rng(6)
    a = rng.standard_normal((37, 192)).astype(np.float32)
    b = rng.standard_normal((53, 192)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = np.array(jfu._mm(ja, jb, ((1,), (1,))))
    ta, tb = torch.as_tensor(a).to(torch.bfloat16), torch.as_tensor(b).to(torch.bfloat16)
    launches = fu.gemm_bf16_kernel.launches
    got = fu.gemm_bf16_kernel(ta, tb)  # CPU tensors: the plain version
    assert fu.gemm_bf16_kernel.launches == launches
    assert got.dtype == torch.float32 and tuple(got.shape) == (37, 53)
    scale = ta.float().abs() @ tb.float().abs().T
    assert float(((got - torch.as_tensor(want)).abs() / scale).max()) < 1e-5
    np.testing.assert_array_equal(fu.gemm_bf16_plain(ta, tb).numpy(), got.numpy())


@pytest.mark.parametrize("n", [131072, 1000, 131067])
def test_split_plan_and_workspace(n):
    """Split-K covers the rows once with chunks of whole k-steps, fills the
    card with ~2 blocks an SM, and the scratch matches the plan."""
    H = 512
    p = fu.ppo_plan(n, H)
    assert p.ldt == -(-n // 8) * 8
    for splits, kc, tiles in ((p.s_w1, p.kc_w1, 4), (p.s_w2, p.kc_w2, 16)):
        assert kc % 64 == 0 and (splits - 1) * kc < p.ldt <= splits * kc
        assert splits * tiles <= 2 * 132 and (splits * tiles >= 132 or kc == 64)
    if n == 131072:
        assert (p.s_w1, p.kc_w1, p.s_w2, p.kc_w2, p.s_head) == (64, 2048, 16, 8192, 256)
    shapes = {name: (shape, dtype) for name, shape, dtype in fu.workspace_shapes(n, H)}
    assert list(shapes)[:8] == ["h1", "h2", "dz1", "dz2", "dheads", "part_w1", "part_w2",
                                "part_head"]
    assert shapes["part_w1"][0] == (p.s_w1, H, 128) and shapes["part_w2"][0] == (p.s_w2, H, H)
    for name in ("h1_t", "dz1_t", "dz2_t"):
        assert shapes[name] == ((H, p.ldt), torch.bfloat16)
    assert shapes["x_pad"][0] == (n, 128) and shapes["x_pad_t"][0] == (128, p.ldt)
    if n == 131072:  # the transposed and padded copies: ~0.47 GB more scratch
        extra = sum(math.prod(shape) * dtype.itemsize for name, (shape, dtype) in shapes.items()
                    if name.endswith(("_t", "_pad")))
        assert 0.44e9 < extra < 0.48e9


def test_core_operands_must_be_16_byte_aligned():
    """The product core's operands start on 16-byte boundaries: the wrappers'
    check refuses a view at an odd offset before anything is launched."""
    buf = torch.zeros(8 * 64 + 1, dtype=torch.bfloat16)
    good, odd = buf[:512].view(8, 64), buf[1:].view(8, 64)
    assert good.data_ptr() % 16 == 0 and odd.data_ptr() % 16 == 2
    fu._check("w2", good, torch.bfloat16, (8, 64), good.device, aligned=True)
    fu._check("x", odd, torch.bfloat16, (8, 64), odd.device)  # read element by element
    with pytest.raises(ValueError, match="16-byte boundary"):
        fu._check("w2", odd, torch.bfloat16, (8, 64), odd.device, aligned=True)


ENTRY_POINTS = {
    "reset_from_seed": lambda **kw: tcw.reset_from_seed(tcw.ray_config(), 0, 4, **kw).objects,
    "zeros_state": lambda **kw: tstate.zeros_state(tcw.ray_config(), 4, **kw).objects,
    "fused_action_stream": lambda **kw: pf.fused_action_stream(4, 1, 3, **kw),
    "fresh_packed_fused": lambda **kw: fr.fresh_packed_fused(tcw.ray_config(), 3, 8, **kw).slot_key,
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_card_unless_asked(entry):
    call = ENTRY_POINTS[entry]
    assert call(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):  # torch's own: no CUDA here
            call()
