"""The port's flax layer semantics (``models/layers.py``) against flax, on the CPU.

Each layer runs on the same bf16 inputs and the same parameters in both
packages. Convolutions and products sum in another order in oneDNN than in
XLA's CPU backend; every other step rounds where flax rounds, so most
outputs are bit-identical. The tolerance and the measured error stand at
each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from gym_craftingworld_tpu_torch.models import layers as L
from gym_craftingworld_tpu_torch.ops.threefry import prng_key

torch.set_num_threads(1)

# (n, k, s) -> (lo, hi) as lax.padtype_to_pads gives them: the shapes the
# pixel policies meet
PADS = {
    (21, 3, 2): (1, 1),  # pixel PPO conv1, default
    (21, 3, 3): (0, 0),  # pixel PPO conv1, throughput()
    (11, 3, 2): (1, 1),  # pixel PPO conv2
    (7, 3, 2): (1, 1),  # pixel PPO conv2, throughput()
    (8, 3, 2): (0, 1),  # pixel PPO conv1 on the 8x8 flat world
    (4, 3, 2): (0, 1),  # pixel PPO conv2 on 8x8
    (84, 8, 4): (2, 2),  # PixelActorCritic stem
    (21, 4, 2): (1, 2),  # PixelActorCritic conv2
    (84, 4, 4): (0, 0),  # PixelDistillStudent stem
}


def bf16_pair(a):
    """``a`` rounded to bf16, as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("nks", list(PADS), ids=lambda t: "n%d_k%d_s%d" % t)
def test_conv_same_padding_matches_lax(nks):
    """XLA's pads exactly, and the bf16 output bit-identical to
    ``lax.conv_general_dilated``'s (measured: 0.0 on every row)."""
    n, k, s = nks
    assert L.same_pads(n, k, s) == PADS[nks]
    assert tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]) == PADS[nks]
    rng = np.random.default_rng(n * 100 + k * 10 + s)
    cin, cout = 3, 5
    jx, tx = bf16_pair(rng.standard_normal((2, n, n, cin)))
    kern = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jx, jnp.asarray(kern, jnp.bfloat16), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = L.conv_nhwc(tx, torch.as_tensor(kern), (s, s))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(f32(got), f32(want))


def load(module, variables):
    """Copy a flax layer's variables into the port's layer by name."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = variables["params"]
            for part in name.split("."):
                node = node[part]
            p.copy_(torch.as_tensor(np.asarray(node)))


def perturbed(variables, seed):
    """The variables plus noise, so that biases and scales are not 0 and 1."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype),
                        variables)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_dense_matches_flax(dtype):
    """bf16: the product rounded to bf16, the bias added in bf16; f32 (the
    heads): the bf16 input promoted, an f32 product. rtol 1e-6 / atol 1e-6
    for the f32 sums' order (measured max 0.0 in both)."""
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}[dtype]
    jx, tx = bf16_pair(np.random.default_rng(1).standard_normal((6, 40)))
    layer = nn.Dense(24, dtype=jdt)
    v = perturbed(layer.init(jax.random.PRNGKey(0), jx), 2)
    t = L.Dense(40, 24, dtype=tdt)
    load(t, v)
    want, got = layer.apply(v, jx), t(tx)
    assert got.dtype == tdt and want.dtype == jdt
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-6, atol=1e-6)


def test_layernorm_matches_flax():
    """Statistics in f32, epsilon 1e-6, bf16 out: bit-identical (measured).
    The gradients of the input, scale and bias within 2e-2 of JAX's
    (relative L2; measured max 3.0e-3)."""
    jx, tx = bf16_pair(3 + 2 * np.random.default_rng(3).standard_normal((4, 9, 32)))
    layer = nn.LayerNorm(dtype=jnp.bfloat16)
    v = perturbed(layer.init(jax.random.PRNGKey(0), jx), 4)
    t = L.LayerNorm(32)
    load(t, v)
    got = t(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), f32(layer.apply(v, jx)))
    w = np.random.default_rng(8).standard_normal((4, 9, 32)).astype(np.float32)
    tx.requires_grad_(True)
    (t(tx).to(torch.float32) * torch.as_tensor(w)).sum().backward()
    gv, gx = jax.grad(lambda p, a: (layer.apply(p, a).astype(jnp.float32) * w).sum(),
                      argnums=(0, 1))(v, jx)
    for got, want in ((tx.grad, gx), (t.scale.grad, gv["params"]["scale"]),
                      (t.bias.grad, gv["params"]["bias"])):
        err = np.linalg.norm(f32(got) - f32(want)) / np.linalg.norm(f32(want))
        assert err <= 2e-2, err


def test_gelu_matches_jax():
    """The forward op by op in bf16 as JAX rounds it: bit-identical
    (measured). The backward, torch's derivative at the saved input, within
    one bf16 place of JAX's op-by-op derivative (atol 1.6e-2 at |x| <= 8;
    measured max 0.0159)."""
    jx, tx = bf16_pair(2 * np.random.default_rng(5).standard_normal((4, 33, 64)))
    np.testing.assert_array_equal(f32(L.gelu(tx)), f32(jax.nn.gelu(jx)))
    assert not torch.equal(L.gelu(tx), torch.nn.functional.gelu(tx))  # F.gelu rounds once
    tx.requires_grad_(True)
    L.gelu(tx).to(torch.float32).sum().backward()
    want = jax.grad(lambda a: jax.nn.gelu(a).astype(jnp.float32).sum())(jx)
    np.testing.assert_allclose(f32(tx.grad), f32(want), rtol=0, atol=1.6e-2)


def test_attention_matches_flax():
    """flax's MultiHeadDotProductAttention in bf16 (self-attention, 4 heads):
    bit-identical (measured) on these shapes; the gradient of its input
    within 2e-2 of JAX's (relative L2; measured 7.4e-3)."""
    jx, tx = bf16_pair(np.random.default_rng(6).standard_normal((3, 17, 32)))
    layer = nn.MultiHeadDotProductAttention(num_heads=4, dtype=jnp.bfloat16)
    v = perturbed(layer.init(jax.random.PRNGKey(1), jx, jx), 7)
    t = L.MultiHeadDotProductAttention(32, 4)
    load(t, v)
    assert t.query.kernel.shape == (32, 4, 8) and t.out.kernel.shape == (4, 8, 32)
    np.testing.assert_array_equal(f32(t(tx)), f32(layer.apply(v, jx, jx)))
    tx.requires_grad_(True)
    t(tx).to(torch.float32).square().sum().backward()
    want = f32(jax.grad(lambda a: layer.apply(v, a, a).astype(jnp.float32).__pow__(2).sum())(jx))
    err = np.linalg.norm(f32(tx.grad) - want) / np.linalg.norm(want)
    assert err <= 2e-2, err


def test_lecun_normal_draws():
    """flax's default kernel init: truncated at two standard deviations,
    variance 1/fan_in (from JAX's key data; its values against flax's in
    tests/test_torch_keyed_init.py)."""
    x = L.lecun_normal(prng_key(0), (256, 512), 256)
    assert abs(float(x.std()) - 1 / 16) < 2e-3
    assert float(x.abs().max()) <= 2 / 16 / L._TRUNC_STD + 1e-6
