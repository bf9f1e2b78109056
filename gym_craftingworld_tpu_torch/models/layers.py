"""Flax's layer semantics as ``torch.nn`` modules, for the port's policy families.

The JAX package's models are flax ``linen`` modules. Each layer below computes
what its flax namesake computes, rounding where it rounds, and holds its
parameters under flax's names and in flax's layouts (a convolution kernel is
HWIO, a dense kernel ``[in, out]``), so a flax parameter tree loads by name
(``interop.py``). The points where a plain PyTorch call would differ:

* ``Conv``: flax's ``padding="SAME"`` is XLA's, which pads ``total =
  max((ceil(n/s) - 1)*s + k - n, 0)`` with ``total // 2`` before and the rest
  after; torch refuses ``padding="same"`` with a stride, and pads
  symmetrically otherwise. The input is NHWC, as in flax.
* ``Dense``: with ``dtype=bf16`` the input, the kernel and the bias are cast
  to bf16, the product is rounded to bf16 and the bias added in bf16; with
  ``dtype=f32`` (the heads) a bf16 input is promoted and the product is f32.
* ``LayerNorm``: epsilon 1e-6 (torch's default is 1e-5); mean and variance in
  f32 (``E[x^2] - E[x]^2``, clipped at 0) even for bf16 input; its backward
  keeps only the bf16 input and the row statistics.
* ``gelu``: ``jax.nn.gelu`` is the tanh approximation by default, and JAX
  rounds each of its steps to bf16; ``F.gelu`` computes in f32.
* ``MultiHeadDotProductAttention``: written out, so that its bf16 rounding
  points are flax's (query scaled by ``1/sqrt(head_dim)`` before the product;
  a softmax whose sum is f32 and the rest bf16).

Parameters are f32 and drawn as flax draws them, from the same key: each
layer takes its flax scope (``models/flax_rng.Rngs``, the key of each
parameter derived from the module path as flax derives it) and draws its
kernel with ``lecun_normal`` (``jax.random.truncated_normal``'s uniforms,
bit for bit, then ``sqrt(2) * erfinv``, the clip and the scale), the GRU's
recurrent kernels with ``orthogonal`` and the embeddings with ``normal``;
biases are zero and LayerNorm scales one. The uniforms come from the
counter kernel on the card (``ops/keyed_draws``); ``erfinv`` and the QR are
torch's, within a few ulps of XLA's (``tests/test_torch_keyed_init.py``).
Without a scope a layer holds zeros, a shape to load weights into.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gym_craftingworld_tpu_torch.models.flax_rng import Rngs, child
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops import threefry as tf

# f32 products must be f32 (flax's dtype=f32 heads), not TF32; bf16 products
# are summed in f32, as XLA sums them, not in cuBLAS's reduced-precision
# split-K reductions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

bf16 = torch.bfloat16
f32 = torch.float32
# lecun_normal's truncated normal on [-2, 2] has this standard deviation
_TRUNC_STD = 0.87962566103423978
# jax.random.truncated_normal(key, -2, 2) draws uniforms on [erf(-2 / sqrt2),
# erf(2 / sqrt2)], XLA's float32 erf (held to JAX by tests/test_torch_keyed_init.py),
# and clips to the float32s next inside +-2
TRUNC_LO, TRUNC_HI = -0.9544997215270996, 0.9544997215270996
TRUNC_CLIP = float(np.nextafter(np.float32(2.0), np.float32(0.0)))
INITS = ("truncated_normal", "normal", "orthogonal")


def _orthogonal_shape(shape) -> tuple:
    """The normal draw behind ``orthogonal`` of ``shape``: (max, min) of its
    rows and columns."""
    n_rows, n_cols = math.prod(shape) // shape[-1], shape[-1]
    return (max(n_rows, n_cols), min(n_rows, n_cols))


def init_uniforms(key: torch.Tensor, init: str, shape) -> torch.Tensor:
    """The uniforms f32[n] behind a parameter of ``shape`` drawn by ``init``
    (``INITS``), on the key's device: the truncated normal's on [TRUNC_LO,
    TRUNC_HI), the normals' on [nextafter(-1, 0), 1)."""
    n = math.prod(_orthogonal_shape(shape) if init == "orthogonal" else shape)
    lo, hi = (TRUNC_LO, TRUNC_HI) if init == "truncated_normal" else (tf.NORMAL_LOW, 1.0)
    return kd.uniform_cols(key, (1, n), minval=lo, maxval=hi)[0]


def from_uniforms(init: str, u: torch.Tensor, shape, arg=None) -> torch.Tensor:
    """A parameter of ``shape`` drawn by ``init`` from its uniforms ``u``
    (``init_uniforms``), on their device: ``"truncated_normal"``, flax's
    ``lecun_normal`` of fan-in ``arg`` (``sqrt(2) * erfinv(u)`` clipped
    inside [-2, 2], times ``sqrt(1 / fan_in) / 0.8796...`` as float32 rounds
    it); ``"normal"``, ``jax.random.normal`` times the float32 of ``arg``;
    ``"orthogonal"``, ``jax.random.orthogonal``'s Q of the QR of a normal
    draw of (max, min) of the rows and columns, its columns' signs those of
    R's diagonal, transposed where the rows are fewer."""
    z = tf.normal_from_uniform(u)
    if init == "truncated_normal":
        std = np.sqrt(np.float32(1.0 / arg)) / np.float32(_TRUNC_STD)
        return (torch.clamp(z, -TRUNC_CLIP, TRUNC_CLIP) * float(std)).reshape(shape)
    if init == "normal":
        return z.reshape(shape) * float(np.float32(arg))
    n_rows, n_cols = math.prod(shape) // shape[-1], shape[-1]
    q, r = torch.linalg.qr(z.reshape(_orthogonal_shape(shape)))
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q.T if n_rows < n_cols else q).reshape(shape)


def lecun_normal(key: torch.Tensor, shape, fan_in: int) -> torch.Tensor:
    """flax's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``, on the key's device."""
    return from_uniforms("truncated_normal", init_uniforms(key, "truncated_normal", shape),
                         shape, fan_in)


def normal(key: torch.Tensor, shape, std: float = 1.0) -> torch.Tensor:
    """flax's ``initializers.normal(std)``, on the key's device."""
    return from_uniforms("normal", init_uniforms(key, "normal", shape), shape, std)


def orthogonal(key: torch.Tensor, shape) -> torch.Tensor:
    """flax's ``initializers.orthogonal()``, on the key's device."""
    return from_uniforms("orthogonal", init_uniforms(key, "orthogonal", shape), shape)


def param(rngs: Rngs | None, name: str, shape, init: str = "zeros", fan_in: int = 0,
          std: float = 1.0, device=None) -> nn.Parameter:
    """Parameter ``name`` of the flax scope ``rngs``, f32: ``"zeros"`` or
    ``"ones"``, or drawn by ``"lecun_normal"`` (of ``fan_in``), ``"normal"``
    (of ``std``) or ``"orthogonal"`` from its key. Every parameter takes its
    count of the scope, as flax's ``param`` does; without a scope, zeros on
    ``device`` (ones for ``"ones"``)."""
    if rngs is not None:
        device = rngs.device
    if init in ("zeros", "ones") or rngs is None:
        if rngs is not None:
            rngs.skip()
        fill = torch.ones if init == "ones" else torch.zeros
        return nn.Parameter(fill(shape, dtype=f32, device=device))
    kind = "truncated_normal" if init == "lecun_normal" else init
    if kind not in INITS:
        raise ValueError(f"unknown init {init!r}")
    key = rngs.param_key(name)
    arg = {"truncated_normal": fan_in, "normal": std}.get(kind)
    rngs.record(name, key, kind, shape, arg)
    return nn.Parameter(from_uniforms(kind, init_uniforms(key, kind, shape), shape, arg))


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding (before, after) of one spatial axis of size ``n``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel_size, strides, dtype=bf16)`` on NHWC input.

    ``kernel`` f32[kh, kw, in, out] (HWIO), ``bias`` f32[out]. The output is
    bf16 NHWC: a bf16 convolution, then the bias added in bf16.
    """

    def __init__(self, in_features: int, features: int, kernel_size, strides=(1, 1),
                 key: Rngs | None = None, device=None):
        super().__init__()
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.kernel = param(key, "kernel", (kh, kw, in_features, features), "lecun_normal",
                            kh * kw * in_features, device=device)
        self.bias = param(key, "bias", (features,), device=self.kernel.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.kernel, self.strides) + self.bias.to(bf16)


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, strides) -> torch.Tensor:
    """``lax.conv_general_dilated(x, k, strides, "SAME", ("NHWC", "HWIO",
    "NHWC"))`` in bf16: x [B, H, W, C] -> bf16[B, H', W', O].

    The convolution runs on the NCHW view of the NHWC tensor (channels-last
    strides, which cuDNN takes as they are) after XLA's asymmetric pads.
    """
    kh, kw = kernel.shape[:2]
    sh, sw = strides
    (hlo, hhi), (wlo, whi) = same_pads(x.shape[1], kh, sh), same_pads(x.shape[2], kw, sw)
    x = F.pad(x.to(bf16), (0, 0, wlo, whi, hlo, hhi))
    w = kernel.to(bf16).permute(3, 2, 0, 1)  # OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w.contiguous(memory_format=torch.channels_last),
                 stride=(sh, sw))
    return y.permute(0, 2, 3, 1)  # NHWC


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=..., use_bias=...)``: ``kernel`` f32[in,
    out], ``bias`` f32[out] unless ``use_bias`` is False. ``init="orthogonal"``
    draws the kernel as flax's ``orthogonal()`` does (the GRU's recurrent
    kernels). ``key`` is the layer's own scope (``Rngs.child(name)``)."""

    def __init__(self, in_features: int, features: int, dtype=bf16,
                 key: Rngs | None = None, device=None,
                 use_bias: bool = True, init: str = "lecun_normal"):
        super().__init__()
        self.dtype = dtype
        self.kernel = param(key, "kernel", (in_features, features), init, in_features,
                            device=device)
        self.bias = param(key, "bias", (features,), device=self.kernel.device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = x.to(d) @ self.kernel.to(d)
        return y if self.bias is None else y + self.bias.to(d)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=bf16)`` over the last axis: statistics in f32,
    epsilon 1e-6, the result cast to bf16."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=bf16, key: Rngs | None = None,
                 device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = param(key, "scale", (features,), "ones", device=device)
        self.bias = param(key, "bias", (features,), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _LayerNorm.apply(x, self.scale, self.bias, self.eps, self.dtype)


class _LayerNorm(torch.autograd.Function):
    """flax's LayerNorm forward as it computes it; the backward is the
    layer norm's derivative in f32 from the saved input and row statistics,
    so autograd keeps the input where the op-by-op forward would keep four
    f32 copies of it."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, dtype):
        xf = x.to(f32)
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mu * mu, 0.0)
        rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, mu, rstd, scale)
        return ((xf - mu) * (rstd * scale) + bias).to(dtype)

    @staticmethod
    def backward(ctx, g):
        x, mu, rstd, scale = ctx.saved_tensors
        g = g.to(f32)
        xhat = (x.to(f32) - mu) * rstd
        lead = tuple(range(g.dim() - 1))
        dxhat = g * scale
        dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        return dx.to(x.dtype), (g * xhat).sum(lead), g.sum(lead), None, None


def _rounded(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``, as JAX rounds a weak-typed constant."""
    return torch.tensor(v, dtype=dtype).item()


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu`` (the tanh approximation) op by op in the input's dtype,
    with its constants rounded to that dtype, as JAX computes it; the
    backward is torch's tanh-gelu derivative at the saved input, so autograd
    keeps one tensor where the op-by-op forward would keep four."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        c0, c1 = _rounded(math.sqrt(2 / math.pi), x.dtype), _rounded(0.044715, x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c0 * (x + c1 * x ** 3))))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(g, x, approximate="tanh")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation, rounded as JAX rounds it."""
    return _Gelu.apply(x)


class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` over the last axis as JAX computes it for bf16: the
    exponentials in the input's dtype, their sum in f32 rounded to the
    input's dtype, one division; the backward is torch's softmax derivative
    at the saved output."""

    @staticmethod
    def forward(ctx, x):
        e = torch.exp(x - x.amax(-1, keepdim=True))
        y = e / e.sum(-1, keepdim=True, dtype=f32).to(x.dtype)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch._softmax_backward_data(g, y, -1, y.dtype)


class DenseGeneral(nn.Module):
    """The projections of flax's attention, in bf16: ``kernel`` f32[*in, *out]
    over ``n_in`` contracted leading axes, ``bias`` f32[*out]. flax draws the
    kernel flattened to [prod(in), prod(out)], so its fan-in is the
    flattened in-axes."""

    def __init__(self, in_shape, out_shape, key: Rngs | None = None, device=None):
        super().__init__()
        self.n_in = len(in_shape)
        self.kernel = param(key, "kernel", (*in_shape, *out_shape), "lecun_normal",
                            math.prod(in_shape), device=device)
        self.bias = param(key, "bias", tuple(out_shape), device=self.kernel.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        n_out = k.dim() - self.n_in
        k_in, k_out = k.shape[:self.n_in], k.shape[self.n_in:]
        lead = x.shape[:x.dim() - self.n_in]
        y = x.to(bf16).reshape(*lead, math.prod(k_in)) @ k.to(bf16).reshape(
            math.prod(k_in), math.prod(k_out))
        y = y + self.bias.to(bf16).reshape(-1)
        return y.reshape(*lead, *k_out) if n_out > 1 else y


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads, dtype=bf16)`` as
    self-attention, with its default ``qkv_features = out_features = dim``.

    ``query``/``key``/``value`` kernels f32[dim, heads, head_dim], biases
    f32[heads, head_dim]; ``out`` kernel f32[heads, head_dim, dim], bias
    f32[dim]. x bf16[B, N, dim] -> bf16[B, N, dim].
    """

    def __init__(self, dim: int, num_heads: int, key: Rngs | None = None, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        hd = dim // num_heads
        for name in ("query", "key", "value"):
            setattr(self, name, DenseGeneral((dim,), (num_heads, hd), child(key, name), device))
        self.out = DenseGeneral((num_heads, hd), (dim,), child(key, "out"), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (getattr(self, n)(x).transpose(1, 2) for n in ("query", "key", "value"))
        depth = q.shape[-1]  # [B, heads, N, head_dim]
        q = q / _rounded(math.sqrt(depth), bf16)
        weights = _Softmax.apply(q @ k.transpose(-1, -2))  # bf16[B, heads, N, N]
        return self.out((weights @ v).transpose(1, 2))
