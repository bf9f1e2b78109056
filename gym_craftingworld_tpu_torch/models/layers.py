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

Parameters are f32 and drawn as flax draws them by default: kernels from
``lecun_normal`` (a truncated normal of variance ``1/fan_in``), biases zero,
LayerNorm scales one. The draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# f32 products must be f32 (flax's dtype=f32 heads), not TF32; bf16 products
# are summed in f32, as XLA sums them, not in cuBLAS's reduced-precision
# split-K reductions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

bf16 = torch.bfloat16
f32 = torch.float32
# lecun_normal's truncated normal on [-2, 2] has this standard deviation
_TRUNC_STD = 0.87962566103423978


def lecun_normal(generator: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: a normal truncated to two standard
    deviations, scaled to variance ``1 / fan_in``, on the generator's device."""
    x = torch.empty(shape, dtype=f32, device=generator.device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def _kernel(shape, fan_in: int, generator: torch.Generator | None, device) -> nn.Parameter:
    """A kernel drawn by ``lecun_normal`` from ``generator``; zeros on ``device``
    without one (a shape to load weights into)."""
    if generator is None:
        return nn.Parameter(torch.zeros(shape, dtype=f32, device=device))
    return nn.Parameter(lecun_normal(generator, shape, fan_in))


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
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kh, kw = kernel_size
        self.strides = tuple(strides)
        shape = (kh, kw, in_features, features)
        self.kernel = _kernel(shape, kh * kw * in_features, generator, device)
        self.bias = nn.Parameter(torch.zeros(features, dtype=f32, device=self.kernel.device))

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


def orthogonal(generator: torch.Generator, shape) -> torch.Tensor:
    """flax's ``initializers.orthogonal()`` for a kernel [in, out]: a matrix
    with orthonormal rows or columns, drawn on the generator's device."""
    x = torch.empty(shape, dtype=f32, device=generator.device)
    return nn.init.orthogonal_(x, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=..., use_bias=...)``: ``kernel`` f32[in,
    out], ``bias`` f32[out] unless ``use_bias`` is False. ``init="orthogonal"``
    draws the kernel as flax's ``orthogonal()`` does (the GRU's recurrent
    kernels)."""

    def __init__(self, in_features: int, features: int, dtype=bf16,
                 generator: torch.Generator | None = None, device=None,
                 use_bias: bool = True, init: str = "lecun_normal"):
        super().__init__()
        self.dtype = dtype
        shape = (in_features, features)
        if init == "orthogonal" and generator is not None:
            self.kernel = nn.Parameter(orthogonal(generator, shape))
        else:
            self.kernel = _kernel(shape, in_features, generator, device)
        self.bias = (nn.Parameter(torch.zeros(features, dtype=f32, device=self.kernel.device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = x.to(d) @ self.kernel.to(d)
        return y if self.bias is None else y + self.bias.to(d)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=bf16)`` over the last axis: statistics in f32,
    epsilon 1e-6, the result cast to bf16."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=bf16, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=f32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=f32, device=device))

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
    over ``n_in`` contracted leading axes, ``bias`` f32[*out]."""

    def __init__(self, in_shape, out_shape, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.n_in = len(in_shape)
        shape = (*in_shape, *out_shape)
        self.kernel = _kernel(shape, math.prod(in_shape), generator, device)
        self.bias = nn.Parameter(torch.zeros(out_shape, dtype=f32, device=self.kernel.device))

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

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        hd = dim // num_heads
        for name in ("query", "key", "value"):
            setattr(self, name, DenseGeneral((dim,), (num_heads, hd), generator, device))
        self.out = DenseGeneral((num_heads, hd), (dim,), generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (getattr(self, n)(x).transpose(1, 2) for n in ("query", "key", "value"))
        depth = q.shape[-1]  # [B, heads, N, head_dim]
        q = q / _rounded(math.sqrt(depth), bf16)
        weights = _Softmax.apply(q @ k.transpose(-1, -2))  # bf16[B, heads, N, N]
        return self.out((weights @ v).transpose(1, 2))
