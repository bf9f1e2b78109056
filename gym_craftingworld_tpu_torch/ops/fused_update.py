"""The fast-PPO minibatch gradient: one CUDA entry point and its plain version.

Counterpart of ``gym_craftingworld_tpu/ops/fused_update.py``, whose two
Pallas kernels (``_kernel``, :57, and ``_kernel_prefetched``, :270) become
``cw_ppo_grads`` in ``csrc/fused_update.cu``. Both compute the gradient of
``train/fast_ppo._loss_bm`` over one minibatch: a bf16 forward of the
F -> H -> H -> (6 + 1) MLP, the clipped-surrogate loss, the hand-derived
backward, and f32 weight gradients summed over the rows.

Rounding points, as in the JAX kernel (:88-101, :156-173) and in
``apply_policy_bm``: bf16 matmul operands with f32 accumulation;
``h = bf16(max(z, 0))``; bf16 ``dh2``, ``dz2``, ``dh1``, ``dz1``; f32 weight
gradients and loss terms. The relu masks of the backward test ``h > 0``, which
is what autodiff of ``relu(bf16(z))`` tests (it equals the JAX kernel's
``z > 0`` except for ``0 < z < 2**-133``, which rounds to a bf16 zero). Ties as
the JAX kernel takes them (:139-153): ``take_un = un <= cl``,
``take_e = e*e >= ec*ec``, ``in_band = |value - old_v| < clip_eps``.

The value head is row 6 of the heads, as in the JAX kernel; the ``-1e30``
fill and the ``[A+1, TILE]`` padding of Mosaic are gone: the loss runs per
row on 6 logits and the value. The TPU's row tile and its zero padding are
gone too: the kernel takes any N and masks the ragged edge itself.

``fused_minibatch_grads`` and ``fused_minibatch_grads_indexed`` launch the
kernel for CUDA tensors and run ``ppo_grads_plain`` for CPU tensors. Each
counts its kernel launches in ``launches``; ``ppo_grads_plain.calls`` counts
the plain version's calls. Both return ``(grads, aux)``: ``grads`` maps the
``MLPParams`` names (``w1 b1 w2 b2 wl bl wv bv``) to f32 tensors of the
parameters' shapes, ``aux`` holds the 0-dim ``loss``, ``pg_loss``,
``v_loss`` and ``entropy``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch.ops import _build

bf16 = torch.bfloat16
f32 = torch.float32

_HEAD_STRIDE = 8  # f32 words a row of the kernel's head cotangents
_TARGET_BLOCKS = 2048  # split-K blocks a weight gradient aims for
_HEAD_SPLITS = 512  # row splits x column blocks of the head partials
_GEMM_TILE, _GEMM_K = 64, 32  # csrc/fused_update.cu CW_GM/CW_GN, CW_GK


class Weights(NamedTuple):
    """The kernel's operands: bf16 matrices, f32 biases, value head as row 6."""

    w1: torch.Tensor  # bf16[H, F]
    b1: torch.Tensor  # f32[H]
    w2: torch.Tensor  # bf16[H, H]
    b2: torch.Tensor  # f32[H]
    wlv: torch.Tensor  # bf16[7, H]
    blv: torch.Tensor  # f32[7]


def weights(params) -> Weights:
    c = lambda t: t.detach().contiguous()
    return Weights(
        w1=c(params.w1.to(bf16)), b1=c(params.b1.to(f32)),
        w2=c(params.w2.to(bf16)), b2=c(params.b2.to(f32)),
        wlv=c(torch.cat([params.wl.to(bf16), params.wv.to(bf16)])),
        blv=c(torch.cat([params.bl.to(f32), params.bv.to(f32)])),
    )


def normalize_adv(adv: torch.Tensor) -> torch.Tensor:
    """(adv - mean) / (std + 1e-8), std over the minibatch with ddof 0 as jnp.std."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


# --------------------------------------------------------------------------
# The plain version: the CPU path, and what the kernel is held against.
# --------------------------------------------------------------------------


def ppo_grads_plain(fppo, w: Weights, x, action, old_lp, old_v, adv_n, ret):
    """Plain version of the kernel: (grads, pg_row, v_row, ent_row).

    The kernel's algebra in torch, at its rounding points: bf16 operands
    multiplied in f32 (exact products, f32 sums).
    """
    ppo_grads_plain.calls += 1
    n = x.shape[0]
    A = w.wlv.shape[0] - 1
    mm = lambda a, b: a.to(bf16).to(f32) @ b.to(bf16).to(f32)
    xf = x.to(bf16).to(f32)
    h1 = torch.relu(xf @ w.w1.to(f32).T + w.b1).to(bf16)
    h2 = torch.relu(mm(h1, w.w2.T) + w.b2).to(bf16)
    heads = mm(h2, w.wlv.T) + w.blv  # f32[N, 7]
    logits, value = heads[:, :A], heads[:, A]

    logsm = torch.log_softmax(logits, dim=1)
    p = torch.exp(logsm)
    onehot = action.to(torch.int64)[:, None] == torch.arange(A, device=x.device)[None, :]
    log_prob = torch.where(onehot, logsm, 0.0).sum(dim=1)
    ratio = torch.exp(log_prob - old_lp)
    clipped = torch.clamp(ratio, 1 - fppo.clip_eps, 1 + fppo.clip_eps)
    un, cl = ratio * adv_n, clipped * adv_n
    pg_row = -torch.minimum(un, cl)
    e = value - ret
    ec = old_v + torch.clamp(value - old_v, -fppo.clip_eps, fppo.clip_eps) - ret
    v_row = 0.5 * torch.maximum(e * e, ec * ec)
    ent_row = -(p * logsm).sum(dim=1)

    inv_n = torch.tensor(1.0 / n, dtype=f32, device=x.device)
    dlogp = torch.where(un <= cl, -adv_n * ratio, 0.0) * inv_n
    dent = -fppo.ent_coef * inv_n
    dlogits = dlogp[:, None] * (onehot.to(f32) - p) + dent * (-p * (logsm + ent_row[:, None]))
    in_band = (value - old_v).abs() < fppo.clip_eps
    dvalue = fppo.vf_coef * inv_n * torch.where(e * e >= ec * ec, e, torch.where(in_band, ec, 0.0))
    dheads = torch.cat([dlogits, dvalue[:, None]], dim=1)  # f32[N, 7]
    dheads_b = dheads.to(bf16).to(f32)
    dz2 = torch.where(h2 > 0, (dheads_b @ w.wlv.to(f32)).to(bf16), 0)
    dz1 = torch.where(h1 > 0, mm(dz2, w.w2).to(bf16), 0)

    gwlv = dheads_b.T @ h2.to(f32)
    gblv = dheads.sum(dim=0)
    grads = {
        "w1": dz1.to(f32).T @ xf, "b1": dz1.to(f32).sum(dim=0),
        "w2": dz2.to(f32).T @ h1.to(f32), "b2": dz2.to(f32).sum(dim=0),
        "wl": gwlv[:A], "bl": gblv[:A], "wv": gwlv[A:], "bv": gblv[A:],
    }
    return grads, pg_row, v_row, ent_row


ppo_grads_plain.calls = 0


# --------------------------------------------------------------------------
# The kernel.
# --------------------------------------------------------------------------


def _splits(rows: int, tiles: int) -> int:
    """Row splits of a weight gradient of ``tiles`` output tiles."""
    return max(1, min(math.ceil(rows / _GEMM_K), _TARGET_BLOCKS // tiles))


def _pointers(tensors):
    """Host array of device pointers; None passes a null pointer."""
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype}{list(shape)}, got {t.dtype}{list(t.shape)}")
    if not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: must be contiguous on {device}")


def ppo_grads_kernel(fppo, w: Weights, x, ids, blk: int, action, old_lp, old_v,
                     adv_n, ret):
    """Launch ``cw_ppo_grads``: (grads, pg_row, v_row, ent_row).

    ``x`` bf16[rows, F]; minibatch row ``r`` reads ``x[r]``, or with ``ids``
    (int32[n / blk]) ``x[ids[r // blk] * blk + r % blk]``.
    """
    dev = x.device
    n = action.shape[0]
    H, F = w.w1.shape
    A = w.wlv.shape[0] - 1
    if A != 6:
        raise ValueError(f"the kernel takes 6 actions, not {A}")
    _check("x", x, bf16, (x.shape[0], F), dev)
    if ids is None:
        if x.shape[0] != n:
            raise ValueError(f"x has {x.shape[0]} rows for {n} minibatch rows")
    else:
        _check("ids", ids, torch.int32, (n // blk,), dev)
        if n % blk or x.shape[0] % blk:
            raise ValueError(f"rows ({n}, {x.shape[0]}) must be whole blocks of {blk}")
    _check("action", action, torch.int32, (n,), dev)
    for name, t in zip(("old_lp", "old_v", "adv_n", "ret"), (old_lp, old_v, adv_n, ret)):
        _check(name, t, f32, (n,), dev)
    wtypes = (bf16, f32, bf16, f32, bf16, f32)
    for name, t, dtype, shape in zip(Weights._fields, w, wtypes,
                                     ((H, F), (H,), (H, H), (H,), (A + 1, H), (A + 1,))):
        _check(name, t, dtype, shape, dev)

    ht, ft = -(-H // _GEMM_TILE), -(-F // _GEMM_TILE)
    s_w1, s_w2 = _splits(n, ht * ft), _splits(n, ht * ht)
    s_head = max(1, min(n, _HEAD_SPLITS // -(-H // 256)))
    empty = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)
    work = [empty(n, H, dtype=bf16) for _ in range(4)] + [
        empty(n, _HEAD_STRIDE), empty(s_w1, H, F), empty(s_w2, H, H),
        empty(s_head, 9 * H + _HEAD_STRIDE)]
    gw1, gw2, ghead = empty(H, F), empty(H, H), empty(9 * H + _HEAD_STRIDE)
    rows = [empty(n) for _ in range(3)]
    ins = [x, ids, action, old_lp, old_v, adv_n, ret, *w]  # a null ids: no block map
    code = _build.load().cw_ppo_grads(
        _pointers(ins), _pointers(work), _pointers([gw1, gw2, ghead, *rows]),
        n, F, H, blk, s_w1, s_w2, s_head,
        fppo.clip_eps, fppo.vf_coef, fppo.ent_coef,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("cw_ppo_grads", code)
    gwlv = ghead[: 7 * H].view(7, H)
    gblv = ghead[7 * H: 7 * H + 7]
    grads = {
        "w1": gw1, "b1": ghead[7 * H + _HEAD_STRIDE: 8 * H + _HEAD_STRIDE],
        "w2": gw2, "b2": ghead[8 * H + _HEAD_STRIDE:],
        "wl": gwlv[:A], "bl": gblv[:A], "wv": gwlv[A:], "bv": gblv[A:],
    }
    return (grads, *rows)


# --------------------------------------------------------------------------
# Entry points, with the JAX signatures.
# --------------------------------------------------------------------------


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def _finish(fppo, n: int, grads, pg_row, v_row, ent_row):
    pg, v_loss, entropy = pg_row.sum() / n, v_row.sum() / n, ent_row.sum() / n
    loss = pg + fppo.vf_coef * v_loss - fppo.ent_coef * entropy
    return grads, {"loss": loss, "pg_loss": pg, "v_loss": v_loss, "entropy": entropy}


def _rest(action, old_lp, old_v, adv, ret):
    c = lambda t, dtype: t.to(dtype).contiguous()
    return (c(action, torch.int32), c(old_lp, f32), c(old_v, f32),
            c(normalize_adv(adv.to(f32)), f32), c(ret, f32))


def fused_minibatch_grads(fppo, params, batch):
    """Gradient of ``_loss_bm`` over one minibatch; (grads, aux).

    ``batch`` = (feat bf16[N, F], action int[N], old_log_prob f32[N],
    old_value f32[N], adv f32[N] (unnormalized), ret f32[N]). Any N.
    """
    feat, *vecs = batch
    n = feat.shape[0]
    w = weights(params)
    rest = _rest(*vecs)
    if not _on_cuda(feat):
        return _finish(fppo, n, *ppo_grads_plain(fppo, w, feat, *rest))
    out = ppo_grads_kernel(fppo, w, feat.to(bf16).contiguous(), None, 1, *rest)
    fused_minibatch_grads.launches += 1
    return _finish(fppo, n, *out)


def fused_minibatch_grads_indexed(fppo, params, featb, ids, rest):
    """``fused_minibatch_grads`` over the feature blocks ``featb[ids]``.

    featb: bf16[NB, BLK, F], the rollout's features block by block; ids:
    int[nbm], this minibatch's blocks in order; rest: (action, old_log_prob,
    old_value, adv unnormalized, ret), each [nbm * BLK], already in minibatch
    order. Returns what ``fused_minibatch_grads(fppo, params,
    (featb[ids].reshape(-1, F),) + rest)`` returns: the kernel reads block
    ``ids[i]`` in place of gathering it, and does the same arithmetic.
    """
    NB, BLK, F = featb.shape
    n = ids.shape[0] * BLK
    w = weights(params)
    rest = _rest(*rest)
    if not _on_cuda(featb):
        x = featb[ids.to(torch.int64)].reshape(n, F)
        return _finish(fppo, n, *ppo_grads_plain(fppo, w, x, *rest))
    x = featb.to(bf16).contiguous().view(NB * BLK, F)
    out = ppo_grads_kernel(fppo, w, x, ids.to(torch.int32).contiguous(), BLK, *rest)
    fused_minibatch_grads_indexed.launches += 1
    return _finish(fppo, n, *out)


fused_minibatch_grads.launches = 0
fused_minibatch_grads_indexed.launches = 0
