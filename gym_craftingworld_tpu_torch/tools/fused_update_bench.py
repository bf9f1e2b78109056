"""The indexed PPO-gradient kernel alone, at one minibatch's shape.

Counterpart of the JAX package's ``tools/fused_update_bench.py``. Times
``fused_minibatch_grads_indexed`` over ``N_ROWS`` rows (default 131,072, a
minibatch of the default fast-PPO update at 16,384 envs) at ``HIDDEN``
(default 512) and F = 67 features: CUDA events around a call (median and
spread of 20) and its device time by ``torch.profiler``, summed over its
sub-kernels. Reports TFLOP/s of the useful work, ``6 N (F H + H H + 7 H)``
FLOP (forward, backward and weight gradients), as a share of the H100's
989 TFLOP/s dense bf16 peak, beside five bf16 ``torch.matmul`` calls of the
gradient's product shapes (cuBLAS; the yardstick, used nowhere in the port).
Prints one JSON line.

The minibatch is the JAX tool's draw (``ops/fused_update.random_minibatch``
of ``split(PRNGKey(1), 6)``, key data on the device), its features drawn
for the eight minibatches' blocks the indexed kernel picks from; the pick
is ``permutation(kb[5], blocks)``, the key the JAX tool splits off and
leaves unused. The yardstick's operands are bf16 normals of
``split(PRNGKey(2), 6)``.

The JAX tool's sweep over row tiles (``TILES``) is gone: it chose Mosaic's
row tile, which has no counterpart here. The CUDA kernel's tiles are
compile-time constants (``CW_BN``, ``csrc/wgmma_gemm.cuh``).

    python -m gym_craftingworld_tpu_torch.tools.fused_update_bench [N_ROWS] [HIDDEN]
    python -m gym_craftingworld_tpu_torch.tools.fused_update_bench 1024 64 --device cpu
"""

from __future__ import annotations

import argparse
import json

import torch

import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch.ops import fused_update as fu
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import fast_ppo as fp
from gym_craftingworld_tpu_torch.utils.profiling import card_identity, device_time_ms, timed_runs

PEAK_BF16 = 989e12  # H100 SXM, dense bf16 FLOP/s at 700 W
MINIBATCHES = 8  # the default update's minibatches: featb holds 8 minibatches of blocks


def five_matmuls(key, n, F, H):
    """The gradient's five products as five bf16 ``torch.matmul`` calls, on
    bf16 normals of ``split(key, 6)``."""
    shapes = ((n, F), (n, H), (n, H), (n, H), (H, F), (H, H))
    x, h1, dz1, dz2, w1, w2 = (kd.normal_bf16(k, s) for k, s in zip(kd.split_keys(key, 6), shapes))

    def run():
        torch.matmul(x, w1.T)
        torch.matmul(h1, w2.T)
        torch.matmul(dz2, w2)
        torch.matmul(dz2.T, h1)
        torch.matmul(dz1.T, x)
    return run


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("rows", nargs="?", type=int, default=131072)
    p.add_argument("hidden", nargs="?", type=int, default=512)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    card = card_identity(dev)
    tag = f"[{card}]"
    cfg = cw.ray_config()
    fppo = fp.FastPPOConfig(hidden=args.hidden)
    N, H, F = args.rows, args.hidden, fp.feature_rows(cfg)
    params = fp.init_params(prng_key(0, device=dev), cfg, fppo)
    # the update phase's layout: blocks of BLK rows, this minibatch's blocks
    # picked out of MINIBATCHES minibatches' worth by a permutation
    BLK = fp.shuffle_block(1, N, 1)
    NB = MINIBATCHES * N // BLK
    kb, (x, *rest) = fu.random_minibatch(prng_key(1, device=dev), N, F, num=6,
                                         feature_rows=NB * BLK)
    featb = x.reshape(NB, BLK, F)
    ids = kd.permutation(kb[5], NB)[: N // BLK]
    call = lambda: fu.fused_minibatch_grads_indexed(fppo, params, featb, ids, rest)
    t = timed_runs(call, dev, reps=20)
    device = device_time_ms(call) if dev.type == "cuda" else None
    lib = timed_runs(five_matmuls(prng_key(2, device=dev), N, F, H), dev, reps=20)
    flop = 6 * N * (F * H + H * H + 7 * H)
    rate = lambda ms: flop / (ms / 1e3)
    line = {"tool": "fused_update_bench", "card": card, "rows": N, "hidden": H, "features": F,
            "block_rows": BLK, "device": args.device,
            "ms": t["median_ms"], "ms_spread": [t["min_ms"], t["max_ms"]],
            "device_ms": device["ms"] if device else None,
            "device_ms_by_kernel": device["kernels"] if device else None,
            "flop": flop, "tflops": rate(t["median_ms"]) / 1e12,
            "share_of_peak": rate(t["median_ms"]) / PEAK_BF16 if device else None,
            "device_tflops": rate(device["ms"]) / 1e12 if device else None,
            "device_share_of_peak": rate(device["ms"]) / PEAK_BF16 if device else None,
            "five_matmuls_ms": lib["median_ms"]}
    print(f"{tag} fused_minibatch_grads_indexed N={N} F={F} H={H} (blocks of {BLK}): "
          f"{t['median_ms']:.4f} ms ({'CUDA events' if device else 'host clock'}, median of 20; "
          f"spread {t['min_ms']:.4f}-{t['max_ms']:.4f}), {line['tflops']:.2f} TFLOP/s"
          + (f", {100 * line['share_of_peak']:.2f}% of 989 TFLOP/s bf16" if device else "")
          + "; device "
          + (f"{device['ms']:.4f} ms ({100 * line['device_share_of_peak']:.2f}%, "
             f"{device['launches']:.0f} launches a call, {device['lost']} without a record)"
             if device else "not measured")
          + f"; five bf16 torch.matmul {lib['median_ms']:.4f} ms")
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
