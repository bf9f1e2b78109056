"""The gradient kernel end to end: the same training through it and through autograd.

Counterpart of the JAX package's ``tools/fused_update_e2e.py``. Per-minibatch
gradient parity does not rule out drift that compounds over hundreds of
updates, so this trains the default ``FastPPOConfig`` on single-task 8x8 at
4,096 envs for 384 updates twice from each seed: through the indexed
gradient kernel (``fused_update=True``) and through autograd of ``_loss_bm``
(``fused_update=False``). Each update draws the pool of 2B worlds, collects,
runs GAE and the update phase (``train_step_fast``); both paths take the
same draws. It records both curves a seed, their tail means over the last 64
updates, and the cross-path gap against the cross-seed noise by the JAX
tool's rule (``cross_path_summary``), with the JAX record
(``docs/fused_update_e2e.json``, read as data) beside them.

    python -m gym_craftingworld_tpu_torch.tools.fused_update_e2e          # on the card
    python -m gym_craftingworld_tpu_torch.tools.fused_update_e2e --device cpu \\
        --envs 64 --updates 2 --hidden 64                                 # a small CPU run
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from gym_craftingworld_tpu_torch.tools.fast_ppo_sweep import (REPO, RUNS, learning_curve,
                                                               tail_mean, write_json)
from gym_craftingworld_tpu_torch.train import fast_ppo as fp
from gym_craftingworld_tpu_torch.utils.profiling import card_identity

RECORD = REPO / "docs" / "fused_update_e2e.json"
B = 4096
UPDATES = 384
SEEDS = (0, 1)
TAIL = 64
PATHS = {"fused_kernel": True, "autodiff": False}


def cross_path_summary(tails: dict) -> dict:
    """The JAX tool's rule on ``tails`` ({path: {seed: tail mean}}, two paths):
    the cross-seed noise is the largest spread of one path's tails over the
    seeds, the cross-path gap the largest difference of the two paths' tails
    at one seed, and the gap is within noise when it is at most twice the
    noise or a tenth of the largest tail."""
    a, b = tails.values()
    noise = max(max(t.values()) - min(t.values()) for t in (a, b))
    gap = max(abs(a[s] - b[s]) for s in a)
    top = max(v for t in (a, b) for v in t.values())
    return {"cross_seed_noise": noise, "cross_path_gap": gap,
            "within_noise": bool(gap <= max(2 * noise, 0.1 * top))}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--envs", type=int, default=B)
    p.add_argument("--updates", type=int, default=UPDATES)
    p.add_argument("--hidden", type=int, default=fp.FastPPOConfig().hidden)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=str(RUNS / "fused_update_e2e.json"))
    args = p.parse_args(argv)

    card = card_identity(args.device)
    tag = f"[{card}]"
    fppo = fp.FastPPOConfig(hidden=args.hidden)
    n, tail = args.updates, min(TAIL, args.updates)
    curves, seconds = {}, {}
    for path, fused in PATHS.items():
        curves[path] = {}
        for seed in SEEDS:
            t0 = time.perf_counter()
            c = learning_curve(fppo, seed, n, args.envs, args.device, fused_update=fused)
            seconds[f"{path} seed{seed}"] = time.perf_counter() - t0
            curves[path][f"seed{seed}"] = c
            print(f"{tag} {path} seed{seed}: tail success/step {tail_mean(c, n, tail):.6f} "
                  f"({seconds[f'{path} seed{seed}']:.1f} s, host clock)", flush=True)
    tails = {path: {s: tail_mean(v, n, tail) for s, v in by.items()}
             for path, by in curves.items()}
    summary = cross_path_summary(tails)
    jax = json.loads(RECORD.read_text())
    doc = {
        "card": card,
        "config": {"envs": args.envs, "updates": n, "grid": "8x8 single-task",
                   "seeds": list(SEEDS), "tail": tail, "hidden": args.hidden,
                   "device": args.device},
        "curves_success_per_step": curves,
        "tail_mean": tails,
        **summary,
        "seconds": seconds,
        "reference": {
            "source": "docs/fused_update_e2e.json (the JAX package, on a TPU)",
            "tail_mean": jax["tail_mean"],
            **{k: jax[k] for k in ("cross_seed_noise", "cross_path_gap", "within_noise")},
            "tail_ratio": {path: float(np.mean(list(tails[path].values()))
                                       / np.mean(list(jax["tail_mean"][path].values())))
                           for path in tails},
        },
    }
    out = write_json(doc, args.out)
    print(f"{tag} gap {summary['cross_path_gap']:.6f} vs noise {summary['cross_seed_noise']:.6f} "
          f"(within_noise={summary['within_noise']}); JAX record: gap "
          f"{jax['cross_path_gap']:.6f}, noise {jax['cross_seed_noise']:.6f}; wrote {out}")
    return doc


if __name__ == "__main__":
    main()
