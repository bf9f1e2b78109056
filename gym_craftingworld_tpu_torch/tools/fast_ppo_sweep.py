"""Throughput and learning sweep over fast-PPO update settings.

Counterpart of the JAX package's ``tools/fast_ppo_sweep.py``. For each
candidate setting of (epochs, minibatches, hidden):

* **throughput**: full-loop env-steps/s of ``train_many_fast`` at 16,384
  envs on 21x21 stacked, 64 updates a run after a warm-up, timed with CUDA
  events (median and spread of 3 runs);
* **learning**: success-per-step curves on single-task 8x8 at 4,096 envs
  for seeds 0 and 1, over 192 updates or, for a setting faster than the
  default, over the updates it runs in the default's wall clock.

The JSON (``--out``) has the JAX record's schema (``config``, and
``candidates`` with the same keys each) and a ``reference`` block that puts
the JAX record's tails (``docs/fast_ppo_sweep.json``, read as data) beside
the port's. The port's random streams are not JAX's, so the two are compared
in distribution.

    python -m gym_craftingworld_tpu_torch.tools.fast_ppo_sweep          # on the card
    python -m gym_craftingworld_tpu_torch.tools.fast_ppo_sweep --device cpu \\
        --candidates 2ep_8mb --seeds 0 --updates 2 --envs 64 --hidden 64 \\
        --bench-envs 64 --bench-updates 2                               # a small CPU run

``learning_curve`` is the function ``chip_smoke.py`` phase 22 runs.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch.ops.threefry import fold_in, prng_key
from gym_craftingworld_tpu_torch.train import fast_ppo as fp
from gym_craftingworld_tpu_torch.utils.profiling import card_identity, timed_runs

REPO = Path(__file__).resolve().parents[2]
RUNS = REPO / "runs" / "torch"
RECORD = REPO / "docs" / "fast_ppo_sweep.json"

CANDIDATES = {
    "2ep_8mb (default)": dict(update_epochs=2, num_minibatches=8),
    "1ep_8mb": dict(update_epochs=1, num_minibatches=8),
    "1ep_4mb": dict(update_epochs=1, num_minibatches=4),
    "1ep_8mb_h384": dict(update_epochs=1, num_minibatches=8, hidden=384),
    "1ep_8mb_h256": dict(update_epochs=1, num_minibatches=8, hidden=256),
}

B_BENCH = 16384
BENCH_UPDATES = 64
BENCH_WARMUP = 8  # updates before the timed runs (builds the kernels, warms the allocator)
B_LEARN = 4096
LEARN_UPDATES = 192
SEEDS = (0, 1)
WINDOW = 32  # updates in a window of the curve; the tail is the last window


def learning_config():
    """Single-task 8x8, the setting the JAX record's curves were taken on."""
    return cw.flat_config(stacking=False)


def learning_curve(fppo: fp.FastPPOConfig, seed: int, n_updates: int = LEARN_UPDATES,
                   envs: int = B_LEARN, device="cuda", fused_update: bool | None = None) -> list:
    """Success per step of each of ``n_updates`` updates of ``train_many_fast``
    on single-task 8x8 at ``envs`` envs.

    Parameters draw from JAX's ``PRNGKey(100 + seed)``, the first envs from
    ``PRNGKey(200 + seed)`` and training from ``PRNGKey(300 + seed)``, as the
    JAX tool's do (the pool kernel's Philox stream is the port's own).
    ``fused_update`` as ``train_step_fast`` takes it:
    None or True through the gradient kernel, False through autograd.
    """
    cfg = learning_config()
    key = lambda s: prng_key(s, device=device)
    ts = fp.init_fast_train_state(key(100 + seed), cfg, fppo)
    env = fp.fresh_packed_batch(cfg, key(200 + seed), envs)
    _, _, _, m = fp.train_many_fast(cfg, fppo, ts, env, n_updates, key(300 + seed),
                                    fused_update=fused_update)
    return [float(x) for x in m["success_per_step"].tolist()]


def tail_mean(curve, n: int, width: int = WINDOW) -> float:
    """Mean of the ``width`` updates before update ``n`` (the whole curve's
    first ``n`` when it is shorter than ``width``)."""
    return float(np.mean(curve[max(0, n - width):n]))


def window_means(curve, n: int, width: int = WINDOW) -> list:
    """Means of the consecutive ``width``-update windows of the first ``n`` updates."""
    return [float(np.mean(curve[i:i + width])) for i in range(0, n - width + 1, width)]


def half_tail_update(curve, n: int, width: int = WINDOW) -> int | None:
    """The first update whose success per step reaches half the tail's mean."""
    tail = tail_mean(curve, n, width)
    hits = [i for i, x in enumerate(curve[:n]) if x >= tail / 2]
    return hits[0] if hits else None


def jax_reference() -> dict:
    """The JAX record's per-candidate numbers at its matched env-step budget
    (192 updates): tails, window means and the update that first reaches
    half the tail, by seed, and the seed means of the tail and of the second
    window (updates 32-63)."""
    doc = json.loads(RECORD.read_text())
    n = doc["config"]["learning"]["updates"]
    out = {}
    for name, c in doc["candidates"].items():
        curves = c["curves_success_per_step"]
        r = {"tail": {s: tail_mean(v, n) for s, v in curves.items()},
             "windows": {s: window_means(v, n) for s, v in curves.items()},
             "half_tail_update": {s: half_tail_update(v, n) for s, v in curves.items()},
             "throughput_env_steps_per_s": c["throughput_env_steps_per_s"]}
        r["tail_seed_mean"] = float(np.mean(list(r["tail"].values())))
        r["early_seed_mean"] = float(np.mean([w[1] for w in r["windows"].values()]))
        out[name] = r
    return out


def throughput(fppo: fp.FastPPOConfig, envs: int = B_BENCH, updates: int = BENCH_UPDATES,
               device="cuda", warmup: int = BENCH_WARMUP) -> dict:
    """Full-loop rate of ``train_many_fast`` at ``envs`` envs on 21x21
    stacked: ``updates`` updates a run, timed (CUDA events) 3 times after
    ``warmup`` updates. The runs carry the training on."""
    cfg = cw.ray_config()
    key = lambda s: prng_key(s, device=device)
    # the JAX tool's keys: PRNGKey(0), fold_in(PRNGKey(0), 1) and PRNGKey(7)
    state = {"ts": fp.init_fast_train_state(key(0), cfg, fppo),
             "env": fp.fresh_packed_batch(cfg, fold_in(key(0), 1), envs), "key": key(7)}

    def run(n):
        state["ts"], state["env"], state["key"], _ = fp.train_many_fast(
            cfg, fppo, state["ts"], state["env"], n, state["key"])

    run(warmup)
    t = timed_runs(lambda: run(updates), device, reps=3, warmup=0)
    steps = envs * fppo.rollout_steps * updates
    return {"env_steps_per_s": steps / (t["median_ms"] / 1e3),
            "env_steps_per_s_spread": [steps / (t["max_ms"] / 1e3), steps / (t["min_ms"] / 1e3)],
            "ms_per_update": t["median_ms"] / updates, "runs_ms": t["runs_ms"]}


def write_json(doc: dict, out) -> Path:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2) + "\n")
    return out


def pick(names) -> dict:
    """The candidates named (by the name's first word, e.g. ``2ep_8mb``), in
    ``CANDIDATES`` order; all of them for None."""
    if names is None:
        return dict(CANDIDATES)
    short = {k.split()[0]: k for k in CANDIDATES}
    unknown = [n for n in names if n not in short]
    if unknown:
        raise SystemExit(f"unknown candidates {unknown}; choose from {sorted(short)}")
    return {k: CANDIDATES[k] for k in CANDIDATES if k.split()[0] in names}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--candidates", nargs="+", help="candidate names (default: all five)")
    p.add_argument("--seeds", nargs="+", type=int, default=list(SEEDS))
    p.add_argument("--updates", type=int, default=LEARN_UPDATES,
                   help="learning updates at the default's wall clock")
    p.add_argument("--envs", type=int, default=B_LEARN, help="envs of the learning runs")
    p.add_argument("--hidden", type=int, help="hidden width of every candidate")
    p.add_argument("--bench-envs", type=int, default=B_BENCH)
    p.add_argument("--bench-updates", type=int, default=BENCH_UPDATES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=str(RUNS / "fast_ppo_sweep.json"))
    args = p.parse_args(argv)

    card = card_identity(args.device)
    tag = f"[{card}]"
    n = args.updates
    reference = jax_reference()
    results, ref_rows, base_rate = {}, {}, None
    for name, kw in pick(args.candidates).items():
        if args.hidden is not None:
            kw = {**kw, "hidden": args.hidden}
        fppo = fp.FastPPOConfig(**kw)
        tp = throughput(fppo, args.bench_envs, args.bench_updates, args.device,
                        warmup=min(BENCH_WARMUP, args.bench_updates))
        rate = tp["env_steps_per_s"]
        base_rate = base_rate or rate  # the first candidate is the baseline
        print(f"{tag} {name}: {rate:.4e} env-steps/s full loop at {args.bench_envs} envs "
              f"(median of 3; spread {tp['env_steps_per_s_spread'][0]:.4e}-"
              f"{tp['env_steps_per_s_spread'][1]:.4e}), {tp['ms_per_update']:.2f} ms/update",
              flush=True)
        # the wall-clock-matched budget: a setting k times faster than the
        # baseline gets k times its updates in the same wall time
        n_wall = max(n, int(round(n * rate / base_rate)))
        curves = {}
        for seed in args.seeds:
            c = learning_curve(fppo, seed, n_wall, args.envs, args.device)
            curves[f"seed{seed}"] = c
            print(f"{tag}   learn seed{seed}: success/step last {min(WINDOW, n)} "
                  f"{tail_mean(c, n):.6f} (matched env-steps) / {tail_mean(c, n_wall):.6f} "
                  f"(matched wall clock, {n_wall} updates)", flush=True)
        results[name] = {
            "throughput_env_steps_per_s": rate,
            "throughput_spread_env_steps_per_s": tp["env_steps_per_s_spread"],
            "ms_per_update": tp["ms_per_update"],
            "wall_clock_updates": n_wall,
            "curves_success_per_step": curves,
            "tail_mean_success_per_step": {s: tail_mean(v, n) for s, v in curves.items()},
            "tail_mean_success_per_step_wall_clock": {s: tail_mean(v, n_wall)
                                                      for s, v in curves.items()},
            "window_means": {s: window_means(v, n) for s, v in curves.items()},
            "half_tail_update": {s: half_tail_update(v, n) for s, v in curves.items()},
        }
        if name in reference:
            jax = reference[name]
            port_tail = float(np.mean(list(results[name]["tail_mean_success_per_step"].values())))
            ref_rows[name] = {
                "jax_tail": jax["tail"], "port_tail": results[name]["tail_mean_success_per_step"],
                "jax_tail_seed_mean": jax["tail_seed_mean"], "port_tail_seed_mean": port_tail,
                "tail_ratio": port_tail / jax["tail_seed_mean"],
                "jax_half_tail_update": jax["half_tail_update"],
                "port_half_tail_update": results[name]["half_tail_update"],
                "jax_throughput_env_steps_per_s": jax["throughput_env_steps_per_s"],
            }
            print(f"{tag}   {name} against the JAX record: tail {port_tail:.6f} vs "
                  f"{jax['tail_seed_mean']:.6f} (ratio {ref_rows[name]['tail_ratio']:.4f})",
                  flush=True)
    doc = {
        "card": card,
        "config": {
            "bench": {"envs": args.bench_envs, "grid": "21x21 stacked",
                      "timing": f"CUDA events, {args.bench_updates} updates a run after "
                                f"{min(BENCH_WARMUP, args.bench_updates)} warm-up updates, "
                                f"median of 3"},
            "learning": {"envs": args.envs, "grid": "8x8 single-task", "updates": n,
                         "seeds": list(args.seeds), "device": args.device},
        },
        "candidates": results,
        "reference": {"source": "docs/fast_ppo_sweep.json (the JAX package, on a TPU)",
                      "updates": LEARN_UPDATES, "by_candidate": ref_rows},
    }
    out = write_json(doc, args.out)
    print(f"{tag} wrote {out}")
    return doc


if __name__ == "__main__":
    main()
