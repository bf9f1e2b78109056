"""Fast-PPO full-loop throughput on the card.

Counterpart of the JAX package's ``tools/fast_ppo_bench.py``: 21x21 stacked,
the default ``FastPPOConfig`` or its ``throughput()`` preset. Times
``N_UPDATES`` updates of ``train_many_fast`` a run with CUDA events, 3 runs
after a warm-up run, and prints ms/update and env-steps/s (median and
spread), each stage's ms (pool, collect, GAE, update phase; median of 5),
the peak device memory of one update, and one JSON line.

    python -m gym_craftingworld_tpu_torch.tools.fast_ppo_bench [ENVS] [N_UPDATES] [preset|default]
    python -m gym_craftingworld_tpu_torch.tools.fast_ppo_bench 256 2 --device cpu   # a small CPU run
"""

from __future__ import annotations

import argparse
import json

import torch

import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch.ops.threefry import fold_in, prng_key
from gym_craftingworld_tpu_torch.train import fast_ppo as fp
from gym_craftingworld_tpu_torch.utils.profiling import card_identity, timed_runs


def arguments(description: str, updates: int, argv=None):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("envs", nargs="?", type=int, default=16384)
    p.add_argument("updates", nargs="?", type=int, default=updates, help="updates a timed run")
    p.add_argument("preset", nargs="?", default="default", choices=["default", "preset"],
                   help="'preset' takes the config's throughput() preset")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def loop_rates(run, envs: int, T: int, n: int, device) -> dict:
    """``run()`` (``n`` updates) timed 3 times after one warm-up: ms/update and
    env-steps/s at the median and at both ends of the spread."""
    t = timed_runs(run, device, reps=3, warmup=1)
    steps = envs * T * n
    return {"ms_per_update": t["median_ms"] / n,
            "ms_per_update_spread": [t["min_ms"] / n, t["max_ms"] / n],
            "env_steps_per_s": steps / (t["median_ms"] / 1e3),
            "env_steps_per_s_spread": [steps / (t["max_ms"] / 1e3), steps / (t["min_ms"] / 1e3)]}


def peak_memory_gib(step, device) -> float | None:
    """Peak device memory of one ``step()`` (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    step()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) / 2**30


def report(tool: str, card: str, setting: dict, rates: dict, stages: dict, peak) -> dict:
    """Print the rates, stages and peak memory, each line with the card, then one JSON line."""
    tag = f"[{card}]"
    print(f"{tag} {tool} " + " ".join(f"{k}={v}" for k, v in setting.items()))
    print(f"{tag} ms/update {rates['ms_per_update']:.2f} (spread "
          f"{rates['ms_per_update_spread'][0]:.2f}-{rates['ms_per_update_spread'][1]:.2f}); "
          f"full-loop env-steps/s {rates['env_steps_per_s']:.4e} (spread "
          f"{rates['env_steps_per_s_spread'][0]:.4e}-{rates['env_steps_per_s_spread'][1]:.4e}); "
          f"median of 3 runs, " + ("CUDA events" if setting["device"] == "cuda" else "host clock"))
    print(f"{tag} stages (ms, median of 5): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + (f"; peak device memory of one update {peak:.3f} GiB" if peak is not None else ""))
    line = {"tool": tool, "card": card, **setting, **rates, "stages_ms": stages,
            "peak_memory_gib": peak}
    print(json.dumps(line))
    return line


def main(argv=None) -> dict:
    args = arguments(__doc__.split("\n")[0], 64, argv)
    dev = torch.device(args.device)
    card = card_identity(dev)
    cfg = cw.ray_config()
    fppo = fp.FastPPOConfig.throughput() if args.preset == "preset" else fp.FastPPOConfig()
    B, T, N = args.envs, fppo.rollout_steps, args.updates
    key = lambda seed: prng_key(seed, device=dev)
    # JAX's tool: PRNGKey(0) for the parameters and the training, fold_in(., 1) for the envs
    state = {"ts": fp.init_fast_train_state(key(0), cfg, fppo),
             "env": fp.fresh_packed_batch(cfg, fold_in(key(0), 1), B), "key": key(0)}

    def run(n):
        state["ts"], state["env"], state["key"], _ = fp.train_many_fast(
            cfg, fppo, state["ts"], state["env"], n, state["key"])

    rates = loop_rates(lambda: run(N), B, T, N, dev)
    ts, env0 = state["ts"], state["env"]
    k_pool = key(2)
    pool = fp._fresh_pool(cfg, k_pool, 2 * B)
    u = fp.gumbel_uniforms(key(3), T, B)
    with torch.no_grad():
        _, traj = fp._collect(cfg, fppo, ts.params, env0, pool, u)
        _, last_value = fp.apply_policy(ts.params, fp.features(cfg, env0))
        adv, ret = fp._gae(fppo, traj, last_value)
        NB = T * B // fp.shuffle_block(T, B, fppo.num_minibatches)
        perms = fp.epoch_perms(key(4), fppo.update_epochs, NB)
        stages = {
            "pool": lambda: fp._fresh_pool(cfg, k_pool, 2 * B),
            "collect": lambda: fp._collect(cfg, fppo, ts.params, env0, pool, u),
            "gae": lambda: fp._gae(fppo, traj, last_value),
            "update_phase": lambda: fp._update_phase(fppo, ts, traj, adv, ret, perms),
        }
        stages = {k: timed_runs(fn, dev)["median_ms"] for k, fn in stages.items()}
    del traj, adv, ret, pool, u
    peak = peak_memory_gib(lambda: run(1), dev)
    setting = {"envs": B, "rollout_steps": T, "hidden": fppo.hidden,
               "epochs": fppo.update_epochs, "minibatches": fppo.num_minibatches,
               "preset": args.preset, "updates_per_run": N, "device": args.device}
    return report("fast_ppo_bench", card, setting, rates, stages, peak)


if __name__ == "__main__":
    main()
