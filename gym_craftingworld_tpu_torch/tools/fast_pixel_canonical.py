"""Pixel-policy PPO at canonical scale: 21x21 grid, 16,384 envs.

Counterpart of the JAX package's ``tools/fast_pixel_canonical.py``. Trains
``train/fast_pixel_ppo``'s conv policy, which reads the re-rendered
(B, 21, 21, 12) one-hot observation every step, and records:

* ``rate``: the full-loop training rate at canonical shapes (21x21 stacked)
  of the default ``PixelPPOConfig`` and of its ``throughput()`` preset, 32
  updates a run after a warm-up, timed with CUDA events (median and spread of
  3 runs; JAX took the least of 3 host-clock runs), and the preset's updates
  at the default's wall clock, ``round(updates x ms_default / ms_preset)``;
* ``default`` and ``preset``: a learning curve on single-task 21x21
  (``stacking=False``) at each config, the default over ``--updates`` and
  the preset over its matched updates, in chunks of 50;
* the ``stacked`` note.

``--part`` runs one part at a time (``preset`` needs ``rate`` first) and
merges it into ``--out``, the JAX record's schema plus the card and a
``reference`` block that compares each curve with the JAX record's
(``docs/pixel_canonical.json``, read as data) window by window
(``compare_windows``). ``--updates`` defaults to the record's
``config.updates``, 400; the JAX code's default (600) is not the run it
recorded. The curves take seed 0: parameters draw from JAX's
``PRNGKey(100 + seed)``, the first envs from ``PRNGKey(200 + seed)`` and
training from ``PRNGKey(300 + seed)``, JAX's keys and draws (the conv init's
normals within a few ulp of JAX's). Each collect
step launches the actions kernel at T = 1
(``train/fast_pixel_ppo._collect_pixel``), 64 launches an update.

    python -m gym_craftingworld_tpu_torch.tools.fast_pixel_canonical --part rate
    python -m gym_craftingworld_tpu_torch.tools.fast_pixel_canonical --part default
    python -m gym_craftingworld_tpu_torch.tools.fast_pixel_canonical --part preset
    python -m gym_craftingworld_tpu_torch.tools.fast_pixel_canonical --device cpu --envs 256 \\
        --updates 2 --rate-updates 1 --rollout-steps 8 --out /tmp/pixel.json   # a small CPU run
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools.fast_ppo_sweep import window_means
from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx
from gym_craftingworld_tpu_torch.utils.profiling import card_identity, timed_runs

REPO = Path(__file__).resolve().parents[2]
RUNS = REPO / "runs" / "torch"
RECORD = REPO / "docs" / "pixel_canonical.json"

B = 16384
CHUNK = 50  # updates a chunk of the curve, and a window of the comparison
RATE_UPDATES = 32
RATE_WARMUP = 4  # updates before the timed runs (cuDNN's set-up, the graph's capture)
PARTS = ("rate", "default", "preset")
# The default curve's bounds against the JAX record, fixed before the first
# full run on the card (PERF.md §6): its last window within
# DEFAULT_LAST_BAND x JAX's, and every window from update RISING_FROM on above
# the one before, as JAX's are.
DEFAULT_LAST_BAND = (0.75, 1.33)
RISING_FROM = 150
STACKED_NOTE = ("flat PPO on stacked exact-match goals fails by design — the "
                "compositional-plan-vector paper's motivating observation; the "
                "solved-canonical pixel result is the distilled_student section")


def jax_record() -> dict:
    return json.loads(RECORD.read_text())


def configs(rollout_steps: int | None = None):
    """(default, preset) ``PixelPPOConfig``s, with ``rollout_steps`` for small runs."""
    kw = {} if rollout_steps is None else {"rollout_steps": rollout_steps}
    return fx.PixelPPOConfig(**kw), fx.PixelPPOConfig.throughput(**kw)


def run_curve(cfg, ppo: fx.PixelPPOConfig, seed: int, updates: int, envs: int = B,
              device="cuda", tag: str = "") -> list:
    """Success per step of each of ``updates`` updates of ``train_many_pixel``,
    in chunks of ``CHUNK``, printing each chunk's mean."""
    key = lambda s: prng_key(s, device=device)
    ts = fx.init_pixel_train_state(key(100 + seed), cfg, ppo)
    env = fx.fresh_packed_batch(cfg, key(200 + seed), envs)
    k = key(300 + seed)
    curve = []
    t0 = time.time()
    while len(curve) < updates:
        n = min(CHUNK, updates - len(curve))
        ts, env, k, m = fx.train_many_pixel(cfg, ppo, ts, env, n, k)
        curve.extend(float(x) for x in m["success_per_step"].tolist())
        print(f"{tag}   {len(curve)}/{updates}: success/step {np.mean(curve[-CHUNK:]):.5f} "
              f"({time.time() - t0:.0f}s, host clock)", flush=True)
    return curve


def loop_rate(cfg, ppo: fx.PixelPPOConfig, envs: int = B, updates: int = RATE_UPDATES,
              device="cuda") -> dict:
    """Full-loop rate of ``train_many_pixel``: ``updates`` updates a run,
    timed (CUDA events) 3 times after ``RATE_WARMUP`` updates; the runs
    carry the training on."""
    key = lambda s: prng_key(s, device=device)
    # the JAX tool's keys: PRNGKey(0), PRNGKey(1) and PRNGKey(7)
    state = {"ts": fx.init_pixel_train_state(key(0), cfg, ppo),
             "env": fx.fresh_packed_batch(cfg, key(1), envs), "key": key(7)}

    def run(n):
        state["ts"], state["env"], state["key"], _ = fx.train_many_pixel(
            cfg, ppo, state["ts"], state["env"], n, state["key"])

    run(min(RATE_WARMUP, updates))
    t = timed_runs(lambda: run(updates), device, reps=3, warmup=0)
    steps = envs * ppo.rollout_steps * updates
    return {"full_loop_env_steps_per_s": steps / (t["median_ms"] / 1e3),
            "full_loop_env_steps_per_s_spread": [steps / (t["max_ms"] / 1e3),
                                                 steps / (t["min_ms"] / 1e3)],
            "ms_per_update": t["median_ms"] / updates,
            "ms_per_update_spread": [t["min_ms"] / updates, t["max_ms"] / updates],
            "runs_ms": t["runs_ms"]}


def compare_windows(port, jax, width: int = CHUNK) -> list:
    """The two curves window by window over the updates both have:
    ``[{"updates": [lo, hi], "port", "jax", "ratio"}]``, ``ratio`` = port /
    jax."""
    n = min(len(port), len(jax))
    return [{"updates": [i, i + width - 1], "port": p, "jax": j, "ratio": p / j}
            for i, p, j in zip(range(0, n, width), window_means(port, n, width),
                               window_means(jax, n, width))]


def default_bounds(windows: list) -> dict:
    """The default curve's bounds on its ``compare_windows`` rows."""
    last = windows[-1]["ratio"]
    rising = [w["port"] for w in windows if w["updates"][0] >= RISING_FROM - CHUNK]
    ok_last = DEFAULT_LAST_BAND[0] <= last <= DEFAULT_LAST_BAND[1]
    ok_rising = all(b > a for a, b in zip(rising, rising[1:]))
    return {"last_window_ratio": last, "last_window_band": list(DEFAULT_LAST_BAND),
            "rising_from_update": RISING_FROM, "rising": ok_rising,
            "held": ok_last and ok_rising}


def policy_name(ppo: fx.PixelPPOConfig) -> str:
    return (f"c{ppo.conv1}/c{ppo.conv2}/h{ppo.hidden}, {ppo.update_epochs} ep x "
            f"{ppo.num_minibatches} mb")


def reference(doc: dict) -> dict:
    """Each curve of ``doc`` beside the JAX record's, window by window."""
    jax = jax_record()
    ref = {"source": "docs/pixel_canonical.json (the JAX package, on a TPU)"}
    for part in ("default", "throughput_preset"):
        j = jax[part]
        row = {"jax_ms_per_update": j["ms_per_update"],
               "jax_full_loop_env_steps_per_s": j["full_loop_env_steps_per_s"],
               "jax_single_task_tail_mean": j["single_task_tail_mean"]}
        if part == "throughput_preset":
            row["jax_updates_at_matched_wall_clock"] = j["updates_at_matched_wall_clock"]
        curve = doc.get(part, {}).get("single_task_curve")
        if curve:
            row["windows"] = compare_windows(curve, j["single_task_curve"])
            if part == "default" and len(row["windows"]) * CHUNK == len(j["single_task_curve"]):
                row["bounds"] = default_bounds(row["windows"])
        ref[part] = row
    return ref


def main(argv=None) -> dict:
    rec = jax_record()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--part", nargs="+", choices=PARTS, default=list(PARTS))
    p.add_argument("--updates", type=int, default=rec["config"]["updates"],
                   help="the default config's updates (the record's config.updates)")
    p.add_argument("--envs", type=int, default=B)
    p.add_argument("--rate-updates", type=int, default=RATE_UPDATES)
    p.add_argument("--rollout-steps", type=int, help="T of both configs (small runs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=str(RUNS / "pixel_canonical.json"))
    args = p.parse_args(argv)

    card = card_identity(args.device)
    tag = f"[{card}]"
    clock = "CUDA events" if torch.device(args.device).type == "cuda" else "host clock"
    default, preset = configs(args.rollout_steps)
    cfg_stacked = cw.ray_config()
    cfg_single = cw.ray_config(stacking=False)
    out = Path(args.out)
    doc = json.loads(out.read_text()) if out.exists() else {}
    if doc.get("card", card) != card:
        raise SystemExit(f"{out} holds a run on {doc['card']}, not on {card}")
    doc["card"] = card
    doc["config"] = {"envs": args.envs, "grid": "21x21", "updates": args.updates,
                     "policy": "conv stem over the re-rendered (21,21,12) one-hot observation",
                     "device": args.device,
                     "timing": f"{clock}, {args.rate_updates} updates a run after "
                               f"{min(RATE_WARMUP, args.rate_updates)} warm-up updates, "
                               f"median of 3"}
    for name, ppo in (("default", default), ("throughput_preset", preset)):
        doc.setdefault(name, {})["policy"] = policy_name(ppo)
    seconds = doc.setdefault("seconds", {})

    if "rate" in args.part:
        t0 = time.time()
        for name, ppo in (("default", default), ("throughput_preset", preset)):
            r = loop_rate(cfg_stacked, ppo, args.envs, args.rate_updates, args.device)
            doc[name].update(r)
            print(f"{tag} {name} full loop: {r['full_loop_env_steps_per_s']:.4e} env-steps/s "
                  f"({r['ms_per_update']:.2f} ms/update, spread {r['ms_per_update_spread'][0]:.2f}"
                  f"-{r['ms_per_update_spread'][1]:.2f}; {clock}, median of 3)", flush=True)
        # matched wall clock: the preset gets the updates that fit in the default's budget
        doc["throughput_preset"]["updates_at_matched_wall_clock"] = int(round(
            args.updates * doc["default"]["ms_per_update"]
            / doc["throughput_preset"]["ms_per_update"]))
        seconds["rate"] = time.time() - t0
    for part, name, ppo in (("default", "default", default),
                            ("preset", "throughput_preset", preset)):
        if part not in args.part:
            continue
        if part == "default":
            n = args.updates
        elif "updates_at_matched_wall_clock" not in doc[name]:
            raise SystemExit(f"--part preset needs --part rate first (no matched updates in {out})")
        else:
            n = doc[name]["updates_at_matched_wall_clock"]
        print(f"{tag} single-task canonical curve ({name}, {n} updates):", flush=True)
        t0 = time.time()
        curve = run_curve(cfg_single, ppo, 0, n, args.envs, args.device, tag)
        seconds[part] = time.time() - t0
        doc[name]["single_task_curve"] = curve
        doc[name]["single_task_tail_mean"] = float(np.mean(curve[-CHUNK:]))
    doc.setdefault("stacked", {}).setdefault("note", STACKED_NOTE)
    doc["reference"] = reference(doc)
    for name in ("default", "throughput_preset"):
        for w in doc["reference"][name].get("windows", []):
            print(f"{tag} {name} updates {w['updates'][0]}-{w['updates'][1]}: success/step "
                  f"{w['port']:.4e} against JAX's {w['jax']:.4e} (ratio {w['ratio']:.4f})")
    if "bounds" in doc["reference"]["default"]:
        print(f"{tag} default bounds: {json.dumps(doc['reference']['default']['bounds'])}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    print(f"{tag} wrote {out}")
    return doc


if __name__ == "__main__":
    main()
