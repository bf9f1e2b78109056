"""Headline benchmark: env-steps/s on one card at 16,384 parallel envs.

Counterpart of the JAX package's root ``bench.py``: the same environment
variables, engines and metric names, one JSON line of the same keys.

* ``BENCH_ENVS``: envs (16,384), on 21x21 from ``reset_from_seed(cfg, 0, B)``;
* ``BENCH_LAYOUT``: the engine, ``packed_fused`` (default; the bench kernel
  through ``ops/packed_fused.fused_rollout_packed_bench``, pack and unpack
  included), ``packed`` (``ops/packed_rollout.rollout_p_bench``),
  ``transposed`` (``ops/transposed_rollout.rollout_t_random``), ``slots``
  (``core/slots.rollout_slots_random``), ``grid``
  (``core/rollout.rollout_random``) or ``obs_ray`` / ``obs_altobs`` /
  ``obs_onehot`` (``ops/obs_rollout.rollout_obs_random``, a render every step);
* ``BENCH_STEPS``: steps a run; by default 1,048,576 for ``packed_fused``
  (about 0.2 s a run on an H100), 2,048 for ``obs_*`` and 512 for the four
  plain-torch engines, which the host paces at a few ms a step;
* ``BENCH_ITERS``: timed runs (11).

Each run continues from the last run's state (``step_num`` saturates at
``max_steps``, so a long rollout without resets is safe) and draws from
JAX's keys as the JAX tool's ``_median_time`` does: the warm-up from
``PRNGKey(0)``, run ``i`` from ``fold_in(PRNGKey(0), i)``, key data on the
device (the counter kernel draws on the card). The plain engines draw
their actions from the key (``randint(key, (T, B), 0, 6)``); for
``packed_fused`` the bench kernel's Philox seed is ``randint(key, (), 0,
2**31 - 1)``, read back to the host. After the warm-up run each run lies
between two CUDA events; the reward checksums, int64 sums, are read after
the last run. The JAX tool's relay workarounds (T-against-T/2 deltas, stall
retries, cool-downs) are gone.

Prints one JSON line: ``metric`` (``bench.py``'s name for the layout and
envs), ``value`` (median env-steps/s), ``unit``, ``vs_baseline`` (over the
reference's single-env CPU rate in ``BASELINE_MEASURED.json``, read as data;
measured here if that file is absent and ``parity/oracle`` finds the
reference, else null), ``runs``, ``min``, ``max``, ``spread_pct``, and the
port's own ``device`` (the card's name and power limit) and ``timing``.

    python -m gym_craftingworld_tpu_torch.tools.bench
    BENCH_LAYOUT=obs_ray python -m gym_craftingworld_tpu_torch.tools.bench
    BENCH_ENVS=64 BENCH_STEPS=8 BENCH_ITERS=2 python -m gym_craftingworld_tpu_torch.tools.bench --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch.core import slots as sm
from gym_craftingworld_tpu_torch.core.rollout import rollout_random
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.ops import obs_rollout as obr
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops import packed_rollout as pr
from gym_craftingworld_tpu_torch.ops import transposed_rollout as tr
from gym_craftingworld_tpu_torch.tools._canonical import REPO
from gym_craftingworld_tpu_torch.utils.profiling import card_identity, timed_runs

LAYOUTS = ("packed_fused", "packed", "transposed", "slots", "grid", "obs_ray", "obs_altobs",
           "obs_onehot")
BASELINE = REPO / "BASELINE_MEASURED.json"


def default_steps(layout: str) -> int:
    if layout == "packed_fused":
        return 1048576
    return 2048 if layout.startswith("obs_") else 512


def metric_name(layout: str, envs: int) -> str:
    """``bench.py``'s metric name for ``layout`` at ``envs`` envs."""
    if layout.startswith("obs_"):
        return f"env_steps_with_{layout[4:]}_obs_per_s_per_chip_{envs // 1024}k_envs"
    return f"env_steps_per_s_per_chip_{envs // 1024}k_envs"


def bench_seed(key: torch.Tensor) -> int:
    """``packed_fused``'s Philox seed of a run: ``randint(key, (), 0, 2**31 -
    1)``, as the JAX tool draws it, read back to the host."""
    return int(kd.randint(key, (), 0, 2**31 - 1))


def make_engine(layout: str, cfg, state):
    """``(roll, state)``: ``roll(state, key, T) -> (state, int64 checksum)``
    runs ``layout``'s engine from ``state`` (an ``EnvState``, converted here to
    the engine's layout) for T steps from key data ``key``, as the JAX tool's
    ``_make_engine``."""
    if layout not in LAYOUTS:
        raise SystemExit(f"unknown BENCH_LAYOUT {layout!r}")
    if layout == "grid":
        engine = lambda st, k, n: rollout_random(cfg, st, k, n)
    else:
        state = sm.from_env_state(state)
        if layout == "packed_fused":
            return (lambda st, k, n: pf.fused_rollout_packed_bench(cfg, st, bench_seed(k), n)), state
        engine = {"packed": lambda st, k, n: pr.rollout_p_bench(cfg, st, k, n),
                  "transposed": lambda st, k, n: tr.rollout_t_random(cfg, st, k, n),
                  "slots": lambda st, k, n: sm.rollout_slots_random(cfg, st, k, n)}.get(
            layout, lambda st, k, n: obr.rollout_obs_random(cfg, st, k, n, layout[4:]))

    def roll(st, key, n):
        st, out = engine(st, key, n)
        return st, (out if torch.is_tensor(out) else out.reward.sum(dtype=torch.int64))

    return roll, state


def reference_steps_per_s(n_steps: int = 3000) -> float | None:
    """The reference's single-env CPU stepping rate: ``BASELINE_MEASURED.json``
    read as data, else measured through ``parity/oracle`` as the JAX tool
    measures it, else None."""
    if BASELINE.exists():
        return json.loads(BASELINE.read_text())["reference_single_env_steps_per_s"]
    from gym_craftingworld_tpu_torch.parity import oracle

    if not oracle.reference_available():
        return None
    env = oracle.make_reference_env("ray", seed=0)
    env.reset()
    actions = np.random.RandomState(0).randint(6, size=n_steps)
    t0 = time.time()
    for a in actions:
        _, _, done, _ = env.step(int(a))
        if done:
            env.reset()
    return n_steps / (time.time() - t0)


def measure(layout: str, envs: int, steps: int, iters: int, device) -> dict:
    """``timed_runs`` of ``layout``'s engine (``median_ms``, ``runs_ms``) and
    the reward checksum of every run, the warm-up's first: the warm-up from
    ``PRNGKey(0)``, timed run ``i`` from ``fold_in(PRNGKey(0), i)``."""
    cfg = cw.ray_config()
    roll, state = make_engine(layout, cfg, cw.reset_from_seed(cfg, 0, envs, device=device))
    key = prng_key(0, device=device)
    box = {"state": state, "run": -1, "checksums": []}

    def run():
        k = key if box["run"] < 0 else kd.fold_in(key, box["run"])
        box["state"], checksum = roll(box["state"], k, steps)
        box["run"] += 1
        box["checksums"].append(checksum)

    t = timed_runs(run, device, reps=iters, warmup=1)
    return {**t, "checksums": [int(c) for c in box["checksums"]]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    layout = os.environ.get("BENCH_LAYOUT", "packed_fused")
    envs = int(os.environ.get("BENCH_ENVS", 16384))
    steps = int(os.environ.get("BENCH_STEPS", default_steps(layout)))
    iters = int(os.environ.get("BENCH_ITERS", 11))
    card = card_identity(dev)
    baseline = reference_steps_per_s()
    t = measure(layout, envs, steps, iters, dev)
    rate = lambda ms: envs * steps / (ms / 1e3)
    value = rate(t["median_ms"])
    line = {"metric": metric_name(layout, envs), "value": round(value), "unit": "env-steps/s",
            "vs_baseline": None if baseline is None else round(value / baseline, 1),
            "runs": len(t["runs_ms"]), "min": round(rate(t["max_ms"])),
            "max": round(rate(t["min_ms"])),
            "spread_pct": round(100 * (rate(t["min_ms"]) - rate(t["max_ms"])) / value, 1),
            "device": card, "timing": "cuda_events" if dev.type == "cuda" else "host_clock"}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
