"""Find the scripted expert's failures across many seeds.

Counterpart of the JAX package's ``tools/expert_probe.py``: ``agents/expert.
ExpertPolicy`` drives one episode an env through the port's Gym façade, over
the JAX tool's seeds and modes, and every episode that does not end in
success is printed in the JAX tool's format:

* ``single``: each task alone on 21x21 (``max_steps`` 300), seeds
  ``13 s + 7`` for s < 10;
* ``stacked``: stacked goals on 21x21, seeds 0-49;
* ``flat``: ``CraftingWorldEnvFlat`` (8x8), stacked goals, seeds 0-19;
* ``all``: the three in that order.

The façade runs on ``--device`` (the card unless asked for the CPU; the
expert reads the episode's init grid from a host copy,
``train/evaluate._HostView``) and draws its resets from a
``torch.Generator``, as the JAX tool's draws from ``jax.random``: the same
seeds give other worlds. ``probe(..., rng_mode="parity")`` draws the
reference's RandomState instead, the JAX façade's worlds bit for bit (the
tests compare the two tools so). ``--seeds N`` takes each mode's first N
seeds.

    python -m gym_craftingworld_tpu_torch.tools.expert_probe [all|single|stacked|flat]
    python -m gym_craftingworld_tpu_torch.tools.expert_probe flat --seeds 2 --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.agents.expert import ExpertPolicy
from gym_craftingworld_tpu_torch.api import CraftingWorldEnvFlat, CraftingWorldEnvRay
from gym_craftingworld_tpu_torch.train.evaluate import _HostView
from gym_craftingworld_tpu_torch.utils.profiling import card_identity

SEEDS = {"single": [s * 13 + 7 for s in range(10)], "stacked": list(range(50)),
         "flat": list(range(20))}
MODES = ("single", "stacked", "flat")


def episodes(mode: str, seeds: int | None = None):
    """``(kind, task, seed, make_env)`` of each episode the JAX tool runs in
    ``mode``, each mode cut to its first ``seeds`` seeds if given."""
    cut = lambda kind: SEEDS[kind][:seeds]
    for kind in MODES if mode == "all" else (mode,):
        if kind == "single":
            for task in C.TASK_LIST:
                for seed in cut(kind):
                    yield kind, task, seed, lambda seed=seed, task=task, **kw: CraftingWorldEnvRay(
                        seed=seed, selected_tasks=[task], stacking=False, max_steps=300, **kw)
        elif kind == "stacked":
            for seed in cut(kind):
                yield kind, "", seed, lambda seed=seed, **kw: CraftingWorldEnvRay(
                    seed=seed, stacking=True, max_steps=300, **kw)
        else:
            for seed in cut(kind):
                yield kind, "", seed, lambda seed=seed, **kw: CraftingWorldEnvFlat(
                    seed=seed, stacking=True, **kw)


def probe(mode: str = "all", seeds: int | None = None, device="cuda", rng_mode: str = "fast",
          verbose: bool = True) -> list:
    """Every episode's ``(kind, task, seed, reward, desired, achieved,
    success)``, success meaning a reward of the env's ``MAX_STEPS``; the
    failures printed as the JAX tool prints them."""
    names = list(C.TASK_LIST)
    records = []
    for kind, task, seed, make_env in episodes(mode, seeds):
        env = make_env(device=device, rng_mode=rng_mode)
        env.reset()
        reward = ExpertPolicy(_HostView(env)).run_episode()
        d = np.asarray(env.desired_goal_vector).reshape(-1)
        a = np.asarray(env.achieved_goal_vector).reshape(-1)
        success = bool(reward == env.MAX_STEPS)
        records.append((kind, task, seed, int(reward), d.tolist(), a.tolist(), success))
        if success or not verbose:
            continue
        if kind == "single":
            print("FAIL single", task, "seed", seed, "desired", np.flatnonzero(d), "achieved",
                  np.flatnonzero(a), flush=True)
        else:
            print(f"FAIL {kind} seed", seed, "desired", [names[i] for i in np.flatnonzero(d)],
                  "achieved", [names[i] for i in np.flatnonzero(a)], flush=True)
    return records


def failures(records: list) -> list:
    """The JAX tool's ``fails``: ``(kind, task, seed, desired, achieved)`` of
    each episode that did not succeed."""
    return [(k, t, s, d, a) for k, t, s, _, d, a, ok in records if not ok]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", nargs="?", default="all", choices=("all",) + MODES)
    p.add_argument("--seeds", type=int, default=None, help="each mode's first N seeds")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    card = card_identity(args.device)
    print(f"[{card}] expert_probe {args.mode}" + (f" seeds={args.seeds}" if args.seeds else ""),
          flush=True)
    records = probe(args.mode, args.seeds, args.device)
    fails = failures(records)
    print(f"total failures: {len(fails)}")
    print(json.dumps({"tool": "expert_probe", "card": card, "mode": args.mode,
                      "seeds": args.seeds, "episodes": len(records), "failures": fails}),
          flush=True)
    return fails


if __name__ == "__main__":
    main()
