"""Diagnose the 8x8 CPV matrix's failures: replay chosen pairs step by step.

Counterpart of the JAX package's ``tools/cpv_debug.py``: train the
``cpv_matrix`` tool's model on its data before DAgger (``CPVPolicy`` with the
init view, hidden ``--hidden``; ``cpv_matrix.training_demos`` and
``scan_bc_train``, optionally smaller), save its parameters
(``--params``, a torch ``state_dict``; reloaded unless ``--retrain``),
then roll the greedy policy through the Gym façade on each ``--pairs`` cell
and classify every failed episode with ``_cpv.failure_kind``, as
``cpv_canonical --trace`` does:

* ``wrong_latch``: an undesired latching bit got set (unrecoverable);
* ``stall``: the last 12 (action, position, holding, achieved) tuples take
  at most 4 values, a limit cycle until the timeout;
* ``timeout``: distinct states until the step cap.

The façade and the policy run on ``--device``, the card unless asked for the
CPU; the façade's fast mode (the default, as the JAX tool's) draws its
resets from JAX's key chain, so the same seeds give the JAX tool's worlds
bit for bit; ``trace_pair(..., rng_mode="parity")`` draws the reference's
RandomState instead, the JAX façade's parity-mode worlds.
Prints the JAX tool's lines, a pair's counts as ``<pair>: {json}``, and one
JSON line of every pair with the card.

    python -m gym_craftingworld_tpu_torch.tools.cpv_debug --pairs BuildHouse+MoveSticks
    python -m gym_craftingworld_tpu_torch.tools.cpv_debug --device cpu --episodes-per-task 2 \\
        --epochs 1 --hidden 16 --episodes 2 --pairs MakeBread+ChopTree
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.api.gym_env import CraftingWorldEnvRay
from gym_craftingworld_tpu_torch.models.actor_critic import obs_features_init
from gym_craftingworld_tpu_torch.models.cpv import init_cpv
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools import cpv_matrix as cm
from gym_craftingworld_tpu_torch.tools._canonical import RUNS, load_params, log, shown
from gym_craftingworld_tpu_torch.tools._cpv import failure_kind
from gym_craftingworld_tpu_torch.utils.profiling import card_identity

PARAMS = RUNS / "cpv_debug" / "params.pt"
PAIRS = ["BuildHouse+MoveSticks", "GoToHouse+MoveAxe", "MoveAxe+MoveHammer",
         "MoveHammer+MoveSticks", "ChopTree+GoToHouse"]


def new_model(args, device) -> torch.nn.Module:
    return init_cpv(prng_key(args.seed + 1, device=device), 8, 8,
                    hidden=args.hidden, with_init=True)


def train(args, device) -> torch.nn.Module:
    """The ``cpv_matrix`` model trained on the tool's data before DAgger."""
    demos = cm.training_demos(args.episodes_per_task, args.seed, args.pool, device)
    model = new_model(args, device)
    return cm.scan_bc_train(demos, prng_key(args.seed + 2, device=device),
                            model, epochs=args.epochs, batch=512, lr=2e-3)


@torch.no_grad()
def trace_pair(model, pair, seed: int, pool: int, episodes: int = 8, verbose: int = 2,
               rng_mode: str = "fast") -> dict:
    """``episodes`` greedy episodes of the stacked pair (resets drawing
    exactly its two bits), from the training pool with the episode stream
    reseeded ``seed + 8001``; {"success", "wrong_latch", "stall", "timeout"}
    counts."""
    device = next(model.parameters()).device
    names = list(C.TASK_LIST)
    env = CraftingWorldEnvRay(seed=seed, size=(8, 8), max_steps=60, stacking=True,
                              fixed_init_state=pool, selected_tasks=list(pair), device=device,
                              rng_mode=rng_mode)
    env.seed(seed + 8001)
    outcomes = {"success": 0, "wrong_latch": 0, "stall": 0, "timeout": 0}
    tries = 0
    while tries < episodes:
        env.reset()
        if int(np.asarray(env.desired_goal_vector).sum()) != 2:
            continue
        tries += 1
        reward, hist = -1, []
        for t in range(env.MAX_STEPS):
            a = int(torch.argmax(model(obs_features_init(env.state))[0][0]))
            ach = np.flatnonzero(np.asarray(env.achieved_goal_vector))
            hold = int(env._state.holding[0])
            pos = tuple(env._state.agent[0].tolist())
            hist.append((t, a, pos, hold, tuple(ach.tolist())))
            _, reward, done, _ = env.step(a)
            if done:
                break
        ach = np.asarray(env.achieved_goal_vector).reshape(-1)
        des = np.asarray(env.desired_goal_vector).reshape(-1)
        if reward == env.MAX_STEPS:
            outcomes["success"] += 1
            continue
        kind = failure_kind(any(ach[b] and not des[b] for b in cm._LATCH),
                            (str(h[1:]) for h in hist))
        outcomes[kind] += 1
        if verbose:
            print(f"  FAIL[{kind}] ep{tries} desired={[names[i] for i in np.flatnonzero(des)]} "
                  f"achieved={[names[i] for i in np.flatnonzero(ach)]}")
            if verbose > 1:
                for h in hist[-18:]:
                    print("   ", h)
    return outcomes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--episodes-per-task", type=int, default=150)
    ap.add_argument("--pool", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--params", default=str(PARAMS))
    ap.add_argument("--retrain", action="store_true")
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--verbose", type=int, default=2)
    ap.add_argument("--pairs", nargs="*", default=PAIRS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    card = card_identity(dev)
    params = Path(args.params)
    if params.exists() and not args.retrain:
        model = load_params(new_model(args, dev), params)
        log(f"loaded {shown(params)}")
    else:
        t0 = time.time()
        model = train(args, dev)
        params.parent.mkdir(parents=True, exist_ok=True)
        torch.save(model.state_dict(), params)
        log(f"trained in {time.time() - t0:.0f}s -> {shown(params)}")
    pairs = {}
    for spec in args.pairs:
        out = trace_pair(model, tuple(spec.split("+")), args.seed, args.pool, args.episodes,
                         args.verbose)
        print(f"{spec}: {json.dumps(out)}", flush=True)
        pairs[spec] = out
    line = {"tool": "cpv_debug", "card": card, "episodes": args.episodes, "pairs": pairs}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
