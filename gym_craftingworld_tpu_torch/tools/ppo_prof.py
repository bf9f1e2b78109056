"""Stage timings of ``train/ppo.py`` on the card.

Counterpart of the JAX package's ``tools/ppo_prof.py``: ``flat_config()``
(8x8, stacked goals), the default ``PPOConfig`` (mlp, hidden 512, T = 64, 2
epochs x 4 minibatches) at ``B`` envs (environment variable, 4,096). The
JAX tool's stages, each run once to warm up and then ``--reps`` times (7)
between CUDA events:

* ``train_step``: ``train_step`` in full, carrying its state; its env-steps/s;
* ``collect``: ``_collect`` of 64 policy steps with auto-reset;
* ``reset``: 64 resets of B envs from their keys (``core/reset.reset``);
* ``grid_step``: 64 grid steps (``core/step.step``) with random actions;
* ``policy_forward``: 64 forwards of the policy on one snapshot;
* ``update_epoch``: one epoch of 4 minibatch updates (autograd, clip and
  Adam) on a synthetic batch of T x B rows, as the JAX tool builds it.

Prints a line a stage with the card and one JSON line a stage. Of the
hand-written kernels only the keyed draws' run on this path: the resets'
and the step's draws from JAX's key chain (``train_step`` from
``PRNGKey(0)``, the collect's noise from ``PRNGKey(1)``).

    python -m gym_craftingworld_tpu_torch.tools.ppo_prof
    B=16 python -m gym_craftingworld_tpu_torch.tools.ppo_prof --device cpu --reps 1
"""

from __future__ import annotations

import argparse
import json
import os

import torch

import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.core.step import step
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import fast_ppo
from gym_craftingworld_tpu_torch.train import ppo as P
from gym_craftingworld_tpu_torch.utils.profiling import card_identity, counted, timed_runs

STAGE_STEPS = 64  # resets, grid steps and forwards a run, as the JAX tool's scans


def update_epoch(ppo: P.PPOConfig, apply_fn, ts: P.TrainState, snap: P.Snapshot,
                 generator: torch.Generator):
    """One epoch of minibatch updates on the JAX tool's synthetic batch: the
    snapshot tiled T times, actions 0, old log-probs and values 0,
    advantages and returns 1; rows in a permutation from ``generator``."""
    T, B = ppo.rollout_steps, snap.objects.shape[0]
    n = T * B
    dev = snap.objects.device
    obs = P.Snapshot(*(x.repeat((T,) + (1,) * (x.dim() - 1)) for x in snap))
    zeros, ones = torch.zeros(n, device=dev), torch.ones(n, device=dev)
    flat = (obs, torch.zeros(n, dtype=torch.int32, device=dev), zeros, zeros, ones, ones)
    optimizer = P.make_optimizer(ppo)
    params, opt_state = ts.params, ts.opt_state
    perm = torch.randperm(n, generator=generator, device=dev)
    mb = n // ppo.num_minibatches
    losses = []
    for i in range(ppo.num_minibatches):
        idx = perm[i * mb: (i + 1) * mb]
        batch = (P.Snapshot(*(x[idx] for x in flat[0])),) + tuple(x[idx] for x in flat[1:])
        grads, aux = P._grads(ppo, apply_fn, params, batch)
        updates, opt_state = optimizer.update(grads, opt_state)
        fast_ppo.apply_updates(params, updates)
        losses.append(aux["loss"])
    return torch.stack(losses).sum()


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=7, help="timed runs a stage")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    card = card_identity(dev)
    B = int(os.environ.get("B", 4096))
    cfg = cw.flat_config()
    ppo = P.PPOConfig()
    T = ppo.rollout_steps
    gen = torch.Generator(device=dev).manual_seed(0)  # the synthetic draws
    _, apply_fn = P.make_policy(ppo)
    ts = P.init_train_state(prng_key(0, device=dev), cfg, ppo)
    carry = {"ts": ts, "env": cw.reset_from_seed(cfg, 0, B, device=dev),
             "key": prng_key(0, device=dev)}

    def train_step():
        carry["ts"], carry["env"], carry["key"], _ = P.train_step(cfg, ppo, carry["ts"],
                                                                  carry["env"], carry["key"])

    st1 = cw.reset_from_seed(cfg, 1, B, device=dev)
    st2 = cw.reset_from_seed(cfg, 2, B, device=dev)
    noise = P.collect_noise(prng_key(1, device=dev), T, B)

    @torch.no_grad()
    def collect():
        return P._collect(cfg, ppo, apply_fn, carry["ts"].params, st1, noise)

    @torch.no_grad()
    def resets():
        for _ in range(STAGE_STEPS):
            reset(cfg, st1.rng)

    @torch.no_grad()
    def grid_steps():
        st = st2
        for _ in range(STAGE_STEPS):
            a = torch.randint(0, C.N_ACTIONS, (B,), generator=gen, device=dev, dtype=torch.int32)
            st, _ = step(cfg, st, a)

    @torch.no_grad()
    def forwards():
        snap = P.snapshot(st2)
        for _ in range(STAGE_STEPS):
            apply_fn(carry["ts"].params, snap)

    stages = {"train_step": train_step, "collect": collect, "reset": resets,
              "grid_step": grid_steps, "policy_forward": forwards,
              "update_epoch": lambda: update_epoch(ppo, apply_fn, carry["ts"], P.snapshot(st2), gen)}
    setting = {"envs": B, "rollout_steps": T, "hidden": ppo.hidden, "policy": ppo.policy,
               "epochs": ppo.update_epochs, "minibatches": ppo.num_minibatches,
               "device": args.device, "reps": args.reps}
    tag = f"[{card}]"
    print(f"{tag} ppo_prof " + " ".join(f"{k}={v}" for k, v in setting.items()), flush=True)
    lines = []
    for name, fn in stages.items():
        t, launches, calls = counted(lambda: timed_runs(fn, dev, reps=args.reps, warmup=1))
        line = {"tool": "ppo_prof", "stage": name, "card": card, **setting, "ms": t["median_ms"],
                "ms_spread": [t["min_ms"], t["max_ms"]], "launches": launches,
                "plain_calls": calls,
                "timing": "cuda_events" if dev.type == "cuda" else "host_clock"}
        if name == "train_step":
            line["env_steps_per_s"] = B * T / (t["median_ms"] / 1e3)
        print(f"{tag} {name}: {t['median_ms']:.1f} ms (median of {args.reps})"
              + (f" -> {line['env_steps_per_s']:.4e} env-steps/s" if name == "train_step" else ""),
              flush=True)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
