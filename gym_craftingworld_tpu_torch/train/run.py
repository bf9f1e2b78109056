"""The PPO training command line.

Usage:
  python -m gym_craftingworld_tpu_torch.train.run --envs 4096 --updates 200 \\
      --size 8 --max-steps 100 --ckpt-dir ckpt

  torchrun --standalone --nproc_per_node 2 \\
      -m gym_craftingworld_tpu_torch.train.run --envs 4096 ...

Counterpart of ``gym_craftingworld_tpu/train/run.py``, with its flags and
JSON log lines, and ``--device`` (``cuda`` unless asked for ``cpu``). Runs
``train/ppo.train_step`` in a loop over this rank's columns of the env batch
(``parallel/mesh.ppo_train_step_sharded``; one rank without torchrun),
logs throughput and skill metrics on rank 0, evaluates the greedy policy on
rank 0, and checkpoints with ``train/checkpoint.py``; ``--resume``
continues bit-identically. Under torchrun the backend is NCCL when every
rank has a card of its own and gloo when ranks share a card or run on the
CPU (``parallel/mesh.choose_backend``). On a card the run takes PyTorch's
deterministic algorithms (with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``), so that
a resumed run repeats the uninterrupted one.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--size", type=int, default=8)
    p.add_argument("--max-steps", type=int, default=100)
    p.add_argument("--rollout-steps", type=int, default=64)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--policy", type=str, default="mlp",
                   choices=["mlp", "cnn", "vit"],
                   help="model family (recurrent training: train/ppo_rnn.py)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", type=str, default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest step_* checkpoint in "
                        "--ckpt-dir; continuation is bit-identical to an "
                        "uninterrupted run")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=0,
                   help="greedy-eval cadence in updates (0 = off)")
    p.add_argument("--eval-episodes", type=int, default=256)
    p.add_argument("--single-task", type=str, default="",
                   help="restrict goals to one named task (e.g. EatBread)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the run lives (the card unless asked for the CPU)")
    args = p.parse_args(argv)

    if args.device == "cuda":
        # cuBLAS reads this when it first starts; deterministic GEMMs need it
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from gym_craftingworld_tpu_torch.config import EnvConfig, resolve_selected_tasks
    from gym_craftingworld_tpu_torch.ops.threefry import prng_key
    from gym_craftingworld_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_env_mesh,
        ppo_train_step_sharded,
        reset_sharded,
    )
    from gym_craftingworld_tpu_torch.train import checkpoint
    from gym_craftingworld_tpu_torch.train.ppo import PPOConfig, init_train_state
    from gym_craftingworld_tpu_torch.utils.profiling import trace

    torch.use_deterministic_algorithms(True)
    initialize_distributed(device=args.device)
    mesh = make_env_mesh(device=args.device)
    lead = mesh.rank == 0

    cfg_kw = dict(height=args.size, width=args.size, max_steps=args.max_steps)
    if args.single_task:
        cfg_kw.update(
            selected_task_indices=resolve_selected_tasks([args.single_task]),
            number_of_tasks=1,
            stacking=False,
        )
    cfg = EnvConfig(**cfg_kw)
    ppo = PPOConfig(rollout_steps=args.rollout_steps, hidden=args.hidden, lr=args.lr,
                    policy=args.policy)

    env_state = reset_sharded(cfg, args.seed, args.envs, mesh)
    # flax's init from JAX's PRNGKey(seed), the step key PRNGKey(seed + 1), on the device
    ts = init_train_state(prng_key(args.seed, device=mesh.device), cfg, ppo)
    key = prng_key(args.seed + 1, device=mesh.device)

    start_u = 0
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume requires --ckpt-dir")
        ckpt_root = os.path.abspath(args.ckpt_dir)
        steps = sorted(
            int(d.split("_", 1)[1])
            for d in os.listdir(ckpt_root)
            if d.startswith("step_") and d.split("_", 1)[1].isdigit()
            and os.path.exists(os.path.join(ckpt_root, d, checkpoint.STATE_FILE))
        )
        if not steps:
            raise SystemExit(f"--resume: no step_* checkpoints in {ckpt_root}")
        path = os.path.join(ckpt_root, f"step_{steps[-1]}")
        ts, env_state, key, start_u = checkpoint.restore(path, ts, mesh.device, mesh)
        if lead:
            print(json.dumps({"resumed_from": path, "update": start_u}), flush=True)

    step = ppo_train_step_sharded(cfg, ppo, mesh)
    steps_per_update = args.envs * ppo.rollout_steps
    t_start = time.time()
    last_log_t, last_log_u = None, 0
    for u in range(start_u, args.updates):
        with trace("train_step"):
            ts, env_state, key, metrics = step(ts, env_state, key)
        if u % args.log_every == 0 or u == args.updates - 1:
            # the host reads the metrics, which waits for the card: the rate
            # is taken over the wall time between log points
            m = {k: float(v) for k, v in metrics.items()}
            now = time.time()
            if last_log_t is not None and u > last_log_u:
                rate = steps_per_update * (u - last_log_u) / (now - last_log_t)
                m["env_steps_per_s"] = round(rate)
            last_log_t, last_log_u = now, u
            m.update(update=u, wall_s=round(now - t_start, 1))
            if lead:
                print(json.dumps(m), flush=True)
        if args.eval_every and (u + 1) % args.eval_every == 0 and lead:
            from gym_craftingworld_tpu_torch.train.evaluate import evaluate_policy

            report = evaluate_policy(cfg, ppo, ts.params, args.eval_episodes,
                                     seed=args.seed + u)
            report["update"] = u
            print(json.dumps({"eval": report}), flush=True)
        if args.ckpt_dir and (u + 1) % args.ckpt_every == 0:
            path = os.path.join(os.path.abspath(args.ckpt_dir), f"step_{u + 1}")
            checkpoint.save(path, ts, env_state, key, step=u + 1, mesh=mesh)
            if lead:
                print(json.dumps({"checkpoint": path}), flush=True)

    if mesh.group is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
