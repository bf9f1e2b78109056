"""Ranks of ``torch.distributed`` on the CPU for the port's sharded tests.

``spawn(target, world, out_dir, *args)`` starts ``world`` processes on
127.0.0.1 with a free port (gloo, one thread each), each of which joins the
process group and calls ``target`` (``"module:function"``, importable from
``tests/``) with ``(out_dir, *args)``; a rank saves what it computed under
``out_dir`` for the test process to compare. A rank that fails fails the
spawn, and its peers are stopped. The rank-side functions of the sharded
tests are below: they import torch and the port only.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
# the slowest spawn of the sharded tests took 6.7 s with six test workers
# busy on 8 cores: a spawn that runs nine times as long has stalled
SPAWN_TIMEOUT_S = 60

_WORKER = r"""
import importlib, os, sys
rank, world, port, target, out = sys.argv[1:6]
sys.path.insert(0, os.environ["CW_TESTS"])
import torch
torch.set_num_threads(1)
from gym_craftingworld_tpu_torch.parallel.mesh import initialize_distributed
initialize_distributed(init_method="tcp://127.0.0.1:" + port, world_size=int(world),
                       rank=int(rank), device="cpu")
mod, fn = target.split(":")
getattr(importlib.import_module(mod), fn)(out, *sys.argv[6:])
torch.distributed.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, world: int, out_dir, *args, timeout: float = SPAWN_TIMEOUT_S) -> None:
    """Run ``target`` on ``world`` CPU ranks; raise with the output of a rank
    that fails or runs past ``timeout`` seconds."""
    port = str(free_port())
    env = dict(os.environ, CW_TESTS=str(TESTS), OMP_NUM_THREADS="1")
    logs = [Path(out_dir) / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(r), str(world), port, target, str(out_dir),
                 *map(str, args)], stdout=f, stderr=subprocess.STDOUT, cwd=ROOT, env=env))
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError("\n".join(f"rank {r} of {target} exited {procs[r].returncode}:\n"
                                       + logs[r].read_text()[-3000:] for r in bad))


def load(out_dir, rank: int) -> dict:
    return torch.load(Path(out_dir) / f"rank{rank}.pt", weights_only=False)


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------


def _rank():
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def _pair_mesh():
    """(this rank's mesh of its pair, pair index): ranks {0, 1} and {2, 3}
    as two meshes of 2 (every rank makes both groups, in one order)."""
    import torch.distributed as dist

    from gym_craftingworld_tpu_torch.parallel.mesh import EnvMesh

    rank, world = _rank()
    groups = [dist.new_group([2 * i, 2 * i + 1]) for i in range(world // 2)]
    return EnvMesh(rank % 2, 2, torch.device("cpu"), groups[rank // 2]), rank // 2


def _save(out, obj) -> None:
    rank, _ = _rank()
    torch.save(obj, Path(out) / f"rank{rank}.pt")


def mesh_checks(out, batch: str) -> None:
    """reset_sharded, shard_state and the collectives at world 4 and 2."""
    from gym_craftingworld_tpu_torch import ray_config
    from gym_craftingworld_tpu_torch.core.reset import reset_from_seed
    from gym_craftingworld_tpu_torch.parallel.mesh import make_env_mesh, reset_sharded, shard_state

    B = int(batch)
    cfg = ray_config()
    mesh4 = make_env_mesh(device="cpu")
    mesh2, _ = _pair_mesh()
    res = {}
    for name, mesh in (("w4", mesh4), ("w2", mesh2)):
        res[f"reset_{name}"] = reset_sharded(cfg, 5, B, mesh)
        res[f"shard_{name}"] = shard_state(reset_from_seed(cfg, 9, B, device="cpu"), mesh)
        try:
            reset_sharded(cfg, 5, B + 1, mesh)
            res[f"raises_{name}"] = False
        except ValueError:
            res[f"raises_{name}"] = True
        local = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 100 * mesh.rank
        res[f"gather_{name}"] = mesh.gather(local)
        res[f"sum_{name}"] = mesh.all_reduce(torch.tensor([mesh.rank + 1], dtype=torch.int64))
    _save(out, res)


def engine_checks(out, batch: str) -> None:
    """The sharded packed scan, actions kernel and bench at world 4 and 2,
    on the inputs the test process saved (``inputs.pt``)."""
    from gym_craftingworld_tpu_torch import ray_config
    from gym_craftingworld_tpu_torch.core.slots import SlotState
    from gym_craftingworld_tpu_torch.parallel import sharded_engine as se
    from gym_craftingworld_tpu_torch.parallel.mesh import make_env_mesh

    cfg = ray_config()
    inp = torch.load(Path(out) / "inputs.pt", weights_only=False)
    slots = SlotState(**inp["slots"])
    mesh4 = make_env_mesh(device="cpu")
    mesh2, pair = _pair_mesh()
    res = {}
    for name, mesh in (("w4", mesh4), ("w2", mesh2)):
        mine = se.shard_slots(slots, mesh)
        res[f"scan_{name}"] = se.rollout_p_sharded(cfg, mine, inp["actions"], inp["T"], mesh)
        res[f"actions_{name}"] = se.fused_rollout_packed_sharded(cfg, mine, inp["actions"],
                                                                 inp["T"], mesh=mesh)
        res[f"bench_{name}"] = se.fused_rollout_packed_bench_sharded(cfg, mine, inp["seed"],
                                                                     inp["T_bench"], mesh=mesh)
    res["pair"] = pair
    _save(out, res)


def train_checks(out) -> None:
    """One sharded update of each trainer (``sharded_train_run``)."""
    from gym_craftingworld_tpu_torch.parallel.mesh import make_env_mesh

    _save(out, sharded_train_run(make_env_mesh(device="cpu")))


def sharded_train_run(mesh) -> dict:
    """Fast PPO, pixel PPO and ``train/ppo.py`` (mlp), one update each over
    ``mesh`` (None: unsharded) from fixed seeds at small shapes: the
    trajectory and final env of the collect, the first minibatch's gradients
    and loss terms, and the update's metrics. The test process calls it with
    no mesh for the unsharded run."""
    import copy

    from gym_craftingworld_tpu_torch import flat_config
    from gym_craftingworld_tpu_torch.core.reset import reset_from_seed
    from gym_craftingworld_tpu_torch.parallel import sharded_engine as se
    from gym_craftingworld_tpu_torch.parallel.mesh import reset_sharded
    from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp
    from gym_craftingworld_tpu_torch.train import ppo as tppo

    cfg = flat_config()
    gen = lambda seed: torch.Generator().manual_seed(seed)
    local = (lambda env: env) if mesh is None else (lambda env: se.shard_packed(env, mesh))
    res = {}

    def run(name, ts, env, rollout_phase, first_grads, step):
        ts0 = copy.deepcopy(ts)
        env1, rollout = rollout_phase(copy.deepcopy(ts0), env, gen(3))
        grads, aux = first_grads(ts0, rollout)
        _, env2, _, metrics = step(ts0, env, gen(3))
        res[name] = dict(env=env1, env_step=env2, traj=rollout[0], grads=grads, aux=aux,
                         metrics=metrics)

    # fast PPO: 256 envs, T = 8, 2 x 2 minibatches of 128-row blocks
    fppo = fp.FastPPOConfig(rollout_steps=8, num_minibatches=2, hidden=32)
    run("fast", fp.init_fast_train_state(gen(1), cfg, fppo),
        local(fp.fresh_packed_batch(cfg, gen(2), 256)),
        lambda ts, env, g: fp.rollout_phase(cfg, fppo, ts, env, g, mesh=mesh),
        lambda ts, r: fp.minibatch_grads(fppo, ts.params, next(fp.minibatches(
            fppo, r.traj, r.adv, r.ret, r.perms, mesh)), None, mesh),
        lambda ts, env, g: fp.train_step_fast(cfg, fppo, ts, env, g, mesh=mesh))

    # pixel PPO: 256 envs, T = 4, 2 x 2 minibatches of 128-row blocks
    px = fx.PixelPPOConfig(rollout_steps=4, num_minibatches=2, conv1=8, conv2=8, hidden=32)
    run("pixel", fx.init_pixel_train_state(gen(1), cfg, px),
        local(fp.fresh_packed_batch(cfg, gen(2), 256)),
        lambda ts, env, g: fx.rollout_phase(cfg, px, ts, env, g, mesh),
        lambda ts, r: fx.minibatch_grads(px, ts.params, cfg, *next(fx.minibatches(
            px, *r, mesh)), mesh),
        lambda ts, env, g: fx.train_step_pixel(cfg, px, ts, env, g, mesh))

    # train/ppo.py, mlp: 32 envs, T = 8, 2 x 4 minibatches of single rows
    pp = tppo.PPOConfig(rollout_steps=8, hidden=32)
    env = (reset_from_seed(cfg, 2, 32, device="cpu") if mesh is None
           else reset_sharded(cfg, 2, 32, mesh))
    _, apply_fn = tppo.make_policy(pp)
    run("ppo", tppo.init_train_state(gen(1), cfg, pp), env,
        lambda ts, env, g: tppo.rollout_phase(cfg, pp, ts, env, g, mesh),
        lambda ts, r: tppo.minibatch_grads(pp, apply_fn, ts.params, *next(tppo.minibatches(
            pp, *r, mesh)), mesh),
        lambda ts, env, g: tppo.train_step(cfg, pp, ts, env, g, mesh))
    return res


def dryrun_checks(out) -> None:
    from gym_craftingworld_tpu_torch.parallel.dryrun import dryrun_multichip

    _save(out, {"line": dryrun_multichip(_rank()[1], "cpu")})


def scaling_cpu(out) -> None:
    """``scaling_artifact``'s ``cpu_virtual8`` section at a tiny size; rank 0
    writes ``scaling.json`` under ``out``."""
    from gym_craftingworld_tpu_torch.tools import scaling_artifact as sa

    sa.run_cpu(Path(out) / "scaling.json", batch_per_device=8, num_steps=4, iters=1)


def keyed_reset_ranks(out, batch: str, steps: str) -> None:
    """A rank's ``reset_sharded`` and an auto-reset rollout of its columns of
    ``randint(PRNGKey(3), (T, B), 0, 6)``, with the envs and keys it drew."""
    from gym_craftingworld_tpu_torch import flat_config, ray_config
    from gym_craftingworld_tpu_torch.core.rollout import rollout
    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
    from gym_craftingworld_tpu_torch.ops.threefry import prng_key
    from gym_craftingworld_tpu_torch.parallel.mesh import make_env_mesh, reset_sharded

    B, T = int(batch), int(steps)
    mesh = make_env_mesh(device="cpu")

    def drawn(fn):
        before = kd.reset_draws_plain.envs, kd.counter_draws_plain.elements
        res = fn()
        return res, {"envs": kd.reset_draws_plain.envs - before[0],
                     "keys": kd.counter_draws_plain.elements - before[1]}

    reset, reset_draws = drawn(lambda: reset_sharded(ray_config(), 5, B, mesh))
    cfg = flat_config(max_steps=6)
    actions = kd.randint_cols(prng_key(3), (T, B), 0, 6, mesh.cols(B))
    (rolled, out_), rollout_draws = drawn(
        lambda: rollout(cfg, reset_sharded(cfg, 5, B, mesh), actions, auto_reset=True))
    # the keys of a rollout are its reset's: the rollout draws no key, it reads them
    rollout_draws["keys"] += T * (B // mesh.size)
    _save(out, {"reset": reset, "reset_draws": reset_draws, "rolled": rolled,
                "done": out_.done, "rollout_draws": rollout_draws})
