"""The env-batch mesh over ranks of ``torch.distributed``, and its resets.

Counterpart of ``gym_craftingworld_tpu/parallel/mesh.py``. JAX runs one
process over a ``Mesh`` of devices, and sharding is a layout that XLA's
partitioner honours. PyTorch runs one process per device: each rank holds
its own contiguous columns of the env batch, runs the unsharded functions on
them, and meets the other ranks only in collectives. So what the partitioner
derives, the port writes out: which rank owns which envs (``EnvMesh.cols``),
the gathers and sums the learner needs (``EnvMesh.all_reduce``,
``EnvMesh.gather``), and the keys of each rank's own envs: env ``b``'s key
is key ``b`` of ``split(PRNGKey(seed), B)``, a hash of ``b`` alone
(``ops/threefry.py``), so a rank derives its columns' keys and draws only
its own envs, and a sharded run equals the unsharded run from the same seed
on any number of ranks, as in JAX.

One collective only, ``all_reduce``: with ``broadcast`` it is all gloo
does on CUDA tensors, and two ranks that share one card must use gloo
(NCCL refuses a duplicate GPU). A gather is an ``all_reduce`` sum of a
zero-filled buffer in which each rank has written its own columns, which is
exact. A rank that finds no card raises unless it was asked for the CPU, and
a collective takes only tensors on the rank's device: nothing falls back to
the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.ops.keyed_draws import randint_cols, split_keys
from gym_craftingworld_tpu_torch.ops.threefry import prng_key

ENV_AXIS = "env"


def choose_backend(device_type: str, local_ranks: int, n_cards: int,
                   requested: str | None = None) -> str:
    """The process group's backend: NCCL when every rank of a host has a card
    of its own, gloo when ranks share a card or run on the CPU.

    Raises for NCCL with more ranks than cards on a host (NCCL refuses two
    ranks on one GPU), for NCCL on the CPU, and for a CUDA run on a host with
    no card.
    """
    if device_type == "cpu":
        if requested == "nccl":
            raise ValueError("NCCL needs a CUDA card for each rank; the CPU takes gloo")
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if n_cards < 1:
        raise RuntimeError("no CUDA card on this host; pass device='cpu' to run on the CPU")
    shared = local_ranks > n_cards
    if requested == "nccl" and shared:
        raise ValueError(f"NCCL refuses two ranks on one card: {local_ranks} ranks on "
                         f"{n_cards} card(s) of this host; use gloo")
    return requested or ("gloo" if shared else "nccl")


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))


def initialize_distributed(**kwargs):
    """Multi-process bring-up (no-op in one process with no arguments but
    ``device``).

    Reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) unless the keyword
    arguments give ``init_method``, ``world_size`` and ``rank``. ``device``
    ("cuda", the default, or "cpu") and ``backend`` choose the backend as
    ``choose_backend`` says; rank 0 says the choice on stderr. Other keywords
    go to ``torch.distributed.init_process_group``.
    """
    if dist.is_initialized():
        return
    device = torch.device(kwargs.pop("device", "cuda"))
    world = int(kwargs.pop("world_size", os.environ.get("WORLD_SIZE", 1)))
    if world == 1 and not kwargs:
        return
    rank = int(kwargs.pop("rank", os.environ.get("RANK", 0)))
    local_ranks = int(kwargs.pop("local_world_size", os.environ.get("LOCAL_WORLD_SIZE", world)))
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = choose_backend(device.type, local_ranks, n_cards, kwargs.pop("backend", None))
    if device.type == "cuda":
        torch.cuda.set_device(_local_rank() % n_cards)
    dist.init_process_group(backend, init_method=kwargs.pop("init_method", "env://"),
                            world_size=world, rank=rank, **kwargs)
    if rank == 0:
        print(json.dumps({"distributed": {"backend": backend, "world_size": world,
                                          "device": device.type, "local_ranks": local_ranks,
                                          "cards": n_cards}}), file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """One rank's view of the env axis: its index, the rank count, its device
    and the process group (None in one process)."""

    rank: int
    size: int
    device: torch.device
    group: object = None

    def cols(self, batch_size: int) -> slice:
        """This rank's envs of a batch of ``batch_size``."""
        if batch_size % self.size:
            raise ValueError(f"batch_size {batch_size} must divide evenly over "
                             f"{self.size} devices")
        n = batch_size // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` over the ranks in place (sum by default); returns it."""
        if self.group is None:
            return t
        if t.device != self.device:
            raise ValueError(f"a collective takes tensors on {self.device}, not {t.device}")
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def gather(self, local: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The whole batch from every rank's columns ``local`` along ``dim``
        (a dtype that NCCL and gloo sum: f32, f64, int32, int64)."""
        if self.group is None:
            return local
        n = local.shape[dim]
        shape = list(local.shape)
        shape[dim] = n * self.size
        out = torch.zeros(shape, dtype=local.dtype, device=local.device)
        out.narrow(dim, self.rank * n, n).copy_(local)
        return self.all_reduce(out)

    def own(self, ids: torch.Tensor, per_step: int):
        """This rank's share of the whole batch's block ids ``ids`` (host
        int64): the batch's blocks lie step-major, ``per_step`` a step, and a
        rank holds ``per_step / size`` contiguous blocks of each step.
        Returns (mask of the rank's ids, their ids among the rank's blocks)."""
        nbl = per_step // self.size
        t, c = ids // per_step, ids % per_step
        own = c // nbl == self.rank
        return own, t[own] * nbl + c[own] - self.rank * nbl


def make_env_mesh(n_devices: int | None = None, device=None) -> EnvMesh:
    """The env mesh of this process: every rank of the process group, or this
    rank alone when ``n_devices`` is 1 or there is no group.

    ``device`` defaults to the card of this rank's ``LOCAL_RANK`` (modulo
    the host's cards, so that ranks may share one); a CUDA mesh on a host
    with no card raises.
    """
    device = torch.device("cuda" if device is None else device)
    if dist.is_initialized() and n_devices != 1:
        rank, size, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
        if n_devices not in (None, size):
            raise ValueError(f"{n_devices} devices asked of a group of {size} ranks")
    else:
        rank, size, group = 0, 1, None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card on this rank; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return EnvMesh(rank, size, device, group)


class Sharding(NamedTuple):
    """How a tensor lies over the mesh: split on ``dim`` (the batch axis) or,
    with ``dim`` None, whole on every rank."""

    mesh: EnvMesh
    dim: int | None

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``x``, on the rank's device."""
        x = x.to(self.mesh.device)
        if self.dim is None:
            return x
        cols = self.mesh.cols(x.shape[self.dim])
        return x.narrow(self.dim, cols.start, cols.stop - cols.start).contiguous()


def env_sharding(mesh: EnvMesh) -> Sharding:
    """Sharding of batch-leading leaves: axis 0 split over the ranks."""
    return Sharding(mesh, 0)


def replicated(mesh: EnvMesh) -> Sharding:
    return Sharding(mesh, None)


def tree_map(fn, tree):
    """``fn`` over the fields of a dataclass (``EnvState``) or NamedTuple state."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: fn(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return type(tree)(*map(fn, tree))


def shard_state(state: EnvState, mesh: EnvMesh) -> EnvState:
    """This rank's columns of a whole batched state."""
    return tree_map(env_sharding(mesh).shard, state)


def reset_sharded(cfg: EnvConfig, seed: int, batch_size: int, mesh: EnvMesh) -> EnvState:
    """This rank's columns of ``reset_from_seed(cfg, seed, batch_size)``.

    The rank derives only its own columns' keys of ``split(PRNGKey(seed),
    batch_size)`` on its device and resets them: no gather, no replicated
    work, and the shards are the unsharded reset's columns on any number of
    ranks.
    """
    keys = split_keys(prng_key(seed), batch_size, mesh.cols(batch_size), mesh.device)
    return reset(cfg, keys)


def ppo_train_step_sharded(cfg: EnvConfig, ppo, mesh: EnvMesh):
    """``train/ppo.train_step`` over this rank's envs of the mesh.

    Returns ``step(ts, env_state, generator) -> (ts, env_state, generator,
    metrics)``: ``env_state`` is this rank's columns, the train state,
    generator and metrics are the same on every rank (see ``train/ppo.py``).
    """
    from gym_craftingworld_tpu_torch.train.ppo import train_step

    def step(ts, env_state, generator):
        return train_step(cfg, ppo, ts, env_state, generator, mesh=mesh)

    return step


def time_ms(run, iters: int, device: torch.device) -> float:
    """Median ms of ``run()`` after one warm-up: CUDA events on a card, the
    host clock on the CPU."""
    run()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def scaling_report(cfg: EnvConfig, batch_per_device: int, num_steps: int = 64,
                   engines=("grid", "packed_scan"), iters: int = 3, device=None) -> dict:
    """env-steps/s on one rank against all ranks of the process group, per engine.

    Engines: ``grid`` (``core/rollout.rollout_random`` of ``PRNGKey(1)``:
    this rank's columns of its actions), ``packed_scan``
    (``parallel/sharded_engine.rollout_p_sharded``) and ``fused`` (the bench
    kernel through ``fused_rollout_packed_bench_sharded``). A rank's time is
    the median of ``iters`` runs after a warm-up (``time_ms``); the N-rank
    rate is the whole batch over the slowest rank's time. Returns ``{engine:
    {"n1": rate, "nN": rate, "devices": N, "efficiency": rate(N) / (N *
    rate(1))}}``; in one process N is 1.
    """
    from gym_craftingworld_tpu_torch.core import slots as sm
    from gym_craftingworld_tpu_torch.core.rollout import rollout
    from gym_craftingworld_tpu_torch.parallel import sharded_engine as se

    full = make_env_mesh(device=device)
    n_max = full.size
    report = {}
    for engine in engines:
        rates = {}
        for n in sorted({1, n_max}):
            mesh = make_env_mesh(1, device) if n == 1 else full
            B = batch_per_device * n
            if engine == "grid":
                state = reset_sharded(cfg, 0, B, mesh)

                def run(state=state, mesh=mesh, B=B):
                    actions = randint_cols(prng_key(1), (num_steps, B), 0, 6, mesh.cols(B),
                                           mesh.device)
                    rollout(cfg, state, actions)

            elif engine == "packed_scan":
                slots = sm.from_env_state(reset_sharded(cfg, 0, B, mesh))
                actions = randint_cols(prng_key(2), (num_steps, B), 0, 6, device=mesh.device)

                def run(slots=slots, actions=actions, mesh=mesh):
                    se.rollout_p_sharded(cfg, slots, actions, num_steps, mesh)

            elif engine == "fused":
                slots = sm.from_env_state(reset_sharded(cfg, 0, B, mesh))

                def run(slots=slots, mesh=mesh):
                    se.fused_rollout_packed_bench_sharded(cfg, slots, 3, num_steps, mesh=mesh)

            else:
                raise ValueError(f"unknown engine {engine!r}")
            ms = torch.tensor(time_ms(run, iters, mesh.device), device=mesh.device)
            ms = float(mesh.all_reduce(ms, op=dist.ReduceOp.MAX))
            rates[n] = B * num_steps / (ms / 1e3)
        report[engine] = {"n1": rates[1], f"n{n_max}": rates[n_max], "devices": n_max,
                          "efficiency": rates[n_max] / (n_max * rates[1])}
    return report


def sum_over_ranks(mesh: EnvMesh | None, *dicts):
    """Each dict of tensors summed over the ranks, in one flat ``all_reduce``
    (the dicts as they are in one process)."""
    if mesh is None or mesh.group is None:
        return dicts
    items = [(i, k, v) for i, d in enumerate(dicts) for k, v in d.items()]
    flat = mesh.all_reduce(torch.cat([v.reshape(-1).to(torch.float32) for _, _, v in items]))
    out, at = [{} for _ in dicts], 0
    for i, k, v in items:
        out[i][k] = flat[at: at + v.numel()].view(v.shape).to(v.dtype)
        at += v.numel()
    return tuple(out)
