"""Checkpoints of the whole training system, with ``torch.save``.

Counterpart of ``gym_craftingworld_tpu/train/checkpoint.py`` (Orbax there).
A checkpoint holds the learner's parameters and optimizer state, the env
batch, the key data int64[2] of JAX's key chain (as JAX's ``_as_ckpt``
stores ``key_data``: every draw of the run comes from it) and the update
index, so a run resumes bit-identically: its continuation is the same
function of the same inputs.

A checkpoint is a directory. Under a mesh every rank writes its own columns
of the env batch (``env.rank<r>.pt``); then rank 0 writes the shared state
(``state.pt``) last, so a directory with ``state.pt`` is whole. Each file is
written to a temporary name and renamed into place, so a run killed while
it saves leaves its last whole checkpoint as it was. The files load with
``torch.load(weights_only=True)``. An Orbax checkpoint of the JAX package
cannot be read here; ``interop.ppo_train_state_from_numpy`` carries a JAX
train state across instead.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.ops.packed_rollout import PackedState
from gym_craftingworld_tpu_torch.train.fast_ppo import AdamState

STATE_FILE = "state.pt"
_ENV_KINDS = {"EnvState": (EnvState, 0), "PackedState": (PackedState, -1)}  # type, batch axis


def _env_file(rank: int) -> str:
    return f"env.rank{rank}.pt"


def _save_atomic(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _env_fields(env_state) -> dict:
    if dataclasses.is_dataclass(env_state):
        return {f.name: getattr(env_state, f.name) for f in dataclasses.fields(env_state)}
    return env_state._asdict()


def save(path: str, ts, env_state, key: torch.Tensor, step: int, mesh=None) -> None:
    """Checkpoint ``ts`` (a trainer state: ``params`` module, ``AdamState``,
    ``update_idx``), this rank's ``env_state`` (``EnvState`` or
    ``PackedState``), the key data ``key`` and ``step`` into directory
    ``path``. Under a mesh every rank calls it."""
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    os.makedirs(path, exist_ok=True)
    _save_atomic({"kind": type(env_state).__name__,
                  "fields": {k: v.detach() for k, v in _env_fields(env_state).items()}},
                 os.path.join(path, _env_file(rank)))
    if mesh is not None:  # every shard is on disk before the shared state marks the whole
        mesh.all_reduce(torch.zeros(1, device=mesh.device))
    if rank == 0:
        opt = ts.opt_state
        _save_atomic({
            "params": {k: v.detach() for k, v in ts.params.state_dict().items()},
            "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu},
            "update_idx": int(ts.update_idx),
            "key": key.detach().cpu(),
            "step": int(step),
            "world": world,
        }, os.path.join(path, STATE_FILE))
    if mesh is not None:
        mesh.all_reduce(torch.zeros(1, device=mesh.device))


def restore(path: str, ts, device, mesh=None):
    """Load checkpoint ``path`` into ``ts``'s parameter module (in place);
    returns (ts, env_state, key, step) with this rank's columns of the env
    batch and the key data on ``device``. The batch is reassembled from the
    shards of the run that saved it, which may have had other ranks."""
    device = torch.device(device)
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    shards = [torch.load(os.path.join(path, _env_file(r)), map_location="cpu", weights_only=True)
              for r in range(state["world"])]
    cls, dim = _ENV_KINDS[shards[0]["kind"]]
    fields = {k: torch.cat([s["fields"][k] for s in shards], dim=dim) for k in shards[0]["fields"]}
    if mesh is not None:
        cols = mesh.cols(fields["step_num"].shape[-1])
        fields = {k: v.narrow(dim, cols.start, cols.stop - cols.start) for k, v in fields.items()}
    env_state = cls(**{k: v.to(device).contiguous() for k, v in fields.items()})
    ts.params.load_state_dict(state["params"])
    o = state["opt_state"]
    on = lambda d: {k: v.to(device) for k, v in d.items()}
    opt_state = AdamState(o["count"].to(device), on(o["mu"]), on(o["nu"]))
    return (type(ts)(ts.params, opt_state, state["update_idx"]), env_state,
            state["key"].to(device), state["step"])
