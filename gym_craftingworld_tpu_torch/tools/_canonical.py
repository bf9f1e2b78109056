"""What the canonical-training tools share.

The JAX package's ``tools/train_canonical.py`` and ``tools/targeted_dagger.py``
each carry their own copy of these; the port keeps one:

* ``CFG``, the canonical setting: 21x21, ``max_steps`` 300, stacked goals;
* ``log``, a timestamped line;
* ``pad_columns`` / ``fit`` / ``append_columns``: the device dataset in a
  buffer of fixed capacity, so that every training chunk samples from one set
  of tensors while DAgger grows it. A round that would overflow the buffer is
  truncated to the room left (``fit``), as the JAX tools truncate it before
  they append (``tools/train_canonical.py:190-192``);
* ``train_chunk`` and ``mixed_rows``: the row ids a chunk of SGD steps trains
  on, uniform below ``n_valid`` or with a share from the rows appended since
  ``fail_lo``, drawn from JAX's key data as the JAX tools draw them;
* saving and loading a policy's parameters as a torch ``state_dict``
  (``params_<tag>.pt``), where the JAX tools write a flax msgpack (and
  ``cpv_canonical`` an npz);
* ``Metrics``, the tools' JSON-lines records, and ``write_curve``, their
  evaluations in ``docs/canonical_curve.json``'s schema;
* ``relabel``: the scripted expert's labels of a DAgger round's rows, in
  several host processes once the rows are many.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.train import dagger
from gym_craftingworld_tpu_torch.train.demos import SnapDataset

REPO = Path(__file__).resolve().parents[2]
RUNS = REPO / "runs" / "torch"
DEMOS = RUNS / "demos_canonical.npz"

CFG = EnvConfig(height=21, width=21, max_steps=300, stacking=True)
RELABEL_WORKERS, RELABEL_SPLIT = 4, 20_000  # host processes of a large relabel
# a relabel in host processes raises past 120 s + 1 ms a row: a state takes
# 0.14-0.25 ms in one process, so a pool that overruns this has stalled
RELABEL_BASE_S, RELABEL_ROW_S = 120.0, 1e-3


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def pad_columns(snaps: SnapDataset, capacity: int, device) -> dict:
    """The dataset's device columns (``dagger.device_columns``) in buffers of
    ``capacity`` rows; rows past ``snaps.num_rows`` are zero."""
    cols = dagger.device_columns(snaps, device)
    n = snaps.num_rows
    assert n <= capacity, (n, capacity)
    data = {}
    for k, v in cols.items():
        data[k] = torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        data[k][:n] = v
    return data


def fit(labeled: SnapDataset, capacity: int, n_valid: int) -> SnapDataset:
    """``labeled`` cut to the ``capacity - n_valid`` rows the buffer has left."""
    if n_valid + labeled.num_rows > capacity:
        labeled = SnapDataset(*[a[: capacity - n_valid] for a in labeled])
    return labeled


def append_columns(data: dict, labeled: SnapDataset, n_valid: int) -> int:
    """Write ``labeled``'s rows after the ``n_valid`` in use; the new count.
    The rows must fit (``fit``)."""
    m = labeled.num_rows
    capacity = next(iter(data.values())).shape[0]
    if n_valid + m > capacity:
        raise ValueError(f"{m} rows after {n_valid} overflow the capacity {capacity}; fit() first")
    new = dagger.device_columns(labeled, next(iter(data.values())).device)
    for k in data:
        data[k][n_valid:n_valid + m] = new[k].to(data[k].dtype)
    return n_valid + m


def train_chunk(cfg: EnvConfig, ts: dagger.BCTrainState, data: dict, n_valid: int, steps: int,
                batch: int, lr: float, key: torch.Tensor):
    """``steps`` SGD steps on the rows ``randint(key, (steps * batch,), 0,
    n_valid)``, on the key's device; (ts, {"loss", "accuracy"} as floats)."""
    idx = kd.randint(key, (steps * batch,), 0, n_valid)
    ts, stats = dagger._bc_epoch(cfg, lr, ts, data, idx, batch)
    return ts, {k: float(v) for k, v in stats.items()}


def mixed_rows(n: int, n_valid: int, fail_lo: int, frac_fail: float,
               key: torch.Tensor) -> torch.Tensor:
    """``n`` row ids: each from the rows ``[fail_lo, n_valid)`` with chance
    ``frac_fail``, else uniform below ``n_valid`` (uniform when no row lies
    past ``fail_lo`` or ``frac_fail`` is 0). As JAX draws them: ``k1, k2, k3
    = split(key, 3)``, then ``randint(k1)``, ``randint(k2)``, ``uniform(k3)``."""
    k1, k2, k3 = kd.split_keys(key, 3)
    uni = kd.randint(k1, (n,), 0, n_valid)
    if fail_lo < n_valid and frac_fail > 0:
        fail = kd.randint(k2, (n,), fail_lo, n_valid)
        pick = kd.uniform_cols(k3, (1, n))[0] < frac_fail
        return torch.where(pick, fail, uni)
    return uni


def mixed_train_chunk(cfg: EnvConfig, ts: dagger.BCTrainState, data: dict, n_valid: int,
                      fail_lo: int, steps: int, batch: int, lr: float, frac_fail: float,
                      key: torch.Tensor):
    """SGD steps with ``frac_fail`` of each batch from the failure rows."""
    idx = mixed_rows(steps * batch, n_valid, fail_lo, frac_fail, key)
    ts, stats = dagger._bc_epoch(cfg, lr, ts, data, idx, batch)
    return ts, {k: float(v) for k, v in stats.items()}


def save_params(model: torch.nn.Module, out: Path, tag: str | None) -> Path:
    """``model``'s ``state_dict`` as ``params_<tag>.pt`` under ``out``
    (``params.pt`` with no tag)."""
    path = Path(out) / (f"params_{tag}.pt" if tag else "params.pt")
    torch.save(model.state_dict(), path)
    return path


def load_params(model: torch.nn.Module, path) -> torch.nn.Module:
    """``model`` with the parameters saved at ``path``, on its own device."""
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=device, weights_only=True))
    return model


class Metrics:
    """A JSON-lines file opened for appending; every record gets ``t`` (host
    clock) and the card."""

    def __init__(self, path: Path, card: str):
        self.card = card
        self.file = open(path, "a")

    def emit(self, rec: dict) -> None:
        rec["t"] = time.time()
        rec["card"] = self.card
        self.file.write(json.dumps(rec) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


CURVE_KEYS = ("tag", "success_rate", "episodes", "mean_episode_steps")


def write_curve(metrics: Path, out: Path) -> list:
    """Every evaluation record of ``metrics`` (a ``metrics.jsonl``, all the runs
    appended to it), in ``docs/canonical_curve.json``'s schema, each with its
    card; written to ``out``."""
    recs = [json.loads(line) for line in Path(metrics).read_text().splitlines()]
    curve = [{k: r[k] for k in CURVE_KEYS + ("card",)} for r in recs if r["phase"] == "eval"]
    Path(out).write_text(json.dumps(curve, indent=1) + "\n")
    return curve


def shown(path) -> str:
    """``path`` as a record names it: relative to the checkout when inside it."""
    p = Path(path).resolve()
    return str(p.relative_to(REPO)) if p.is_relative_to(REPO) else str(path)


def seconds_since(t0: float, device) -> float:
    """Host seconds since ``t0``, after the card has finished its queue."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def relabel(cfg: EnvConfig, host: dict, workers: int | None = None) -> SnapDataset:
    """``dagger.expert_relabel`` of the rows ``host``, in ``workers`` host
    processes, a contiguous chunk each (by default ``RELABEL_WORKERS``, at
    most the host's cores, once there are ``RELABEL_SPLIT`` rows, else one).
    They are spawned, not forked, so none inherits the card's context, and
    label with numpy only. The expert's action depends only on the row it
    labels, so the labels are the same. A pool that has not returned within
    ``RELABEL_BASE_S`` + ``RELABEL_ROW_S`` a row is stopped and raises
    ``multiprocessing.TimeoutError``."""
    n = len(host["agent_key"])
    if workers is None:
        workers = min(RELABEL_WORKERS, os.cpu_count() or 1) if n >= RELABEL_SPLIT else 1
    if workers <= 1 or n < 2:
        return dagger.expert_relabel(cfg, host)
    import multiprocessing

    cuts = np.linspace(0, n, workers + 1).astype(int)
    chunks = [(cfg, {k: v[lo:hi] for k, v in host.items()}) for lo, hi in zip(cuts[:-1], cuts[1:])]
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        parts = pool.starmap_async(dagger.expert_relabel, chunks).get(
            RELABEL_BASE_S + RELABEL_ROW_S * n)
    return SnapDataset(*[np.concatenate(cols) for cols in zip(*parts)])
