"""CPV compositional matrix at the canonical scale: 21x21, all pairs and triples.

Counterpart of the JAX package's ``tools/cpv_canonical.py``, which writes
``docs/cpv_matrix.json``: train one ``CPVGridPolicy`` (goal only through the
residual plan vector, the Plan-Arithmetic construction of reference
README.md:8) on single-task expert data, then measure zero-shot stacked
execution over every single (9), unordered pair (36) and triple (84), one
episode per fixed-pool world per cell.

Protocol, as in JAX:
  * a fixed world pool shared between training and evaluation (the
    train/test novelty is the task composition);
  * training data = single-task episodes + handoff episodes (one task from a
    world whose lower-rank predecessors are pre-applied, agent position and
    held tool randomized; ``tools/_cpv.apply_predecessors_np``) +
    pending-bit relabels + on-policy DAgger over the same single-task
    handoff episodes (policy actions, expert labels). No trajectory ever
    completes more than one task.

The pool is JAX's: ``core/reset.generate_pool`` of ``PRNGKey(--seed)`` draws
the JAX tool's worlds bit for bit (``--pool-npz`` reads a pool from a file,
``load_pool``). What differs from JAX: the rollouts are eager loops that freeze finished episodes
(``train/dagger._rollout_states``, ``_eval_batch_grid``), whose ``sample``
draws are Gumbel noise and ``argmax_eps`` draws uniforms and moves from a
``torch.Generator`` seeded as JAX seeds its keys; parameters are saved as
``<save-params>/params.pt`` (a torch ``state_dict``) in place of flax's
``params.npz``; a large DAgger relabel runs in several host processes
(``relabel``, the same labels); the JSON goes to ``--out`` with the card
added; ``--smoke`` runs on the CPU, and options after it override its
settings.

Resume points, the port's own (a run on the card is cut into calls with a
time limit): ``<save-params>/phase1.npz`` caches phase 1 as JAX's does;
after each DAgger round the parameters, the Adam state, the aggregate and
the host RandomState's state go to ``resume.pt`` and ``aggregate.npz``, and
``--resume`` carries on from the last round saved, equal to an unbroken
run; ``--matrix-only`` evaluates ``params.pt`` (phase 4 alone).

    python -m gym_craftingworld_tpu_torch.tools.cpv_canonical               # on the card
    python -m gym_craftingworld_tpu_torch.tools.cpv_canonical --smoke       # tiny, CPU
    python -m gym_craftingworld_tpu_torch.tools.cpv_canonical --resume      # after a cut
    python -m gym_craftingworld_tpu_torch.tools.cpv_canonical --matrix-only
    python -m gym_craftingworld_tpu_torch.tools.cpv_canonical \
        --pool-npz gym_craftingworld_tpu_torch/tools/records/cpv_pool_jax_seed7.npz  # a saved pool
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig, ray_config
from gym_craftingworld_tpu_torch.core.reset import generate_pool
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.models.cpv import init_cpv_grid
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools._canonical import (REPO, RUNS, load_params, log, relabel,
                                                          save_params, seconds_since)
from gym_craftingworld_tpu_torch.tools._cpv import RANK, apply_predecessors_np, failure_kind
from gym_craftingworld_tpu_torch.train import dagger
from gym_craftingworld_tpu_torch.train.demos import NumpyExpert, SnapDataset, collect_batch
from gym_craftingworld_tpu_torch.train.fast_ppo import AdamState
from gym_craftingworld_tpu_torch.utils.profiling import card_identity

OUT = RUNS / "cpv_matrix.json"
SAVE = RUNS / "cpv_canonical"
PAIRS = list(itertools.combinations(range(C.N_TASKS), 2))
TRIPLES = list(itertools.combinations(range(C.N_TASKS), 3))
SMOKE_TRIPLES = [(0, 1, 2)]  # --smoke evaluates one triple
SMOKE = ["--pool", "8", "--singles-per-task", "2", "--handoff-episodes", "8", "--bc-epochs", "1",
         "--dagger-rounds", "1", "--dagger-episodes", "4", "--dagger-epochs", "1",
         "--cell-episodes", "4", "--channels", "8", "--hidden", "32", "--batch", "64",
         "--device", "cpu", "--out", str(RUNS / "cpv_smoke.json"),
         "--save-params", str(RUNS / "cpv_smoke")]


# ---------------------------------------------------------------------------
# start states: pool worlds + optional pre-applied predecessors
# ---------------------------------------------------------------------------


def make_pool(cfg: EnvConfig, seed: int, n: int, device="cuda"):
    """``n`` pool worlds of ``generate_pool(cfg, PRNGKey(seed), n)`` on
    ``device`` (JAX's worlds, as ``tools/cpv_canonical.py:116`` draws them),
    as numpy (objects int8[n, H, W], agent int32[n, 2])."""
    objects, agent = generate_pool(cfg, prng_key(seed), n, device)
    return objects.cpu().numpy(), agent.cpu().numpy().astype(np.int32)


def load_pool(path, n: int):
    """A pool saved as npz (``objects`` int8[n, H, W], ``agent`` int32[n, 2]),
    such as ``tools/records/cpv_pool_jax_seed7.npz``, the JAX tool's
    ``make_pool(ray_config(), 7, 256)``; it must hold ``n`` worlds."""
    with np.load(path) as z:
        objects, agent = z["objects"], z["agent"]
    if len(objects) != n or len(agent) != n:
        raise ValueError(f"{path} holds {len(objects)} worlds, not --pool {n}")
    return objects.astype(np.int8), agent.astype(np.int32)


def build_start_states(cfg: EnvConfig, pool_objects, pool_agent, widx, pending, preds, rng,
                       device="cuda"):
    """Host-built EnvState batch on ``device``: world ``widx[b]``, desired =
    ``preds[b]`` ∪ {``pending[b]``}, achieved = ``preds[b]``'s bits,
    predecessors pre-applied. ``preds[b]`` is a rank-sorted list (possibly
    empty). Returns (EnvState, task per env int32[B])."""
    B = len(widx)
    objects = pool_objects[widx].copy()  # int8[B, H, W]
    agents = pool_agent[widx].copy()  # int32[B, 2]
    holding = np.zeros(B, np.int32)
    desired = np.zeros((B, C.N_TASKS), np.int8)
    achieved = np.zeros((B, C.N_TASKS), np.int8)
    init_objects = objects.copy()
    for b in range(B):
        r, c = agents[b]
        init_objects[b, r, c] = C.AGENT_INIT_MARK
        ok, ag, hold = apply_predecessors_np(
            objects[b], achieved[b], (int(r), int(c)), 0, preds[b], rng
        )
        assert ok, (widx[b], preds[b])
        agents[b] = ag
        holding[b] = hold
        desired[b, list(preds[b]) + [int(pending[b])]] = 1
    # JAX draws the states' key here; the port's EnvState.rng is never read,
    # but the draw keeps this RandomState's later batches equal to JAX's
    rng.randint(2**31)

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    i8, i32 = torch.int8, torch.int32
    return EnvState(
        objects=dev(objects, i8),
        agent=dev(agents, i32),
        holding=dev(holding, i32),
        desired=dev(desired, i8),
        achieved=dev(achieved, i8),
        init_objects=dev(init_objects, i8),
        init_agent=dev(pool_agent[widx], i32),
        goal_objects=dev(init_objects, i8),
        goal_agent=dev(agents, i32),
        step_num=torch.zeros(B, dtype=i32, device=device),
        rng=torch.zeros((B, 2), dtype=torch.int64, device=device),
    ), np.asarray(pending, np.int32)


def draw_handoff_batch(cfg: EnvConfig, pool_objects, pool_agent, B, rng, max_preds=2,
                       task_weights=None, device="cuda"):
    """Random (world, pending task, rank-lower predecessor set) batch.

    Predecessors are drawn uniformly half the time and from the adjacent
    lower ranks half the time: the hard compositions are exactly
    adjacent-rank pairs (GoToHouse with the tool-Move tasks just below it,
    EatBread with MakeBread), which uniform draws under-sample 7:1.
    """
    P = len(pool_objects)
    widx = rng.randint(P, size=B)
    if task_weights is None:
        pending = rng.randint(C.N_TASKS, size=B)
    else:
        pending = rng.choice(C.N_TASKS, size=B, p=task_weights)
    preds = []
    for b in range(B):
        lower = [t for t in range(C.N_TASKS) if RANK[t] < RANK[pending[b]]]
        lower.sort(key=lambda t: RANK[t])
        k = rng.randint(0, min(max_preds, len(lower)) + 1)
        if k and rng.rand() < 0.5:
            S = lower[-k:]  # the k adjacent lower ranks
        else:
            S = rng.choice(lower, k, replace=False).tolist() if k else []
        preds.append(sorted(S, key=lambda t: RANK[t]))
    return build_start_states(cfg, pool_objects, pool_agent, widx, pending, preds, rng, device)


# ---------------------------------------------------------------------------
# expert data
# ---------------------------------------------------------------------------


def collect_expert_from(cfg: EnvConfig, state: EnvState, tasks, seed, noise_eps=0.05,
                        only_successful=True):
    """Expert episodes from a prepared start-state batch -> (SnapDataset,
    task per row, expert success rate): one lockstep batch of
    ``train/demos.collect_batch``, noise from ``RandomState(seed ^ 0x5EED)``."""
    B = state.objects.shape[0]
    wrng = np.random.RandomState(seed ^ 0x5EED)
    snaps, b_idx, success = collect_batch(cfg, state, wrng, [NumpyExpert() for _ in range(B)],
                                          noise_eps, only_successful)
    return snaps, np.asarray(tasks)[b_idx], float(success.mean())


def augment_pending(snaps: SnapDataset, tasks, seed):
    """Row copies with 1-2 higher-rank pending bits added to desired: the
    relabel for "act on the current task while later tasks are pending"
    (latching makes the expert's action independent of pending bits). Half
    the rows take the adjacent higher ranks, half draw uniformly."""
    rng = np.random.RandomState(seed)
    desired = snaps.desired.copy().astype(np.int64)
    keep = np.zeros(len(tasks), bool)
    for r, j in enumerate(tasks):
        higher = [t for t in range(C.N_TASKS)
                  if RANK[t] > RANK[j] and not (desired[r] >> t) & 1]
        if not higher:
            continue
        higher.sort(key=lambda t: RANK[t])
        k = 1 + rng.randint(min(2, len(higher)))
        if rng.rand() < 0.5:
            chosen = higher[:k]  # the k adjacent higher ranks
        else:
            chosen = rng.choice(higher, k, replace=False)
        for t in chosen:
            desired[r] |= 1 << int(t)
        keep[r] = True
    out = snaps._replace(desired=desired.astype(snaps.desired.dtype))
    return SnapDataset(*[np.asarray(col)[keep] for col in out])


def save_phase1(path: Path, data: SnapDataset, tasks) -> None:
    """Phase 1's cache in JAX's layout: the ``SnapDataset`` columns and
    ``tasks``, one array each."""
    np.savez(path, tasks=tasks, **data._asdict())


def load_phase1(path: Path):
    with np.load(path) as z:
        return SnapDataset(**{f: z[f] for f in SnapDataset._fields}), z["tasks"]


# ---------------------------------------------------------------------------
# on-policy rollouts from given start states (DAgger + evaluation)
# ---------------------------------------------------------------------------


def mode_draws(mode: str, T: int, B: int, generator: torch.Generator):
    """The draws ``(explore_u, explore_a, explore_eps, noise)`` of a rollout
    in ``mode``, the last four arguments of ``dagger._rollout_states``:

    * ``argmax``, greedy: none;
    * ``sample``, a draw from the policy's softmax (BC from a multi-modal
      expert leaves near-ties whose argmax can limit-cycle): Gumbel noise
      f32[T, B, A];
    * ``argmax_eps``, greedy with 5% random moves, DAgger's rollouts (greedy
      execution visits the limit-cycle states the argmax evaluation fails
      on, and the random moves kick it off the orbit): uniforms f32[T, B]
      and moves int[T, B] in 0..3.
    """
    dev = generator.device
    if mode == "argmax_eps":
        return (torch.rand((T, B), generator=generator, device=dev),
                torch.randint(0, 4, (T, B), generator=generator, device=dev), 0.05, None)
    if mode not in ("argmax", "sample"):
        raise ValueError(f"unknown mode {mode!r}")
    noise = dagger.gumbel((T, B, C.N_ACTIONS), generator) if mode == "sample" else None
    return (torch.zeros((T, B), device=dev), torch.zeros((T, B), dtype=torch.int64, device=dev),
            0.0, noise)


def _success_from(cfg: EnvConfig, model, state: EnvState, mode: str, generator: torch.Generator):
    """Evaluation-only rollout; returns (success [B], achieved [B, 9])."""
    noise = (dagger.gumbel((cfg.max_steps, state.objects.shape[0], C.N_ACTIONS), generator)
             if mode == "sample" else None)
    out = dagger._eval_batch_grid(cfg, model, state, noise)
    return out["success"], out["achieved"]


def salvageable(cols: dict, live: np.ndarray, tasks):
    """The live rows of [T, B] host columns with no undesired latched bit
    (``dagger._LATCH_MASK``), flattened; returns (rows by column, task per row)."""
    ach = cols["achieved"].astype(np.int64)
    des = cols["desired"].astype(np.int64)
    sel = (live & ((ach & ~des & dagger._LATCH_MASK) == 0)).reshape(-1)
    host = {k: v.reshape((-1,) + v.shape[2:])[sel] for k, v in cols.items()}
    task_rows = np.broadcast_to(np.asarray(tasks)[None, :], live.shape).reshape(-1)[sel]
    return host, task_rows


def dagger_collect(cfg: EnvConfig, model, state: EnvState, tasks, seed, mode="argmax_eps"):
    """Policy rollout from handoff starts (draws from a generator seeded
    ``seed``); expert labels on every salvageable live state, in
    ``_canonical.RELABEL_WORKERS`` host processes once there are
    ``RELABEL_SPLIT`` rows (``relabel``). Returns (labelled SnapDataset, task per row, policy
    success rate)."""
    gen = torch.Generator(device=state.objects.device).manual_seed(seed)
    cols, live, success = dagger._rollout_states(
        cfg, model, state, *mode_draws(mode, cfg.max_steps, state.objects.shape[0], gen))
    host, task_rows = salvageable({k: v.cpu().numpy() for k, v in cols.items()},
                                  live.cpu().numpy(), tasks)
    return relabel(cfg, host), task_rows, float(success.float().mean())


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------


def cell_state(cfg: EnvConfig, pool_objects, pool_agent, task_set, seed, episodes, device):
    """A cell's start states: one episode per pool world (cycled if episodes
    > pool), desired = exactly the cell's task bits, fresh start."""
    widx = np.arange(episodes) % len(pool_objects)
    rng = np.random.RandomState(seed)
    pending = [max(task_set, key=lambda t: RANK[t])] * episodes
    preds = [[]] * episodes
    state, _ = build_start_states(cfg, pool_objects, pool_agent, widx, pending, preds, rng,
                                  device)
    des = np.zeros((episodes, C.N_TASKS), np.int8)
    des[:, list(task_set)] = 1
    return dataclasses.replace(state, desired=torch.from_numpy(des).to(device))


def eval_cell(cfg: EnvConfig, model, pool_objects, pool_agent, task_set, seed, episodes):
    """A cell's {"argmax", "sample"} success rates over ``cell_state``; the
    sampled draws from a generator seeded ``seed + 17``."""
    dev = next(model.parameters()).device
    state = cell_state(cfg, pool_objects, pool_agent, task_set, seed, episodes, dev)
    out = {}
    for mode in ("argmax", "sample"):
        succ, _ = _success_from(cfg, model, state, mode,
                                torch.Generator(device=dev).manual_seed(seed + 17))
        out[mode] = float(succ.float().mean())
    return out


def cell_seed(seed: int, task_set) -> int:
    """The seed of a cell's evaluation, as JAX's matrix numbers them."""
    if len(task_set) == 1:
        return seed + 7001 + task_set[0]
    if len(task_set) == 2:
        return seed + 8001 + 10 * task_set[0] + task_set[1]
    return seed + 9001 + sum(10**k * t for k, t in enumerate(task_set))


def trace_cell(cfg: EnvConfig, model, pool_objects, pool_agent, task_set, seed, episodes):
    """Why a cell's episodes fail, in the classes of JAX's
    ``tools/cpv_debug.py``: the cell's episodes replayed as ``eval_cell``
    rolls them (the same start states and draws, so the same successes),
    each failure counted by ``_cpv.failure_kind`` as ``wrong_latch`` (an
    undesired latching bit set: unrecoverable), else ``stall`` (its last 12
    states take at most 4 distinct values: a limit cycle until timeout),
    else ``timeout``; and, by task, the desired bits missing and the
    undesired bits set at its last state. Returns {mode: counts}."""
    dev = next(model.parameters()).device
    state = cell_state(cfg, pool_objects, pool_agent, task_set, seed, episodes, dev)
    names = list(C.TASK_LIST)
    out = {}
    for mode in ("argmax", "sample"):
        gen = torch.Generator(device=dev).manual_seed(seed + 17)
        cols, live, success = dagger._rollout_states(
            cfg, model, state, *mode_draws(mode, cfg.max_steps, episodes, gen))
        cols = {k: v.cpu().numpy() for k, v in cols.items()}
        live, success = live.cpu().numpy(), success.cpu().numpy()
        ach, des = cols["achieved"].astype(np.int64), cols["desired"].astype(np.int64)
        state_cols = ("occ_key", "occ_code", "agent_key", "holding", "achieved")
        rows = np.concatenate([cols[k].reshape(live.shape + (-1,)).astype(np.int64)
                               for k in state_cols], axis=-1)  # [T, B, state]
        rec = {"success": float(success.mean()), "wrong_latch": 0, "stall": 0, "timeout": 0,
               "missing": {}, "undesired": {}}
        for b in np.flatnonzero(~success):
            n = int(live[:, b].sum())
            kind = failure_kind(((ach[:n, b] & ~des[:n, b] & dagger._LATCH_MASK) != 0).any(),
                                (r.tobytes() for r in rows[:n, b]))
            rec[kind] += 1
            for key, bits in (("missing", des[n - 1, b] & ~ach[n - 1, b]),
                              ("undesired", ach[n - 1, b] & ~des[n - 1, b])):
                for t in range(C.N_TASKS):
                    if bits >> t & 1:
                        rec[key][names[t]] = rec[key].get(names[t], 0) + 1
        out[mode] = rec
    return out


def matrix(cfg: EnvConfig, model, pool_objects, pool_agent, args, pairs, triples) -> dict:
    """Phase 4: every single, the ``pairs`` and the ``triples``, in JAX's schema."""
    names = list(C.TASK_LIST)
    results = {
        "config": {
            "grid": f"{cfg.height}x{cfg.width}", "max_steps": cfg.max_steps,
            "world_pool": args.pool, "cell_episodes": args.cell_episodes,
            "singles_per_task": args.singles_per_task,
            "handoff_episodes": args.handoff_episodes,
            "dagger_rounds": args.dagger_rounds,
            "dagger_episodes": args.dagger_episodes,
            "model": f"CPVGridPolicy(channels={args.channels}, "
                     f"hidden={args.hidden}) — goal via residual plan "
                     f"vector only",
            "protocol": (
                "fixed world pool shared between training and evaluation "
                "(paper-style fixed env set); evaluation rolls one episode "
                "per pool world per cell with desired = exactly the cell's "
                "task bits. Training data = single-task expert episodes + "
                "handoff episodes (one task executed from a world whose "
                "lower-rank predecessors are pre-applied; agent position / "
                "held tool randomized) + pending-bit relabels + on-policy "
                "DAgger over the same single-task handoff episodes (policy "
                "actions, expert labels); no trajectory ever completes more "
                "than one task — the composition itself is never "
                "demonstrated"
            ),
        },
        "execution": (
            "headline pairs/triples execute the policy's own softmax "
            "distribution ('sample'); argmax recorded alongside — BC from a "
            "multi-modal expert leaves near-ties whose argmax limit-cycles"
        ),
        "singles": {}, "singles_argmax": {},
        "pairs": {}, "pairs_argmax": {},
        "triples": {}, "triples_argmax": {},
    }

    def cell(kind, key, task_set, seed):
        r = eval_cell(cfg, model, pool_objects, pool_agent, task_set, seed, args.cell_episodes)
        results[kind][key] = r["sample"]
        results[kind + "_argmax"][key] = r["argmax"]
        log(f"{kind[:-1]} {key}: {r['sample']:.3f} sampled / {r['argmax']:.3f} argmax")

    for j, name in enumerate(names):
        cell("singles", name, (j,), cell_seed(args.seed, (j,)))
    for pair in pairs:
        cell("pairs", "+".join(names[t] for t in pair), pair, cell_seed(args.seed, pair))
    for tri in triples:
        cell("triples", "+".join(names[t] for t in tri), tri, cell_seed(args.seed, tri))
    for kind in ("pairs", "triples"):
        for suffix in ("", "_argmax"):
            vals = list(results[kind + suffix].values())
            if vals:
                results[f"{kind[:-1]}_mean{suffix}"] = float(np.mean(vals))
                results[f"{kind[:-1]}_min{suffix}"] = float(np.min(vals))
    return results


# ---------------------------------------------------------------------------
# the record against JAX's
# ---------------------------------------------------------------------------

JAX_RECORD = REPO / "docs" / "cpv_matrix.json"
# the bars of docs/round5.md:30-32 and JAX's record: (key, least value)
BOUNDS = (("pair_mean", 0.85), ("pair_min", 0.50), ("triple_mean", 0.70),
          ("cell_min", 0.25), ("single_min", 0.90))


def compare_with_jax(doc: dict, jax_doc: dict) -> dict:
    """A matrix ``doc`` (this tool's JSON) beside JAX's record: each bound
    of ``BOUNDS`` on the sampled matrix (``cell_min`` over pairs and
    triples), held or missed; each shared cell's difference (port - JAX) in
    both modes; the 10 lowest sampled cells of each; the 10 cells most below
    and most above JAX's."""
    def cells(d, suffix=""):
        return {**d["pairs" + suffix], **d["triples" + suffix]}

    got = {"pair_mean": doc["pair_mean"], "pair_min": doc["pair_min"],
           "triple_mean": doc.get("triple_mean"), "cell_min": min(cells(doc).values()),
           "single_min": min(doc["singles"].values())}
    out = {"bounds": {k: {"value": got[k], "bound": b, "jax": (
        min(cells(jax_doc).values()) if k == "cell_min" else min(jax_doc["singles"].values())
        if k == "single_min" else jax_doc[k]), "held": got[k] is not None and got[k] >= b}
        for k, b in BOUNDS}}
    for suffix in ("", "_argmax"):
        mine, theirs = cells(doc, suffix), cells(jax_doc, suffix)
        diff = {k: mine[k] - theirs[k] for k in mine if k in theirs}
        mode = suffix.strip("_") or "sampled"
        out[mode] = {
            "diff": diff,
            "mean_diff": float(np.mean(list(diff.values()))),
            "lowest": sorted(mine.items(), key=lambda kv: kv[1])[:10],
            "jax_lowest": sorted(theirs.items(), key=lambda kv: kv[1])[:10],
            "most_below_jax": sorted(diff.items(), key=lambda kv: kv[1])[:10],
            "most_above_jax": sorted(diff.items(), key=lambda kv: -kv[1])[:10]}
    return out


# ---------------------------------------------------------------------------
# resume points
# ---------------------------------------------------------------------------


def save_round(out: Path, r: int, ts: dagger.BCTrainState, data: SnapDataset,
               rng: np.random.RandomState) -> None:
    """After DAgger round ``r``: the aggregate and the RandomState's state
    (``aggregate.npz``), then the parameters and the Adam state
    (``resume.pt``), each written whole before it replaces the last."""
    _, key, pos, has_gauss, gauss = rng.get_state()
    tmp = out / "aggregate.tmp.npz"
    np.savez(tmp, round=r, rng_key=key, rng_pos=pos, rng_has_gauss=has_gauss, rng_gauss=gauss,
             **data._asdict())
    os.replace(tmp, out / "aggregate.npz")
    opt = ts.opt_state
    torch.save({"round": r, "params": ts.params.state_dict(), "count": opt.count,
                "mu": opt.mu, "nu": opt.nu}, out / "resume.tmp.pt")
    os.replace(out / "resume.tmp.pt", out / "resume.pt")


def load_round(out: Path, model: torch.nn.Module):
    """The state ``save_round`` left: (round, BCTrainState over ``model``,
    aggregate, RandomState)."""
    dev = next(model.parameters()).device
    saved = torch.load(out / "resume.pt", map_location=dev, weights_only=True)
    model.load_state_dict(saved["params"])
    with np.load(out / "aggregate.npz") as z:
        if int(z["round"]) != saved["round"]:
            raise ValueError(f"{out}: aggregate.npz is of round {int(z['round'])}, resume.pt "
                             f"of round {saved['round']}")
        data = SnapDataset(**{f: z[f] for f in SnapDataset._fields})
        rng = np.random.RandomState()
        rng.set_state(("MT19937", z["rng_key"], int(z["rng_pos"]), int(z["rng_has_gauss"]),
                       float(z["rng_gauss"])))
    ts = dagger.BCTrainState(model, AdamState(saved["count"], saved["mu"], saved["nu"]))
    return saved["round"], ts, data, rng


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def main(argv=None, pairs=None, triples=None) -> dict:
    """Run the protocol; returns {"results" (the JSON written), "phase1"
    ((data, tasks) before the relabels, or None when not collected),
    "rounds" (rows a DAgger round added), "seconds" (host clock by phase)}.

    The matrix takes the 36 ``PAIRS`` and the 84 ``TRIPLES`` (one triple
    under ``--smoke``) unless ``pairs`` or ``triples`` name its cells.
    """
    argv = list(argv) if argv is not None else None
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--singles-per-task", type=int, default=512)
    ap.add_argument("--handoff-episodes", type=int, default=4096)
    ap.add_argument("--bc-epochs", type=int, default=16)
    ap.add_argument("--dagger-rounds", type=int, default=12)
    ap.add_argument("--dagger-episodes", type=int, default=3072)
    ap.add_argument("--dagger-epochs", type=int, default=3)
    ap.add_argument("--cell-episodes", type=int, default=256)
    ap.add_argument("--channels", type=int, default=96)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--pool-npz", default=None, metavar="NPZ",
                    help="the world pool from this file (load_pool) in place of make_pool's")
    ap.add_argument("--smoke", action="store_true", help="tiny 8x8 end-to-end check on the CPU")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--save-params", default=str(SAVE))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--matrix-only", action="store_true",
                    help="phase 4 alone, from <save-params>/params.pt")
    ap.add_argument("--resume", action="store_true",
                    help="carry on after the last DAgger round saved in <save-params>")
    ap.add_argument("--compare", default=None, metavar="JSON",
                    help="no run: this tool's JSON beside docs/cpv_matrix.json "
                         "(compare_with_jax), written as <name>_vs_jax.json")
    ap.add_argument("--trace", default="",
                    help="cells to trace after the matrix, e.g. MakeBread+ChopTree,GoToHouse "
                         "(trace_cell; written beside --out as <name>_trace.json)")
    args = ap.parse_args(argv)
    if args.compare:
        path = Path(args.compare)
        cmp = compare_with_jax(json.loads(path.read_text()), json.loads(JAX_RECORD.read_text()))
        path.with_name(path.stem + "_vs_jax.json").write_text(json.dumps(cmp, indent=1) + "\n")
        print(json.dumps(cmp["bounds"], indent=1))
        return {"compare": cmp}
    if args.smoke:  # JAX's tiny settings; options given after them override them
        args = ap.parse_args(SMOKE + (argv if argv is not None else sys.argv[1:]))
        cfg = EnvConfig(height=8, width=8, max_steps=60)
    else:
        cfg = ray_config()
    pairs = PAIRS if pairs is None else pairs
    if triples is None:
        triples = SMOKE_TRIPLES if args.smoke else TRIPLES
    dev = torch.device(args.device)
    card = card_identity(dev)
    save = Path(args.save_params) if args.save_params else None
    if save:
        save.mkdir(parents=True, exist_ok=True)
    names = list(C.TASK_LIST)
    seconds, rounds, phase1 = {}, [], None
    rng = np.random.RandomState(args.seed)
    if args.pool_npz:
        pool_objects, pool_agent = load_pool(args.pool_npz, args.pool)
    else:
        pool_objects, pool_agent = make_pool(cfg, args.seed, args.pool, dev)
    log(f"pool: {args.pool} worlds at {cfg.height}x{cfg.width} "
        f"({args.pool_npz or 'make_pool'}) on {card}")
    model = init_cpv_grid(torch.Generator(device=dev).manual_seed(args.seed + 1), cfg,
                          channels=args.channels, hidden=args.hidden)
    ts = dagger.init_bc_state(model)
    start = 0
    resume = args.resume and save and (save / "resume.pt").exists()

    if args.matrix_only:
        load_params(model, save / "params.pt")
        log(f"parameters loaded from {save / 'params.pt'}")
    elif resume:
        r, ts, data, rng = load_round(save, model)
        start = r + 1
        log(f"resumed after DAgger round {r}: {data.num_rows} rows")
    else:
        # ---- phase 1: expert data (singles + handoffs) -------------------------
        t0 = time.perf_counter()
        cache = save / "phase1.npz" if save else None
        if cache and cache.exists() and not args.smoke:
            data, tasks_all = load_phase1(cache)
            log(f"phase-1 data loaded from {cache}: {data.num_rows} rows")
        else:
            parts, part_tasks = [], []
            for j in range(C.N_TASKS):
                B = args.singles_per_task
                widx = np.arange(B) % args.pool
                state, tasks = build_start_states(cfg, pool_objects, pool_agent, widx, [j] * B,
                                                  [[]] * B, rng, dev)
                snaps, trows, sr = collect_expert_from(cfg, state, tasks, args.seed + j,
                                                       noise_eps=0.05)
                parts.append(snaps)
                part_tasks.append(trows)
                log(f"singles[{names[j]}]: {snaps.num_episodes} eps "
                    f"({snaps.num_rows} rows, expert sr {sr:.3f})")
            done_eps = 0
            while done_eps < args.handoff_episodes:
                B = min(512, args.handoff_episodes - done_eps)
                state, tasks = draw_handoff_batch(cfg, pool_objects, pool_agent, B, rng,
                                                  device=dev)
                snaps, trows, sr = collect_expert_from(cfg, state, tasks,
                                                       args.seed + 100 + done_eps, noise_eps=0.05)
                parts.append(snaps)
                part_tasks.append(trows)
                done_eps += B
                log(f"handoff {done_eps}/{args.handoff_episodes}: +{snaps.num_rows} "
                    f"rows (expert sr {sr:.3f})")
            data = SnapDataset.concat(*parts)
            tasks_all = np.concatenate(part_tasks)
            if cache and not args.smoke:
                save_phase1(cache, data, tasks_all)
                log(f"phase-1 data cached -> {cache}")
        phase1 = (data, tasks_all)
        aug = augment_pending(data, tasks_all, args.seed + 999)
        data = SnapDataset.concat(data, aug)
        seconds["expert"] = seconds_since(t0, dev)
        log(f"dataset: {data.num_rows} rows (incl. {aug.num_rows} pending relabels) in "
            f"{seconds['expert']:.0f}s")

        # ---- phase 2: BC ---------------------------------------------------------
        t0 = time.perf_counter()
        ts, _ = dagger.bc_train_snaps(
            cfg, data, torch.Generator(device=dev).manual_seed(args.seed + 2), state=ts,
            epochs=args.bc_epochs, batch_size=args.batch, lr=1e-3, log=log)
        seconds["bc"] = seconds_since(t0, dev)

    if not args.matrix_only:
        # ---- phase 3: DAgger over handoff starts -----------------------------------
        # pending draws weighted toward the non-latching / resource-conflict
        # tasks where limit cycles concentrate
        w = np.ones(C.N_TASKS)
        for t in (C.T_BUILD_HOUSE, C.T_MOVE_AXE, C.T_MOVE_HAMMER, C.T_MOVE_STICKS):
            w[t] = 3.0
        w[C.T_GO_TO_HOUSE] = 5.0  # the weak-cell common factor
        w[C.T_EAT_BREAD] = 2.0  # MakeBread+EatBread adjacency
        for r in range(start, args.dagger_rounds):
            t0 = time.perf_counter()
            state, tasks = draw_handoff_batch(cfg, pool_objects, pool_agent,
                                              args.dagger_episodes, rng,
                                              task_weights=w / w.sum(), device=dev)
            # alternate rollout modes: greedy+eps rounds correct the argmax limit
            # cycles; sampled rounds cover the softmax execution's distribution
            mode = "argmax_eps" if r % 2 == 0 else "sample"
            labeled, trows, sr = dagger_collect(cfg, ts.params, state, tasks,
                                                args.seed + 300 + r, mode=mode)
            aug = augment_pending(labeled, trows, args.seed + 600 + r)
            before = data.num_rows
            data = SnapDataset.concat(data, labeled, aug)
            t_collect = seconds_since(t0, dev)
            lr = 5e-4 if r < args.dagger_rounds // 2 else 3e-4
            t1 = time.perf_counter()
            ts, _ = dagger.bc_train_snaps(
                cfg, data, torch.Generator(device=dev).manual_seed(args.seed + 400 + r),
                state=ts, epochs=args.dagger_epochs, batch_size=args.batch, lr=lr, log=log)
            t_train = seconds_since(t1, dev)
            rounds.append({"round": r, "mode": mode, "policy_sr": sr, "rows_before": before,
                           "relabelled": labeled.num_rows, "augmented": aug.num_rows,
                           "rows_after": data.num_rows, "collect_s": t_collect,
                           "train_s": t_train})
            log(f"dagger {r} [{mode}]: policy sr {sr:.3f}, +{labeled.num_rows} rows "
                f"(+{aug.num_rows} relabels) -> {data.num_rows} (collect and relabel "
                f"{t_collect:.0f}s, train {t_train:.0f}s)")
            if save:
                save_round(save, r, ts, data, rng)
        if save:
            save_params(ts.params, save, None)

    # ---- phase 4: the matrix ----------------------------------------------------
    t0 = time.perf_counter()
    results = matrix(cfg, ts.params, pool_objects, pool_agent, args, pairs, triples)
    seconds["matrix"] = seconds_since(t0, dev)
    results = {"card": card, **results}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2, sort_keys=True) + "\n")
    log(f"pair mean {results.get('pair_mean', 0):.3f} min "
        f"{results.get('pair_min', 0):.3f}; triple mean "
        f"{results.get('triple_mean', 0):.3f} min "
        f"{results.get('triple_min', 0):.3f} -> {out} (matrix {seconds['matrix']:.0f}s)")
    trace = {}
    for key in filter(None, args.trace.split(",")):
        task_set = tuple(sorted(names.index(n) for n in key.split("+")))
        trace[key] = trace_cell(cfg, ts.params, pool_objects, pool_agent, task_set,
                                cell_seed(args.seed, task_set), args.cell_episodes)
        log(f"trace {key}: {json.dumps(trace[key])}")
    if trace:
        path = out.with_name(out.stem + "_trace.json")
        path.write_text(json.dumps({"card": card, "cells": trace}, indent=2, sort_keys=True) + "\n")
    return {"results": results, "phase1": phase1, "rounds": rounds, "seconds": seconds,
            "trace": trace}


if __name__ == "__main__":
    main()
