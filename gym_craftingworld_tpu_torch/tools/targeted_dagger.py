"""Targeted failure-DAgger: close the canonical 21x21 stacked setting.

Counterpart of the JAX package's ``tools/targeted_dagger.py``. Vanilla DAgger
(``tools/train_canonical``) plateaus near 94%: its aggregate is dominated by
states the policy already handles. This tool puts the training mass on the
failures:

* collect states only from failed greedy episodes (``train/dagger.py``
  ``failures_only``), keeping the salvageable prefix of each (the frames
  before any undesired latched achievement);
* relabel them with the scripted expert and append them to the aggregate;
* train on mixture batches: ``--frac-fail`` of every batch from the rows
  appended by this run's rounds, the rest uniform over the whole aggregate
  (``tools/_canonical.mixed_rows``);
* evaluate greedily every round, stop early at ``--target``, reload the best
  round's parameters and write the ``docs/canonical_policy.json`` schema
  (``full_eval_artifact``) over ``--final-eval-episodes`` at a held-out seed:
  to ``--policy-json`` if its success reaches 0.97, else beside it as
  ``*_candidate.json``, as JAX does.

Without ``--init-params`` a fresh GridPolicy is BC-trained on the aggregate
first (demos plus every ``dagger*.npz`` and ``targeted*.npz`` in ``--out``).

The draws are JAX's, split for split from ``PRNGKey(--seed)`` on the device
(the init's ``k_init``, then a ``split`` a chunk for ``mixed_rows``), and
every evaluation and rollout resets from ``split(PRNGKey(seed), n)``, the
artifact's too. What differs: parameters are ``params_<tag>.pt`` state
dicts; the JSON and every record of ``targeted_metrics.jsonl`` carry the
card.

    python -m gym_craftingworld_tpu_torch.tools.targeted_dagger --channels 96 --hidden 1536
    python -m gym_craftingworld_tpu_torch.tools.targeted_dagger \\
        --init-params runs/torch/canonical/params_final.pt --rounds 6
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.models.grid_policy import init_grid_policy
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools._canonical import (
    CFG, DEMOS, RUNS, Metrics, append_columns, fit, load_params, log, mixed_train_chunk,
    pad_columns, save_params, seconds_since)
from gym_craftingworld_tpu_torch.train import dagger
from gym_craftingworld_tpu_torch.train.demos import SnapDataset
from gym_craftingworld_tpu_torch.utils.profiling import card_identity

SETTING = "canonical 21x21, stacked 1-9 task exact-match goals (reference defaults)"


def artifact_summary(out: dict, episodes: int, seed: int) -> dict:
    """The ``docs/canonical_policy.json`` payload from one evaluation's
    terminal stats (``success``, ``steps``, ``desired``, ``achieved``, as
    tensors or arrays): per-skill completion where desired, success by the
    number of desired tasks."""
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    success = host(out["success"])
    steps = host(out["steps"])
    desired = host(out["desired"]).astype(bool)
    achieved = host(out["achieved"]).astype(bool)
    n_tasks = desired.sum(1)
    by_k = {}
    for k in range(1, C.N_TASKS + 1):
        sel = n_tasks == k
        if sel.any():
            by_k[str(k)] = {"episodes": int(sel.sum()), "success": float(success[sel].mean())}
    per_skill = {}
    for i, name in enumerate(C.TASK_LIST):
        sel = desired[:, i]
        per_skill[name] = float(achieved[sel, i].mean())
    return {
        "episodes": int(episodes),
        "eval_seed": int(seed),
        "mean_episode_steps": float(steps.mean()),
        "setting": SETTING,
        "skill_completion_when_desired": per_skill,
        "success_by_num_tasks": by_k,
        "success_rate": float(success.mean()),
    }


def full_eval_artifact(cfg: EnvConfig, model: torch.nn.Module, episodes: int, seed: int,
                       state=None) -> dict:
    """The ``docs/canonical_policy.json`` payload of ``episodes`` greedy episodes.

    One world from each of ``episodes`` keys split from ``PRNGKey(seed)``,
    JAX's worlds, on the model's device; ``state`` (an ``EnvState``)
    replaces those resets.
    """
    if state is None:
        dev = next(model.parameters()).device
        state = reset(cfg, kd.split_keys(prng_key(seed, device=dev), episodes))
    return artifact_summary(dagger._eval_batch_grid(cfg, model, state), episodes, seed)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(RUNS / "canonical"))
    ap.add_argument("--demos", default=str(DEMOS))
    ap.add_argument("--init-params", default=None,
                    help="resume from a params_<tag>.pt; when absent a fresh model is "
                         "BC-trained on the aggregate first")
    ap.add_argument("--bc-steps", type=int, default=6000)
    ap.add_argument("--bc-lr", type=float, default=1e-3)
    ap.add_argument("--capacity", type=int, default=6_000_000)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--episodes", type=int, default=6144,
                    help="greedy episodes rolled per round (failures kept)")
    ap.add_argument("--steps", type=int, default=1200, help="SGD steps per round")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--frac-fail", type=float, default=0.5)
    ap.add_argument("--eval-episodes", type=int, default=2048)
    ap.add_argument("--final-eval-episodes", type=int, default=8192)
    ap.add_argument("--final-eval-seed", type=int, default=424242)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--target", type=float, default=0.975,
                    help="stop early when round eval reaches this")
    ap.add_argument("--policy-json", default=str(RUNS / "canonical_policy.json"))
    ap.add_argument("--tag", default="",
                    help="suffix for round files/checkpoints (avoids clobbering when reusing "
                         "an out dir)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg, dev = CFG, torch.device(args.device)
    card = card_identity(dev)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    metrics = Metrics(out / "targeted_metrics.jsonl", card)
    emit = metrics.emit
    log(f"card: {card}")

    snaps = SnapDataset.load(args.demos)
    prior = sorted(out.glob("dagger*.npz")) + sorted(out.glob("targeted*.npz"))
    if prior:
        extras = [SnapDataset.load(str(p)) for p in prior]
        snaps = SnapDataset.concat(snaps, *extras)
        log(f"loaded {len(prior)} prior round file(s) → {snaps.num_rows} rows")
    data = pad_columns(snaps, args.capacity, dev)
    n_valid = snaps.num_rows
    fail_lo = n_valid  # mixture window: every row appended from here on
    log(f"device dataset ready: {n_valid} rows")

    key, k_init = kd.split_keys(prng_key(args.seed, device=dev), 2)
    model = init_grid_policy(k_init, cfg, args.channels, args.hidden)
    ts = dagger.init_bc_state(model)
    if args.init_params:
        load_params(model, args.init_params)
        log(f"resumed params from {args.init_params}")
    else:
        done = 0
        while done < args.bc_steps:
            steps = min(500, args.bc_steps - done)
            key, k = kd.split_keys(key, 2)
            t0 = time.perf_counter()
            ts, stats = mixed_train_chunk(cfg, ts, data, n_valid, 0, steps, args.batch,
                                          args.bc_lr, 0.0, k)
            s = seconds_since(t0, dev)
            done += steps
            log(f"[{card}] bc {done}/{args.bc_steps}: loss {stats['loss']:.4f} "
                f"acc {stats['accuracy']:.4f} ({s:.0f}s)")
            emit({"phase": "bc", "steps": done, **stats, "train_s": s})
        t0 = time.perf_counter()
        res = dagger.evaluate_grid_policy(cfg, ts.params, args.eval_episodes, seed=4899)
        s = seconds_since(t0, dev)
        log(f"[{card}] bc eval: success {res['success_rate']:.4f} ({s:.0f}s)")
        emit({"phase": "eval", "round": -1, **res, "s": s})
        save_params(ts.params, out, "bc_big")

    best = (-1.0, None)
    for r in range(args.rounds):
        t0 = time.perf_counter()
        cols, sr = dagger.collect_policy_states(cfg, ts.params, args.episodes,
                                                seed=31000 + args.seed + r, explore_eps=0.0,
                                                failures_only=True)
        collect_s = seconds_since(t0, dev)
        n_new = len(cols["agent_key"])
        log(f"[{card}] round {r}: greedy success {sr:.4f}, {n_new} salvageable failure states "
            f"({collect_s:.0f}s)")
        t0 = time.perf_counter()
        labeled = dagger.expert_relabel(cfg, cols)
        relabel_s = time.perf_counter() - t0
        log(f"[{card}] round {r}: relabeled in {relabel_s:.0f}s")
        labeled = fit(labeled, args.capacity, n_valid)
        labeled.save(str(out / f"targeted{args.tag}{r}.npz"))
        n_valid = append_columns(data, labeled, n_valid)
        emit({"phase": "collect", "round": r, "rollout_success": sr,
              "rows": int(labeled.num_rows), "n_valid": int(n_valid), "states": n_new,
              "collect_s": collect_s, "relabel_s": relabel_s})

        done = 0
        while done < args.steps:
            steps = min(400, args.steps - done)
            key, k = kd.split_keys(key, 2)
            t0 = time.perf_counter()
            ts, stats = mixed_train_chunk(cfg, ts, data, n_valid, fail_lo, steps, args.batch,
                                          args.lr, args.frac_fail, k)
            s = seconds_since(t0, dev)
            done += steps
            log(f"[{card}] round {r} train {done}/{args.steps}: loss {stats['loss']:.4f} "
                f"acc {stats['accuracy']:.4f} ({s:.0f}s)")
            emit({"phase": "train", "round": r, "steps": done, **stats, "train_s": s})

        t0 = time.perf_counter()
        res = dagger.evaluate_grid_policy(cfg, ts.params, args.eval_episodes, seed=4900 + r)
        s = seconds_since(t0, dev)
        log(f"[{card}] round {r} eval: success {res['success_rate']:.4f} ({s:.0f}s)")
        emit({"phase": "eval", "round": r, **res, "s": s})
        save_params(ts.params, out, f"targeted{args.tag}{r}")
        if res["success_rate"] > best[0]:
            best = (res["success_rate"], f"targeted{args.tag}{r}")
        if res["success_rate"] >= args.target:
            log(f"round {r}: target {args.target} reached")
            break

    log(f"best round checkpoint: {best[1]} ({best[0]:.4f})")
    load_params(ts.params, out / f"params_{best[1]}.pt")  # the best round for the artifact
    t0 = time.perf_counter()
    artifact = full_eval_artifact(cfg, ts.params, args.final_eval_episodes,
                                  args.final_eval_seed)
    s = seconds_since(t0, dev)
    artifact["policy"] = f"GridPolicy(channels={args.channels}, hidden={args.hidden}), greedy argmax"
    artifact["card"] = card
    log(f"[{card}] final eval: success {artifact['success_rate']:.4f} over "
        f"{args.final_eval_episodes} eps ({s:.0f}s)")
    emit({"phase": "final", **{k: v for k, v in artifact.items() if not isinstance(v, dict)},
          "s": s})
    save_params(ts.params, out, f"targeted{args.tag}_final")
    path = Path(args.policy_json)
    if artifact["success_rate"] < 0.97:
        path = path.with_name(path.stem + "_candidate.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(artifact, indent=2, sort_keys=True) + "\n")
    log(f"wrote {path}" + ("" if path.name == Path(args.policy_json).name
                           else " (below 0.97: a candidate)"))
    metrics.close()
    return {"artifact": artifact, "path": str(path)}


if __name__ == "__main__":
    main()
