"""Train a GridPolicy to solve canonical 21x21 stacked CraftingWorld: BC, then DAgger.

Counterpart of the JAX package's ``tools/train_canonical.py``: BC from the
expert snapshot demos (``tools/collect_canonical_demos``), then DAgger rounds
(``train/dagger.py``), each evaluated as ``train/evaluate.py`` defines
success (greedy policy, fresh stacked resets, reward == ``max_steps``). The
dataset lives on the card in a buffer of fixed capacity
(``tools/_canonical.pad_columns``); the expert relabels on the host.

As in JAX: BC evaluates every 4 chunks (seed 900) and at its end (901); a
DAgger round collects on-policy states (``explore_eps`` 0.02, seed 1000 +
``--round-base`` + r), relabels them, saves ``dagger<n>.npz``, appends them,
trains and evaluates (seed 902 + r); the final evaluation takes seed 31337.
One Adam state runs through BC and DAgger, whose learning rates differ.
``--init-params`` with ``--round-base`` resumes a run: the ``dagger*.npz``
files already in ``--out`` are folded into the dataset first.

The draws are JAX's, split for split from ``PRNGKey(--seed)`` on the device:
``key, k_init = split(key)`` for the model's initial weights (flax's init),
then ``key, k = split(key)`` for each chunk's rows; the evaluations and the
DAgger rollouts reset from ``split(PRNGKey(seed), n)`` (``train/dagger.py``).
What differs: parameters are saved as a torch ``state_dict`` (``params_<tag>.pt``);
``metrics.jsonl`` keeps JAX's records and adds the card to each, and the
stages' host seconds (``collect_s``, ``relabel_s``, ``train_s``, ``s``); at
the end of a run ``canonical_curve.json`` lists every evaluation in it, the
runs resumed into ``--out`` included, in ``docs/canonical_curve.json``'s
schema with the card.

    python -m gym_craftingworld_tpu_torch.tools.train_canonical                # on the card
    python -m gym_craftingworld_tpu_torch.tools.train_canonical --init-params \\
        runs/torch/canonical/params_final.pt --round-base 8 --dagger-rounds 6 \\
        --bc-steps 0 --eval-episodes 1024 --final-eval-episodes 4096          # resumed
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from gym_craftingworld_tpu_torch.models.grid_policy import init_grid_policy
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools._canonical import (
    CFG, DEMOS, RUNS, Metrics, append_columns, fit, load_params, log, pad_columns, save_params,
    seconds_since, train_chunk, write_curve)
from gym_craftingworld_tpu_torch.train import dagger
from gym_craftingworld_tpu_torch.train.demos import SnapDataset
from gym_craftingworld_tpu_torch.utils.profiling import card_identity


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demos", default=str(DEMOS))
    ap.add_argument("--out", default=str(RUNS / "canonical"))
    ap.add_argument("--capacity", type=int, default=6_000_000)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--bc-steps", type=int, default=4000)
    ap.add_argument("--bc-lr", type=float, default=1e-3)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--dagger-rounds", type=int, default=8)
    ap.add_argument("--dagger-episodes", type=int, default=768)
    ap.add_argument("--dagger-max-states", type=int, default=300_000)
    ap.add_argument("--dagger-steps", type=int, default=1500)
    ap.add_argument("--dagger-lr", type=float, default=3e-4)
    ap.add_argument("--eval-episodes", type=int, default=512)
    ap.add_argument("--final-eval-episodes", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-params", default=None, help="resume from a saved params_<tag>.pt")
    ap.add_argument("--round-base", type=int, default=0,
                    help="offset for DAgger round numbering/seeds on resume")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg, dev = CFG, torch.device(args.device)
    card = card_identity(dev)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    metrics = Metrics(out / "metrics.jsonl", card)
    emit = metrics.emit
    log(f"card: {card}")

    t0 = time.time()
    snaps = SnapDataset.load(args.demos)
    log(f"demos loaded: {snaps.num_episodes} episodes, {snaps.num_rows} rows "
        f"({time.time() - t0:.0f}s)")
    prior = sorted(out.glob("dagger*.npz"))
    if prior:
        extras = [SnapDataset.load(str(p)) for p in prior]
        snaps = SnapDataset.concat(snaps, *extras)
        log(f"reloaded {len(prior)} prior DAgger round(s): "
            f"+{sum(e.num_rows for e in extras)} rows → {snaps.num_rows}")
    t0 = time.perf_counter()
    data = pad_columns(snaps, args.capacity, dev)
    log(f"device dataset ready ({seconds_since(t0, dev):.0f}s)")
    n_valid = snaps.num_rows

    key, k_init = kd.split_keys(prng_key(args.seed, device=dev), 2)
    model = init_grid_policy(k_init, cfg, args.channels, args.hidden)
    if args.init_params:
        load_params(model, args.init_params)
        log(f"resumed params from {args.init_params}")
    ts = dagger.init_bc_state(model)

    def evaluate(tag, n_eps, seed):
        t0 = time.perf_counter()
        res = dagger.evaluate_grid_policy(cfg, ts.params, n_eps, seed)
        s = seconds_since(t0, dev)
        log(f"[{card}] eval[{tag}] success {res['success_rate']:.3f} over {res['episodes']} eps "
            f"(mean steps {res['mean_episode_steps']:.0f}, {s:.0f}s)")
        emit({"phase": "eval", "tag": tag, **res, "s": s})
        return res

    # ---- BC phase ----------------------------------------------------------
    done_steps = 0
    while done_steps < args.bc_steps:
        steps = min(args.chunk, args.bc_steps - done_steps)
        key, k = kd.split_keys(key, 2)
        t0 = time.perf_counter()
        ts, stats = train_chunk(cfg, ts, data, n_valid, steps, args.batch, args.bc_lr, k)
        s = seconds_since(t0, dev)
        done_steps += steps
        log(f"[{card}] bc {done_steps}/{args.bc_steps}: loss {stats['loss']:.4f} "
            f"acc {stats['accuracy']:.4f} ({s:.0f}s)")
        emit({"phase": "bc", "steps": done_steps, **stats, "train_s": s})
        if done_steps % (args.chunk * 4) == 0:
            evaluate(f"bc{done_steps}", args.eval_episodes, seed=900)
    save_params(ts.params, out, "bc")
    evaluate("bc_final", args.eval_episodes, seed=901)

    # ---- DAgger rounds -----------------------------------------------------
    for r in range(args.dagger_rounds):
        t0 = time.perf_counter()
        cols, sr = dagger.collect_policy_states(
            cfg, ts.params, args.dagger_episodes, seed=1000 + args.round_base + r,
            explore_eps=0.02, max_states=args.dagger_max_states)
        collect_s = seconds_since(t0, dev)
        log(f"[{card}] dagger {r}: rollout success {sr:.3f}, {len(cols['agent_key'])} states "
            f"({collect_s:.0f}s)")
        t0 = time.perf_counter()
        labeled = dagger.expert_relabel(cfg, cols)
        relabel_s = time.perf_counter() - t0
        log(f"[{card}] dagger {r}: labeled in {relabel_s:.0f}s")
        labeled = fit(labeled, args.capacity, n_valid)
        labeled.save(str(out / f"dagger{args.round_base + r}.npz"))
        n_valid = append_columns(data, labeled, n_valid)
        emit({"phase": "dagger_collect", "round": r, "rollout_success": sr,
              "rows": int(labeled.num_rows), "n_valid": int(n_valid),
              "states": len(cols["agent_key"]), "collect_s": collect_s, "relabel_s": relabel_s})
        done = 0
        while done < args.dagger_steps:
            steps = min(args.chunk, args.dagger_steps - done)
            key, k = kd.split_keys(key, 2)
            t0 = time.perf_counter()
            ts, stats = train_chunk(cfg, ts, data, n_valid, steps, args.batch, args.dagger_lr, k)
            s = seconds_since(t0, dev)
            done += steps
            log(f"[{card}] dagger {r} train {done}/{args.dagger_steps}: "
                f"loss {stats['loss']:.4f} acc {stats['accuracy']:.4f} ({s:.0f}s)")
            emit({"phase": "dagger_train", "round": r, "steps": done, **stats, "train_s": s})
        save_params(ts.params, out, f"dagger{r}")
        evaluate(f"dagger{r}", args.eval_episodes, seed=902 + r)

    # ---- final evaluation --------------------------------------------------
    res = evaluate("final", args.final_eval_episodes, seed=31337)
    path = save_params(ts.params, out, "final")
    log(f"final params → {path}")
    emit({"phase": "done", "success_rate": res["success_rate"]})
    metrics.close()
    write_curve(out / "metrics.jsonl", out / "canonical_curve.json")
    return res


if __name__ == "__main__":
    main()
