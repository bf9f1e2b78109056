"""CPV compositional-execution matrix on 8x8: every pair and a sample of triples.

Counterpart of the JAX package's ``tools/cpv_matrix.py`` (the round-4
protocol, before ``cpv_canonical``): train one ``CPVPolicy`` with the init
view (``models/cpv.py``) on single-task expert demonstrations of all 9
skills through the Gym façade, with handoff demos, pending-bit relabels and
on-policy DAgger over single-task handoff episodes, then measure zero-shot
stacked execution on every unordered pair and ``--triples`` random triples.
No stacked trajectory is ever collected. This is the claim CraftingWorld was
built to test ("Plan Arithmetic: Compositional Plan Vectors", NeurIPS 2019;
reference README.md:8).

The façade (``api/gym_env.CraftingWorldEnvRay`` with ``fixed_init_state``),
the demos (``train/bc.collect_demos`` with ``obs_features_init``) and the
policy run on ``--device``, the card unless asked for the CPU; the host's
RandomState streams (``seed + 555``, ``seed + 777``, ``eval_seed ^
0xC9C1E``) are JAX's, and so are the keys: the init from ``PRNGKey(seed +
1)`` (flax's), the epochs' permutations from ``PRNGKey(seed + 2)`` and
``PRNGKey(seed + 500 + r)``. What differs: JAX's ``scan_bc_train`` is one
fused scan an epoch, here a loop over the epoch's permutation with
``train/bc.py``'s hand-written Adam; the JAX tool always writes ``docs/cpv_matrix.json``, this
one ``--out`` (by default ``runs/torch/cpv_matrix_8x8.json``) with the card.

    python -m gym_craftingworld_tpu_torch.tools.cpv_matrix
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.agents.expert import ExpertPolicy
from gym_craftingworld_tpu_torch.api.gym_env import CraftingWorldEnvRay
from gym_craftingworld_tpu_torch.models.actor_critic import obs_features_init
from gym_craftingworld_tpu_torch.models.cpv import init_cpv
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools._canonical import RUNS, log
from gym_craftingworld_tpu_torch.tools._cpv import RANK, apply_predecessors_np
from gym_craftingworld_tpu_torch.train import bc, fast_ppo
from gym_craftingworld_tpu_torch.train.evaluate import _HostView
from gym_craftingworld_tpu_torch.utils.profiling import card_identity

OUT = RUNS / "cpv_matrix_8x8.json"
_LATCH = (C.T_MAKE_BREAD, C.T_EAT_BREAD, C.T_BUILD_HOUSE, C.T_CHOP_TREE, C.T_CHOP_ROCK)


@torch.no_grad()
def scan_bc_train(demos: bc.Demos, key: torch.Tensor, model: torch.nn.Module,
                  epochs: int, batch: int, lr: float) -> torch.nn.Module:
    """``bc.bc_train``'s objective with a fresh ``optax.adam(lr)`` state: each
    epoch ``key, k = split(key)`` and ``permutation(k, n)`` (JAX's key data,
    on its device) in ``n // batch`` minibatches, the remainder dropped.
    Trains ``model`` in place and returns it."""
    tx = fast_ppo.adam(lr)
    opt_state = tx.init(dict(model.named_parameters()))
    dev = key.device
    feats = torch.from_numpy(demos.features).to(dev)
    actions = torch.from_numpy(demos.actions).to(dev)
    n = feats.shape[0]
    steps = n // batch
    for ep in range(epochs):
        key, perm = kd.split_permutation(key, n)
        losses = []
        for i in range(steps):
            idx = perm[i * batch: (i + 1) * batch]
            loss, grads = bc._ce_grads(model, feats[idx], actions[idx])
            updates, opt_state = tx.update(grads, opt_state)
            fast_ppo.apply_updates(model, updates)
            losses.append(loss)
        if (ep + 1) % 10 == 0:
            loss = float(torch.stack(losses).mean()) if losses else float("nan")
            log(f"  epoch {ep + 1}/{epochs}: loss {loss:.4f}")
    return model


def apply_predecessors(env: CraftingWorldEnvRay, S, j, rng) -> bool:
    """Rewrite a freshly reset env into the post-``S`` handoff state with
    desired = ``S`` ∪ {``j``} (``tools/_cpv.apply_predecessors_np`` on the
    env's arrays, written back into its state). The episode that follows
    executes exactly one task, ``j``; only its conditioning context matches
    the mid-composition states a stacked run visits. False if an effect's
    source object is missing (the env is then left as it was)."""
    st = env._state
    objects = st.objects[0].cpu().numpy().copy()
    achieved = np.zeros(C.N_TASKS, np.int8)
    agent = tuple(int(x) for x in st.agent[0].cpu())
    ok, agent, holding = apply_predecessors_np(objects, achieved, agent, 0, S, rng)
    if not ok:
        return False
    desired = np.zeros(C.N_TASKS, np.int8)
    desired[list(S) + [j]] = 1
    dev = st.objects.device

    def row(a, dtype):
        return torch.as_tensor(np.asarray(a)[None], dtype=dtype, device=dev)

    env._state = dataclasses.replace(
        st, objects=row(objects, st.objects.dtype), desired=row(desired, st.desired.dtype),
        achieved=row(achieved, st.achieved.dtype), holding=row(holding, st.holding.dtype),
        agent=row(agent, st.agent.dtype))
    env._cached = {}
    return True


def _draw_task(env, rng, rank, p=None):
    """A reset, the pending task ``j`` (weights ``p``) and 0-2 rank-lower
    predecessors applied; (j, applied) as JAX draws them."""
    env.reset()
    j = int(rng.randint(C.N_TASKS)) if p is None else int(rng.choice(C.N_TASKS, p=p))
    lower = [t for t in range(C.N_TASKS) if rank[t] < rank[j]]
    k = int(rng.randint(0, min(2, len(lower)) + 1))
    S = sorted((rng.choice(lower, k, replace=False).tolist() if k else []),
               key=lambda t: rank[t])
    return j, apply_predecessors(env, S, j, rng)


def collect_context_demos(episodes, seed, pool, rank, device="cuda"):
    """Handoff demonstrations: solve one task j from a world where 0-2
    lower-rank predecessors are already complete. Returns (Demos, task per row)."""
    env = CraftingWorldEnvRay(seed=seed, size=(8, 8), max_steps=60, stacking=False,
                              fixed_init_state=pool, device=device)
    rng = np.random.RandomState(seed + 555)
    feats, acts, eps, tasks = [], [], [], []
    kept = 0
    attempts = 0
    while kept < episodes and attempts < 8 * episodes:
        attempts += 1
        j, ok = _draw_task(env, rng, rank)
        if not ok:
            continue
        expert = ExpertPolicy(_HostView(env))
        ep_f, ep_a = [], []
        reward = -1
        for _ in range(env.MAX_STEPS):
            a = expert.action()
            if a is None:
                a = C.ACTION_UP
            ep_f.append(obs_features_init(env.state)[0].cpu().numpy())
            ep_a.append(int(a))
            _, reward, done, _ = env.step(int(a))
            if done:
                break
        if reward != env.MAX_STEPS:
            continue
        feats.extend(ep_f)
        acts.extend(ep_a)
        eps.extend([kept] * len(ep_a))
        tasks.extend([j] * len(ep_a))
        kept += 1
    return (
        bc.Demos(np.stack(feats).astype(np.float32), np.asarray(acts, np.int32),
                 np.asarray(eps, np.int32)),
        np.asarray(tasks, np.int32),
    )


@torch.no_grad()
def collect_policy_dagger(model, episodes, seed, pool, rank, explore_eps=0.05, device="cuda"):
    """On-policy DAgger over single-task handoff episodes.

    Episodes are drawn as :func:`collect_context_demos` draws them, pending
    tasks weighted toward the non-latching / resource-conflict ones, but
    driven by the current policy (greedy, ``explore_eps`` random moves);
    every visited state is labelled by the scripted expert, until an
    undesired latched bit makes the episode unsalvageable. No trajectory
    completes more than one task.
    """
    env = CraftingWorldEnvRay(seed=seed, size=(8, 8), max_steps=60, stacking=False,
                              fixed_init_state=pool, device=device)
    rng = np.random.RandomState(seed + 777)
    w = np.ones(C.N_TASKS)
    for t in (C.T_BUILD_HOUSE, C.T_GO_TO_HOUSE, C.T_MOVE_AXE, C.T_MOVE_HAMMER, C.T_MOVE_STICKS):
        w[t] = 3.0
    w /= w.sum()
    feats, acts, eps = [], [], []
    kept = 0
    attempts = 0
    while kept < episodes and attempts < 8 * episodes:
        attempts += 1
        j, ok = _draw_task(env, rng, rank, p=w)
        if not ok:
            continue
        expert = ExpertPolicy(_HostView(env))
        n_rows = 0
        for _ in range(env.MAX_STEPS):
            des = np.asarray(env.desired_goal_vector).reshape(-1)
            ach = np.asarray(env.achieved_goal_vector).reshape(-1)
            if any(ach[b] and not des[b] for b in _LATCH):
                break  # unsalvageable: expert labels past here are noise
            label = expert.action()
            if label is None:
                label = C.ACTION_UP
            f = obs_features_init(env.state)
            feats.append(f[0].cpu().numpy())
            acts.append(int(label))
            n_rows += 1
            if rng.rand() < explore_eps:
                a = int(rng.randint(4))
            else:
                a = int(torch.argmax(model(f)[0][0]))
            _, reward, done, _ = env.step(a)
            if done:
                break
        if n_rows == 0:
            continue  # a first-frame latch break contributed nothing
        eps.extend([kept] * n_rows)
        kept += 1
    if not feats:  # every attempt failed: an empty batch, not a crash
        dim = int(obs_features_init(env.state).shape[-1])
        return bc.Demos(np.zeros((0, dim), np.float32), np.zeros((0,), np.int32),
                        np.zeros((0,), np.int32))
    return bc.Demos(np.stack(feats).astype(np.float32), np.asarray(acts, np.int32),
                    np.asarray(eps, np.int32))


def augment_pending(demos: bc.Demos, tasks, rank, seed, grid_dim):
    """Per-row copy with 1-2 random higher-rank pending bits added to the
    desired mask: the relabel for "act on the current task while later tasks
    are still pending"."""
    rng = np.random.RandomState(seed)
    feats = demos.features.copy()
    keep = np.zeros(len(tasks), bool)
    for r, j in enumerate(tasks):
        higher = [t for t in range(C.N_TASKS) if rank[t] > rank[j]]
        if not higher:
            continue
        k = 1 + rng.randint(min(2, len(higher)))
        P = rng.choice(higher, k, replace=False)
        feats[r, grid_dim + P] = 1
        keep[r] = True
    return bc.Demos(feats[keep], demos.actions[keep], demos.episode[keep])


def training_demos(episodes_per_task, seed, pool, device) -> bc.Demos:
    """The behaviour-cloning set before DAgger: ``episodes_per_task``
    single-task expert episodes of each skill, as many handoff episodes as
    all of those together, and the pending-bit relabels of both."""
    base = dict(size=(8, 8), max_steps=60, stacking=False, fixed_init_state=pool, device=device)
    t0 = time.time()
    grid_dim = 8 * 8 * C.N_CHANNELS
    singles, single_tasks = [], []
    for k, task in enumerate(C.TASK_LIST):
        d = bc.collect_demos(episodes_per_task, seed=seed, selected_tasks=[task],
                             random_warmup=25, feature_fn=obs_features_init, **base)
        singles.append(d)
        single_tasks.append(np.full(len(d.actions), k, np.int32))
        log(f"demos[{task}]: {d.num_episodes} eps, {len(d.actions)} rows")
    demos_s = bc.concat_demos(*singles)
    tasks_s = np.concatenate(single_tasks)

    n_ctx = episodes_per_task * C.N_TASKS
    demos_c, tasks_c = collect_context_demos(n_ctx, seed, pool, RANK, device)
    log(f"handoff demos: {demos_c.num_episodes} eps, {len(demos_c.actions)} rows")

    demos_base = bc.concat_demos(demos_s, demos_c)
    tasks_base = np.concatenate([tasks_s, tasks_c])
    demos_p = augment_pending(demos_base, tasks_base, RANK, seed + 99, grid_dim)
    demos_aug = bc.concat_demos(demos_base, demos_p)
    log(f"dataset: {len(demos_aug.actions)} rows "
        f"(singles {len(demos_s.actions)}, handoff {len(demos_c.actions)}, "
        f"pending-relabel {len(demos_p.actions)}) in {time.time() - t0:.0f}s")
    return demos_aug


@torch.no_grad()
def greedy_eval(model, pool_seed, eval_seed, episodes, n_tasks, selected_tasks, pool, stacking,
                sample=False, device="cuda"):
    """Policy rollouts on the training world pool with a fresh episode RNG.

    The env is built with the training seed, so ``fixed_init_state`` makes
    the same pool, then reseeded with ``eval_seed``, so task draws and world
    order differ from training; stacked evaluations reset until exactly
    ``n_tasks`` bits are drawn. ``sample=True`` executes the policy's
    softmax (host draws from ``RandomState(eval_seed ^ 0xC9C1E)``) instead of
    its argmax. Returns (success rate, episodes).
    """
    env = CraftingWorldEnvRay(seed=pool_seed, size=(8, 8), max_steps=60, stacking=stacking,
                              fixed_init_state=pool, selected_tasks=selected_tasks, device=device)
    env.seed(eval_seed)
    rng = np.random.RandomState(eval_seed ^ 0xC9C1E)
    succ, tries, resets = 0, 0, 0
    while tries < episodes and resets < 60 * episodes:
        env.reset()
        resets += 1
        if int(np.asarray(env.desired_goal_vector).sum()) != n_tasks:
            continue
        tries += 1
        reward = -1
        for _ in range(env.MAX_STEPS):
            logits = model(obs_features_init(env.state))[0][0].cpu().numpy().astype(np.float64)
            if sample:
                p = np.exp(logits - logits.max())
                p /= p.sum()
                a = int(rng.choice(len(p), p=p))
            else:
                a = int(np.argmax(logits))
            _, reward, done, _ = env.step(a)
            if done:
                break
        succ += reward == env.MAX_STEPS
    return succ / max(tries, 1), tries


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--episodes-per-task", type=int, default=150)
    ap.add_argument("--pool", type=int, default=16, help="fixed_init_state world-pool size")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--pair-episodes", type=int, default=24)
    ap.add_argument("--dagger-rounds", type=int, default=5)
    ap.add_argument("--dagger-episodes", type=int, default=1000)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--triples", type=int, default=6)
    ap.add_argument("--triple-episodes", type=int, default=16)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    card = card_identity(dev)
    key = lambda seed: prng_key(seed, device=dev)
    names = list(C.TASK_LIST)

    demos_aug = training_demos(args.episodes_per_task, args.seed, args.pool, dev)

    model = init_cpv(key(args.seed + 1), 8, 8, hidden=args.hidden, with_init=True)
    scan_bc_train(demos_aug, key(args.seed + 2), model, epochs=args.epochs, batch=512, lr=2e-3)

    # on-policy DAgger over single-task handoff episodes: close the
    # covariate-shift gap (limit cycles on non-latching residuals) without
    # ever demonstrating a composition
    for r in range(args.dagger_rounds):
        t0 = time.time()
        d = collect_policy_dagger(model, args.dagger_episodes, args.seed + 300 + r, args.pool,
                                  RANK, device=dev)
        demos_aug = bc.concat_demos(demos_aug, d)
        scan_bc_train(demos_aug, key(args.seed + 500 + r), model,
                      epochs=max(args.epochs // 3, 8), batch=512, lr=1e-3)
        log(f"dagger {r}: +{len(d.actions)} rows -> {len(demos_aug.actions)} "
            f"({time.time() - t0:.0f}s)")

    acc = bc.bc_accuracy(model, demos_aug)
    log(f"train accuracy {acc:.4f}")

    results = {"card": card,
               "train_accuracy": float(acc),
               "config": {"grid": "8x8", "episodes_per_task":
                          args.episodes_per_task, "epochs": args.epochs,
                          "pair_episodes": args.pair_episodes,
                          "world_pool": args.pool,
                          "dagger_rounds": args.dagger_rounds,
                          "protocol": (
                              "fixed world pool shared between training and "
                              "evaluation (paper-style fixed env set); "
                              "evaluation reseeds the episode RNG, so world "
                              "order and task draws are fresh. Training data "
                              "= single-task demos + handoff demos (one task "
                              "executed from a world whose predecessors are "
                              "pre-completed, agent position randomized) + "
                              "pending-bit relabels + on-policy DAgger over "
                              "the same single-task handoff episodes (policy "
                              "actions, expert labels); no trajectory ever "
                              "completes more than one task — the "
                              "composition itself is never demonstrated"
                          )},
               "singles": {}, "pairs": {}, "triples": {},
               "pairs_argmax": {}, "triples_argmax": {}}
    for task in names:
        sr, n = greedy_eval(model, args.seed, args.seed + 7001, 16, 1, [task], args.pool,
                            stacking=False, device=dev)
        results["singles"][task] = sr
        log(f"single {task}: {sr:.2f}")

    def stacked(kind, tasks, episodes, eval_seed):
        key = "+".join(tasks)
        sr, n = greedy_eval(model, args.seed, eval_seed, episodes, len(tasks), tasks, args.pool,
                            stacking=True, sample=True, device=dev)
        sr_g, _ = greedy_eval(model, args.seed, eval_seed, episodes, len(tasks), tasks,
                              args.pool, stacking=True, sample=False, device=dev)
        results[kind][key] = sr
        results[kind + "_argmax"][key] = sr_g
        log(f"{kind[:-1]} {key}: {sr:.2f} sampled / {sr_g:.2f} argmax ({n} eps)")

    for i, j in itertools.combinations(range(C.N_TASKS), 2):
        stacked("pairs", [names[i], names[j]], args.pair_episodes, args.seed + 8001)
    rng = np.random.RandomState(args.seed + 13)
    for _ in range(args.triples):
        tri = sorted(rng.choice(C.N_TASKS, 3, replace=False).tolist())
        stacked("triples", [names[t] for t in tri], args.triple_episodes, args.seed + 9001)

    pair_rates = list(results["pairs"].values())
    results["pair_mean"] = float(np.mean(pair_rates))
    results["pair_min"] = float(np.min(pair_rates))
    pa = list(results["pairs_argmax"].values())
    results["pair_mean_argmax"] = float(np.mean(pa))
    results["pair_min_argmax"] = float(np.min(pa))
    results["execution"] = (
        "headline pairs/triples execute the policy's own softmax "
        "distribution (argmax rates recorded alongside): BC from a "
        "multi-modal expert leaves near-ties whose argmax limit-cycles"
    )
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2, sort_keys=True) + "\n")
    log(f"pair mean {results['pair_mean']:.3f} min {results['pair_min']:.3f} -> {out}")
    return results


if __name__ == "__main__":
    main()
