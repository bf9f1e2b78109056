"""RL fine-tune of the canonical GridPolicy under the exact-match reward.

Counterpart of the JAX package's ``tools/finetune_canonical.py``, which writes
``docs/canonical_finetune.json``: PPO of the trained GridPolicy against the
true exact-match reward, to attack the plateau BC and targeted DAgger leave.

Recipe, as in JAX:
  * the batched canonical env (reset with goal imagination, grid step),
    auto-reset from a fresh pool of 2B worlds each update, through a window
    that moves by an odd stride each step (``off = t * 12007 mod B``);
  * reward +1 on exact match, -1/max_steps otherwise;
  * value-head warmup (a loss of ``vf_coef * v_loss`` alone) before joint
    PPO: the BC checkpoint's value head is untrained;
  * a low learning rate and a best checkpoint kept at each evaluation, so
    the fine-tune never ships a regression.

Every draw is JAX's, from the same key data on the device (``draw``): the
envs reset from ``split(PRNGKey(--seed), envs)``, and each update splits
``PRNGKey(--seed + 1)``'s chain into its pool, its Gumbel noise and its
epoch permutations as JAX's ``train_step`` does (the keyed-draw kernels on
the card). What differs: parameters load from and save to
``params_<tag>.pt`` state dicts; the JSON goes to ``--out`` with the card
and an ``analysis`` line written from the run's own numbers.

    python -m gym_craftingworld_tpu_torch.tools.finetune_canonical \\
        --updates 260 --warmup 10 --lr 1e-5 --ent-coef 1e-4 --eval-every 25
    python -m gym_craftingworld_tpu_torch.tools.finetune_canonical --smoke   # tiny, CPU
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
from pathlib import Path
from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch.config import EnvConfig, ray_config
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.core.rollout import _select
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import step
from gym_craftingworld_tpu_torch.models.grid_policy import (init_grid_policy, planes_from_snaps,
                                                            planes_from_state,
                                                            snap_columns_from_state)
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools._canonical import RUNS, load_params, log, save_params, shown
from gym_craftingworld_tpu_torch.train import dagger, fast_ppo
from gym_craftingworld_tpu_torch.train.ppo import gumbel_noise
from gym_craftingworld_tpu_torch.utils.profiling import card_identity

OUT = RUNS / "canonical_finetune.json"
SAVE = RUNS / "canonical"
INIT = SAVE / "params_targeted_final.pt"
POOL_STRIDE = 12007  # odd window stride through the pool, full period
SMOKE = ["--init-params", "", "--channels", "8", "--hidden", "32", "--envs", "16",
         "--updates", "2", "--warmup", "1", "--eval-every", "1", "--eval-episodes", "8",
         "--final-eval-episodes", "8", "--device", "cpu", "--out", str(RUNS / "ft_smoke.json")]


class FTConfig(NamedTuple):
    rollout_steps: int = 128
    num_minibatches: int = 16
    update_epochs: int = 1
    gamma: float = 0.999
    gae_lambda: float = 0.95
    clip_eps: float = 0.1
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    lr: float = 2e-5
    max_grad_norm: float = 0.5


class FTState(NamedTuple):
    params: torch.nn.Module  # the GridPolicy, updated in place
    opt_state: fast_ppo.AdamState


class Draws(NamedTuple):
    """An update's random inputs: the pool of 2B fresh worlds, the Gumbel
    noise f32[T, B, A] of the sampled actions, one permutation of the T*B rows
    per epoch int[E, T*B]."""

    pool: EnvState
    noise: torch.Tensor
    perms: torch.Tensor


def make_tx(ft: FTConfig) -> fast_ppo.Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))``."""
    return fast_ppo.adam(ft.lr, max_norm=ft.max_grad_norm)


def init_state(model: torch.nn.Module, ft: FTConfig) -> FTState:
    return FTState(model, make_tx(ft).init(dict(model.named_parameters())))


def draw(cfg: EnvConfig, ft: FTConfig, B: int, key: torch.Tensor):
    """An update's draws from key data ``key``, as JAX's ``train_step`` makes
    them: ``key, k_pool, k_roll, k_perm = split(key, 4)``; the pool is the
    reset of ``split(k_pool, 2B)``; step ``t``'s noise is ``categorical``'s
    Gumbel draw (float32, the logits' dtype) of ``split(k_roll, T)[t]``;
    epoch ``e``'s rows are ``permutation(split(k_perm, E)[e], T * B)``.
    Returns (the next key, Draws), on the key's device."""
    key, k_pool, k_roll, k_perm = kd.split_keys(key, 4)
    pool = reset(cfg, kd.split_keys(k_pool, 2 * B))
    noise = gumbel_noise(k_roll, B, planes=ft.rollout_steps)
    N = ft.rollout_steps * B
    perms = torch.stack([kd.permutation(k, N) for k in kd.split_keys(k_perm, ft.update_epochs)])
    return key, Draws(pool, noise, perms)


def _window(pool: EnvState, off: int, B: int) -> EnvState:
    return EnvState(**{f.name: getattr(pool, f.name)[off:off + B]
                       for f in dataclasses.fields(EnvState)})


@torch.no_grad()
def collect(cfg: EnvConfig, ft: FTConfig, model: torch.nn.Module, env: EnvState, pool: EnvState,
            noise: torch.Tensor):
    """T sampled steps of every env, auto-reset from ``pool``'s window; the
    trajectory stores snapshot columns, not planes (at 2,048 envs x 128 steps
    the planes would take ~11 GB). Returns (env, traj of [T, B] tensors, the
    bootstrap value f32[B])."""
    B = env.objects.shape[0]
    keys = ("action", "logp", "value", "reward", "done", "raw")
    traj = {k: [] for k in keys + ("cols",)}
    win = torch.tensor(1.0, device=env.objects.device)
    lose = torch.tensor(-1.0 / cfg.max_steps, device=env.objects.device)
    for t in range(ft.rollout_steps):
        logits, value = model(*planes_from_state(cfg, env))
        action = torch.argmax(logits + noise[t], dim=-1).to(torch.int32)
        logp = torch.log_softmax(logits, dim=-1).gather(1, action.long()[:, None])[:, 0]
        st2, res = step(cfg, env, action)
        off = (t * POOL_STRIDE) % B
        traj["cols"].append(snap_columns_from_state(cfg, env))
        env = _select(res.done, _window(pool, off, B), st2)
        for k, v in zip(keys, (action, logp, value, torch.where(res.reward == cfg.max_steps, win, lose),
                               res.done, res.reward)):
            traj[k].append(v)
    out = {k: torch.stack(traj[k]) for k in keys}
    out["cols"] = {k: torch.stack([c[k] for c in traj["cols"]]) for k in traj["cols"][0]}
    _, last_value = model(*planes_from_state(cfg, env))
    return env, out, last_value


def gae(ft: FTConfig, traj: dict, last_value: torch.Tensor):
    """(advantages, returns) f32[T, B], reversed over t."""
    adv = torch.zeros_like(traj["value"])
    g, next_value = torch.zeros_like(last_value), last_value
    for t in reversed(range(traj["value"].shape[0])):
        nd = 1.0 - traj["done"][t].to(torch.float32)
        delta = traj["reward"][t] + ft.gamma * next_value * nd - traj["value"][t]
        g = delta + ft.gamma * ft.gae_lambda * nd * g
        adv[t] = g
        next_value = traj["value"][t]
    return adv, adv + traj["value"]


def ppo_loss(cfg: EnvConfig, ft: FTConfig, model: torch.nn.Module, b: dict, value_only: bool):
    """The minibatch's (loss, pg, v_loss, entropy): clipped surrogate,
    clipped value and entropy, with the advantages normalised by their
    population std; ``value_only`` keeps ``vf_coef * v_loss`` alone."""
    adv = b["adv"]
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    c = b["cols"]
    logits, value = model(*planes_from_snaps(
        cfg, c["occ_key"], c["occ_code"], c["init_key"], c["init_agent_key"], c["agent_key"],
        c["holding"], c["desired"], c["achieved"]))
    logsm = torch.log_softmax(logits, dim=-1)
    logp = logsm.gather(1, b["action"].long()[:, None])[:, 0]
    ratio = torch.exp(logp - b["logp"])
    pg = -torch.minimum(ratio * adv_n,
                        torch.clamp(ratio, 1 - ft.clip_eps, 1 + ft.clip_eps) * adv_n).mean()
    vc = b["value"] + torch.clamp(value - b["value"], -ft.clip_eps, ft.clip_eps)
    v_loss = 0.5 * torch.maximum((value - b["ret"]) ** 2, (vc - b["ret"]) ** 2).mean()
    ent = -(torch.exp(logsm) * logsm).sum(-1).mean()
    loss = ft.vf_coef * v_loss if value_only else pg + ft.vf_coef * v_loss - ft.ent_coef * ent
    return loss, pg, v_loss, ent


def update_phase(cfg: EnvConfig, ft: FTConfig, ts: FTState, flat: dict, perms: torch.Tensor,
                 value_only: bool):
    """``update_epochs`` x ``num_minibatches`` steps of clip + Adam over the
    flattened trajectory. A parameter the loss does not reach (the policy
    head under ``value_only``) takes a zero gradient, as optax steps every
    leaf. Returns (ts, stats f32[E * M, 4])."""
    tx = make_tx(ft)
    model, opt_state = ts
    named = dict(model.named_parameters())
    N = flat["action"].shape[0]
    mb = N // ft.num_minibatches
    stats = []
    for perm in perms.to(torch.int64):
        for i in range(ft.num_minibatches):
            idx = perm[i * mb:(i + 1) * mb]
            b = {k: ({c: x[idx] for c, x in v.items()} if k == "cols" else v[idx])
                 for k, v in flat.items()}
            with torch.enable_grad():
                terms = ppo_loss(cfg, ft, model, b, value_only)
                grads = torch.autograd.grad(terms[0], list(named.values()),
                                            materialize_grads=True)
            updates, opt_state = tx.update(dict(zip(named, grads)), opt_state)
            fast_ppo.apply_updates(model, updates)
            stats.append(torch.stack([t.detach() for t in terms]))
    return FTState(model, opt_state), torch.stack(stats)


@torch.no_grad()
def train_step(cfg: EnvConfig, ft: FTConfig, ts: FTState, env: EnvState, key: torch.Tensor,
               value_only: bool):
    """One PPO iteration of the GridPolicy on the canonical env, drawing from
    key data ``key`` (``draw``). Returns (ts, env, the next key, metrics as
    0-dim tensors), as JAX's; the parameters are updated in place."""
    B = env.objects.shape[0]
    key, draws = draw(cfg, ft, B, key)
    env, traj, last_value = collect(cfg, ft, ts.params, env, draws.pool, draws.noise)
    adv, ret = gae(ft, traj, last_value)
    N = ft.rollout_steps * B
    flat = {k: traj[k].reshape(N) for k in ("action", "logp", "value")}
    flat["adv"], flat["ret"] = adv.reshape(N), ret.reshape(N)
    flat["cols"] = {k: v.reshape((N,) + tuple(v.shape[2:])) for k, v in traj["cols"].items()}
    ts, stats = update_phase(cfg, ft, ts, flat, draws.perms, value_only)
    done = traj["done"]
    mean = stats.mean(0)
    metrics = {"loss": mean[0], "pg": mean[1], "v_loss": mean[2], "entropy": mean[3],
               "success_rate": (traj["raw"] == cfg.max_steps).sum() / done.sum().clamp_min(1),
               "done_frac": done.to(torch.float32).mean()}
    return ts, env, key, metrics


def analysis(base: float, curve: list, best: str, final: float, warmup: int) -> str:
    """One line on the run, from its own numbers."""
    joint = [c for c in curve if c["update"] > warmup]
    if not joint:
        return f"no joint-PPO evaluation; baseline {base:.4f}, final {final:.4f} ({best})"
    first, last = joint[0], joint[-1]
    peak = max(joint, key=lambda c: c["eval"])
    verdict = "beats" if final > base else "does not beat"
    ratio = f", {last['eval'] / base:.4f} x the baseline" if base > 0 else ""
    return (f"greedy eval {base:.4f} at the start; the first joint-PPO evaluation "
            f"(update {first['update']}) reads {first['eval']:.4f}, the best "
            f"{peak['eval']:.4f} (update {peak['update']}), the last {last['eval']:.4f} "
            f"(update {last['update']}{ratio}); the "
            f"best-checkpoint guard ships '{best}', whose final eval {final:.4f} {verdict} "
            f"the baseline")


def main(argv=None) -> dict:
    """Run the fine-tune; returns {"doc" (the JSON written), "path", "updates"
    (the metrics of every update, as floats), "policy_head_after_warmup"
    (whether the value-only updates left the policy head's parameters
    bit-identical; None without a value-only update), "model" (the policy
    shipped: the best checkpoint's parameters)}."""
    argv = list(argv) if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--init-params", default=str(INIT),
                    help="the GridPolicy teacher's params_<tag>.pt ('' for a fresh one)")
    ap.add_argument("--channels", type=int, default=96)
    ap.add_argument("--hidden", type=int, default=1536)
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--updates", type=int, default=120)
    ap.add_argument("--warmup", type=int, default=15, help="value-only updates before joint PPO")
    ap.add_argument("--eval-every", type=int, default=15)
    ap.add_argument("--eval-episodes", type=int, default=4096)
    ap.add_argument("--final-eval-episodes", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--ent-coef", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--smoke", action="store_true", help="tiny 8x8 run on the CPU")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--save", default=str(SAVE), help="where params_rl_finetuned.pt goes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.smoke:  # JAX's tiny settings; options given after them override them
        args = ap.parse_args(SMOKE + argv)
        cfg = EnvConfig(height=8, width=8, max_steps=40)
    else:
        cfg = ray_config()
    dev = torch.device(args.device)
    card = card_identity(dev)
    model = init_grid_policy(prng_key(0, device=dev), cfg, args.channels,
                             args.hidden)
    if args.init_params:
        load_params(model, args.init_params)
        log(f"loaded {args.init_params}")
    ft = FTConfig(lr=args.lr, ent_coef=args.ent_coef)
    ts = init_state(model, ft)
    env = reset(cfg, kd.split_keys(prng_key(args.seed, device=dev), args.envs))
    key = prng_key(args.seed + 1, device=dev)

    def evaluate(tag, n, seed):
        res = dagger.evaluate_grid_policy(cfg, model, n, seed)
        log(f"eval[{tag}]: {res['success_rate']:.4f} over {n} eps on {card}")
        return res

    base = evaluate("start", args.eval_episodes, 900)
    best = (base["success_rate"], copy.deepcopy(model.state_dict()), "start")
    curve = [{"update": 0, "eval": base["success_rate"]}]
    head = {k: v.clone() for k, v in model.policy.state_dict().items()}
    head_kept, history = None, []
    for u in range(1, args.updates + 1):
        value_only = u <= args.warmup
        ts, env, key, m = train_step(cfg, ft, ts, env, key, value_only)
        m = {k: float(v) for k, v in m.items()}
        history.append({"update": u, "value_only": value_only, **m})
        if u == args.warmup:
            head_kept = all(torch.equal(v, head[k]) for k, v in model.policy.state_dict().items())
        if u % 5 == 0 or u <= 2:
            log(f"update {u}{' (value-only)' if value_only else ''}: train sr "
                f"{m['success_rate']:.4f} v_loss {m['v_loss']:.4f} ent {m['entropy']:.3f}")
        if u % args.eval_every == 0 and u > args.warmup:
            res = evaluate(f"u{u}", args.eval_episodes, 900 + u)
            curve.append({"update": u, "eval": res["success_rate"]})
            if res["success_rate"] > best[0]:
                best = (res["success_rate"], copy.deepcopy(model.state_dict()), f"u{u}")

    model.load_state_dict(best[1])
    log(f"best checkpoint: {best[2]} ({best[0]:.4f} on the running eval)")
    final = evaluate("final(best)", args.final_eval_episodes, 31337)
    doc = {
        "config": {"envs": args.envs, "updates": args.updates, "warmup_value_only": args.warmup,
                   "lr": args.lr, "ppo": ft._asdict(),
                   "init": shown(args.init_params) if args.init_params else "fresh (smoke)"},
        "baseline_eval": base, "final_eval": final, "best_checkpoint": best[2], "curve": curve,
        "analysis": analysis(base["success_rate"], curve, best[2], final["success_rate"],
                             args.warmup),
        "card": card,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    log(f"-> {out}")
    if not args.smoke and final["success_rate"] > base["success_rate"]:
        Path(args.save).mkdir(parents=True, exist_ok=True)
        path = save_params(model, args.save, "rl_finetuned")
        log(f"improved policy saved -> {path}")
    return {"doc": doc, "path": str(out), "updates": history,
            "policy_head_after_warmup": head_kept, "model": model}


if __name__ == "__main__":
    main()
