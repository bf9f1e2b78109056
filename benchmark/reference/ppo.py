"""The PPO iteration both trainers run, in plain torch: the reference's loop.

One iteration, as the configuration states it (PPO, Schulman et al. 2017,
with the fast-PPO loop of the measured package): ``key, k_pool, k_roll,
k_perm = split(key, 4)``; a pool of 2B fresh worlds from ``k_pool``; T steps
of the policy, each action the argmax of the logits plus Gumbel noise
``-log(-log u)`` of ``u = uniform(split(k_roll, T)[t], (6, B), 1e-7, 1)``,
finished worlds replaced by the pool's window at ``(t * stride) % B``; GAE
(gamma, lambda); ``update_epochs`` epochs, each a permutation of the batch's
shuffle blocks from ``split(k_perm, epochs)``, cut into minibatches whose
advantages are normalised over the minibatch (std with ddof 0, + 1e-8); the
clipped surrogate, the clipped value loss and the entropy bonus; the
gradient clipped to a global norm, then Adam, both written out as optax
defines them.

``iterate`` runs ``steps`` iterations. With ``follow`` (the program's record)
it takes the program's actions where the program sampled them, and judges
each by how far its Gumbel-perturbed reference logit lies below the best
one; without it, it samples its own, and its record stands in the program's
place (the control). A policy plugs in through ``Policy``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from benchmark.reference import keys as K
from benchmark.reference import world as W

f32 = torch.float32


class Policy(NamedTuple):
    """What a trainer's policy gives the loop.

    ``collect(params, env)`` -> (logits f32[6, B], value f32[B]) of worlds
    ``env`` (torch int32 fields); ``store(env)`` -> what the update needs of
    one step's worlds (a tensor or a dict of tensors, batch last);
    ``forward(params, stored, rows)`` -> (logits f32[6, n], value f32[n]) of
    the stored rows ``rows`` (t-major indices), differentiable in params;
    ``block`` the shuffle block's rows."""

    collect: Callable
    store: Callable
    forward: Callable
    block: int


class Record(NamedTuple):
    """What ``steps`` iterations produced, program or reference, iteration by
    iteration."""

    actions: list  # int32[T, B] the collect sampled
    losses: list  # (loss, pg_loss, v_loss, entropy) of the first minibatch
    envs: list  # the worlds after the iteration (numpy fields)
    starts: list  # the parameters at the iteration's start, by leaf
    opts: list  # Adam's (mu, nu, count) at the iteration's start
    mu_first: list  # Adam's mu after the iteration's first optimizer step
    ends: list  # the parameters at the iteration's end


def ppo_loss(conf: dict, logits, value, action, old_lp, old_v, adv_n, ret):
    """(loss, pg, v_loss, entropy) of one minibatch; logits [6, n]."""
    logsm = torch.log_softmax(logits, dim=0)
    log_prob = logsm.gather(0, action[None].to(torch.int64))[0]
    ratio = torch.exp(log_prob - old_lp)
    eps = conf["clip_eps"]
    pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - eps, 1 + eps) * adv_n).mean()
    vc = old_v + torch.clamp(value - old_v, -eps, eps)
    v_loss = 0.5 * torch.maximum((value - ret) ** 2, (vc - ret) ** 2).mean()
    entropy = -(torch.exp(logsm) * logsm).sum(dim=0).mean()
    loss = pg + conf["vf_coef"] * v_loss - conf["ent_coef"] * entropy
    return loss, pg, v_loss, entropy


class Adam:
    """optax ``chain(clip_by_global_norm(max_norm), adam(lr, 0.9, 0.999, 1e-8))``."""

    def __init__(self, conf: dict, params: dict):
        self.lr, self.max_norm = conf["lr"], conf["max_grad_norm"]
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)

    def state(self):
        return ({k: v.clone() for k, v in self.mu.items()},
                {k: v.clone() for k, v in self.nu.items()}, self.count.clone())

    def load(self, state) -> None:
        mu, nu, count = state
        dev = self.count.device
        self.mu = {k: v.to(dev).clone() for k, v in mu.items()}
        self.nu = {k: v.to(dev).clone() for k, v in nu.items()}
        self.count = count.to(dev).clone()

    def step(self, params: dict, grads: dict) -> None:
        b1, b2, eps = 0.9, 0.999, 1e-8
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.max_norm
        grads = {k: torch.where(keep, g, g / norm * self.max_norm) for k, g in grads.items()}
        self.count = self.count + 1
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, g in grads.items():
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * g ** 2 + b2 * self.nu[k]
            params[k] = params[k] - self.lr * ((self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + eps))


def gumbel_argmax_gap(g: torch.Tensor, action: torch.Tensor) -> float:
    """How far the chosen actions' perturbed logits lie below the best: the widest gap."""
    return float((g.max(dim=0).values - g.gather(0, action[None].to(torch.int64))[0]).max())


def _stack(xs):
    if isinstance(xs[0], dict):
        return {k: torch.stack([x[k] for x in xs]) for k in xs[0]}
    return torch.stack(xs)


def _rows(stored, rows: torch.Tensor, B: int):
    """Rows (t-major ``t * B + b``) of stored per-step tensors, batch last."""
    t, b = rows // B, rows % B
    if isinstance(stored, dict):
        return {k: v[t, ..., b].movedim(0, -1) if v.dim() > 2 else v[t, b] for k, v in stored.items()}
    return stored[t, ..., b]


def iterate(conf: dict, policy: Policy, params: dict, env: dict, key: torch.Tensor,
            steps: int, B: int, pool_fn: Callable, follow: Record | None = None):
    """``steps`` iterations from weights ``params`` (f32 by name), worlds
    ``env`` (numpy fields) and training key ``key``; (Record, each
    iteration's widest action gap).

    With ``follow``, each iteration starts from the program's parameters and
    Adam state at that iteration's start (only the program holds them after
    the first), so that each iteration is judged alone; the worlds and keys
    stay the reference's own. ``pool_fn(k_pool, n)`` gives the pool's worlds."""
    dev = key.device
    T, E, M = conf["rollout_steps"], conf["update_epochs"], conf["num_minibatches"]
    env_kw = dict(height=conf["env"]["height"], width=conf["env"]["width"],
                  max_steps=conf["env"]["max_steps"])
    params = {k: v.detach().to(dev).clone() for k, v in params.items()}
    opt = Adam(conf, params)
    rec = Record(*([] for _ in Record._fields))
    gaps = [0.0] * steps
    gamma, lam = conf["gamma"], conf["gae_lambda"]
    for s in range(steps):
        if follow is not None:
            params = {k: v.to(dev).clone() for k, v in follow.starts[s].items()}
            opt.load(follow.opts[s])
        rec.starts.append({k: v.clone() for k, v in params.items()})
        rec.opts.append(opt.state())
        key, k_pool, k_roll, k_perm = K.split(key, 4)
        pool = pool_fn(k_pool, 2 * B)
        u = K.uniform(K.split(k_roll, T), (6, B), 1e-7, 1.0)
        noise = -torch.log(-torch.log(u))
        del u
        stored, acts, logps, values, rewards, dones = [], [], [], [], [], []
        with torch.no_grad():
            for t in range(T):
                te = W.to_torch(env, dev)
                logits, value = policy.collect(params, te)
                g = logits + noise[t]
                if follow is None:
                    a = torch.argmax(g, dim=0).to(torch.int32)
                else:
                    a = follow.actions[s][t].to(dev)
                    gaps[s] = max(gaps[s], gumbel_argmax_gap(g, a))
                logps.append(torch.log_softmax(logits, dim=0).gather(0, a[None].to(torch.int64))[0])
                stored.append(policy.store(te))
                acts.append(a)
                values.append(value)
                env, raw, done = W.step(env, a.cpu().numpy(), **env_kw)
                off = (t * conf["pool_stride"]) % B
                env = W.where(done, W.take(pool, slice(off, off + B)), env)
                rewards.append(np.where(raw == env_kw["max_steps"], 1.0, -1.0 / env_kw["max_steps"]))
                dones.append(done)
            _, last_value = policy.collect(params, W.to_torch(env, dev))
            reward = torch.from_numpy(np.stack(rewards)).to(f32).to(dev)
            done = torch.from_numpy(np.stack(dones)).to(dev)
            value = torch.stack(values)
            adv = torch.empty_like(value)
            gae = torch.zeros_like(last_value)
            next_value = last_value
            for t in reversed(range(T)):
                not_done = 1.0 - done[t].to(f32)
                delta = reward[t] + gamma * next_value * not_done - value[t]
                gae = delta + gamma * lam * not_done * gae
                adv[t] = gae
                next_value = value[t]
            ret = (adv + value).reshape(-1)
        stored, action = _stack(stored), torch.stack(acts)
        vecs = [x.reshape(-1) for x in (action, torch.stack(logps), value, adv)]
        rec.actions.append(action)
        rec.envs.append(env)
        NB = T * B // policy.block
        nbm = NB // M
        for k_e in K.split(k_perm, E):
            perm = K.permutation(k_e, NB)
            for i in range(M):
                ids = perm[i * nbm:(i + 1) * nbm]
                rows = (ids[:, None] * policy.block + torch.arange(policy.block, device=dev)).reshape(-1)
                a_mb, lp_mb, v_mb, adv_mb = (x[rows] for x in vecs)
                adv_n = (adv_mb - adv_mb.mean()) / (adv_mb.std(correction=0) + 1e-8)
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                with torch.enable_grad():
                    logits, val = policy.forward(leaves, stored, rows)
                    out = ppo_loss(conf, logits, val, a_mb, lp_mb, v_mb, adv_n, ret[rows])
                    grads = dict(zip(leaves, torch.autograd.grad(out[0], list(leaves.values()))))
                opt.step(params, grads)
                if len(rec.mu_first) == s:
                    rec.losses.append([float(x.detach()) for x in out])
                    rec.mu_first.append({k: v.clone() for k, v in opt.mu.items()})
        rec.ends.append({k: v.clone() for k, v in params.items()})
        del stored, vecs
    return rec, gaps


def first_gradient(rec: Record, s: int) -> dict:
    """Iteration ``s``'s first gradient as the optimizer got it (clipped),
    from Adam's first moment before and after its first step."""
    b1 = 0.9
    mu0 = rec.opts[s][0]
    return {k: (v.double() - b1 * mu0[k].to(v.device).double()) / (1 - b1)
            for k, v in rec.mu_first[s].items()}


def leaf_gaps(prog: dict, ref: dict, names=None) -> dict:
    """Each leaf's gap of norms, ``| |p| - |r| |`` over ``max(|r|, the
    median leaf's |r|)``."""
    names = list(ref) if names is None else names
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = float(np.median(list(norms.values())))
    gaps = {}
    for k in names:
        p = float(torch.linalg.vector_norm(prog[k].to(ref[k].device).double()))
        gaps[k] = abs(p - norms[k]) / max(norms[k], med, 1e-30)
    return gaps


def compare(conf: dict, prog: Record, ref: Record, action_gaps: list):
    """(the numbers compared, their details by iteration and leaf).

    Each iteration starts both sides from the program's state, so each
    number is that of one iteration's work: the worlds after it (exact), the
    widest action gap of its collect, its first minibatch's loss (over the
    sum of its terms' magnitudes), its first gradient (worst leaf) and its
    change of the parameters (median leaf: Adam moves each element by about
    the learning rate whatever its gradient's size, so a small leaf whose
    gradient is partly round-off swings from seed to seed; its worst leaf is
    kept in the details). The change leaves out the leaves whose first
    gradient in the reference is under 1e-3 of the median leaf's: Adam moves
    those by round-off alone."""
    mismatches = sum(int(W.mismatched(p, r).sum()) for p, r in zip(prog.envs, ref.envs))
    loss_gaps, grad_gaps, change_gaps, left_out = [], [], [], []
    for s in range(len(ref.envs)):
        lp, (lr, pg, v, ent) = prog.losses[s][0], ref.losses[s]
        scale = abs(pg) + conf["vf_coef"] * abs(v) + conf["ent_coef"] * abs(ent)
        loss_gaps.append(abs(lp - lr) / scale)
        g_ref = first_gradient(ref, s)
        grad_gaps.append(leaf_gaps(first_gradient(prog, s), g_ref))
        norms = {k: float(torch.linalg.vector_norm(x)) for k, x in g_ref.items()}
        med = float(np.median(list(norms.values())))
        moved = [k for k in g_ref if norms[k] >= 1e-3 * med]
        left_out.append([k for k in g_ref if k not in moved])
        delta = lambda r: {k: r.ends[s][k].to(r.starts[s][k].device) - r.starts[s][k] for k in moved}
        change_gaps.append(leaf_gaps(delta(prog), delta(ref)))
    worst = lambda gaps: max(max(g.values()) for g in gaps)
    median = max(float(np.median(list(g.values()))) for g in change_gaps)
    detail = {"action_gaps": action_gaps, "loss_gaps": loss_gaps, "grad_gaps": grad_gaps,
              "change_gaps": change_gaps, "change_worst_leaf": worst(change_gaps),
              "left_out_of_change": left_out}
    return {"env_mismatch": mismatches, "action_gap": max(action_gaps), "loss_gap": max(loss_gaps),
            "grad_gap": worst(grad_gaps), "change_gap": median}, detail
