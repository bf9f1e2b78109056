"""Recurrent PPO: sequence-aware rollouts and updates for the GRU family.

Counterpart of ``gym_craftingworld_tpu/train/ppo_rnn.py``. Differences from
the feed-forward path (``train/ppo.py``):

  * the rollout carries (env_state, hidden) and stores per-step dones so the
    GRU can reset at episode boundaries;
  * minibatches shuffle over the ENV axis (whole sequences stay intact) and
    the loss re-runs the GRU over the full T steps from the rollout's initial
    hidden state (truncated-BPTT PPO), by autograd through a Python loop.

What the port does differently, as ``train/ppo.py`` does:

* The step takes JAX's key data int64[2] on the env's device and draws as
  JAX does: ``key, k_roll, k_perm = split(key, 3)``, step ``t``'s
  ``categorical(split(k_roll, T)[t], logits)`` as the argmax of Gumbel
  noise ``noise`` f32[T, B, 6] plus the logits (one launch of the counter
  kernel for the T steps' uniforms), and ``permutation(k_e, B)`` over the
  env axis for each ``k_e`` of ``split(k_perm, update_epochs)``. Both are
  drawn from the key unless passed in, so a test can pass JAX's draws. The
  GRU's init is flax's from the same kind of key (``models/flax_rng.py``).

A done env restarts from its own ``rng`` key, as in JAX (``ppo_rnn.py:100``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.core.rollout import _select
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import step
from gym_craftingworld_tpu_torch.models.actor_critic import feature_dim
from gym_craftingworld_tpu_torch.models.rnn import RecurrentActorCritic, init_params
from gym_craftingworld_tpu_torch.ops.fused_update import normalize_adv
from gym_craftingworld_tpu_torch.render.raster import render_onehot
from gym_craftingworld_tpu_torch.train import fast_ppo
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.train.ppo import (
    PPOConfig,
    Snapshot,
    gumbel_noise,
    make_optimizer,
    snapshot,
)

f32 = torch.float32


class RnnTransition(NamedTuple):
    obs: Snapshot  # [T, B, ...]
    prev_done: torch.Tensor  # bool[T, B]: episode boundary BEFORE this step
    action: torch.Tensor  # int32[T, B]
    log_prob: torch.Tensor  # f32[T, B]
    value: torch.Tensor  # f32[T, B]
    reward: torch.Tensor  # f32[T, B]
    done: torch.Tensor  # bool[T, B]


class RnnTrainState(NamedTuple):
    params: RecurrentActorCritic
    opt_state: fast_ppo.AdamState
    hidden: torch.Tensor  # f32[B, H], carried across train steps
    prev_done: torch.Tensor  # bool[B]
    update_idx: int


def _features(snap: Snapshot) -> torch.Tensor:
    B = snap.objects.shape[0]
    grid = render_onehot(snap.objects, snap.agent, snap.holding)
    return torch.cat([grid.reshape(B, -1).to(f32), snap.desired.to(f32),
                      snap.achieved.to(f32)], dim=-1)


def init_rnn_train_state(key: torch.Tensor, cfg: EnvConfig, ppo: PPOConfig,
                         batch_size: int) -> RnnTrainState:
    """The GRU actor-critic, flax's init from JAX's key data ``key`` on the
    key's device, a fresh optimizer state, a zero hidden state and no
    episode boundary."""
    params = init_params(key, feature_dim(cfg.height, cfg.width), ppo.hidden)
    opt_state = make_optimizer(ppo).init(dict(params.named_parameters()))
    return RnnTrainState(params, opt_state, params.initial_state(batch_size),
                         torch.zeros((batch_size,), dtype=torch.bool, device=key.device), 0)


def _collect(cfg: EnvConfig, ppo: PPOConfig, params: RecurrentActorCritic, env_state: EnvState,
             hidden: torch.Tensor, prev_done: torch.Tensor, noise: torch.Tensor):
    """``rollout_steps`` GRU policy steps with auto-reset; ``noise`` f32[T, B,
    6] Gumbel draws. Returns (env_state, hidden, prev_done, RnnTransition)."""
    T, B = ppo.rollout_steps, env_state.objects.shape[0]
    dev = env_state.objects.device
    buf = lambda x: torch.empty((T, *x.shape), dtype=x.dtype, device=dev)
    tr = RnnTransition(Snapshot(*(buf(x) for x in snapshot(env_state))),
                       *(torch.empty((T, B), dtype=d, device=dev)
                         for d in (torch.bool, torch.int32, f32, f32, f32, torch.bool)))
    win = torch.tensor(1.0, device=dev)
    lose = torch.tensor(-1.0 / cfg.max_steps, device=dev)
    st, h, done_prev = env_state, hidden, prev_done
    for t in range(T):
        obs = snapshot(st)
        h_next, logits, value = params(h, _features(obs), done_prev)
        action = torch.argmax(noise[t] + logits, dim=-1).to(torch.int32)
        log_prob = torch.log_softmax(logits, dim=-1).gather(1, action.long()[:, None])[:, 0]
        st, res = step(cfg, st, action)
        st = _select(res.done, reset(cfg, st.rng), st)
        for dst, src in zip(tr.obs, obs):
            dst[t] = src
        for dst, src in zip(tr[1:], (done_prev, action, log_prob, value,
                                     torch.where(res.reward == cfg.max_steps, win, lose),
                                     res.done)):
            dst[t] = src
        h, done_prev = h_next, res.done
    return st, h, done_prev, tr


def _seq_loss(ppo: PPOConfig, params: RecurrentActorCritic, mb):
    """The clipped-surrogate loss of one minibatch of whole sequences: the GRU
    re-run over its T steps from the minibatch's initial hidden state."""
    traj, adv, ret, h0 = mb
    h, logits, value = h0, [], []
    for t in range(traj.action.shape[0]):
        h, lg, v = params(h, _features(Snapshot(*(x[t] for x in traj.obs))), traj.prev_done[t])
        logits.append(lg)
        value.append(v)
    log_probs = torch.log_softmax(torch.stack(logits), dim=-1)  # [T, n, A]
    value = torch.stack(value)
    log_prob = log_probs.gather(2, traj.action.long()[..., None])[..., 0]
    ratio = torch.exp(log_prob - traj.log_prob)
    a_n = normalize_adv(adv)
    pg = -torch.minimum(ratio * a_n,
                        torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) * a_n).mean()
    v_clipped = traj.value + torch.clamp(value - traj.value, -ppo.clip_eps, ppo.clip_eps)
    v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2).mean()
    entropy = -(torch.exp(log_probs) * log_probs).sum(-1).mean()
    return pg + ppo.vf_coef * v_loss - ppo.ent_coef * entropy


def _update_phase(ppo: PPOConfig, ts: RnnTrainState, traj: RnnTransition, adv, ret,
                  h0: torch.Tensor, perms: torch.Tensor):
    """The minibatched updates of one iteration over env-axis permutations
    ``perms`` int[update_epochs, B]. Returns (params, opt_state, losses [E,
    M]); params are updated in place."""
    B = traj.action.shape[1]
    if B % ppo.num_minibatches:
        raise ValueError("batch must divide num_minibatches")
    mb_envs = B // ppo.num_minibatches
    optimizer = make_optimizer(ppo)
    params, opt_state = ts.params, ts.opt_state
    named = dict(params.named_parameters())
    losses = []
    for e in range(ppo.update_epochs):
        perm = perms[e].to(torch.int64)
        for i in range(ppo.num_minibatches):
            idx = perm[i * mb_envs: (i + 1) * mb_envs]
            take = lambda x: x[:, idx]
            mb_traj = RnnTransition(Snapshot(*(take(x) for x in traj.obs)),
                                    *(take(x) for x in traj[1:]))
            with torch.enable_grad():
                loss = _seq_loss(ppo, params, (mb_traj, take(adv), take(ret), h0[idx]))
                grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
            updates, opt_state = optimizer.update(grads, opt_state)
            fast_ppo.apply_updates(params, updates)
            losses.append(loss.detach())
    return params, opt_state, torch.stack(losses).reshape(ppo.update_epochs,
                                                          ppo.num_minibatches)


@torch.no_grad()
def train_step_rnn(cfg: EnvConfig, ppo: PPOConfig, ts: RnnTrainState, env_state: EnvState,
                   key: torch.Tensor, noise: torch.Tensor | None = None,
                   perms: torch.Tensor | None = None):
    """One recurrent PPO iteration: rollout -> GAE -> minibatched sequence
    updates; (ts, env_state, key, metrics). ``key`` is JAX's key data
    int64[2] on the env's device; the Gumbel ``noise`` f32[T, B, 6] and the
    env permutations ``perms`` int[update_epochs, B] are drawn from it as
    JAX's ``train_step_rnn`` draws them unless they are passed in, and the
    next key is returned. The auto-reset worlds come from the envs' keys."""
    T, B = ppo.rollout_steps, env_state.objects.shape[0]
    key, k_roll, k_perm = kd.split_keys(key, 3)
    if noise is None:
        noise = gumbel_noise(k_roll, B, planes=T)
    h0 = ts.hidden
    env_state, hidden, prev_done, traj = _collect(cfg, ppo, ts.params, env_state, h0,
                                                  ts.prev_done, noise)
    _, _, last_value = ts.params(hidden, _features(snapshot(env_state)), prev_done)
    adv, ret = fast_ppo._gae(ppo, traj, last_value)  # generalised advantages, f32[T, B]
    if perms is None:
        perms = fast_ppo.epoch_perms(k_perm, ppo.update_epochs, B)
    params, opt_state, losses = _update_phase(ppo, ts, traj, adv, ret, h0, perms)
    metrics = {
        "loss": losses.mean(),
        "reward_mean": traj.reward.mean(),
        "success_rate": (traj.reward > 0.5).sum() / traj.done.sum().clamp_min(1),
    }
    ts = RnnTrainState(params, opt_state, hidden, prev_done, ts.update_idx + 1)
    return ts, env_state, key, metrics
