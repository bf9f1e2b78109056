"""PPO over the batched grid env: the parity-grade trainer of the flax families.

Counterpart of ``gym_craftingworld_tpu/train/ppo.py``: a rollout of batched
env steps with auto-reset, GAE, and clipped-surrogate updates over shuffled
minibatches, for the three policy families ``mlp`` (``models/actor_critic``),
``cnn`` (``models/cnn``) and ``vit`` (``models/vit``). Rollouts store a
compact ``Snapshot`` of each step's state, and the loss renders the
observations anew from it.

What the port does differently:

* Stepping is the port's batched grid step (``core/step.step``); a done env
  restarts from its own ``rng`` key, as in JAX (``core/rollout.py``).
* The step takes JAX's key data int64[2] on the env's device and draws as
  JAX does: ``key, k_roll, k_perm = split(key, 3)``, the collect's chain
  ``k, k_act = split(k)`` a step (advanced on the device by the counter
  kernel), ``categorical(k_act, logits)`` as the argmax of Gumbel noise plus
  the logits (the noise's uniforms bit for bit, its logarithms torch's),
  and ``permutation(k_e, T*B)`` over ``split(k_perm, update_epochs)``, sorted
  on the device. The pure functions take the noise ``noise`` f32[T, B, 6]
  and the permutations ``perms`` int[update_epochs, T*B] explicitly, so a
  test can pass JAX's draws in. ``init_train_state`` takes key data too
  and draws the family's parameters as flax's ``model.init`` does
  (``models/flax_rng.py``).
* A policy is a ``torch.nn.Module`` holding its parameters (flax's names and
  layouts, ``models/layers.py``); the optimizer is the hand-written clip +
  Adam of ``train/fast_ppo.py`` on its named parameters, applied in place.
* Under a ``mesh`` (``parallel/mesh.ppo_train_step_sharded``) a rank steps
  its own columns of the batch and computes the unsharded step's function:
  its envs restart from their own keys, so it builds and draws only its own
  worlds; it draws only its own envs' noise (the whole draw's values
  there) and the whole permutations; minibatch row
  ``t*B + b`` belongs to rank ``b // (B / world)``; each minibatch's
  advantages are normalised over all its rows; each rank differentiates its
  rows' share of the means, and one ``all_reduce`` a minibatch sums the
  gradients and loss terms before the clip and Adam, run alike on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.core.rollout import _select
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import step
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops import threefry as tf
from gym_craftingworld_tpu_torch.ops.fused_update import normalize_adv
from gym_craftingworld_tpu_torch.parallel.mesh import sum_over_ranks
from gym_craftingworld_tpu_torch.render.raster import render_onehot, render_ray
from gym_craftingworld_tpu_torch.train import fast_ppo

f32 = torch.float32


class PPOConfig(NamedTuple):
    rollout_steps: int = 64
    update_epochs: int = 2
    num_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: int = 512
    policy: str = "mlp"  # "mlp" (one-hot features) | "cnn" (pixel renders) | "vit"


class Snapshot(NamedTuple):
    """Compact per-step state capture stored in rollouts; observations are
    rendered anew from it in the loss."""

    objects: torch.Tensor  # int8[B, H, W]
    agent: torch.Tensor  # int32[B, 2]
    holding: torch.Tensor  # int32[B]
    desired: torch.Tensor  # int8[B, 9]
    achieved: torch.Tensor  # int8[B, 9]


class Transition(NamedTuple):
    obs: Snapshot  # [T, B, ...]
    action: torch.Tensor  # int32[T, B]
    log_prob: torch.Tensor  # f32[T, B]
    value: torch.Tensor  # f32[T, B]
    reward: torch.Tensor  # f32[T, B]
    done: torch.Tensor  # bool[T, B]


class TrainState(NamedTuple):
    params: nn.Module
    opt_state: fast_ppo.AdamState
    update_idx: int


def snapshot(state: EnvState) -> Snapshot:
    return Snapshot(state.objects, state.agent, state.holding, state.desired, state.achieved)


def _goal_bits(snap: Snapshot) -> torch.Tensor:
    return torch.cat([snap.desired.to(f32), snap.achieved.to(f32)], dim=-1)


def make_policy(ppo: PPOConfig):
    """Model family dispatch: (module class, apply(params, snapshot))."""
    if ppo.policy == "mlp":
        from gym_craftingworld_tpu_torch.models.actor_critic import ActorCritic

        def apply_fn(params, snap: Snapshot):
            B = snap.objects.shape[0]
            grid = render_onehot(snap.objects, snap.agent, snap.holding)
            return params(torch.cat([grid.reshape(B, -1).to(f32), _goal_bits(snap)], dim=-1))

        return ActorCritic, apply_fn
    if ppo.policy == "cnn":
        from gym_craftingworld_tpu_torch.models.cnn import PixelActorCritic

        def apply_fn(params, snap: Snapshot):
            return params(render_ray(snap.objects, snap.agent, snap.holding), _goal_bits(snap))

        return PixelActorCritic, apply_fn
    if ppo.policy == "vit":
        from gym_craftingworld_tpu_torch.models.vit import GridActorCritic

        def apply_fn(params, snap: Snapshot):
            B, H, W = snap.objects.shape
            grid = render_onehot(snap.objects, snap.agent, snap.holding)
            return params(grid.reshape(B, H * W, grid.shape[-1]), _goal_bits(snap))

        return GridActorCritic, apply_fn
    raise ValueError(f"unknown policy family {ppo.policy!r}")


def make_optimizer(ppo: PPOConfig) -> fast_ppo.Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))`` on a dict
    of named tensors (``train/fast_ppo.make_optimizer``)."""
    return fast_ppo.make_optimizer(ppo)


def init_train_state(key: torch.Tensor, cfg: EnvConfig, ppo: PPOConfig) -> TrainState:
    """The family's module, flax's init from JAX's key data ``key`` on the
    key's device, and a fresh optimizer state."""
    if ppo.policy == "cnn":
        from gym_craftingworld_tpu_torch.models.cnn import init_params
    elif ppo.policy == "vit":
        from gym_craftingworld_tpu_torch.models.vit import init_params
    else:
        from gym_craftingworld_tpu_torch.models.actor_critic import init_params

    params = init_params(key, cfg.height, cfg.width, ppo.hidden)
    return TrainState(params, make_optimizer(ppo).init(dict(params.named_parameters())), 0)


def gumbel_noise(keys: torch.Tensor, B: int, cols: slice = slice(None),
                 planes: int = 0) -> torch.Tensor:
    """``jax.random.categorical``'s Gumbel noise f32[T, len(cols), 6] of the
    envs ``cols`` of a batch of B: ``gumbel(k_t, (B, 6))`` for each key
    ``k_t`` of ``keys`` [T, 2] or, with ``planes`` T, of ``split(keys, T)``;
    one launch on the card. Env ``b``'s row is counters ``6b .. 6b + 5``."""
    r = range(B)[cols]
    u = kd.uniform_cols(keys, (1, B * C.N_ACTIONS), slice(r.start * C.N_ACTIONS,
                                                          r.stop * C.N_ACTIONS),
                        tf.TINY, 1.0, planes=planes)
    return tf.gumbel_from_uniform(u.reshape(u.shape[0], len(r), C.N_ACTIONS))


def collect_noise(k_roll: torch.Tensor, T: int, B: int, cols: slice = slice(None)) -> torch.Tensor:
    """The collect's noise from ``k_roll``: the chain ``k, k_act = split(k)``
    a step (``keyed_draws.chain_keys``), then ``gumbel_noise`` of the T
    ``k_act``s."""
    return gumbel_noise(kd.chain_keys(k_roll, T)[1], B, cols)


def _collect(cfg: EnvConfig, ppo: PPOConfig, apply_fn, params: nn.Module,
             env_state: EnvState, noise: torch.Tensor):
    """``rollout_steps`` policy steps with auto-reset; ``noise`` f32[T, B, 6]
    Gumbel draws. Done envs restart from their own keys. Returns
    (env_state, Transition). Under a mesh, ``env_state`` and ``noise`` are
    this rank's columns."""
    T, B = ppo.rollout_steps, env_state.objects.shape[0]
    dev = env_state.objects.device
    buf = lambda x: torch.empty((T, *x.shape), dtype=x.dtype, device=dev)
    tr = Transition(Snapshot(*(buf(x) for x in snapshot(env_state))),
                    *(torch.empty((T, B), dtype=d, device=dev)
                      for d in (torch.int32, f32, f32, f32, torch.bool)))
    win = torch.tensor(1.0, device=dev)
    lose = torch.tensor(-1.0 / cfg.max_steps, device=dev)
    st = env_state
    for t in range(T):
        obs = snapshot(st)
        logits, value = apply_fn(params, obs)
        action = torch.argmax(noise[t] + logits, dim=-1).to(torch.int32)
        log_prob = torch.log_softmax(logits, dim=-1).gather(1, action.long()[:, None])[:, 0]
        st, res = step(cfg, st, action)
        st = _select(res.done, reset(cfg, st.rng), st)
        for dst, src in zip(tr.obs, obs):
            dst[t] = src
        for dst, src in zip(tr[1:], (action, log_prob, value,
                                     torch.where(res.reward == cfg.max_steps, win, lose),
                                     res.done)):
            dst[t] = src
    return st, tr


def _gae(ppo: PPOConfig, traj: Transition, last_value: torch.Tensor):
    """Generalised advantages (reverse scan); (adv, returns) f32[T, B]."""
    return fast_ppo._gae(ppo, traj, last_value)


def _ppo_loss(ppo: PPOConfig, apply_fn, params: nn.Module, batch, normalized: bool = False,
              n_total: int | None = None):
    """``normalized`` and ``n_total`` as ``train/fast_ppo._ppo_loss`` takes them."""
    obs, action, old_log_prob, old_value, adv, ret = batch
    mean = fast_ppo.shard_mean(n_total)
    logits, value = apply_fn(params, obs)
    log_probs = torch.log_softmax(logits, dim=-1)
    log_prob = log_probs.gather(1, action.long()[:, None])[:, 0]
    ratio = torch.exp(log_prob - old_log_prob)
    adv_n = adv if normalized else normalize_adv(adv)
    pg = -mean(torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) * adv_n,
    ))
    v_clipped = old_value + torch.clamp(value - old_value, -ppo.clip_eps, ppo.clip_eps)
    v_loss = 0.5 * mean(torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2))
    entropy = -mean((torch.exp(log_probs) * log_probs).sum(-1))
    loss = pg + ppo.vf_coef * v_loss - ppo.ent_coef * entropy
    return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": entropy}


def _grads(ppo: PPOConfig, apply_fn, params: nn.Module, batch, normalized: bool = False,
           n_total: int | None = None):
    """(grads by parameter name, aux with "loss") by autograd of ``_ppo_loss``."""
    named = dict(params.named_parameters())
    with torch.enable_grad():
        loss, aux = _ppo_loss(ppo, apply_fn, params, batch, normalized, n_total)
        g = torch.autograd.grad(loss, list(named.values()))
    return dict(zip(named, g)), {"loss": loss.detach(),
                                 **{k: v.detach() for k, v in aux.items()}}


def minibatches(ppo: PPOConfig, traj: Transition, adv, ret, perms: torch.Tensor, mesh=None):
    """The update phase's minibatches in order, as (batch, n_total).

    ``perms`` int[update_epochs, T*B]: each epoch's permutation of the whole
    batch's rows (row ``t*B + b``). ``batch`` = (snapshots, action,
    old_log_prob, old_value, adv_n, ret) of this rank's rows of the
    minibatch, in minibatch order, the advantages normalised over all of its
    rows; ``n_total`` the minibatch's rows under a mesh of several ranks,
    else None. Under such a mesh the whole batch's ``adv`` is gathered once
    and the permutations read on the host once.
    """
    T, Bl = traj.action.shape
    world = 1 if mesh is None else mesh.size
    B = Bl * world
    merge = lambda x: x.reshape((T * Bl,) + x.shape[2:])
    flat = (Snapshot(*(merge(x) for x in traj.obs)),) + tuple(
        merge(x) for x in (traj.action, traj.log_prob, traj.value, ret))
    adv_all = (adv if mesh is None else mesh.gather(adv)).reshape(T * B)
    mb_size = T * B // ppo.num_minibatches
    host = perms.cpu() if world > 1 else None
    for e in range(ppo.update_epochs):
        perm = perms[e].to(torch.int64)
        for i in range(ppo.num_minibatches):
            idx = perm[i * mb_size: (i + 1) * mb_size]
            adv_n = normalize_adv(adv_all[idx])
            if world > 1:  # a row is a block of one
                own, idx = mesh.own(host[e, i * mb_size: (i + 1) * mb_size].to(torch.int64), B)
                idx, adv_n = idx.to(perm.device), adv_n[own.to(perm.device)]
            obs, action, old_lp, old_v, r = flat
            yield ((Snapshot(*(x[idx] for x in obs)), action[idx], old_lp[idx], old_v[idx],
                    adv_n, r[idx]), mb_size if world > 1 else None)


def minibatch_grads(ppo: PPOConfig, apply_fn, params: nn.Module, batch,
                    n_total: int | None = None, mesh=None):
    """(grads, aux with "loss") of one minibatch from ``minibatches``, summed
    over the ranks; a rank with no rows of it contributes zeros."""
    if batch[1].numel() == 0:
        grads = {k: torch.zeros_like(p) for k, p in params.named_parameters()}
        aux = {k: torch.zeros((), device=batch[1].device)
               for k in ("loss", "pg_loss", "v_loss", "entropy")}
    else:
        grads, aux = _grads(ppo, apply_fn, params, batch, True, n_total)
    grads, aux = sum_over_ranks(mesh, grads, aux)
    return grads, aux


def _update_phase(ppo: PPOConfig, apply_fn, ts: TrainState, traj: Transition, adv, ret,
                  perms: torch.Tensor, mesh=None):
    """The minibatched updates of one iteration. ``perms`` int[update_epochs,
    T*B]: each epoch's permutation of the rows. Returns (params, opt_state,
    losses [E, M], aux dict of [E, M]); params are updated in place."""
    optimizer = make_optimizer(ppo)
    params, opt_state = ts.params, ts.opt_state
    losses, auxes = [], []
    for batch, n_total in minibatches(ppo, traj, adv, ret, perms, mesh):
        grads, aux = minibatch_grads(ppo, apply_fn, params, batch, n_total, mesh)
        updates, opt_state = optimizer.update(grads, opt_state)
        fast_ppo.apply_updates(params, updates)
        losses.append(aux.pop("loss"))
        auxes.append(aux)
    shape = (ppo.update_epochs, ppo.num_minibatches)
    stack = lambda xs: torch.stack(xs).reshape(shape)
    return (params, opt_state, stack(losses),
            {k: stack([a[k] for a in auxes]) for k in auxes[0]})


@torch.no_grad()
def rollout_phase(cfg: EnvConfig, ppo: PPOConfig, ts: TrainState, env_state: EnvState,
                  key: torch.Tensor, mesh=None):
    """The draws, the collect and GAE of one iteration; (env_state, (traj,
    adv, ret, perms), next key). ``key, k_roll, k_perm = split(key, 3)`` as
    JAX's ``train_step``; the noise [T, B, 6] from ``k_roll``'s chain (under
    a mesh, the rank's envs only) and the epoch permutations of the whole
    batch from ``k_perm``."""
    _, apply_fn = make_policy(ppo)
    T, Bl = ppo.rollout_steps, env_state.objects.shape[0]
    B = Bl if mesh is None else Bl * mesh.size
    key, k_roll, k_perm = kd.split_keys(key, 3)
    noise = collect_noise(k_roll, T, B, slice(None) if mesh is None else mesh.cols(B))
    env_state, traj = _collect(cfg, ppo, apply_fn, ts.params, env_state, noise)
    _, last_value = apply_fn(ts.params, snapshot(env_state))
    adv, ret = _gae(ppo, traj, last_value)
    perms = fast_ppo.epoch_perms(k_perm, ppo.update_epochs, T * B)
    return env_state, (traj, adv, ret, perms), key


@torch.no_grad()
def train_step(cfg: EnvConfig, ppo: PPOConfig, ts: TrainState, env_state: EnvState,
               key: torch.Tensor, mesh=None):
    """One PPO iteration: rollout -> GAE -> minibatched clipped updates;
    (ts, env_state, key, metrics). The auto-reset worlds come from the envs'
    keys; ``key``, JAX's key data int64[2] on the env's device, draws the
    noise and the epoch permutations as JAX's ``train_step`` does, and the
    next key is returned. Under a ``mesh`` ``env_state`` is this rank's
    columns, every rank holds the same key, and the metrics' sums run over
    every rank."""
    _, apply_fn = make_policy(ppo)
    env_state, (traj, adv, ret, perms), key = rollout_phase(cfg, ppo, ts, env_state, key, mesh)
    params, opt_state, losses, auxes = _update_phase(ppo, apply_fn, ts, traj, adv, ret, perms,
                                                     mesh)
    T, Bl = traj.action.shape
    n = T * Bl * (1 if mesh is None else mesh.size)
    sums = torch.stack([traj.reward.sum(), traj.done.sum().to(f32), (traj.reward > 0.5).sum().to(f32)])
    if mesh is not None:
        mesh.all_reduce(sums)
    reward, dones, successes = sums
    metrics = {
        "loss": losses.mean(),
        "reward_mean": reward / n,
        "episode_done_frac": dones / n,
        "success_rate": successes / dones.clamp_min(1),
        **{k: v.mean() for k, v in auxes.items()},
    }
    return TrainState(params, opt_state, ts.update_idx + 1), env_state, key, metrics
