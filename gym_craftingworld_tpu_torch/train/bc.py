"""Imitation learning: expert demonstrations -> behavioral cloning.

Counterpart of ``gym_craftingworld_tpu/train/bc.py``, the small-data
imitation path (flat features in host memory; ``train/dagger.py`` is the
large-data one):

  * :func:`collect_demos` drives the scripted expert (``agents/expert.py``)
    through seeded episodes of the Ray façade on ``device`` and records
    (goal-conditioned feature, expert action) pairs;
  * :func:`bc_train` clones a policy (by default the flagship ``ActorCritic``)
    with a cross-entropy trainer and plain Adam, as ``optax.adam(lr)``;
  * :func:`evaluate_bc` and :func:`evaluate_bc_stacked` roll the clone
    greedily through the façade and report success.

A policy is a ``torch.nn.Module`` holding its parameters, so where the JAX
package passes ``(model, params)`` the port passes the module alone, and
``bc_train`` returns ``(model, metrics)``. It takes JAX's key data and
splits it as JAX does (``key, init_key = split(key)``, then ``key, k =
split(key)`` and ``permutation(k, n)`` an epoch), unless ``perms`` passes the
permutations in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.agents.expert import ExpertPolicy
from gym_craftingworld_tpu_torch.api.gym_env import CraftingWorldEnvRay
from gym_craftingworld_tpu_torch.models.actor_critic import feature_dim, init_params, obs_features
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.train import fast_ppo
from gym_craftingworld_tpu_torch.train.evaluate import _HostView


class Demos(NamedTuple):
    """Flat demonstration dataset (episodes concatenated)."""

    features: np.ndarray  # f32[N, D] — obs_features rows
    actions: np.ndarray  # i32[N] — expert action per row
    episode: np.ndarray  # i32[N] — source episode index (for splits)

    @property
    def num_episodes(self) -> int:
        return int(self.episode.max()) + 1 if self.episode.size else 0

    def save(self, path: str) -> None:
        np.savez_compressed(path, features=self.features,
                            actions=self.actions, episode=self.episode)

    @classmethod
    def load(cls, path: str) -> "Demos":
        with np.load(path) as z:
            return cls(z["features"], z["actions"], z["episode"])


def _row(feature_fn, state) -> np.ndarray:
    return (feature_fn or obs_features)(state)[0].cpu().numpy()


def collect_demos(num_episodes: int, seed: int = 0, only_successful: bool = True,
                  random_warmup: int = 0, feature_fn=None, **env_kwargs) -> Demos:
    """Expert demonstrations over ``num_episodes`` seeded resets.

    ``env_kwargs`` pass through to :class:`CraftingWorldEnvRay` (grid size,
    ``selected_tasks``, ``stacking``, ``fixed_init_state``, ``rng_mode``,
    ``device``: the card unless the caller names another). With
    ``only_successful`` (default) episodes where the expert failed are
    dropped. ``feature_fn`` overrides the per-state feature function (default
    ``obs_features``; the CPV protocol passes ``obs_features_init``).
    ``random_warmup > 0`` takes 0..N unrecorded random move steps before the
    expert takes over.
    """
    env = CraftingWorldEnvRay(seed=seed, **env_kwargs)
    wrng = np.random.RandomState(seed + 977)
    feats: list[np.ndarray] = []
    acts: list[int] = []
    eps: list[int] = []
    kept = 0
    for _ in range(num_episodes):
        env.reset()
        if random_warmup:
            dead = False
            for _ in range(wrng.randint(0, random_warmup + 1)):
                _, _, done, _ = env.step(int(wrng.randint(4)))
                if done:  # warmup stumbled into the goal; drop the episode
                    dead = True
                    break
            if dead:
                continue
        expert = ExpertPolicy(_HostView(env))
        ep_f: list[np.ndarray] = []
        ep_a: list[int] = []
        reward = -1
        for _ in range(env.MAX_STEPS):
            a = expert.action()
            if a is None:  # stalled: mirror ExpertPolicy.run_episode
                a = C.ACTION_UP
            ep_f.append(_row(feature_fn, env.state))
            ep_a.append(int(a))
            _, reward, done, _ = env.step(int(a))
            if done:
                break
        if only_successful and reward != env.MAX_STEPS:
            continue
        feats.extend(ep_f)
        acts.extend(ep_a)
        eps.extend([kept] * len(ep_a))
        kept += 1
    if not feats:
        raise ValueError("expert produced no successful demonstrations")
    return Demos(
        np.stack(feats).astype(np.float32),
        np.asarray(acts, np.int32),
        np.asarray(eps, np.int32),
    )


def augment_stacked_goals(demos: Demos, height: int, width: int,
                          first_task: int, second_task: int) -> Demos:
    """Plan-space augmentation for compositional execution (no new rollouts).

    Rows demonstrating ``first_task`` get ``second_task`` added to
    ``desired``; rows demonstrating ``second_task`` get ``first_task`` added
    to both ``desired`` and ``achieved``. Returns only the augmented rows.
    """
    grid_dim = height * width * C.N_CHANNELS
    des = demos.features[:, grid_dim : grid_dim + C.N_TASKS]
    rows_first = des[:, first_task] == 1
    rows_second = des[:, second_task] == 1
    f1 = demos.features[rows_first].copy()
    f1[:, grid_dim + second_task] = 1
    f2 = demos.features[rows_second].copy()
    f2[:, grid_dim + first_task] = 1
    f2[:, grid_dim + C.N_TASKS + first_task] = 1
    return Demos(
        np.concatenate([f1, f2]),
        np.concatenate([demos.actions[rows_first],
                        demos.actions[rows_second]]),
        np.concatenate([demos.episode[rows_first],
                        demos.episode[rows_second]]),
    )


def concat_demos(*parts: Demos) -> Demos:
    """Concatenate datasets, re-basing episode indices to stay unique."""
    feats, acts, eps = [], [], []
    base = 0
    for d in parts:
        feats.append(d.features)
        acts.append(d.actions)
        eps.append(d.episode + base)
        base += d.num_episodes
    return Demos(np.concatenate(feats), np.concatenate(acts),
                 np.concatenate(eps))


def _ce_grads(model: torch.nn.Module, fb: torch.Tensor, ab: torch.Tensor):
    """(cross-entropy of the expert actions, grads by parameter name); the
    value head, which the loss does not read, gets zeros, as under JAX."""
    named = dict(model.named_parameters())
    with torch.enable_grad():
        logits, _ = model(fb)
        loss = -torch.log_softmax(logits, dim=-1).gather(1, ab.long()[:, None]).mean()
        g = torch.autograd.grad(loss, list(named.values()), materialize_grads=True)
    return loss.detach(), dict(zip(named, g))


@torch.no_grad()
def bc_train(demos: Demos, key: torch.Tensor, height: int, width: int,
             hidden: int = 256, epochs: int = 30, batch_size: int = 256, lr: float = 1e-3,
             model: torch.nn.Module | None = None, perms=None):
    """Clone the expert: cross-entropy on actions over shuffled minibatches.

    Returns ``(model, metrics)``; metrics carry per-epoch ``loss`` and the
    final training ``accuracy``. By default trains a fresh ``ActorCritic``,
    flax's init from ``init_key``; pass ``model`` to clone any family whose
    forward is ``model(obs) -> (logits, value)``. The data, the model and
    the draws live on the key's device (JAX's key data int64[2]). ``perms``,
    one permutation of the rows per epoch, replaces the key's.
    """
    if demos.features.shape[1] != feature_dim(height, width):
        raise ValueError(
            f"demo feature width {demos.features.shape[1]} does not match "
            f"a {height}x{width} grid ({feature_dim(height, width)})")
    dev = key.device
    key, init_key = kd.split_keys(key, 2)
    if model is None:
        model = init_params(init_key, height, width, hidden)
    tx = fast_ppo.adam(lr)
    opt_state = tx.init(dict(model.named_parameters()))
    feats = torch.from_numpy(demos.features).to(dev)
    actions = torch.from_numpy(demos.actions).to(dev)
    n = feats.shape[0]
    batch_size = min(batch_size, n)
    losses = []
    steps = max(1, n // batch_size)
    for epoch in range(epochs):
        if perms is None:
            key, perm = kd.split_permutation(key, n)
        else:
            perm = torch.as_tensor(perms[epoch], device=dev)
        perm = perm.to(torch.int64)
        ep_loss = []
        for i in range(steps):
            idx = perm[i * batch_size: (i + 1) * batch_size]
            loss, grads = _ce_grads(model, feats[idx], actions[idx])
            updates, opt_state = tx.update(grads, opt_state)
            fast_ppo.apply_updates(model, updates)
            ep_loss.append(loss)
        losses.append(float(torch.stack(ep_loss).double().sum()) / steps)
    metrics = {"loss": losses, "accuracy": bc_accuracy(model, demos)}
    return model, metrics


@torch.no_grad()
def bc_accuracy(model: torch.nn.Module, demos: Demos) -> float:
    """Fraction of dataset rows where argmax policy == expert action."""
    dev = next(model.parameters()).device
    logits, _ = model(torch.from_numpy(demos.features).to(dev))
    actions = torch.from_numpy(demos.actions).to(dev)
    return float((torch.argmax(logits, dim=-1) == actions).to(torch.float32).mean())


def _greedy(model: torch.nn.Module, env) -> int:
    with torch.no_grad():
        logits, _ = model(obs_features(env.state))
    return int(torch.argmax(logits[0]))


def evaluate_bc(model: torch.nn.Module, num_episodes: int, seed: int = 0,
                **env_kwargs) -> dict:
    """Greedy rollouts of the cloned policy through the Ray façade (its
    ``env_kwargs`` as ``collect_demos`` takes them); success/return stats."""
    env = CraftingWorldEnvRay(seed=seed, **env_kwargs)
    successes, steps_used = 0, []
    for _ in range(num_episodes):
        env.reset()
        reward = -1
        for t in range(env.MAX_STEPS):
            _, reward, done, _ = env.step(_greedy(model, env))
            if done:
                break
        if reward == env.MAX_STEPS:
            successes += 1
            steps_used.append(t + 1)
    return {
        "success_rate": successes / num_episodes,
        "mean_success_steps": float(np.mean(steps_used)) if steps_used else None,
        "episodes": num_episodes,
    }


def evaluate_bc_stacked(model: torch.nn.Module, num_episodes: int, seed: int = 0,
                        n_tasks: int = 2, **env_kwargs) -> dict:
    """Greedy rollouts on episodes whose goal stacks exactly ``n_tasks`` bits
    (``stacking=True`` resets until one with ``n_tasks`` desired bits comes
    up), the compositional-execution measurement."""
    env = CraftingWorldEnvRay(seed=seed, stacking=True, **env_kwargs)
    successes, tries, resets = 0, 0, 0
    while tries < num_episodes and resets < 50 * num_episodes:
        env.reset()
        resets += 1
        if int(np.asarray(env.desired_goal_vector).sum()) != n_tasks:
            continue
        tries += 1
        reward = -1
        for _ in range(env.MAX_STEPS):
            _, reward, done, _ = env.step(_greedy(model, env))
            if done:
                break
        successes += reward == env.MAX_STEPS
    return {"success_rate": successes / max(tries, 1), "episodes": tries}
