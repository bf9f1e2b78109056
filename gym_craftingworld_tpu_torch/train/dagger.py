"""BC + DAgger at scale: the trainer behind the canonical-setting policy.

Counterpart of ``gym_craftingworld_tpu/train/dagger.py``, the large-data
imitation path (``train/bc.py`` is the small-data one):

  * the dataset lives on the device as ``SnapDataset`` integer columns
    (``train/demos.py``) and policy features are rebuilt per minibatch
    (``models/grid_policy.py``);
  * evaluation is a batched greedy rollout over the grid reset and step on
    the device, the measurement ``train/evaluate.py`` defines;
  * DAgger (Ross et al., AISTATS 2011): roll the current policy on the
    device, pull only the snapshot rows of visited states, relabel them with
    the scripted expert on the host (``train/demos.NumpyExpert``), fold them
    into the dataset and keep training.

What the port does differently. A policy (``GridPolicy`` or
``CPVGridPolicy``) is a ``torch.nn.Module`` holding its parameters, so where
the JAX package passes ``(model, params)`` the port passes the module, and
``BCTrainState.params`` is the module. Each epoch's permutation, the resets
and the exploration draws come from generators on the model's device unless
passed in (``perms``, ``state``, ``explore``). The JAX evaluation loops until
every episode is done; finished episodes are frozen, so the port checks for
that every ``_DONE_EVERY`` steps, one host sync per check, with the same
result.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.reset import reset_from_generator
from gym_craftingworld_tpu_torch.core.rollout import _select
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import step
from gym_craftingworld_tpu_torch.models.grid_policy import (
    init_grid_policy,
    planes_from_snaps,
    planes_from_state,
    snap_columns_from_state,
)
from gym_craftingworld_tpu_torch.train import fast_ppo
from gym_craftingworld_tpu_torch.train.demos import (
    NumpyExpert,
    SnapDataset,
    grids_from_snaps,
    label_snapshot,
    mask_to_bits,
)

_COL_FIELDS = (
    "occ_key", "occ_code", "init_key", "init_agent_key", "agent_key",
    "holding", "desired", "achieved",
)
_DONE_EVERY = 32  # greedy steps between all-done checks


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def device_columns(snaps: SnapDataset, device="cuda") -> dict:
    """Upload the feature columns + labels once; ~40 bytes/row."""
    cols = {k: torch.from_numpy(np.asarray(getattr(snaps, k))).to(device) for k in _COL_FIELDS}
    cols["action"] = torch.from_numpy(snaps.action.astype(np.int32)).to(device)
    return cols


def _batch_planes(cfg: EnvConfig, cols: dict):
    return planes_from_snaps(
        cfg, cols["occ_key"], cols["occ_code"], cols["init_key"],
        cols["init_agent_key"], cols["agent_key"], cols["holding"],
        cols["desired"], cols["achieved"],
    )


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


class BCTrainState(NamedTuple):
    params: torch.nn.Module
    opt_state: fast_ppo.AdamState


def _make_tx(lr: float) -> fast_ppo.Optimizer:
    """``optax.chain(clip_by_global_norm(1.0), adam(lr))``."""
    return fast_ppo.adam(lr, max_norm=1.0)


def init_bc_state(model: torch.nn.Module) -> BCTrainState:
    """``model`` with a fresh optimizer state (its shape does not depend on
    the learning rate)."""
    return BCTrainState(model, _make_tx(0.0).init(dict(model.named_parameters())))


def _snap_grads(cfg: EnvConfig, model: torch.nn.Module, mb: dict):
    """(cross-entropy, accuracy, grads by parameter name) of one minibatch of
    snapshot columns; the value head gets zero gradients."""
    planes, extras = _batch_planes(cfg, mb)
    named = dict(model.named_parameters())
    with torch.enable_grad():
        logits, _ = model(planes, extras)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -logp.gather(1, mb["action"].long()[:, None]).mean()
        g = torch.autograd.grad(ce, list(named.values()), materialize_grads=True)
    acc = (torch.argmax(logits, -1) == mb["action"]).to(torch.float32).mean()
    return ce.detach(), acc, dict(zip(named, g))


@torch.no_grad()
def _bc_epoch(cfg: EnvConfig, lr: float, ts: BCTrainState, data: dict, perm: torch.Tensor,
              batch_size: int):
    """One epoch over shuffled minibatches; the remainder rows are dropped.
    Returns (ts, {"loss", "accuracy"} as 0-dim tensors); the parameters are
    updated in place."""
    tx = _make_tx(lr)
    steps = perm.shape[0] // batch_size
    perm = perm.to(torch.int64)
    model, opt_state = ts
    losses, accs = [], []
    for i in range(steps):
        idx = perm[i * batch_size: (i + 1) * batch_size]
        mb = {k: v[idx] for k, v in data.items()}
        loss, acc, grads = _snap_grads(cfg, model, mb)
        updates, opt_state = tx.update(grads, opt_state)
        fast_ppo.apply_updates(model, updates)
        losses.append(loss)
        accs.append(acc)
    return BCTrainState(model, opt_state), {"loss": torch.stack(losses).mean(),
                                            "accuracy": torch.stack(accs).mean()}


def bc_train_snaps(cfg: EnvConfig, snaps: SnapDataset, generator: torch.Generator,
                   state: BCTrainState | None = None, epochs: int = 10,
                   batch_size: int = 4096, lr: float = 1e-3, channels: int = 64,
                   hidden: int = 1024, log=None, perms=None):
    """Clone the expert from snapshot demos. Returns (ts, history).

    Pass ``state`` (a ``BCTrainState``, e.g. ``init_bc_state`` of a
    ``CPVGridPolicy``) to continue training, as the DAgger rounds do;
    otherwise a fresh ``GridPolicy`` is drawn from ``generator``. Training
    runs on the generator's device; ``perms``, one permutation of the rows
    per epoch, replaces the generator's.
    """
    dev = generator.device
    ts = init_bc_state(init_grid_policy(generator, cfg, channels, hidden)) if state is None else state
    data = device_columns(snaps, dev)
    n = snaps.num_rows
    batch_size = min(batch_size, n)
    history = []
    for ep in range(epochs):
        perm = (torch.randperm(n, generator=generator, device=dev) if perms is None
                else torch.as_tensor(perms[ep], device=dev))
        ts, stats = _bc_epoch(cfg, lr, ts, data, perm, batch_size)
        stats = {k: float(v) for k, v in stats.items()}
        history.append(stats)
        if log:
            log(f"epoch {ep + 1}/{epochs}: loss {stats['loss']:.4f} "
                f"acc {stats['accuracy']:.4f}")
    return ts, history


# ---------------------------------------------------------------------------
# on-device evaluation (the train/evaluate.py measurement, GridPolicy family)
# ---------------------------------------------------------------------------


def _greedy(cfg: EnvConfig, model: torch.nn.Module, st: EnvState,
            noise: torch.Tensor | None = None) -> torch.Tensor:
    """The argmax of the policy's logits, plus ``noise`` f32[B, A] if given
    (Gumbel noise makes it a draw from the softmax, as ``jax.random.categorical``)."""
    logits, _ = model(*planes_from_state(cfg, st))
    if noise is not None:
        logits = logits + noise
    return torch.argmax(logits, dim=-1).to(torch.int32)


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise f32 of ``shape`` from ``generator``, on its device
    (``jax.random.gumbel``: uniforms from the smallest normal f32 up)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


@torch.no_grad()
def _eval_batch_grid(cfg: EnvConfig, model: torch.nn.Module, state: EnvState,
                     noise: torch.Tensor | None = None) -> dict:
    """One greedy episode per env from ``state``; terminal stats as tensors.
    With ``noise`` f32[T, B, A] (``gumbel``), step t samples from the
    policy's softmax instead."""
    B = state.objects.shape[0]
    dev = state.objects.device
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    reward = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for t in range(cfg.max_steps):
        action = _greedy(cfg, model, state, None if noise is None else noise[t])
        st2, res = step(cfg, state, action)
        state = _select(done, state, st2)  # freeze finished episodes
        reward = torch.where(done, reward, res.reward)
        done = done | res.done
        if t % _DONE_EVERY == _DONE_EVERY - 1 and bool(done.all()):
            break
    return {"success": reward == cfg.max_steps, "steps": state.step_num,
            "desired": state.desired, "achieved": state.achieved}


def evaluate_grid_policy(cfg: EnvConfig, model: torch.nn.Module, num_episodes: int,
                         seed: int = 0) -> dict:
    """Greedy exact-match evaluation over ``num_episodes`` parallel episodes,
    reset from a generator seeded ``seed`` on the model's device."""
    from gym_craftingworld_tpu_torch.train.evaluate import summarize

    generator = torch.Generator(device=_device(model)).manual_seed(seed)
    state = reset_from_generator(cfg, num_episodes, generator)
    return summarize(_eval_batch_grid(cfg, model, state))


# ---------------------------------------------------------------------------
# DAgger: on-policy states, expert labels
# ---------------------------------------------------------------------------


@torch.no_grad()
def _rollout_states(cfg: EnvConfig, model: torch.nn.Module, state: EnvState,
                    explore_u: torch.Tensor, explore_a: torch.Tensor, explore_eps: float,
                    noise: torch.Tensor | None = None):
    """Roll the policy greedily (+eps random moves); record snapshot columns.

    ``explore_u`` f32[T, B] uniforms and ``explore_a`` int[T, B] moves in
    0..3, T = ``max_steps``: step t takes ``explore_a[t]`` where
    ``explore_u[t] < explore_eps``. With ``noise`` f32[T, B, A]
    (``gumbel``), the policy's action is a draw from its softmax instead of
    its argmax. Returns ([T, B] column dict, live [T, B],
    success [B]); once every episode is done the remaining steps are not run,
    and their rows are zero and not live.
    """
    B = state.objects.shape[0]
    T = cfg.max_steps
    dev = state.objects.device
    cols = None
    live = torch.zeros((T, B), dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    reward = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for t in range(T):
        now = snap_columns_from_state(cfg, state)
        if cols is None:
            cols = {k: torch.zeros((T, *v.shape), dtype=v.dtype, device=dev) for k, v in now.items()}
        for k, v in now.items():
            cols[k][t] = v
        action = _greedy(cfg, model, state, None if noise is None else noise[t])
        # eps-mix random moves for coverage (eps == 0.0 -> uniform < 0, no-op)
        action = torch.where(explore_u[t] < explore_eps, explore_a[t].to(torch.int32), action)
        st2, res = step(cfg, state, action)
        state = _select(done, state, st2)
        reward = torch.where(done, reward, res.reward)
        live[t] = ~done
        done = done | res.done
        if t % _DONE_EVERY == _DONE_EVERY - 1 and bool(done.all()):
            break
    return cols, live, reward == cfg.max_steps


# achieved bits that latch forever once set (craftingworld_ray.py:657-665,
# 686-697): MakeBread, EatBread, BuildHouse, ChopTree, ChopRock. An episode
# holding an undesired latched bit can never reach exact-match success.
_LATCH_MASK = (
    (1 << C.T_MAKE_BREAD) | (1 << C.T_EAT_BREAD) | (1 << C.T_BUILD_HOUSE)
    | (1 << C.T_CHOP_TREE) | (1 << C.T_CHOP_ROCK)
)


def collect_policy_states(cfg: EnvConfig, model: torch.nn.Module, num_episodes: int,
                          seed: int = 0, explore_eps: float = 0.0,
                          max_states: int | None = None, failures_only: bool = False,
                          state: EnvState | None = None, explore=None):
    """Visited-state snapshot rows from on-policy rollouts (host arrays).

    ``failures_only`` keeps only salvageable states (no undesired latched
    achievement yet) of episodes that end unsuccessful: the targeted-DAgger
    collection mode. The resets come from a generator seeded ``seed`` and the
    exploration draws ``(u, a)`` from one seeded ``seed ^ 0xDA66E4``, both on
    the model's device, unless ``state`` and ``explore`` pass them in.

    Returns ``(cols dict of [N, ...] numpy arrays, success_rate)``.
    """
    dev = _device(model)
    T = cfg.max_steps
    if state is None:
        state = reset_from_generator(cfg, num_episodes,
                                     torch.Generator(device=dev).manual_seed(seed))
    if explore is None:
        g = torch.Generator(device=dev).manual_seed(seed ^ 0xDA66E4)
        explore = (torch.rand((T, num_episodes), generator=g, device=dev),
                   torch.randint(0, 4, (T, num_episodes), generator=g, device=dev))
    cols, live, success = _rollout_states(cfg, model, state, *explore, float(explore_eps))
    live = live.cpu().numpy()
    if failures_only:
        failed = ~success.cpu().numpy()  # [B]
        live = live & failed[None, :]
        ach = cols["achieved"].cpu().numpy().astype(np.int64)  # [T, B]
        des = cols["desired"].cpu().numpy().astype(np.int64)
        salvageable = (ach & ~des & _LATCH_MASK) == 0
        live = live & salvageable
    live = live.reshape(-1)
    host = {k: v.cpu().numpy().reshape((-1,) + tuple(v.shape[2:]))[live]
            for k, v in cols.items()}
    if max_states is not None and len(host["agent_key"]) > max_states:
        idx = np.random.RandomState(seed).choice(
            len(host["agent_key"]), max_states, replace=False
        )
        host = {k: v[idx] for k, v in host.items()}
    return host, float(success.cpu().numpy().mean())


def expert_relabel(cfg: EnvConfig, cols: dict) -> SnapDataset:
    """Label snapshot rows with the scripted expert → a SnapDataset."""
    n = len(cols["agent_key"])
    snaps = SnapDataset(
        action=np.zeros(n, np.int8),
        episode=np.zeros(n, np.int32),
        **{k: cols[k] for k in _COL_FIELDS},
    )
    objects, init_objects = grids_from_snaps(cfg, snaps, np.arange(n))
    des_bits = mask_to_bits(snaps.desired)
    ach_bits = mask_to_bits(snaps.achieved)
    W = cfg.width
    expert = NumpyExpert()
    labels = np.zeros(n, np.int8)
    for i in range(n):
        ak = int(snaps.agent_key[i])
        labels[i] = label_snapshot(
            expert, objects[i], (ak // W, ak % W), int(snaps.holding[i]),
            init_objects[i], des_bits[i], ach_bits[i],
        )
    return snaps._replace(action=labels)


def dagger_round(cfg: EnvConfig, ts: BCTrainState, dataset: SnapDataset, round_idx: int,
                 generator: torch.Generator, num_episodes: int = 512,
                 max_states: int = 200_000, epochs: int = 3, batch_size: int = 4096,
                 lr: float = 3e-4, explore_eps: float = 0.02, log=None):
    """One DAgger iteration: rollout → relabel → aggregate → train.

    Returns (ts, dataset, info).
    """
    cols, sr = collect_policy_states(
        cfg, ts.params, num_episodes, seed=1000 + round_idx,
        explore_eps=explore_eps, max_states=max_states,
    )
    labeled = expert_relabel(cfg, cols)
    dataset = SnapDataset.concat(dataset, labeled)
    if log:
        log(f"dagger round {round_idx}: rollout success {sr:.3f}, "
            f"+{labeled.num_rows} rows → {dataset.num_rows} total")
    ts, hist = bc_train_snaps(
        cfg, dataset, generator, state=ts, epochs=epochs,
        batch_size=batch_size, lr=lr, log=log,
    )
    return ts, dataset, {"rollout_success": sr, "history": hist}
