"""PPO over the packed-key engine: the throughput training path.

Counterpart of ``gym_craftingworld_tpu/train/fast_ppo.py``; see that
module's docstring for the design. In brief: rollouts step the packed int16
engine, the policy is a feature-major MLP over ``[F, B]`` features, finished
envs pull fresh worlds from a pool of 2B worlds drawn once per update, and
the update runs the clipped-surrogate loss over block-shuffled minibatches.

What the port does differently:

* Random draws come from an explicit ``torch.Generator`` on the training
  device, and the pure functions take their draws explicitly (``u`` for the
  Gumbel noise, ``perms`` for the epoch shuffles, ``scores``/``k``/``perm``
  for ``fresh_packed_from_draws``), so tests feed them JAX's draws.
* The collect steps each env through the fused actions kernel with T = 1
  (``ops/packed_fused.rollout_packed_actions``), which computes
  ``_step_p_unrolled`` in one launch instead of ~150 small ones.
* ``fused_pool`` / ``fused_update`` default to the kernel wrappers
  (``ops/fused_reset.fresh_packed_fused``,
  ``ops/fused_update.fused_minibatch_grads_indexed``): a CUDA device launches
  the kernels and the CPU runs their plain versions. ``False`` selects
  ``fresh_packed_batch`` and autograd of ``_loss_bm``, as in JAX.
* The optimizer is optax's ``chain(clip_by_global_norm, adam)`` written out
  by hand on dicts of tensors (``make_optimizer``); ``clip_grad_norm_``
  divides by ``norm + 1e-6`` and is not the same function.
* Parameters live in the ``MLPParams`` module under the JAX names and
  layouts and are updated in place; ``train_step_fast`` returns the same
  module it was given.

Matmuls that JAX runs with ``preferred_element_type=f32`` round their
operands to bf16 and multiply in f32; TF32 is switched off for them
(``torch.backends.cuda.matmul.allow_tf32 = False``, set on import of this
module) so the f32 products are exact and the sums f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.reset import ordered_cells, sample_desired
from gym_craftingworld_tpu_torch.ops import fused_update as fu
from gym_craftingworld_tpu_torch.ops.fused_reset import assemble, fresh_packed_fused
from gym_craftingworld_tpu_torch.ops.packed_fused import rollout_packed_actions
from gym_craftingworld_tpu_torch.ops.packed_rollout import PackedState

# f32 matmuls must be f32 (JAX's preferred_element_type=f32), not TF32
torch.backends.cuda.matmul.allow_tf32 = False

bf16 = torch.bfloat16
f32 = torch.float32
PARAM_NAMES = ("w1", "b1", "w2", "b2", "wl", "bl", "wv", "bv")
POOL_STRIDE = 12007  # odd window stride through the pool, full period


class FastPPOConfig(NamedTuple):
    rollout_steps: int = 64
    update_epochs: int = 2
    num_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: int = 512

    @classmethod
    def throughput(cls, **overrides) -> "FastPPOConfig":
        """The JAX package's wall-clock preset: 1 epoch, hidden 384."""
        return cls(update_epochs=1, hidden=384)._replace(**overrides)


# ---------------------------------------------------------------------------
# fresh worlds, directly in the packed layout
# ---------------------------------------------------------------------------


def fresh_packed_from_draws(cfg: EnvConfig, scores: torch.Tensor, k: torch.Tensor,
                            perm: torch.Tensor) -> PackedState:
    """``n`` fresh worlds as a pure function of their draws.

    ``scores`` f32[n, H*W] placement scores (the 9 best cells in score
    order: 8 objects, then the agent), ``k`` int[n] task counts and ``perm``
    int[n, n_sel] task permutations, as ``core/reset.sample_desired`` takes
    them. The agent's cell holds no object, so ``obj_here`` is 0 and
    ``icode_here`` is ``AGENT_INIT_MARK``.
    """
    idx = ordered_cells(scores, C.N_OBJECTS + 1).to(torch.int32)  # [n, 9]
    rows = sample_desired(cfg, k, perm).to(torch.int32)  # [n, 9]
    bits = torch.arange(C.N_TASKS, dtype=torch.int32, device=scores.device)
    desired = (rows << bits[None, :]).sum(dim=1, dtype=torch.int32)
    return assemble(cfg, torch.cat([idx.T, desired[None]]))


def fresh_packed_batch(cfg: EnvConfig, generator: torch.Generator, n: int) -> PackedState:
    """``n`` fresh worlds, drawn from ``generator`` on its device."""
    draw = dict(generator=generator, device=generator.device)
    scores = torch.rand((n, cfg.n_cells), **draw)
    if cfg.stacking:
        k = torch.randint(0, cfg.number_of_tasks, (n,), **draw) + 1
    else:
        k = torch.ones((n,), dtype=torch.int64, device=generator.device)
    perm = torch.argsort(torch.rand((n, len(cfg.selected_task_indices)), **draw), dim=1)
    return fresh_packed_from_draws(cfg, scores, k, perm)


def _pool_take(pool: PackedState, idx: torch.Tensor) -> PackedState:
    """Gather pool columns ``idx`` int[B] into a PackedState batch of B."""
    return PackedState(*(x[..., idx] for x in pool))


def _pool_slice(pool: PackedState, off: int, B: int) -> PackedState:
    """The B-column window of the pool at ``off`` (a view; off + B <= 2B)."""
    return PackedState(*(x[..., off: off + B] for x in pool))


def _autoreset(state: PackedState, fresh: PackedState, done: torch.Tensor) -> PackedState:
    return PackedState(*(torch.where(done, f, s) for f, s in zip(fresh, state)))


# ---------------------------------------------------------------------------
# policy: feature-major MLP (params f32, matmuls bf16 -> f32)
# ---------------------------------------------------------------------------


def feature_rows(cfg: EnvConfig) -> int:
    return 5 * C.N_OBJECTS + 27


def _bf(x: float, device) -> torch.Tensor:
    """A bf16 constant as a 0-dim tensor, so products round like JAX's bf16(x)."""
    return torch.tensor(x, dtype=bf16, device=device)


def features(cfg: EnvConfig, s: PackedState) -> torch.Tensor:
    """Packed state -> bf16[F, B] policy features (bit for bit JAX's)."""
    dev = s.slot_key.device
    HW = cfg.n_cells
    key = s.slot_key.to(torch.int32)  # [8, B]
    on = key < HW
    held = key == HW
    r = torch.where(on, key // cfg.width, 0)
    c = torch.where(on, key % cfg.width, 0)
    b = lambda x: x.to(bf16)
    bits = torch.arange(C.N_TASKS, dtype=torch.int32, device=dev)[:, None]
    hold = s.holding.to(torch.int32)
    des = s.desired.to(torch.int32)
    ach = s.achieved.to(torch.int32)
    inv_h, inv_w = _bf(1 / cfg.height, dev), _bf(1 / cfg.width, dev)
    rows = [
        b(s.slot_type) * _bf(1 / 8, dev),  # 8
        b(r) * inv_h,  # 8
        b(c) * inv_w,  # 8
        b(on),  # 8
        b(held),  # 8
        b(s.agent_r)[None] * inv_h,  # 1
        b(s.agent_c)[None] * inv_w,  # 1
        b(hold[None, :] == torch.arange(4, device=dev)[:, None]),  # 4
        b((des[None, :] >> bits) & 1),  # 9
        b((ach[None, :] >> bits) & 1),  # 9
        b(s.obj_here)[None] * _bf(1 / 8, dev),  # 1
        b(s.icode_here)[None] * _bf(1 / 10, dev),  # 1
        b(s.step_num)[None] * _bf(1 / cfg.max_steps, dev),  # 1
    ]
    return torch.cat(rows, dim=0)  # [F, B]


class MLPParams(nn.Module):
    """The policy's parameters under the JAX names and layouts (f32)."""

    def __init__(self, F: int, H: int, device=None):
        super().__init__()
        z = lambda *shape: nn.Parameter(torch.zeros(shape, dtype=f32, device=device))
        self.w1, self.b1 = z(H, F), z(H)
        self.w2, self.b2 = z(H, H), z(H)
        self.wl, self.bl = z(C.N_ACTIONS, H), z(C.N_ACTIONS)
        self.wv, self.bv = z(1, H), z(1)

    def tensors(self) -> dict:
        return {k: getattr(self, k) for k in PARAM_NAMES}


def init_params(generator: torch.Generator, cfg: EnvConfig, fppo: FastPPOConfig) -> MLPParams:
    """He-normal weights drawn from ``generator``, zero biases, on its device."""
    F, H = feature_rows(cfg), fppo.hidden
    p = MLPParams(F, H, device=generator.device)
    he = lambda shp, fan: torch.randn(shp, generator=generator, device=generator.device) * math.sqrt(2.0 / fan)
    with torch.no_grad():
        p.w1.copy_(he((H, F), F))
        p.w2.copy_(he((H, H), H))
        p.wl.copy_(0.01 * he((C.N_ACTIONS, H), H))
        p.wv.copy_(he((1, H), H))
    return p


def _mm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 products and sums: [h, F] @ [F, B] -> f32[h, B]."""
    return w.to(bf16).to(f32) @ x.to(bf16).to(f32)


def apply_policy(p: MLPParams, feat: torch.Tensor):
    """feat [F, B] -> (logits f32[6, B], value f32[B])."""
    h = torch.relu(_mm(p.w1, feat) + p.b1[:, None])
    h = torch.relu(_mm(p.w2, h) + p.b2[:, None])
    logits = _mm(p.wl, h) + p.bl[:, None]
    value = (_mm(p.wv, h) + p.bv[:, None])[0]
    return logits, value


# ---------------------------------------------------------------------------
# the optimizer: optax chain(clip_by_global_norm, adam), by hand
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: step count and the two moments by name."""

    count: torch.Tensor  # int32, 0-dim
    mu: dict
    nu: dict


class Optimizer(NamedTuple):
    init: object  # params -> AdamState
    update: object  # (grads, state) -> (updates, state)


def make_optimizer(fppo: FastPPOConfig, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))`` on dicts.

    The clip keeps the gradients when their global norm is below
    ``max_grad_norm`` and scales them by ``max_grad_norm / norm`` otherwise;
    Adam's step is ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` with the moments
    bias-corrected by the step count.
    """
    max_norm, lr = fppo.max_grad_norm, fppo.lr

    def init(params) -> AdamState:
        zeros = {k: torch.zeros_like(v, dtype=f32).detach() for k, v in params.items()}
        count = torch.zeros((), dtype=torch.int32, device=next(iter(zeros.values())).device)
        return AdamState(count, zeros, {k: v.clone() for k, v in zeros.items()})

    def update(grads: dict, state: AdamState):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < max_norm
        grads = {k: torch.where(keep, g, g / norm * max_norm) for k, g in grads.items()}
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        updates = {k: -lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)) for k in grads}
        return updates, AdamState(count, mu, nu)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: MLPParams, updates: dict) -> None:
    """params += updates, in place."""
    for k, u in updates.items():
        getattr(params, k).add_(u)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


class FastTrainState(NamedTuple):
    params: MLPParams
    opt_state: AdamState
    update_idx: int


class _Traj(NamedTuple):
    feat: torch.Tensor  # bf16[T, F, B]
    action: torch.Tensor  # int32[T, B]
    log_prob: torch.Tensor  # f32[T, B]
    value: torch.Tensor  # f32[T, B]
    reward: torch.Tensor  # f32[T, B]
    done: torch.Tensor  # bool[T, B]
    raw_reward: torch.Tensor  # int32[T, B] (reference scale, for metrics)


def init_fast_train_state(generator: torch.Generator, cfg: EnvConfig,
                          fppo: FastPPOConfig) -> FastTrainState:
    params = init_params(generator, cfg, fppo)
    return FastTrainState(params, make_optimizer(fppo).init(params.tensors()), 0)


def gumbel_uniforms(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniforms on [1e-7, 1) as ``jax.random.uniform(minval=1e-7, maxval=1)``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return torch.clamp_min(u * (1.0 - 1e-7) + 1e-7, 1e-7)


def _sample_action(u: torch.Tensor, logits: torch.Tensor):
    """Gumbel-argmax over the action axis (axis 0) with uniforms ``u``; (action, log_prob)."""
    g = logits - torch.log(-torch.log(u))
    action = torch.argmax(g, dim=0).to(torch.int32)  # first index on ties, as jnp
    logsm = torch.log_softmax(logits, dim=0)
    log_prob = logsm.gather(0, action.to(torch.int64)[None])[0]
    return action, log_prob


def _collect(cfg: EnvConfig, fppo: FastPPOConfig, params: MLPParams,
             env: PackedState, pool: PackedState, u: torch.Tensor):
    """T steps of the policy; ``u`` f32[T, 6, B] Gumbel uniforms. (env, _Traj)."""
    T, B = fppo.rollout_steps, env.agent_r.shape[-1]
    dev = env.agent_r.device
    buf = lambda dtype, *shape: torch.empty((T, *shape), dtype=dtype, device=dev)
    tr = _Traj(buf(bf16, feature_rows(cfg), B), buf(torch.int32, B), buf(f32, B),
               buf(f32, B), buf(f32, B), buf(torch.bool, B), buf(torch.int32, B))
    win = torch.tensor(1.0, device=dev)
    lose = torch.tensor(-1.0 / cfg.max_steps, device=dev)
    st = env
    for t in range(T):
        feat = features(cfg, st)
        logits, value = apply_policy(params, feat)
        action, log_prob = _sample_action(u[t], logits)
        st, raw, done = rollout_packed_actions(cfg, st, action[None])
        off = (t * POOL_STRIDE) % B
        st = _autoreset(st, _pool_slice(pool, off, B), done[0])
        for dst, src in zip(tr, (feat, action, log_prob, value,
                                 torch.where(raw[0] == cfg.max_steps, win, lose),
                                 done[0], raw[0])):
            dst[t] = src
    return st, tr


def _gae(fppo: FastPPOConfig, traj: _Traj, last_value: torch.Tensor):
    """Generalised advantages (reverse scan); (adv, returns) f32[T, B]."""
    adv = torch.empty_like(traj.value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    gl = fppo.gamma * fppo.gae_lambda
    for t in reversed(range(traj.value.shape[0])):
        not_done = 1.0 - traj.done[t].to(f32)
        delta = traj.reward[t] + fppo.gamma * next_value * not_done - traj.value[t]
        gae = delta + gl * not_done * gae
        adv[t] = gae
        next_value = traj.value[t]
    return adv, adv + traj.value


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------


def _mm_bm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batch-major bf16 matmul: x[N, K] with w[H, K] -> f32[N, H]."""
    return x.to(bf16).to(f32) @ w.to(bf16).to(f32).T


def apply_policy_bm(p: MLPParams, feat: torch.Tensor):
    """feat [N, F] -> (logits f32[6, N], value f32[N]); the trunk stored bf16."""
    h = torch.relu((_mm_bm(feat, p.w1) + p.b1[None, :]).to(bf16))
    h = torch.relu((_mm_bm(h, p.w2) + p.b2[None, :]).to(bf16))
    logits = _mm_bm(h, p.wl).T + p.bl[:, None]
    value = (_mm_bm(h, p.wv).T + p.bv[:, None])[0]
    return logits, value


def _ppo_loss(fppo: FastPPOConfig, logits, value, batch):
    _, action, old_log_prob, old_value, adv, ret = batch
    logsm = torch.log_softmax(logits, dim=0)
    onehot = torch.arange(logits.shape[0], device=logits.device)[:, None] == action[None, :]
    log_prob = (onehot * logsm).sum(dim=0)
    ratio = torch.exp(log_prob - old_log_prob)
    adv_n = fu.normalize_adv(adv)
    pg = -torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - fppo.clip_eps, 1 + fppo.clip_eps) * adv_n,
    ).mean()
    v_clipped = old_value + torch.clamp(value - old_value, -fppo.clip_eps, fppo.clip_eps)
    v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2).mean()
    entropy = -(torch.exp(logsm) * logsm).sum(dim=0).mean()
    loss = pg + fppo.vf_coef * v_loss - fppo.ent_coef * entropy
    return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": entropy}


def _loss(fppo: FastPPOConfig, params: MLPParams, batch):
    """Clipped-surrogate loss over feature-major ``feat [F, M]``; (loss, aux)."""
    logits, value = apply_policy(params, batch[0])
    return _ppo_loss(fppo, logits, value, batch)


def _loss_bm(fppo: FastPPOConfig, params: MLPParams, batch):
    """The same loss over batch-major ``feat [N, F]``; (loss, aux)."""
    logits, value = apply_policy_bm(params, batch[0])
    return _ppo_loss(fppo, logits, value, batch)


def shuffle_block(T: int, B: int, num_minibatches: int) -> int:
    """Shuffle-block rows: the largest power-of-two multiple of 128 (<= 2048)
    that tiles every minibatch and leaves >= 8 blocks per minibatch; the
    smallest tiling block when none leaves 8."""
    rows_mb = (T * B) // num_minibatches
    cands = [blk for blk in (2048, 1024, 512, 256, 128) if rows_mb % blk == 0]
    if not cands:
        raise ValueError(
            f"rollout_steps*batch/num_minibatches ({rows_mb}) must be a "
            f"multiple of 128 for block-shuffled minibatching"
        )
    for blk in cands:
        if blk * 8 <= rows_mb:
            return blk
    return cands[-1]


def _autograd_grads(fppo: FastPPOConfig, params: MLPParams, batch):
    """(grads, aux with "loss") by autograd of ``_loss_bm``."""
    with torch.enable_grad():
        loss, aux = _loss_bm(fppo, params, batch)
        names = list(PARAM_NAMES)
        g = torch.autograd.grad(loss, [getattr(params, k) for k in names])
    aux = {k: v.detach() for k, v in aux.items()}
    return dict(zip(names, g)), {"loss": loss.detach(), **aux}


def _update_phase(fppo: FastPPOConfig, ts: FastTrainState, traj: _Traj, adv, ret,
                  perms: torch.Tensor, use_fused_kernel: bool | None = None):
    """GAE-to-optimizer tail of one PPO iteration.

    ``perms`` int[update_epochs, NB]: each epoch's permutation of the
    shuffle blocks. ``use_fused_kernel`` None or True takes
    ``fused_minibatch_grads_indexed`` (the kernel on CUDA, its plain version
    on the CPU); False takes autograd of ``_loss_bm``. Returns (params,
    opt_state, losses [E, M], aux dict of [E, M]); params are updated in place.
    """
    T, B = traj.action.shape
    F = traj.feat.shape[1]
    BLK = shuffle_block(T, B, fppo.num_minibatches)
    NB = (T * B) // BLK
    featb = traj.feat.permute(0, 2, 1).reshape(NB, BLK, F)
    vecs = tuple(x.reshape(NB, BLK) for x in
                 (traj.action, traj.log_prob, traj.value, adv, ret))
    optimizer = make_optimizer(fppo)
    params, opt_state = ts.params, ts.opt_state
    nbm = NB // fppo.num_minibatches
    mb = nbm * BLK
    losses, auxes = [], []
    for e in range(fppo.update_epochs):
        perm = perms[e].to(torch.int64)
        for i in range(fppo.num_minibatches):
            ids = perm[i * nbm: (i + 1) * nbm]
            rest = tuple(x[ids].reshape(mb) for x in vecs)
            if use_fused_kernel is False:
                grads, aux = _autograd_grads(fppo, params, (featb[ids].reshape(mb, F),) + rest)
            else:
                grads, aux = fu.fused_minibatch_grads_indexed(fppo, params, featb, ids, rest)
            updates, opt_state = optimizer.update(grads, opt_state)
            apply_updates(params, updates)
            losses.append(aux.pop("loss"))
            auxes.append(aux)
    shape = (fppo.update_epochs, fppo.num_minibatches)
    stack = lambda xs: torch.stack(xs).reshape(shape)
    return (params, opt_state, stack(losses),
            {k: stack([a[k] for a in auxes]) for k in auxes[0]})


def _fresh_pool(cfg: EnvConfig, generator: torch.Generator, n: int,
                fused: bool | None = None) -> PackedState:
    """The auto-reset pool: the pool kernel's wrapper by default (two fresh
    31-bit seed words, drawn on the device), ``fresh_packed_batch`` when
    ``fused`` is False."""
    if fused is False:
        return fresh_packed_batch(cfg, generator, n)
    seeds = torch.randint(0, 2**31 - 1, (2,), generator=generator,
                          device=generator.device, dtype=torch.int32)
    return fresh_packed_fused(cfg, seeds[0], n, seed2=seeds[1])


@torch.no_grad()
def train_step_fast(cfg: EnvConfig, fppo: FastPPOConfig, ts: FastTrainState,
                    env: PackedState, generator: torch.Generator, *,
                    fused_pool: bool | None = None, fused_update: bool | None = None):
    """One PPO iteration on the packed engine; (ts, env, generator, metrics).

    Every draw comes from ``generator``, which must live on the env's
    device. Metrics are 0-dim tensors on that device.
    """
    B = env.agent_r.shape[-1]
    T = fppo.rollout_steps
    NB = T * B // shuffle_block(T, B, fppo.num_minibatches)  # raises if shapes don't tile
    pool = _fresh_pool(cfg, generator, 2 * B, fused=fused_pool)
    u = gumbel_uniforms(generator, (T, C.N_ACTIONS, B))
    env, traj = _collect(cfg, fppo, ts.params, env, pool, u)
    _, last_value = apply_policy(ts.params, features(cfg, env))
    adv, ret = _gae(fppo, traj, last_value)
    perms = torch.stack([torch.randperm(NB, generator=generator, device=generator.device)
                         for _ in range(fppo.update_epochs)])
    params, opt_state, losses, auxes = _update_phase(
        fppo, ts, traj, adv, ret, perms, use_fused_kernel=fused_update)

    successes = (traj.raw_reward == cfg.max_steps).sum()
    metrics = {
        "loss": losses.mean(),
        "reward_mean": traj.reward.mean(),
        "episode_done_frac": traj.done.to(f32).mean(),
        "success_rate": successes / traj.done.sum().clamp_min(1),
        "success_per_step": successes / (T * B),
        **{k: v.mean() for k, v in auxes.items()},
    }
    return FastTrainState(params, opt_state, ts.update_idx + 1), env, generator, metrics


def train_many_fast(cfg: EnvConfig, fppo: FastPPOConfig, ts: FastTrainState,
                    env: PackedState, num_updates: int, generator: torch.Generator, *,
                    fused_pool: bool | None = None, fused_update: bool | None = None):
    """``num_updates`` PPO iterations; metrics stacked [num_updates]."""
    history = []
    for _ in range(num_updates):
        ts, env, generator, metrics = train_step_fast(
            cfg, fppo, ts, env, generator, fused_pool=fused_pool, fused_update=fused_update)
        history.append(metrics)
    metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    return ts, env, generator, metrics
