"""PPO over the packed-key engine: the throughput training path.

Counterpart of ``gym_craftingworld_tpu/train/fast_ppo.py``; see that
module's docstring for the design. In brief: rollouts step the packed int16
engine, the policy is a feature-major MLP over ``[F, B]`` features, finished
envs pull fresh worlds from a pool of 2B worlds drawn once per update, and
the update runs the clipped-surrogate loss over block-shuffled minibatches.

What the port does differently:

* Random draws come from JAX's key chain, bit for bit: the step takes key
  data int64[2] on the training device and splits it as JAX does
  (``split(key, 4)``: the next key, the pool's, the collect's, the
  permutations'), and every draw below is ``jax.random``'s from those keys
  (``ops/keyed_draws.py``: the counter kernel on the card, ``ops/threefry``
  on the CPU). The keys never leave the device. The pool kernel's own
  in-kernel Philox stream stays the port's (JAX's is the TPU's hardware
  generator): its two seeds are JAX's ``randint`` draws. The pure functions
  still take their draws explicitly (``u`` for the Gumbel noise, ``perms``
  for the epoch shuffles, ``scores``/``k``/``perm`` for
  ``fresh_packed_from_draws``), so tests can feed them JAX's draws.
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
* Under a ``mesh`` (``parallel/mesh.py``) each rank steps its own columns
  of the env batch and computes the unsharded step's function: every rank
  holds the same key and splits it alike; it draws the whole pool of 2B
  worlds (its windows move across every column; over several ranks the
  keyed ``fresh_packed_batch``, as JAX's sharded step takes it) and the
  whole permutations, but only its own columns of the Gumbel uniforms (the
  same values as the whole draw's there); a shuffle block lies on one rank;
  each minibatch's advantages are normalised over the whole minibatch
  (gathered by ``all_reduce``); a rank launches the gradient kernel on its
  own blocks with the whole minibatch's ``1/n``, and the ranks sum the
  gradients and loss terms in one ``all_reduce`` before the clip and Adam,
  which every rank runs alike. Only the order of the gradient sums differs
  from the unsharded step.

Matmuls that JAX runs with ``preferred_element_type=f32`` round their
operands to bf16 and multiply in f32; TF32 is switched off for them
(``torch.backends.cuda.matmul.allow_tf32 = False``, set on import of this
module) so the f32 products are exact and the sums f32. On the card the policy's
heads sum their products in f64 instead (``_mm_head``).
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
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.fused_reset import assemble, fresh_packed_fused
from gym_craftingworld_tpu_torch.ops.packed_fused import rollout_packed_actions
from gym_craftingworld_tpu_torch.ops.packed_rollout import PackedState
from gym_craftingworld_tpu_torch.parallel.mesh import sum_over_ranks
from gym_craftingworld_tpu_torch.utils.profiling import trace

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


def fresh_packed_batch(cfg: EnvConfig, key: torch.Tensor, n: int) -> PackedState:
    """``n`` fresh worlds drawn from key data ``key`` on its device, bit for
    bit JAX's ``fresh_packed_batch``: ``k_place, k_task = split(key)``, the
    scores ``uniform(k_place, (n, H*W))`` and ``sample_desired`` over
    ``split(k_task, n)`` (the reset kernel's tasks mode)."""
    k_place, k_task = kd.split_keys(key, 2)
    scores = kd.uniform_cols(k_place, (n, cfg.n_cells))
    tasks = kd.reset_draws(cfg, kd.split_keys(k_task, n), "tasks")
    return fresh_packed_from_draws(cfg, scores, tasks.k, tasks.perm)


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


def he_normal(key: torch.Tensor, shape, fan: int) -> torch.Tensor:
    """JAX's ``normal(k, shape) * np.sqrt(2.0 / fan)``."""
    return kd.normal(key, shape) * math.sqrt(2.0 / fan)


def init_params(key: torch.Tensor, cfg: EnvConfig, fppo: FastPPOConfig) -> MLPParams:
    """He-normal weights from ``split(key, 4)`` as JAX's ``init_params``,
    zero biases, on the key's device."""
    F, H = feature_rows(cfg), fppo.hidden
    p = MLPParams(F, H, device=key.device)
    k1, k2, k3, k4 = kd.split_keys(key, 4)
    with torch.no_grad():
        p.w1.copy_(he_normal(k1, (H, F), F))
        p.w2.copy_(he_normal(k2, (H, H), H))
        p.wl.copy_(0.01 * he_normal(k3, (C.N_ACTIONS, H), H))
        p.wv.copy_(he_normal(k4, (1, H), H))
    return p


def _mm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 products and sums: [h, F] @ [F, B] -> f32[h, B]."""
    return w.to(bf16).to(f32) @ x.to(bf16).to(f32)


def _mm_head(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``_mm`` for a head's few-row product, whose column sums on the card do
    not depend on the batch's width.

    cuBLAS picks its kernel, and so the order of an f32 sum, by the
    product's shape: on an H100 the one-row ``wv`` and a seven-row
    ``[wl; wv]`` product of 8,192 columns sum differently from 16,384 (the
    512-row trunk products and the six-row ``wl`` did not; ``chip_smoke.py``
    phase 21 holds them), and a rank of a mesh, holding a part of the batch,
    must give the whole batch's columns bit for bit. So on the card the sums
    run in f64, where the products of bf16 operands (16 significant bits
    each) add without rounding unless their magnitudes span more than 2**37,
    and round to f32 once: no order changes them. The CPU keeps JAX's f32.
    """
    acc = torch.float64 if x.is_cuda else f32
    return (w.to(bf16).to(acc) @ x.to(bf16).to(acc)).to(f32)


def apply_policy(p: MLPParams, feat: torch.Tensor):
    """feat [F, B] -> (logits f32[6, B], value f32[B])."""
    h = torch.relu(_mm(p.w1, feat) + p.b1[:, None])
    h = torch.relu(_mm(p.w2, h) + p.b2[:, None])
    logits = _mm_head(p.wl, h) + p.bl[:, None]
    value = (_mm_head(p.wv, h) + p.bv[:, None])[0]
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
    return adam(fppo.lr, b1, b2, eps, max_norm=fppo.max_grad_norm)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         max_norm: float | None = None) -> Optimizer:
    """``optax.adam(lr)`` on dicts; with ``max_norm``,
    ``optax.chain(clip_by_global_norm(max_norm), adam(lr))``."""

    def init(params) -> AdamState:
        zeros = {k: torch.zeros_like(v, dtype=f32).detach() for k, v in params.items()}
        count = torch.zeros((), dtype=torch.int32, device=next(iter(zeros.values())).device)
        return AdamState(count, zeros, {k: v.clone() for k, v in zeros.items()})

    def update(grads: dict, state: AdamState):
        if max_norm is not None:
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
def apply_updates(params: nn.Module, updates: dict) -> None:
    """params += updates, in place, by parameter name (dotted for submodules)."""
    for k, u in updates.items():
        params.get_parameter(k).add_(u)


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


def init_fast_train_state(key: torch.Tensor, cfg: EnvConfig,
                          fppo: FastPPOConfig) -> FastTrainState:
    params = init_params(key, cfg, fppo)
    return FastTrainState(params, make_optimizer(fppo).init(params.tensors()), 0)


GUMBEL_MIN = 1e-7  # _sample_action's uniform(minval=1e-7, maxval=1)


def gumbel_uniforms(k_roll: torch.Tensor, T: int, B: int, cols: slice = slice(None)) -> torch.Tensor:
    """The collect's uniforms f32[T, 6, len(cols)]: step ``t``'s are columns
    ``cols`` of ``uniform(split(k_roll, T)[t], (6, B), minval=1e-7,
    maxval=1)``, JAX's draws bit for bit, in one launch on the card."""
    return kd.uniform_cols(k_roll, (C.N_ACTIONS, B), cols, GUMBEL_MIN, 1.0, planes=T)


def epoch_perms(k_perm: torch.Tensor, epochs: int, n: int) -> torch.Tensor:
    """``permutation(k_e, n)`` for each ``k_e`` of ``split(k_perm, epochs)``:
    int32[epochs, n], sorted on the key's device."""
    return torch.stack([kd.permutation(k, n) for k in kd.split_keys(k_perm, epochs)])


def _sample_action(u: torch.Tensor, logits: torch.Tensor):
    """Gumbel-argmax over the action axis (axis 0) with uniforms ``u``; (action, log_prob)."""
    g = logits - torch.log(-torch.log(u))
    action = torch.argmax(g, dim=0).to(torch.int32)  # first index on ties, as jnp
    logsm = torch.log_softmax(logits, dim=0)
    log_prob = logsm.gather(0, action.to(torch.int64)[None])[0]
    return action, log_prob


def _window(pool: PackedState, t: int, B: int, mesh=None) -> PackedState:
    """Step ``t``'s auto-reset worlds: the whole batch's pool window at
    ``(t * POOL_STRIDE) % B``, or under a mesh this rank's columns of it."""
    if mesh is None:
        return _pool_slice(pool, (t * POOL_STRIDE) % B, B)
    cols = mesh.cols(B * mesh.size)
    off = (t * POOL_STRIDE) % (B * mesh.size)
    return _pool_slice(pool, off + cols.start, B)


def _collect(cfg: EnvConfig, fppo: FastPPOConfig, params: MLPParams,
             env: PackedState, pool: PackedState, u: torch.Tensor, mesh=None):
    """T steps of the policy; ``u`` f32[T, 6, B] Gumbel uniforms. (env, _Traj).

    Under a ``mesh``, ``env`` and ``u`` are this rank's columns and ``pool``
    the whole batch's pool of 2B worlds.
    """
    T, B = fppo.rollout_steps, env.agent_r.shape[-1]
    dev = env.agent_r.device
    buf = lambda dtype, *shape: torch.empty((T, *shape), dtype=dtype, device=dev)
    tr = _Traj(buf(bf16, feature_rows(cfg), B), buf(torch.int32, B), buf(f32, B),
               buf(f32, B), buf(f32, B), buf(torch.bool, B), buf(torch.int32, B))
    win = torch.tensor(1.0, device=dev)
    lose = torch.tensor(-1.0 / cfg.max_steps, device=dev)
    st = env
    for t in range(T):
        with trace("ppo.policy"):
            feat = features(cfg, st)
            logits, value = apply_policy(params, feat)
            action, log_prob = _sample_action(u[t], logits)
        st, raw, done = rollout_packed_actions(cfg, st, action[None])
        st = _autoreset(st, _window(pool, t, B, mesh), done[0])
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


def shard_mean(n_total: int | None):
    """The mean over a minibatch: ``Tensor.mean``, or for a shard of a
    minibatch of ``n_total`` rows, the shard's part of the whole mean."""
    if n_total is None:
        return lambda x: x.mean()
    return lambda x: x.sum() / n_total


def _ppo_loss(fppo: FastPPOConfig, logits, value, batch, normalized: bool = False,
              n_total: int | None = None):
    """``normalized``: ``batch``'s advantages are normalised already (over
    the whole minibatch); ``n_total`` as ``shard_mean`` takes it."""
    _, action, old_log_prob, old_value, adv, ret = batch
    mean = shard_mean(n_total)
    logsm = torch.log_softmax(logits, dim=0)
    onehot = torch.arange(logits.shape[0], device=logits.device)[:, None] == action[None, :]
    log_prob = (onehot * logsm).sum(dim=0)
    ratio = torch.exp(log_prob - old_log_prob)
    adv_n = adv if normalized else fu.normalize_adv(adv)
    pg = -mean(torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - fppo.clip_eps, 1 + fppo.clip_eps) * adv_n,
    ))
    v_clipped = old_value + torch.clamp(value - old_value, -fppo.clip_eps, fppo.clip_eps)
    v_loss = 0.5 * mean(torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2))
    entropy = -mean((torch.exp(logsm) * logsm).sum(dim=0))
    loss = pg + fppo.vf_coef * v_loss - fppo.ent_coef * entropy
    return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": entropy}


def _loss(fppo: FastPPOConfig, params: MLPParams, batch):
    """Clipped-surrogate loss over feature-major ``feat [F, M]``; (loss, aux)."""
    logits, value = apply_policy(params, batch[0])
    return _ppo_loss(fppo, logits, value, batch)


def _loss_bm(fppo: FastPPOConfig, params: MLPParams, batch, normalized: bool = False,
             n_total: int | None = None):
    """The same loss over batch-major ``feat [N, F]``; (loss, aux)."""
    logits, value = apply_policy_bm(params, batch[0])
    return _ppo_loss(fppo, logits, value, batch, normalized, n_total)


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


def _autograd_grads(fppo: FastPPOConfig, params: MLPParams, batch, normalized: bool = False,
                    n_total: int | None = None):
    """(grads, aux with "loss") by autograd of ``_loss_bm``."""
    with torch.enable_grad():
        loss, aux = _loss_bm(fppo, params, batch, normalized, n_total)
        names = list(PARAM_NAMES)
        g = torch.autograd.grad(loss, [getattr(params, k) for k in names])
    aux = {k: v.detach() for k, v in aux.items()}
    return dict(zip(names, g)), {"loss": loss.detach(), **aux}


def check_blocks(Bl: int, BLK: int, mesh) -> None:
    """Raise unless a rank's ``Bl`` envs are whole shuffle blocks of ``BLK``
    rows (a block must lie on one rank; one process takes any blocks)."""
    if mesh is not None and mesh.size > 1 and Bl % BLK:
        raise ValueError(f"a rank's {Bl} envs must be whole shuffle blocks of {BLK} rows "
                         f"(batch / ranks % {BLK} == 0)")


class Minibatch(NamedTuple):
    """One minibatch of the update phase, as this rank holds it."""

    featb: torch.Tensor  # bf16[NB_rank, BLK, F]: the rank's trajectory, block by block
    ids: torch.Tensor  # int64[k]: the rank's blocks of the minibatch, in minibatch order
    rest: tuple  # (action, old_log_prob, old_value, adv_n, ret), each [k * BLK]
    n_total: int | None  # the whole minibatch's rows under a mesh of ranks, else None


def minibatches(fppo: FastPPOConfig, traj: _Traj, adv, ret, perms: torch.Tensor, mesh=None):
    """The update phase's minibatches, epoch by epoch, in order.

    ``perms`` int[update_epochs, NB]: each epoch's permutation of the whole
    batch's shuffle blocks (block ``j`` holds rows ``j * BLK ..`` of the
    t-major [T * B] rows). The advantages are normalised over the whole
    minibatch (``adv_n``). Under a mesh of several ranks the rank keeps the
    blocks in its columns (a block lies on one rank, or this raises), maps
    them to its own block ids, gathers the whole batch's ``adv`` once, and
    reads the permutations on the host once.
    """
    T, Bl = traj.action.shape
    F = traj.feat.shape[1]
    world = 1 if mesh is None else mesh.size
    B = Bl * world
    BLK = shuffle_block(T, B, fppo.num_minibatches)
    check_blocks(Bl, BLK, mesh)
    ncb = B // BLK  # the batch's blocks of a step
    featb = traj.feat.permute(0, 2, 1).reshape(T * Bl // BLK, BLK, F)
    vecs = tuple(x.reshape(T * Bl // BLK, BLK) for x in (traj.action, traj.log_prob, traj.value, ret))
    adv_b = (adv if mesh is None else mesh.gather(adv)).reshape(T * B // BLK, BLK)
    nbm = T * B // BLK // fppo.num_minibatches
    host = perms.cpu() if world > 1 else None
    for e in range(fppo.update_epochs):
        perm = perms[e].to(torch.int64)
        for i in range(fppo.num_minibatches):
            ids = perm[i * nbm: (i + 1) * nbm]
            adv_n = fu.normalize_adv(adv_b[ids].reshape(-1)).view(nbm, BLK)
            if world > 1:
                own, ids = mesh.own(host[e, i * nbm: (i + 1) * nbm].to(torch.int64), ncb)
                ids, adv_n = ids.to(perm.device), adv_n[own.to(perm.device)]
            action, old_lp, old_v, r = (x[ids].reshape(-1) for x in vecs)
            yield Minibatch(featb, ids, (action, old_lp, old_v, adv_n.reshape(-1), r),
                            nbm * BLK if world > 1 else None)


def minibatch_grads(fppo: FastPPOConfig, params: MLPParams, mb: Minibatch,
                    use_fused_kernel: bool | None = None, mesh=None):
    """(grads, aux with "loss") of one minibatch, summed over the ranks.

    ``use_fused_kernel`` None or True takes ``fused_minibatch_grads_indexed``
    (the kernel on CUDA, its plain version on the CPU), False autograd of
    ``_loss_bm``. A rank that holds no block of the minibatch contributes
    zeros and launches nothing.
    """
    if mb.ids.numel() == 0:
        grads = {k: torch.zeros_like(getattr(params, k)) for k in PARAM_NAMES}
        aux = {k: torch.zeros((), device=mb.featb.device)
               for k in ("loss", "pg_loss", "v_loss", "entropy")}
    elif use_fused_kernel is False:
        x = mb.featb[mb.ids].reshape(-1, mb.featb.shape[-1])
        grads, aux = _autograd_grads(fppo, params, (x,) + mb.rest, True, mb.n_total)
    else:
        grads, aux = fu.fused_minibatch_grads_indexed(fppo, params, mb.featb, mb.ids, mb.rest,
                                                      normalized=True, n_total=mb.n_total)
    grads, aux = sum_over_ranks(mesh, grads, aux)
    return grads, aux


def _update_phase(fppo: FastPPOConfig, ts: FastTrainState, traj: _Traj, adv, ret,
                  perms: torch.Tensor, use_fused_kernel: bool | None = None, mesh=None):
    """GAE-to-optimizer tail of one PPO iteration.

    ``perms`` int[update_epochs, NB]: each epoch's permutation of the shuffle
    blocks (``minibatches``); ``use_fused_kernel`` as ``minibatch_grads``
    takes it. Returns (params, opt_state, losses [E, M], aux dict of
    [E, M]); params are updated in place.
    """
    optimizer = make_optimizer(fppo)
    params, opt_state = ts.params, ts.opt_state
    losses, auxes = [], []
    for mb in minibatches(fppo, traj, adv, ret, perms, mesh):
        with trace("ppo.grads"):
            grads, aux = minibatch_grads(fppo, params, mb, use_fused_kernel, mesh)
        updates, opt_state = optimizer.update(grads, opt_state)
        apply_updates(params, updates)
        losses.append(aux.pop("loss"))
        auxes.append(aux)
    shape = (fppo.update_epochs, fppo.num_minibatches)
    stack = lambda xs: torch.stack(xs).reshape(shape)
    return (params, opt_state, stack(losses),
            {k: stack([a[k] for a in auxes]) for k in auxes[0]})


def _fresh_pool(cfg: EnvConfig, key: torch.Tensor, n: int,
                fused: bool | None = None) -> PackedState:
    """The auto-reset pool from ``k_pool``: the pool kernel's wrapper by
    default, seeded by ``randint(key, (2,), 0, 2**31 - 1)`` as JAX's fused
    pool is, or JAX's keyed ``fresh_packed_batch`` when ``fused`` is False."""
    if fused is False:
        return fresh_packed_batch(cfg, key, n)
    seeds = kd.randint(key, (2,), 0, 2**31 - 1)
    return fresh_packed_fused(cfg, seeds[0], n, seed2=seeds[1])


class Rollout(NamedTuple):
    """What the update phase takes from one iteration's collect."""

    traj: _Traj
    adv: torch.Tensor  # f32[T, B]
    ret: torch.Tensor  # f32[T, B]
    perms: torch.Tensor  # int64[update_epochs, NB], the whole batch's blocks


def pool_choice(fused_pool: bool | None, mesh) -> bool | None:
    """JAX's sharded step draws the keyed ``fresh_packed_batch`` over several
    ranks (``parallel/sharded_engine.py:83``), the pool kernel otherwise."""
    if fused_pool is None and mesh is not None and mesh.size > 1:
        return False
    return fused_pool


@torch.no_grad()
def rollout_phase(cfg: EnvConfig, fppo: FastPPOConfig, ts: FastTrainState, env: PackedState,
                  key: torch.Tensor, *, fused_pool: bool | None = None, mesh=None):
    """The draws, the collect and GAE of one PPO iteration; (env, Rollout,
    next key).

    ``key, k_pool, k_roll, k_perm = split(key, 4)`` as JAX's
    ``train_step_fast``; then the pool of 2B worlds from ``k_pool``, the
    Gumbel uniforms [T, 6, B] from ``k_roll`` and the epoch permutations from
    ``k_perm``. Under a mesh a rank draws the whole pool and permutations and
    its own columns of the uniforms.
    """
    Bl = env.agent_r.shape[-1]
    B = Bl if mesh is None else Bl * mesh.size
    T = fppo.rollout_steps
    BLK = shuffle_block(T, B, fppo.num_minibatches)  # raises if shapes don't tile
    check_blocks(Bl, BLK, mesh)
    NB = T * B // BLK
    key, k_pool, k_roll, k_perm = kd.split_keys(key, 4)
    pool = _fresh_pool(cfg, k_pool, 2 * B, fused=pool_choice(fused_pool, mesh))
    u = gumbel_uniforms(k_roll, T, B, slice(None) if mesh is None else mesh.cols(B))
    with trace("ppo.collect"):
        env, traj = _collect(cfg, fppo, ts.params, env, pool, u, mesh)
    _, last_value = apply_policy(ts.params, features(cfg, env))
    adv, ret = _gae(fppo, traj, last_value)
    perms = epoch_perms(k_perm, fppo.update_epochs, NB)
    return env, Rollout(traj, adv, ret, perms), key


def rollout_metrics(cfg: EnvConfig, traj, losses, auxes: dict, mesh=None) -> dict:
    """An iteration's metrics (0-dim tensors): the loss terms' means and the
    trajectory's rates, whose sums run over every rank's columns."""
    T, Bl = traj.action.shape
    n = T * Bl * (1 if mesh is None else mesh.size)
    sums = torch.stack([traj.reward.sum(), traj.done.sum().to(f32),
                        (traj.raw_reward == cfg.max_steps).sum().to(f32)])
    if mesh is not None:
        mesh.all_reduce(sums)
    reward, dones, successes = sums
    return {
        "loss": losses.mean(),
        "reward_mean": reward / n,
        "episode_done_frac": dones / n,
        "success_rate": successes / dones.clamp_min(1),
        "success_per_step": successes / n,
        **{k: v.mean() for k, v in auxes.items()},
    }


@torch.no_grad()
def train_step_fast(cfg: EnvConfig, fppo: FastPPOConfig, ts: FastTrainState,
                    env: PackedState, key: torch.Tensor, *,
                    fused_pool: bool | None = None, fused_update: bool | None = None,
                    mesh=None):
    """One PPO iteration on the packed engine; (ts, env, key, metrics).

    ``key`` is JAX's key data, int64[2] on the env's device; every draw
    comes from it as in JAX, and the next key is returned. Metrics are 0-dim
    tensors on that device. Under a ``mesh``
    (``parallel/sharded_engine.fast_train_step_sharded``), ``env`` is this
    rank's columns, every rank holds the same key, and every rank ends with
    the same parameters.
    """
    env, r, key = rollout_phase(cfg, fppo, ts, env, key, fused_pool=fused_pool, mesh=mesh)
    with trace("ppo.update"):
        params, opt_state, losses, auxes = _update_phase(
            fppo, ts, r.traj, r.adv, r.ret, r.perms, use_fused_kernel=fused_update, mesh=mesh)
    metrics = rollout_metrics(cfg, r.traj, losses, auxes, mesh)
    return FastTrainState(params, opt_state, ts.update_idx + 1), env, key, metrics


def train_many_fast(cfg: EnvConfig, fppo: FastPPOConfig, ts: FastTrainState,
                    env: PackedState, num_updates: int, key: torch.Tensor, *,
                    fused_pool: bool | None = None, fused_update: bool | None = None):
    """``num_updates`` PPO iterations; (ts, env, key, metrics stacked [num_updates])."""
    history = []
    for _ in range(num_updates):
        ts, env, key, metrics = train_step_fast(
            cfg, fppo, ts, env, key, fused_pool=fused_pool, fused_update=fused_update)
        history.append(metrics)
    metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    return ts, env, key, metrics
