"""Fast PPO for policies that look at the world: a CNN over the one-hot grid.

Counterpart of ``gym_craftingworld_tpu/train/fast_pixel_ppo.py``; see that
module's docstring for the design. It runs the fast-PPO loop
(``train/fast_ppo.py``: packed engine, pool auto-reset, GAE, clipped
surrogate, block-shuffled minibatches) with two changes:

* Rollouts store the packed state columns of every step, not observations;
  the (B, H, W, 12) one-hot grid the policy reads (``render/raster.
  render_onehot`` semantics, plus 22 goal and holding bits) is rendered anew
  from the stored state in the collect and in every update minibatch
  (``render_grid_obs``), with compares and selects only.
* The policy is a conv stem: strided 3x3 convolutions in bf16 over the NHWC
  grid (XLA's SAME pads, ``models/layers.conv_nhwc``), the bits fused at the
  dense layer, f32 heads.

What the port does differently, as in ``train/fast_ppo.py``: draws come from
JAX's key chain bit for bit (``split(key, 4)`` a step: the pool of
``fresh_packed_batch``, the Gumbel uniforms, the epoch permutations;
``split(key, 5)`` for the conv init, whose normals are within a few ulp),
and the pure functions take them as arguments (``u`` Gumbel uniforms,
``perms`` epoch permutations of the minibatch blocks); the collect steps through the fused actions kernel at
T = 1 (``ops/packed_fused.rollout_packed_actions``: the kernel on the card,
its plain version on the CPU); the optimizer is the hand-written clip + Adam
on the ``ConvParams`` tensors; the gradient is autograd of ``_pixel_loss``;
on the card the collect's forward runs in chunks of ``POLICY_CHUNK`` rows,
so that its columns do not depend on the batch's width, replayed from a CUDA
graph so that the chunks cost the host one replay.
Under a ``mesh`` a rank steps its own columns and computes the unsharded
step's function, as ``train/fast_ppo.py`` says: the whole pool and
permutations and its own columns of the uniforms, shuffle
blocks of ``BLK`` rows that lie on one rank, advantages normalised over the
whole minibatch, each rank's autograd of its rows' share of the means, and
one ``all_reduce`` of the gradients and loss terms a minibatch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.models.layers import conv_nhwc
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.fused_update import normalize_adv
from gym_craftingworld_tpu_torch.ops.packed_fused import rollout_packed_actions
from gym_craftingworld_tpu_torch.ops.packed_rollout import PackedState
from gym_craftingworld_tpu_torch.parallel.mesh import sum_over_ranks
from gym_craftingworld_tpu_torch.train.fast_ppo import (
    AdamState,
    FastPPOConfig,
    _autoreset,
    _gae,
    _sample_action,
    _window,
    apply_updates,
    check_blocks,
    epoch_perms,
    fresh_packed_batch,
    gumbel_uniforms,
    he_normal,
    make_optimizer,
    rollout_metrics,
    shard_mean,
)

bf16 = torch.bfloat16
f32 = torch.float32
i32 = torch.int32
CONV_NAMES = ("k1", "b1", "k2", "b2", "w1", "bd", "wl", "bl", "wv", "bv")
BLK = 128  # rows per shuffle block of the update phase
# Rows of one call of the collect's policy forward on the card. cuDNN and
# cuBLAS pick their kernel, and with it the order of each sum, by the batch's
# width (on an H100 the f32 product with w1 gives other bits at 8,192 rows
# than at 16,384: chip_smoke.py phase 17), so a rank of a mesh would sum its
# columns unlike the unsharded run. The forward runs in chunks of this one
# width instead, the last zero-padded, and every convolution and product has
# the same shape on every rank. 4,096 divides 16,384 / W for W = 1, 2 and 4
# ranks, so no chunk of the default 16,384 envs is padded.
POLICY_CHUNK = 4096


class PixelPPOConfig(NamedTuple):
    rollout_steps: int = 64
    update_epochs: int = 2
    num_minibatches: int = 16
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    conv1: int = 32
    conv2: int = 64
    hidden: int = 256
    stride1: int = 2  # first-conv stride; the throughput preset uses 3

    @classmethod
    def throughput(cls, **overrides) -> "PixelPPOConfig":
        """The JAX package's wall-clock preset: 1 epoch, 8 minibatches, a
        slimmer stem with a stride-3 first conv."""
        return cls(update_epochs=1, num_minibatches=8, conv1=16, conv2=32,
                   hidden=192, stride1=3)._replace(**overrides)

    @property
    def as_fast(self) -> FastPPOConfig:
        """The shared-loop view (GAE, optimizer and clipping knobs)."""
        return FastPPOConfig(
            rollout_steps=self.rollout_steps, update_epochs=self.update_epochs,
            num_minibatches=self.num_minibatches, gamma=self.gamma,
            gae_lambda=self.gae_lambda, clip_eps=self.clip_eps, vf_coef=self.vf_coef,
            ent_coef=self.ent_coef, lr=self.lr, max_grad_norm=self.max_grad_norm,
            hidden=self.hidden)


# ---------------------------------------------------------------------------
# observation: packed state -> one-hot grid + goal bits
# ---------------------------------------------------------------------------


def render_grid_obs(cfg: EnvConfig, s: PackedState):
    """(grid bf16[B, H, W, 12], bits bf16[B, 22]) from packed columns.

    Grid channels 0-7 object one-hot, 8 agent, 9-11 held item in the agent's
    cell (``render_onehot``); bits are the desired and achieved masks and the
    holding one-hot. Each cell's object code is accumulated over the 8 slots
    with compares (one object per cell), then expanded to channels.
    """
    B = s.agent_r.shape[-1]
    HW = cfg.n_cells
    dev = s.agent_r.device
    ar = lambda lo, hi: torch.arange(lo, hi, dtype=i32, device=dev)
    key = s.slot_key.to(i32)  # [8, B]
    typ = s.slot_type.to(i32)
    cells = ar(0, HW)
    code = torch.zeros((B, HW), dtype=i32, device=dev)
    for i in range(C.N_OBJECTS):
        code = code + typ[i][:, None] * (key[i][:, None] == cells[None, :]).to(i32)
    obj = (code[:, :, None] == ar(1, C.N_OBJECTS + 1)).to(bf16)  # [B, HW, 8]
    agent_key = s.agent_r.to(i32) * cfg.width + s.agent_c.to(i32)
    agent = (agent_key[:, None] == cells[None, :]).to(bf16)[..., None]  # [B, HW, 1]
    hold = s.holding.to(i32)
    held_oh = ((hold - 1)[:, None] == ar(0, 3)).to(bf16)  # [B, 3]; 0 gives a zero row
    held = agent * held_oh[:, None, :]  # [B, HW, 3]
    grid = torch.cat([obj, agent, held], dim=-1).reshape(B, cfg.height, cfg.width,
                                                         C.N_CHANNELS)
    bits9 = ar(0, C.N_TASKS)
    des = ((s.desired.to(i32)[:, None] >> bits9) & 1).to(bf16)
    ach = ((s.achieved.to(i32)[:, None] >> bits9) & 1).to(bf16)
    hold4 = (hold[:, None] == ar(0, 4)).to(bf16)
    return grid, torch.cat([des, ach, hold4], dim=-1)


# ---------------------------------------------------------------------------
# the conv policy
# ---------------------------------------------------------------------------


class ConvParams(nn.Module):
    """The conv policy's parameters under the JAX names and layouts (f32):
    ``k1`` [3, 3, 12, C1] and ``k2`` [3, 3, C1, C2] (HWIO), ``w1``
    [flat + 22, H], ``wl`` [H, 6], ``wv`` [H, 1], and their biases."""

    def __init__(self, c1: int, c2: int, flat: int, hidden: int, device=None):
        super().__init__()
        z = lambda *shape: nn.Parameter(torch.zeros(shape, dtype=f32, device=device))
        self.k1, self.b1 = z(3, 3, C.N_CHANNELS, c1), z(c1)
        self.k2, self.b2 = z(3, 3, c1, c2), z(c2)
        self.w1, self.bd = z(flat + 22, hidden), z(hidden)
        self.wl, self.bl = z(hidden, C.N_ACTIONS), z(C.N_ACTIONS)
        self.wv, self.bv = z(hidden, 1), z(1)
        self.policy_graph = None  # the collect's captured policy step (_policy_graphed)

    def tensors(self) -> dict:
        return {k: getattr(self, k) for k in CONV_NAMES}


def _flat_dim(cfg: EnvConfig, ppo: PixelPPOConfig) -> int:
    s1 = ppo.stride1
    h = ((cfg.height + s1 - 1) // s1 + 1) // 2
    w = ((cfg.width + s1 - 1) // s1 + 1) // 2
    return h * w * ppo.conv2


def init_pixel_params(key: torch.Tensor, cfg: EnvConfig, ppo: PixelPPOConfig) -> ConvParams:
    """He-normal weights from ``split(key, 5)`` as JAX's
    ``init_pixel_params``, zero biases, on the key's device."""
    flat = _flat_dim(cfg, ppo)
    p = ConvParams(ppo.conv1, ppo.conv2, flat, ppo.hidden, device=key.device)
    ks = kd.split_keys(key, 5)
    with torch.no_grad():
        p.k1.copy_(he_normal(ks[0], p.k1.shape, 9 * C.N_CHANNELS))
        p.k2.copy_(he_normal(ks[1], p.k2.shape, 9 * ppo.conv1))
        p.w1.copy_(he_normal(ks[2], p.w1.shape, flat + 22))
        p.wl.copy_(0.01 * he_normal(ks[3], p.wl.shape, ppo.hidden))
        p.wv.copy_(he_normal(ks[4], p.wv.shape, ppo.hidden))
    return p


def apply_pixel_policy(p: ConvParams, grid: torch.Tensor, bits: torch.Tensor,
                       stride1: int = 2):
    """(grid bf16[B,H,W,12], bits bf16[B,22]) -> (logits f32[B,6], value f32[B]).

    The convolutions are bf16 with the biases added in bf16; ``w1``'s product
    has bf16 operands and f32 products and sums, plus the f32 bias; the heads
    round their bf16 products to bf16 before the f32 bias is added, as JAX's
    ``h @ wl.astype(bf16) + bl`` does.
    """
    x = torch.relu(conv_nhwc(grid, p.k1, (stride1, stride1)) + p.b1.to(bf16))
    x = torch.relu(conv_nhwc(x, p.k2, (2, 2)) + p.b2.to(bf16))
    x = torch.cat([x.reshape(x.shape[0], -1), bits], dim=-1)
    h = torch.relu(x.to(f32) @ p.w1.to(bf16).to(f32) + p.bd).to(bf16)
    logits = (h @ p.wl.to(bf16)).to(f32) + p.bl
    value = ((h @ p.wv.to(bf16)).to(f32) + p.bv)[:, 0]
    return logits, value


def apply_pixel_policy_chunked(p: ConvParams, grid: torch.Tensor, bits: torch.Tensor,
                               stride1: int, chunk: int):
    """``apply_pixel_policy`` over chunks of ``chunk`` rows, the last zero-padded
    to ``chunk``: every call has one shape, so a row's result does not depend
    on how many rows the batch holds. The port leaves cuDNN's autotuner
    (``torch.backends.cudnn.benchmark``, which would choose per process) at
    its default, off."""
    B = grid.shape[0]
    logits, value = [], []
    for i in range(0, B, chunk):
        g, b = grid[i:i + chunk], bits[i:i + chunk]
        n = g.shape[0]
        if n < chunk:
            g = torch.cat([g, g.new_zeros((chunk - n, *g.shape[1:]))])
            b = torch.cat([b, b.new_zeros((chunk - n, *b.shape[1:]))])
        lg, v = apply_pixel_policy(p, g, b, stride1)
        logits.append(lg[:n])
        value.append(v[:n])
    return torch.cat(logits), torch.cat(value)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


class PixelTrainState(NamedTuple):
    params: ConvParams
    opt_state: AdamState
    update_idx: int


class _PTraj(NamedTuple):
    state: PackedState  # the packed columns before each step, [T, ...]
    action: torch.Tensor  # int32[T, B]
    log_prob: torch.Tensor  # f32[T, B]
    value: torch.Tensor  # f32[T, B]
    reward: torch.Tensor  # f32[T, B]
    done: torch.Tensor  # bool[T, B]
    raw_reward: torch.Tensor  # int32[T, B] (reference scale, for metrics)


def init_pixel_train_state(key: torch.Tensor, cfg: EnvConfig,
                           ppo: PixelPPOConfig) -> PixelTrainState:
    params = init_pixel_params(key, cfg, ppo)
    return PixelTrainState(params, make_optimizer(ppo.as_fast).init(params.tensors()), 0)


class _PolicyGraph(NamedTuple):
    """A captured policy step: what it was captured for, the graph, its input
    state and its outputs."""

    key: tuple
    graph: object  # torch.cuda.CUDAGraph
    state: PackedState
    out: tuple


def _policy_graphed(p: ConvParams, cfg: EnvConfig, st: PackedState, stride1: int):
    """``_policy_tb`` in chunks of ``POLICY_CHUNK`` rows on the card, replayed
    from a CUDA graph: each chunk's forward makes some 30 launches, and at
    ``throughput()`` widths the host, not the card, paces them. The params
    hold the graph (``ConvParams.policy_graph``), captured on the first call
    for their tensors (the optimizer updates them in place), this config and
    these shapes; another call captures it anew. ``st`` is copied into its
    input and the outputs out."""
    key = (cfg, stride1, [(x.shape, x.dtype) for x in st],
           [t.data_ptr() for t in p.tensors().values()])
    if p.policy_graph is None or p.policy_graph.key != key:
        p.policy_graph = None  # the old capture's memory goes first
        state = PackedState(*(x.clone() for x in st))
        run = lambda: _policy_tb(p, cfg, state, stride1, POLICY_CHUNK)
        side = torch.cuda.Stream(device=st.agent_r.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.no_grad():
            with torch.cuda.stream(side):
                run()  # cuDNN's and cuBLAS's set-up, outside the capture
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = run()
        p.policy_graph = _PolicyGraph(key, graph, state, out)
    g = p.policy_graph
    for dst, src in zip(g.state, st):
        dst.copy_(src)
    g.graph.replay()
    return tuple(x.clone() for x in g.out)


def _policy_tb(p: ConvParams, cfg: EnvConfig, st: PackedState, stride1: int = 2,
               chunk: int | None = None):
    """The policy on the lane-major packed state: logits [6, B], value [B].

    ``chunk`` rows a forward call (``apply_pixel_policy_chunked``); None takes
    ``POLICY_CHUNK`` rows from a CUDA graph on the card (``_policy_graphed``)
    and the whole batch, as JAX does, on the CPU.
    """
    if chunk is None and st.agent_r.is_cuda:
        return _policy_graphed(p, cfg, st, stride1)
    grid, bits = render_grid_obs(cfg, st)
    if chunk is None:
        logits, value = apply_pixel_policy(p, grid, bits, stride1)
    else:
        logits, value = apply_pixel_policy_chunked(p, grid, bits, stride1, chunk)
    return logits.T, value


def _collect_pixel(cfg: EnvConfig, ppo: PixelPPOConfig, params: ConvParams,
                   env: PackedState, pool: PackedState, u: torch.Tensor, mesh=None,
                   chunk: int | None = None):
    """T steps of the policy; ``u`` f32[T, 6, B] Gumbel uniforms. (env, _PTraj).

    Under a ``mesh``, ``env`` and ``u`` are this rank's columns and ``pool``
    the whole batch's pool of 2B worlds. ``chunk`` as ``_policy_tb`` takes it.
    """
    T, B = ppo.rollout_steps, env.agent_r.shape[-1]
    dev = env.agent_r.device
    buf = lambda dtype, *shape: torch.empty((T, *shape), dtype=dtype, device=dev)
    tr = _PTraj(PackedState(*(buf(x.dtype, *x.shape) for x in env)), buf(i32, B),
                buf(f32, B), buf(f32, B), buf(f32, B), buf(torch.bool, B), buf(i32, B))
    win = torch.tensor(1.0, device=dev)
    lose = torch.tensor(-1.0 / cfg.max_steps, device=dev)
    st = env
    for t in range(T):
        logits, value = _policy_tb(params, cfg, st, ppo.stride1, chunk)
        action, log_prob = _sample_action(u[t], logits)
        for dst, src in zip(tr.state, st):
            dst[t] = src
        st, raw, done = rollout_packed_actions(cfg, st, action[None])
        st = _autoreset(st, _window(pool, t, B, mesh), done[0])
        for dst, src in zip(tr[1:], (action, log_prob, value,
                                     torch.where(raw[0] == cfg.max_steps, win, lose),
                                     done[0], raw[0])):
            dst[t] = src
    return st, tr


def _pixel_loss(ppo: PixelPPOConfig, params: ConvParams, cfg: EnvConfig, batch,
                normalized: bool = False, n_total: int | None = None):
    """Clipped-surrogate loss on a minibatch of stored states; (loss, aux).

    ``normalized`` and ``n_total`` as ``train/fast_ppo._ppo_loss`` takes them.
    """
    st, action, old_log_prob, old_value, adv, ret = batch
    mean = shard_mean(n_total)
    grid, bits = render_grid_obs(cfg, st)
    logits, value = apply_pixel_policy(params, grid, bits, ppo.stride1)  # [M, 6], [M]
    logsm = torch.log_softmax(logits, dim=-1)
    log_prob = logsm.gather(1, action.to(torch.int64)[:, None])[:, 0]
    ratio = torch.exp(log_prob - old_log_prob)
    adv_n = adv if normalized else normalize_adv(adv)
    pg = -mean(torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) * adv_n,
    ))
    v_clipped = old_value + torch.clamp(value - old_value, -ppo.clip_eps, ppo.clip_eps)
    v_loss = 0.5 * mean(torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2))
    entropy = -mean((torch.exp(logsm) * logsm).sum(dim=-1))
    loss = pg + ppo.vf_coef * v_loss - ppo.ent_coef * entropy
    return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": entropy}


def _pixel_grads(ppo: PixelPPOConfig, params: ConvParams, cfg: EnvConfig, batch,
                 normalized: bool = False, n_total: int | None = None):
    """(grads by name, aux with "loss") by autograd of ``_pixel_loss``."""
    with torch.enable_grad():
        loss, aux = _pixel_loss(ppo, params, cfg, batch, normalized, n_total)
        g = torch.autograd.grad(loss, [getattr(params, k) for k in CONV_NAMES])
    return dict(zip(CONV_NAMES, g)), {"loss": loss.detach(),
                                      **{k: v.detach() for k, v in aux.items()}}


def _blocks(traj: _PTraj, adv: torch.Tensor, ret: torch.Tensor):
    """The trajectory in shuffle blocks of ``BLK`` rows, t-major: state
    columns [..., NB, BLK] and (action, log_prob, value, adv, ret) [NB, BLK]."""
    T, B = traj.action.shape
    NB = T * B // BLK
    state = PackedState(*(x.movedim(0, -2).reshape(x.shape[1:-1] + (NB, BLK))
                          if x.dim() == 3 else x.reshape(NB, BLK) for x in traj.state))
    rest = tuple(x.reshape(NB, BLK) for x in (traj.action, traj.log_prob, traj.value,
                                              adv, ret))
    return state, rest


def minibatches(ppo: PixelPPOConfig, traj: _PTraj, adv, ret, perms: torch.Tensor, mesh=None):
    """The update phase's minibatches in order, as (batch, n_total): ``batch``
    = (states, action, old_log_prob, old_value, adv_n, ret) of this rank's
    rows, the advantages normalised over the whole minibatch; ``n_total``
    the whole minibatch's rows under a mesh of several ranks, else None.

    ``perms`` int[update_epochs, NB]: each epoch's permutation of the whole
    batch's shuffle blocks. Ownership as in ``train/fast_ppo.minibatches``.
    """
    T, Bl = traj.action.shape
    world = 1 if mesh is None else mesh.size
    B = Bl * world
    check_blocks(Bl, BLK, mesh)
    ncb = B // BLK  # the batch's blocks of a step
    blk_state, rest = _blocks(traj, adv, ret)
    adv_b = (adv if mesh is None else mesh.gather(adv)).reshape(T * B // BLK, BLK)
    nbm = T * B // BLK // ppo.num_minibatches
    host = perms.cpu() if world > 1 else None
    for e in range(ppo.update_epochs):
        perm = perms[e].to(torch.int64)
        for i in range(ppo.num_minibatches):
            ids = perm[i * nbm: (i + 1) * nbm]
            adv_n = normalize_adv(adv_b[ids].reshape(-1)).view(nbm, BLK)
            if world > 1:
                own, ids = mesh.own(host[e, i * nbm: (i + 1) * nbm].to(torch.int64), ncb)
                ids, adv_n = ids.to(perm.device), adv_n[own.to(perm.device)]
            st_mb = PackedState(*(x[..., ids, :].reshape(x.shape[:-2] + (-1,)) for x in blk_state))
            action, old_lp, old_v, _, r = (x[ids].reshape(-1) for x in rest)
            yield ((st_mb, action, old_lp, old_v, adv_n.reshape(-1), r),
                   nbm * BLK if world > 1 else None)


def minibatch_grads(ppo: PixelPPOConfig, params: ConvParams, cfg: EnvConfig, batch,
                    n_total: int | None = None, mesh=None):
    """(grads, aux with "loss") of one minibatch from ``minibatches``, summed
    over the ranks; a rank with no rows of it contributes zeros."""
    if batch[1].numel() == 0:
        grads = {k: torch.zeros_like(getattr(params, k)) for k in CONV_NAMES}
        aux = {k: torch.zeros((), device=batch[1].device)
               for k in ("loss", "pg_loss", "v_loss", "entropy")}
    else:
        grads, aux = _pixel_grads(ppo, params, cfg, batch, True, n_total)
    grads, aux = sum_over_ranks(mesh, grads, aux)
    return grads, aux


def _update_phase(cfg: EnvConfig, ppo: PixelPPOConfig, ts: PixelTrainState, traj: _PTraj,
                  adv: torch.Tensor, ret: torch.Tensor, perms: torch.Tensor, mesh=None):
    """GAE-to-optimizer tail of one PPO iteration.

    ``perms`` int[update_epochs, NB]: each epoch's permutation of the shuffle
    blocks. Returns (params, opt_state, losses [E, M], aux dict of [E, M]);
    params are updated in place.
    """
    optimizer = make_optimizer(ppo.as_fast)
    params, opt_state = ts.params, ts.opt_state
    losses, auxes = [], []
    for batch, n_total in minibatches(ppo, traj, adv, ret, perms, mesh):
        grads, aux = minibatch_grads(ppo, params, cfg, batch, n_total, mesh)
        updates, opt_state = optimizer.update(grads, opt_state)
        apply_updates(params, updates)
        losses.append(aux.pop("loss"))
        auxes.append(aux)
    shape = (ppo.update_epochs, ppo.num_minibatches)
    stack = lambda xs: torch.stack(xs).reshape(shape)
    return (params, opt_state, stack(losses),
            {k: stack([a[k] for a in auxes]) for k in auxes[0]})


@torch.no_grad()
def rollout_phase(cfg: EnvConfig, ppo: PixelPPOConfig, ts: PixelTrainState, env: PackedState,
                  key: torch.Tensor, mesh=None):
    """The draws, the collect and GAE of one iteration; (env, (traj, adv,
    ret, perms), next key). ``key, k_pool, k_roll, k_perm = split(key, 4)``
    as JAX's ``train_step_pixel``; the pool is ``fresh_packed_batch(k_pool,
    2B)``, the uniforms and permutations as ``train/fast_ppo.rollout_phase``
    draws them."""
    T, Bl = ppo.rollout_steps, env.agent_r.shape[-1]
    B = Bl if mesh is None else Bl * mesh.size
    if (T * B) % (BLK * ppo.num_minibatches):
        raise ValueError(f"rollout_steps*batch ({T}*{B}) must be a multiple of "
                         f"{BLK}*num_minibatches")
    check_blocks(Bl, BLK, mesh)
    NB = T * B // BLK
    key, k_pool, k_roll, k_perm = kd.split_keys(key, 4)
    pool = fresh_packed_batch(cfg, k_pool, 2 * B)
    u = gumbel_uniforms(k_roll, T, B, slice(None) if mesh is None else mesh.cols(B))
    env, traj = _collect_pixel(cfg, ppo, ts.params, env, pool, u, mesh)
    _, last_value = _policy_tb(ts.params, cfg, env, ppo.stride1)
    adv, ret = _gae(ppo.as_fast, traj, last_value)
    perms = epoch_perms(k_perm, ppo.update_epochs, NB)
    return env, (traj, adv, ret, perms), key


@torch.no_grad()
def train_step_pixel(cfg: EnvConfig, ppo: PixelPPOConfig, ts: PixelTrainState,
                     env: PackedState, key: torch.Tensor, mesh=None):
    """One PPO iteration of the grid-observation CNN policy; (ts, env, key,
    metrics). ``key`` is JAX's key data int64[2] on the env's device; every
    draw comes from it as in JAX, and the next key is returned. Under a
    ``mesh`` ``env`` is this rank's columns
    (``parallel/sharded_engine.pixel_train_step_sharded``)."""
    env, (traj, adv, ret, perms), key = rollout_phase(cfg, ppo, ts, env, key, mesh)
    params, opt_state, losses, auxes = _update_phase(cfg, ppo, ts, traj, adv, ret, perms, mesh)
    metrics = rollout_metrics(cfg, traj, losses, auxes, mesh)
    return PixelTrainState(params, opt_state, ts.update_idx + 1), env, key, metrics


def train_many_pixel(cfg: EnvConfig, ppo: PixelPPOConfig, ts: PixelTrainState,
                     env: PackedState, num_updates: int, key: torch.Tensor):
    """``num_updates`` PPO iterations; (ts, env, key, metrics stacked [num_updates])."""
    history = []
    for _ in range(num_updates):
        ts, env, key, metrics = train_step_pixel(cfg, ppo, ts, env, key)
        history.append(metrics)
    metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    return ts, env, key, metrics
