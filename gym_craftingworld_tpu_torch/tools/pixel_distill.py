"""Distill the canonical grid policy into an images-only pixel policy.

Counterpart of the JAX package's ``tools/pixel_distill.py``, which writes the
``distilled_student`` section of ``docs/pixel_canonical.json``: a DAgger
distillation of the trained GridPolicy teacher into
``models/cnn.PixelDistillStudent``, which reads exactly the reference's pixel
observation content (the current frame, the imagined desired-goal frame and
the init frame, rendered RGB; craftingworld_ray.py:84-92) and nothing else.

  round 0   roll the teacher greedily (2% random moves) on fresh canonical
            resets, record snapshot columns and the episode's imagined-goal
            columns; label them with the teacher's argmax and logits (soft
            targets);
  round 1+  roll the student (2% random moves) on its own visitation, keep the
            salvageable frames of failed episodes (at most ``--fail-cap``
            each) and every frame of the won ones, and label them with the
            scripted expert (hard targets), as the JAX code does;
  train     minibatches flip the columns (``augment_flips``), render the
            three frames from them on the device (``images_from_cols``) and
            fit 0.9 soft + 0.1 hard cross-entropy on teacher rows, hard on
            student rows; 50/50 mixture batches by upsampling the core.

Every ``jax.random`` draw is JAX's, from the same key data on the device
(the keyed-draw kernels on the card): the rollouts' resets and exploration
(``collect_round``), the minibatches' flips (``flip_bits``) and the sampled
evaluation's chain (``eval_student``); the host draws (``RandomState``) are
JAX's too, so the same columns give the same rows. What differs: on the
card an epoch's minibatch updates replay one CUDA graph (``student_epoch``;
launched one by one from the host, the ~400 launches of a minibatch set the
pace, not the card); the student relabel runs in several host processes
(``_canonical.relabel``); parameters are ``params_<tag>.pt`` / ``student.pt``
state dicts; the section gains the card.

    python -m gym_craftingworld_tpu_torch.tools.pixel_distill      # on the card, the defaults
    python -m gym_craftingworld_tpu_torch.tools.pixel_distill --smoke   # tiny, CPU
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig, ray_config
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.core.rollout import _select
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.core.step import step
from gym_craftingworld_tpu_torch.models.cnn import init_student
from gym_craftingworld_tpu_torch.models.grid_policy import (init_grid_policy, planes_from_snaps,
                                                            planes_from_state,
                                                            snap_columns_from_state)
from gym_craftingworld_tpu_torch.render.raster import render_ray
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools._canonical import RUNS, load_params, log, relabel, shown
from gym_craftingworld_tpu_torch.train import dagger
from gym_craftingworld_tpu_torch.train.ppo import collect_noise
from gym_craftingworld_tpu_torch.train.evaluate import summarize
from gym_craftingworld_tpu_torch.train.fast_ppo import AdamState
from gym_craftingworld_tpu_torch.utils.profiling import card_identity

OUT = RUNS / "pixel_canonical.json"
SAVE = RUNS / "pixel_distill"
TEACHER = RUNS / "canonical" / "params_targeted_final.pt"
# JAX's tiny settings, with round 0's teacher episodes cut to the others' 8
SMOKE = ["--rounds", "2", "--episodes", "8", "--episodes0", "8", "--epochs0", "1", "--epochs", "1", "--batch", "32",
         "--eval-episodes", "8", "--final-eval-episodes", "8", "--channels", "8", "--hidden",
         "32", "--stem", "8", "--teacher-channels", "8", "--teacher-hidden", "32", "--teacher",
         "", "--device", "cpu", "--out", str(RUNS / "pixel_smoke.json"), "--save",
         str(RUNS / "pixel_smoke")]
LR, WEIGHT_DECAY, MAX_NORM = 3e-4, 1e-4, 1.0
_DONE_EVERY = 32  # rollout steps between all-done checks
i32 = torch.int32


# ---------------------------------------------------------------------------
# grids and frames from occupancy columns, on the device
# ---------------------------------------------------------------------------


def grids_from_occ(cfg: EnvConfig, occ_key, occ_code):
    """(cell, code) slot pairs -> int8 code grids [B, H, W]."""
    cells = torch.arange(cfg.n_cells, dtype=i32, device=occ_key.device)
    hit = occ_key.to(i32)[:, :, None] == cells[None, None, :]
    flat = (hit.to(i32) * occ_code.to(i32)[:, :, None]).sum(1, dtype=i32)
    return flat.to(torch.int8).reshape(-1, cfg.height, cfg.width)


def init_grids_from_keys(cfg: EnvConfig, init_key):
    """init_key[s] (slot s = object code s+1) -> int8 grids [B, H, W]."""
    cells = torch.arange(cfg.n_cells, dtype=i32, device=init_key.device)
    hit = init_key.to(i32)[:, :, None] == cells[None, None, :]
    codes = torch.arange(1, C.N_OBJECTS + 1, dtype=i32, device=init_key.device)
    flat = (hit.to(i32) * codes[None, :, None]).sum(1, dtype=i32)
    return flat.to(torch.int8).reshape(-1, cfg.height, cfg.width)


def rc(cfg: EnvConfig, key):
    """Flat cell keys -> (row, col) int32[..., 2]."""
    key = key.to(i32)
    return torch.stack([key // cfg.width, key % cfg.width], dim=-1)


def images_from_cols(cfg: EnvConfig, cols: dict):
    """Snapshot columns -> the stacked (current, goal, init) frames uint8[B, 4H, 4W, 9]."""
    cur = grids_from_occ(cfg, cols["occ_key"], cols["occ_code"])
    goal = grids_from_occ(cfg, cols["goal_occ_key"], cols["goal_occ_code"])
    init = init_grids_from_keys(cfg, cols["init_key"])
    zero = torch.zeros(cur.shape[0], dtype=i32, device=cur.device)
    img_c = render_ray(cur, rc(cfg, cols["agent_key"]), cols["holding"].to(i32))
    img_g = render_ray(goal, rc(cfg, cols["goal_agent_key"]), zero)
    img_i = render_ray(init, rc(cfg, cols["init_agent_key"]), zero)
    return torch.cat([img_c, img_g, img_i], dim=-1)


def goal_columns_from_state(cfg: EnvConfig, state: EnvState) -> dict:
    """Imagined-goal occupancy columns (``snap_columns_from_state``'s stable
    sort; a goal grid holds at most 8 objects: imagination only transforms,
    removes or moves the reset set)."""
    B = state.goal_objects.shape[0]
    flat = state.goal_objects.reshape(B, cfg.n_cells).to(i32)
    order = torch.argsort((flat == 0).to(torch.int8), dim=1, stable=True)[:, :C.N_OBJECTS]
    code = flat.gather(1, order)
    occ_key = torch.where(code > 0, order, cfg.n_cells + 1).to(torch.int16)
    gk = (state.goal_agent[:, 0] * cfg.width + state.goal_agent[:, 1]).to(torch.int16)
    return dict(goal_occ_key=occ_key, goal_occ_code=code.to(torch.int8), goal_agent_key=gk)


def fixed_frames(state: EnvState):
    """An episode's goal frame and its init frame, ``AGENT_INIT_MARK`` stripped
    (as ``images_from_cols`` rebuilds it from ``init_key``)."""
    zero = torch.zeros_like(state.holding)
    init = torch.where(state.init_objects == C.AGENT_INIT_MARK, 0, state.init_objects)
    return (render_ray(state.goal_objects, state.goal_agent, zero),
            render_ray(init, state.init_agent, zero))


# ---------------------------------------------------------------------------
# rollouts
# ---------------------------------------------------------------------------


def _policy_logits(cfg: EnvConfig, kind: str, model, st: EnvState, frames):
    if kind == "grid":
        return model(*planes_from_state(cfg, st))[0]
    img_c = render_ray(st.objects, st.agent, st.holding)
    return model(torch.cat([img_c, *frames], dim=-1))[0]


@torch.no_grad()
def _rollout_collect(cfg: EnvConfig, kind: str, model, state: EnvState, explore_u, explore_a,
                     eps: float):
    """Roll the teacher (``"grid"``) or the student (``"pixel"``) greedily from
    ``state``; step t takes the move ``explore_a[t]`` (0-3) where
    ``explore_u[t] < eps``. Returns (snapshot columns [T, B], goal columns
    [B], live [T, B], success [B]); once every episode is done the remaining
    steps are not run, and their rows are zero and not live."""
    B, T = state.objects.shape[0], cfg.max_steps
    dev = state.objects.device
    goal_cols = goal_columns_from_state(cfg, state)
    frames = fixed_frames(state)
    cols = None
    live = torch.zeros((T, B), dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    reward = torch.full((B,), -1, dtype=i32, device=dev)
    for t in range(T):
        now = snap_columns_from_state(cfg, state)
        if cols is None:
            cols = {k: torch.zeros((T, *v.shape), dtype=v.dtype, device=dev) for k, v in now.items()}
        for k, v in now.items():
            cols[k][t] = v
        action = torch.argmax(_policy_logits(cfg, kind, model, state, frames), dim=-1).to(i32)
        action = torch.where(explore_u[t] < eps, explore_a[t].to(i32), action)
        st2, res = step(cfg, state, action)
        state = _select(done, state, st2)
        reward = torch.where(done, reward, res.reward)
        live[t] = ~done
        done = done | res.done
        if t % _DONE_EVERY == _DONE_EVERY - 1 and bool(done.all()):
            break
    return cols, goal_cols, live, reward == cfg.max_steps


def keep_rows(cols: dict, goal_cols: dict, live: np.ndarray, success: np.ndarray,
              fail_cap: int | None, rng_seed: int) -> dict:
    """A chunk's host rows: the live frames, or with ``fail_cap`` every frame
    of a won episode and at most ``fail_cap`` salvageable frames (no
    undesired latched achievement) of a failed one, the surplus dropped by
    ``RandomState(rng_seed)`` episode by episode; each row with its episode's
    goal columns."""
    if fail_cap is not None:
        ach = cols["achieved"].astype(np.int64)
        des = cols["desired"].astype(np.int64)
        salvage = (ach & ~des & dagger._LATCH_MASK) == 0
        keep = live & (success[None, :] | salvage)
        rng = np.random.RandomState(rng_seed)
        for b in np.nonzero(~success)[0]:
            rows = np.nonzero(keep[:, b])[0]
            if len(rows) > fail_cap:
                keep[rng.choice(rows, len(rows) - fail_cap, replace=False), b] = False
        live = keep
    sel = live.reshape(-1)
    host = {k: v.reshape((-1,) + v.shape[2:])[sel] for k, v in cols.items()}
    T = live.shape[0]
    for k, v in goal_cols.items():
        host[k] = np.broadcast_to(v[None], (T,) + v.shape).reshape((-1,) + v.shape[1:])[sel]
    return host


def collect_round(cfg: EnvConfig, kind: str, model, episodes: int, seed: int, eps: float,
                  chunk: int = 2048, fail_cap: int | None = None):
    """Chunked rollouts on the model's device -> (host column dict, success
    rate). Chunk ``i`` (its first episode) resets from ``split(PRNGKey(seed +
    i), B)`` and explores with the draws of ``PRNGKey(seed ^ (7 + i))``:
    step ``t``'s ``k_u, k_a = split(split(key, max_steps)[t])``, a move
    ``randint(k_a, (B,), 0, 4)`` where ``uniform(k_u, (B,)) < eps``
    (``dagger.explore_draws``), as the JAX tool draws them."""
    dev = next(model.parameters()).device
    parts, succ = [], []
    for i in range(0, episodes, chunk):
        B = min(chunk, episodes - i)
        state = reset(cfg, kd.split_keys(prng_key(seed + i, device=dev), B))
        u, a = dagger.explore_draws(prng_key(seed ^ (7 + i), device=dev), cfg.max_steps, B)
        cols, goal_cols, live, success = _rollout_collect(cfg, kind, model, state, u, a, eps)
        host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}
        success = success.cpu().numpy()
        parts.append(keep_rows(host(cols), host(goal_cols), live.cpu().numpy(), success,
                               fail_cap, seed + 13 * i))
        succ.append(success)
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return out, float(np.concatenate(succ).mean())


# ---------------------------------------------------------------------------
# teacher labels, flips, the student's epoch
# ---------------------------------------------------------------------------


@torch.no_grad()
def teacher_label(cfg: EnvConfig, model, cols: dict, chunk: int = 65536):
    """The teacher's argmax labels int8[n] and its logits f16[n, 6]:
    distillation fits the soft targets (hard labels carry no margin, and the
    student grows near-ties whose greedy execution limit-cycles)."""
    dev = next(model.parameters()).device
    n = len(cols["agent_key"])
    labels = np.zeros(n, np.int8)
    tlogits = np.zeros((n, C.N_ACTIONS), np.float16)
    for i in range(0, n, chunk):
        sl = {k: torch.from_numpy(np.ascontiguousarray(cols[k][i:i + chunk])).to(dev)
              for k in dagger._COL_FIELDS}
        logits, _ = model(*dagger._batch_planes(cfg, sl))
        labels[i:i + chunk] = torch.argmax(logits, dim=-1).to(torch.int8).cpu().numpy()
        tlogits[i:i + chunk] = logits.to(torch.float16).cpu().numpy()
    return labels, tlogits


_IMG_COLS = ("occ_key", "occ_code", "agent_key", "holding", "init_key", "init_agent_key",
             "goal_occ_key", "goal_occ_code", "goal_agent_key")
_FLIP_COLS = ("occ_key", "agent_key", "init_key", "init_agent_key", "goal_occ_key",
              "goal_agent_key")
# action index remaps under vertical / horizontal world flips
# (0 up, 1 right, 2 down, 3 left, 4 pickup, 5 drop)
_PERM_H = np.array([2, 1, 0, 3, 4, 5], np.int32)
_PERM_W = np.array([0, 3, 2, 1, 4, 5], np.int32)


def _flip_key(cfg: EnvConfig, key, fh, fw):
    """Flip flat cell keys by row (``fh``) and column (``fw``) per row of the
    batch; keys off the grid (the pad value) pass through."""
    k = key.to(i32)
    valid = (k >= 0) & (k < cfg.n_cells)
    r, c = k // cfg.width, k % cfg.width
    shape = (-1,) + (1,) * (k.dim() - 1)
    r = torch.where(fh.reshape(shape), cfg.height - 1 - r, r)
    c = torch.where(fw.reshape(shape), cfg.width - 1 - c, c)
    return torch.where(valid, r * cfg.width + c, k).to(key.dtype)


_PERMS: dict = {}  # device -> (_PERM_H, _PERM_W) there, made once


def augment_flips(cfg: EnvConfig, mb: dict, fh, fw) -> dict:
    """Vertical (``fh``) and horizontal (``fw``) world flips in column space,
    bool[B] each, with the move actions relabelled: the frames are rendered
    after, so they stay on the render distribution, and the dynamics are
    symmetric under both flips."""
    out = dict(mb)
    for k in _FLIP_COLS:
        out[k] = _flip_key(cfg, mb[k], fh, fw)
    dev = mb["label"].device
    if dev not in _PERMS:
        _PERMS[dev] = (torch.from_numpy(_PERM_H).to(dev), torch.from_numpy(_PERM_W).to(dev))
    ph, pw = _PERMS[dev]
    lab = mb["label"].to(i32)
    lab = torch.where(fh, ph[lab.long()], lab)
    out["label"] = torch.where(fw, pw[lab.long()], lab)
    lg = mb["tlogits"]
    lg = torch.where(fh[:, None], lg[:, ph.long()], lg)
    out["tlogits"] = torch.where(fw[:, None], lg[:, pw.long()], lg)
    return out


def init_opt(model: torch.nn.Module) -> AdamState:
    """A fresh AdamW state over ``model.parameters()``, in their order; its
    tensors are updated in place."""
    zeros = [torch.zeros_like(p) for p in model.parameters()]
    return AdamState(torch.zeros((), dtype=i32, device=zeros[0].device), zeros,
                     [z.clone() for z in zeros])


@torch.no_grad()
def apply_adamw(params: list, grads: list, opt: AdamState, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> None:
    """``optax.chain(clip_by_global_norm(1.0), adamw(3e-4, weight_decay=1e-4))``
    over every parameter (optax's ``adamw`` with no mask), in place on the
    parameters and ``opt``, as multi-tensor ops: the clip divides by ``norm /
    MAX_NORM`` when the global norm is at least ``MAX_NORM``; the moments
    take ``(1 - b) * g + b * m`` (summed in either order, the same f32); the
    step is ``-LR * (mu_hat / (sqrt(nu_hat) + eps) + WEIGHT_DECAY * param)``
    with the moments bias-corrected by the step count."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    grads = torch._foreach_div(grads, torch.where(norm < MAX_NORM, torch.ones_like(norm),
                                                  norm / MAX_NORM))
    torch._foreach_mul_(opt.mu, b1)
    torch._foreach_add_(opt.mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(opt.nu, b2)
    torch._foreach_add_(opt.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
    opt.count.add_(1)
    c1 = 1 - torch.full_like(norm, b1) ** opt.count  # no number from the host: see _train
    c2 = 1 - torch.full_like(norm, b2) ** opt.count
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(opt.nu, c2)), eps)
    direction = torch._foreach_div(torch._foreach_div(opt.mu, c1), den)
    torch._foreach_add_(direction, torch._foreach_mul(params, WEIGHT_DECAY))
    torch._foreach_add_(params, torch._foreach_mul(direction, -LR))


def minibatch(cfg: EnvConfig, data: dict, idx, fh, fw):
    """Rows ``idx`` of ``data`` flipped (``augment_flips``) and rendered:
    (images, label, tlogits, soft)."""
    mb = augment_flips(cfg, {k: v[idx] for k, v in data.items()}, fh, fw)
    return images_from_cols(cfg, mb), mb["label"], mb["tlogits"], mb["soft"]


def student_loss(model, images, label, tlogits, soft):
    """(loss, accuracy) of a minibatch: soft rows (``soft`` 1) fit 0.9 of the
    teacher's softmax + 0.1 of its label, the others their label."""
    logits, _ = model(images)
    logp = torch.log_softmax(logits, dim=-1)
    pt = torch.softmax(tlogits.to(torch.float32), dim=-1)
    soft_ce = -(pt * logp).sum(-1)
    hard_ce = -logp.gather(1, label.long()[:, None])[:, 0]
    flag = soft.to(torch.float32)
    loss = (flag * (0.9 * soft_ce + 0.1 * hard_ce) + (1 - flag) * hard_ce).mean()
    acc = (torch.argmax(logits, -1) == label).to(torch.float32).mean()
    return loss, acc


def _train(model, params: list, opt: AdamState, batch, sums) -> None:
    """The loss of one ``minibatch``, its gradients and clip + AdamW; adds
    (loss, accuracy) to ``sums``. No host sync and no copy from the host, so
    a CUDA graph can hold it (the render cannot: ``render_ray`` writes a
    Python 255)."""
    with torch.enable_grad():
        loss, acc = student_loss(model, *batch)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
    apply_adamw(params, list(grads), opt)
    sums.add_(torch.stack([loss.detach(), acc]))


GRAPH_WARMUP = 3  # eager minibatches on a side stream before the capture


def student_epoch(cfg: EnvConfig, model, opt: AdamState, data: dict, perm, batch_size: int,
                  fh, fw, graph: bool = True):
    """One epoch of minibatches ``perm[i * batch_size:(i + 1) * batch_size]``
    (the remainder dropped), minibatch ``i`` flipped by ``fh[i]``, ``fw[i]``.
    On the card (and ``graph``) the first ``GRAPH_WARMUP`` run eagerly; each
    later one is gathered and rendered by the host into static buffers, and
    its forward, backward and update replay one captured CUDA graph of
    ``_train``: the same kernels on the same tensors, without the host
    launching each. Returns (opt, mean loss, mean accuracy) as 0-dim tensors;
    the student and ``opt`` are updated in place."""
    steps = perm.shape[0] // batch_size
    perm = perm.to(torch.int64)
    params = list(model.parameters())
    sums = torch.zeros(2, dtype=torch.float32, device=perm.device)
    batch = lambda i: minibatch(cfg, data, perm[i * batch_size:(i + 1) * batch_size], fh[i], fw[i])
    if not graph or perm.device.type != "cuda" or steps <= GRAPH_WARMUP:
        for i in range(steps):
            _train(model, params, opt, batch(i), sums)
        return opt, sums[0] / steps, sums[1] / steps
    side = torch.cuda.Stream(perm.device)
    side.wait_stream(torch.cuda.current_stream(perm.device))
    with torch.cuda.stream(side):
        for i in range(GRAPH_WARMUP):
            _train(model, params, opt, batch(i), sums)
    torch.cuda.current_stream(perm.device).wait_stream(side)
    static = [t.clone() for t in batch(GRAPH_WARMUP)]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):  # records the kernels; runs none of them
        _train(model, params, opt, static, sums)
    for i in range(GRAPH_WARMUP, steps):
        for s, t in zip(static, batch(i)):
            s.copy_(t)
        g.replay()
    return opt, sums[0] / steps, sums[1] / steps


def flip_bits(aug_key: torch.Tensor, steps: int, batch_size: int):
    """An epoch's flips (fh, fw) bool[steps, batch_size] from key data
    ``aug_key``, as the JAX tool's ``augment_flips`` draws minibatch ``i``'s:
    ``kh, kw = split(fold_in(aug_key, i))``, then ``bernoulli(kh, 0.5, (B,))``
    and ``bernoulli(kw, 0.5, (B,))``. ``fold_in(key, i)`` is the key at
    counter ``i``, key ``i`` of a split: four counter launches an epoch,
    made before the epoch's CUDA graph, which then draws nothing."""
    k = kd.counter_draws(kd.split_keys(aug_key, steps), "split", 1, 2, 0, 2)[:, 0]
    return kd.bernoulli(k[:, 0], 0.5, (batch_size,)), kd.bernoulli(k[:, 1], 0.5, (batch_size,))


# ---------------------------------------------------------------------------
# student evaluation (canonical stacked exact match)
# ---------------------------------------------------------------------------


@torch.no_grad()
def _eval_student(cfg: EnvConfig, model, state: EnvState, noise=None) -> dict:
    """One episode per env from ``state``, greedy, or with ``noise`` f32[T, B,
    A] (``categorical``'s Gumbel noise) a draw from the student's softmax each step;
    finished episodes are frozen, and the loop stops once every one is done."""
    B = state.objects.shape[0]
    dev = state.objects.device
    frames = fixed_frames(state)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    reward = torch.full((B,), -1, dtype=i32, device=dev)
    for t in range(cfg.max_steps):
        logits = _policy_logits(cfg, "pixel", model, state, frames)
        if noise is not None:
            logits = logits + noise[t]
        st2, res = step(cfg, state, torch.argmax(logits, dim=-1).to(i32))
        state = _select(done, state, st2)
        reward = torch.where(done, reward, res.reward)
        done = done | res.done
        if t % _DONE_EVERY == _DONE_EVERY - 1 and bool(done.all()):
            break
    return {"success": reward == cfg.max_steps, "steps": state.step_num,
            "desired": state.desired, "achieved": state.achieved}


def eval_student(cfg: EnvConfig, model, episodes: int, seed: int, chunk: int = 2048,
                 mode: str = "argmax") -> dict:
    """``train/evaluate.summarize`` of ``episodes`` episodes in chunks; chunk
    ``i`` resets from ``keys = split(PRNGKey(seed + 31 * i), B)``. The
    ``sample`` mode draws as the JAX tool's ``while_loop`` does, from the
    first env's key ``keys[0]`` by the sequential chain ``k, k_t = split(k)``
    once a step and ``categorical(k_t, logits)``: its ``max_steps`` step keys
    are made before the episode (``train/ppo.collect_noise``), the loop
    reading as many as it runs."""
    if mode not in ("argmax", "sample"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = next(model.parameters()).device
    outs = []
    for i in range(0, episodes, chunk):
        B = min(chunk, episodes - i)
        keys = kd.split_keys(prng_key(seed + 31 * i, device=dev), B)
        state = reset(cfg, keys)
        noise = collect_noise(keys[0], cfg.max_steps, B) if mode == "sample" else None
        outs.append({k: v.cpu().numpy() for k, v in _eval_student(cfg, model, state, noise).items()})
    return summarize({k: np.concatenate([o[k] for o in outs]) for k in outs[0]})


# ---------------------------------------------------------------------------


def main(argv=None) -> dict:
    """Run the distillation; returns {"section" (the ``distilled_student``
    section written), "path", "rounds" (per round: rows collected, relabelled
    and the aggregate's sizes)}."""
    argv = list(argv) if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--teacher", default=str(TEACHER),
                    help="the GridPolicy teacher's params_<tag>.pt ('' for a fresh one)")
    ap.add_argument("--teacher-channels", type=int, default=96)
    ap.add_argument("--teacher-hidden", type=int, default=1536)
    ap.add_argument("--channels", type=int, default=96)
    ap.add_argument("--hidden", type=int, default=1536)
    ap.add_argument("--stem", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--fail-cap", type=int, default=40,
                    help="max frames kept per failed student episode")
    ap.add_argument("--episodes", type=int, default=8192)
    ap.add_argument("--episodes0", type=int, default=24576)
    ap.add_argument("--epochs0", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--eval-episodes", type=int, default=2048)
    ap.add_argument("--final-eval-episodes", type=int, default=8192)
    ap.add_argument("--max-rows", type=int, default=5_000_000)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--smoke", action="store_true", help="tiny 8x8 run on the CPU")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--save", default=str(SAVE))
    ap.add_argument("--init-student", default="", help="resume the student from a .pt")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.smoke:  # JAX's tiny settings; options given after them override them
        args = ap.parse_args(SMOKE + argv)
        cfg = EnvConfig(height=8, width=8, max_steps=40)
    else:
        cfg = ray_config()
    dev = torch.device(args.device)
    card = card_identity(dev)
    teacher = init_grid_policy(prng_key(0, device=dev), cfg,
                               args.teacher_channels, args.teacher_hidden)
    if args.teacher:
        load_params(teacher, args.teacher)
        log(f"teacher loaded from {args.teacher}")
    student = init_student(prng_key(args.seed, device=dev), cfg,
                           channels=args.channels, hidden=args.hidden, stem=args.stem)
    if args.init_student:
        load_params(student, args.init_student)
        log(f"student resumed from {args.init_student}")
    opt = init_opt(student)

    core = None  # round-0 teacher-path rows: the known-good distribution
    student_data = None  # filtered on-policy student rows
    history, rounds = [], []
    for r in range(args.rounds):
        t0 = time.time()
        info = {"round": r}
        if r == 0:
            core, sr = collect_round(cfg, "grid", teacher, args.episodes0, args.seed + 100,
                                     eps=0.02)
            log(f"round 0: teacher rollouts sr {sr:.3f}, {len(core['agent_key'])} rows "
                f"({time.time() - t0:.0f}s)")
            core["label"], core["tlogits"] = teacher_label(cfg, teacher, core)
            core["soft"] = np.ones(len(core["label"]), np.float16)
            info["collected"] = len(core["label"])
        else:
            cols, sr = collect_round(cfg, "pixel", student, args.episodes, args.seed + 100 * r,
                                     eps=0.02, fail_cap=args.fail_cap)
            log(f"round {r}: student rollouts sr {sr:.3f}, {len(cols['agent_key'])} filtered "
                f"rows ({time.time() - t0:.0f}s)")
            t0l = time.time()
            labeled = relabel(cfg, {k: cols[k] for k in dagger._COL_FIELDS})
            cols["label"] = labeled.action
            cols["tlogits"] = np.zeros((len(cols["label"]), C.N_ACTIONS), np.float16)
            cols["soft"] = np.zeros(len(cols["label"]), np.float16)
            info.update(collected=len(cols["agent_key"]), relabelled=labeled.num_rows,
                        relabel_s=time.time() - t0l)
            log(f"  expert labels: {len(cols['label'])} rows ({time.time() - t0l:.0f}s)")
            info["student_rows_before"] = 0 if student_data is None else len(student_data["label"])
            student_data = cols if student_data is None else {
                k: np.concatenate([student_data[k], cols[k]]) for k in cols}
            info["appended"] = len(student_data["label"]) - info["student_rows_before"]
            if len(student_data["label"]) > args.max_rows:
                keep = np.random.RandomState(args.seed + r).choice(
                    len(student_data["label"]), args.max_rows, replace=False)
                student_data = {k: v[keep] for k, v in student_data.items()}
            info["student_rows"] = len(student_data["label"])
        info["collect_s"] = time.time() - t0
        n0 = len(core["label"])
        if student_data is None:
            data, idx_all = core, np.arange(n0)
        else:
            data = {k: np.concatenate([core[k], student_data[k]]) for k in core}
            n1 = len(student_data["label"])
            # 50/50 mixture batches: upsample the teacher-path core so that
            # on-policy rows never exceed half the mass
            reps = max(1, int(round(n1 / n0)))
            idx_all = np.concatenate([np.tile(np.arange(n0), reps), n0 + np.arange(n1)])
        on_dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in data.items()
                  if k in _IMG_COLS + ("label", "tlogits", "soft")}
        n = len(idx_all)
        t1 = time.time()
        for ep in range(args.epochs0 if r == 0 else args.epochs):
            order = np.random.RandomState(args.seed + 17 * r + ep).permutation(n)
            perm = torch.from_numpy(idx_all[order].astype(np.int32)).to(dev)
            fh, fw = flip_bits(prng_key(args.seed + 1000 * r + ep, device=dev), n // args.batch,
                               args.batch)
            opt, loss, acc = student_epoch(cfg, student, opt, on_dev, perm, args.batch, fh, fw)
            core_share = 1 - (0 if student_data is None else n1 / n)
            log(f"  train ep {ep}: loss {float(loss):.4f} acc {float(acc):.4f} ({n} mixture "
                f"rows, core share {core_share:.2f})")
        info.update(mixture_rows=n, core_rows=n0, train_s=time.time() - t1)
        res = eval_student(cfg, student, args.eval_episodes, args.seed + 900 + r)
        res_s = eval_student(cfg, student, args.eval_episodes, args.seed + 900 + r,
                             mode="sample")
        log(f"round {r} eval: {res['success_rate']:.4f} argmax / "
            f"{res_s['success_rate']:.4f} sampled over {res['episodes']} eps on {card}")
        history.append({"round": r, "rollout_sr": sr, **res,
                        "success_rate_sampled": res_s["success_rate"]})
        rounds.append(info)

    res = eval_student(cfg, student, args.final_eval_episodes, 31337)
    res_sample = eval_student(cfg, student, args.final_eval_episodes, 31337, mode="sample")
    log(f"final student eval: {res['success_rate']:.4f} argmax / "
        f"{res_sample['success_rate']:.4f} sampled over {res['episodes']} eps")
    Path(args.save).mkdir(parents=True, exist_ok=True)
    torch.save(student.state_dict(), Path(args.save) / "student.pt")

    out = Path(args.out)
    try:
        doc = json.loads(out.read_text())
    except (OSError, json.JSONDecodeError):
        doc = {}
    section = {
        "final_eval": res,
        "final_eval_sampled": res_sample,
        "history": history,
        "observation": (
            "images ONLY: current frame + imagined desired-goal frame + init frame (the "
            "reference's pixel observation content, craftingworld_ray.py:84-92); no goal bits, "
            "no achieved vector, no step counter"),
        "model": f"PixelDistillStudent(stem={args.stem}, channels={args.channels}, "
                 f"hidden={args.hidden})",
        "teacher": f"GridPolicy({args.teacher_channels}, {args.teacher_hidden}) from "
                   f"{shown(args.teacher) if args.teacher else 'a fresh init (smoke)'}",
        "protocol": (
            f"DAgger distillation: round 0 teacher rollouts labelled by the teacher (soft "
            f"targets), later rounds student rollouts labelled by the scripted expert; "
            f"{args.rounds} rounds x {args.episodes} episodes ({args.episodes0} in round 0)"),
        "card": card,
    }
    doc["distilled_student"] = section
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    log(f"-> {out}")
    return {"section": section, "path": str(out), "rounds": rounds}


if __name__ == "__main__":
    main()
