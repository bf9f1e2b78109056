"""The CraftingWorld env as the benchmark's reference computes it.

Plain numpy and torch, sharing no code with the measured package:

* ``step``: one step of a batch of worlds in the packed layout the program's
  kernels carry (the layout is the entry's input and output, so the
  reference reads and writes it too), written from the env's rules
  (``gym_craftingworld/envs/craftingworld_ray.py``: moves blocked by rock and
  tree without hammer or axe, pickup and drop of sticks, axe and hammer,
  the crafting effects, the nine task bits, reward ``max_steps`` on an
  exact match of the achieved and desired masks and -1 otherwise, the step
  counter saturating at ``max_steps``);
* ``pool``: the program's world-pool stream (Philox4x32-10 keys, 9 ordered
  cells by iterated argmax, the task mask from 16 more keys), a frozen copy;
* ``keyed_batch``: ``fresh_packed_batch`` of the JAX package from Threefry
  key data (uniform placement scores, per-env ``randint`` and
  ``permutation`` of the tasks);
* ``bench_actions``: the bench kernel's Philox action stream;
* ``features`` and ``render``: the policies' inputs.

A batch of worlds is a dict of int32 numpy arrays by field name, slot fields
``[8, B]`` and the rest ``[B]``; ``FIELDS`` is the program's field order.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import keys as K

FIELDS = ("slot_key", "slot_type", "init_key", "init_type", "agent_r", "agent_c", "holding",
          "obj_here", "icode_here", "achieved", "desired", "init_agent_key", "step_num")
N_OBJ, N_TASKS, N_ACTIONS = 8, 9, 6
STICKS, AXE, HAMMER, ROCK, TREE, BREAD, HOUSE, WHEAT = range(1, 9)
AGENT_MARK = 9
MASK32 = 0xFFFFFFFF
POOL_KEY, ACTION_KEY = 0x4357504C, 0x43574F52
PHILOX_M, PHILOX_W = (0xD2511F53, 0xCD9E8D57), (0x9E3779B9, 0xBB67AE85)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def step(env: dict, action: np.ndarray, height: int, width: int, max_steps: int,
         dtype=np.int16):
    """One step of every world; (new env, reward int32[B], done bool[B]).

    The new state is held in ``dtype`` (the program's int16; a narrower type
    wraps its keys, which is the control's lower precision)."""
    s = {k: v.astype(np.int32) for k, v in env.items()}
    out, reward, done = step32(s, action.astype(np.int32), height, width, max_steps)
    return {k: out[k].astype(dtype) for k in FIELDS}, reward, done


def step32(s: dict, a: np.ndarray, height: int, width: int, max_steps: int):
    """``step`` on int32 fields, with no conversions: every value fits int16,
    so a run of these steps equals a run of ``step`` in int16."""
    held_key = height * width
    is_move = a < 4
    nr = np.clip(s["agent_r"] + (a == 2) - (a == 0), 0, height - 1)
    nc = np.clip(s["agent_c"] + (a == 1) - (a == 3), 0, width - 1)
    cur = s["agent_r"] * width + s["agent_c"]
    new = nr * width + nc
    key, typ = s["slot_key"], s["slot_type"]
    there = key == new
    obj_there = (there * typ).sum(0)
    icode_there = ((s["init_key"] == new) * s["init_type"]).sum(0)
    here, hold = s["obj_here"], s["holding"]
    blocked = ((obj_there == ROCK) & (hold != HAMMER)) | ((obj_there == TREE) & (hold != AXE))
    move_ok = is_move & (new != cur) & ~blocked
    pick = (a == 4) & (here >= STICKS) & (here <= HAMMER) & (hold == 0)
    drop = (a == 5) & (hold != 0) & (here == 0)
    eff = np.where(obj_there == TREE, STICKS, obj_there)
    eff = np.where((obj_there == STICKS) & (hold == HAMMER), HOUSE, eff)
    eff = np.where((obj_there == WHEAT) & (hold == AXE), BREAD, eff)
    removed = (obj_there == ROCK) | (obj_there == BREAD)
    hit = there & move_ok
    typ = np.where(hit, eff, typ)
    key2 = np.where(hit & removed, held_key + 1, key)
    key2 = np.where(pick & (key == cur), held_key, key2)
    key2 = np.where(drop & (key == held_key), cur, key2)
    bit = lambda m, t: m.astype(np.int32) << t
    latched = s["achieved"] | bit(move_ok & (obj_there == WHEAT) & (hold == AXE), 0) \
        | bit(move_ok & (obj_there == BREAD), 1) \
        | bit(move_ok & (obj_there == STICKS) & (hold == HAMMER), 2) \
        | bit(move_ok & (obj_there == TREE), 3) | bit(move_ok & (obj_there == ROCK), 4)
    cell = np.where(move_ok, np.where(removed, 0, eff), here)
    icode = np.where(move_ok, icode_there, s["icode_here"])
    fkey = np.where(move_ok, new, cur)
    marked = np.where((icode == 0) & (fkey == s["init_agent_key"]), AGENT_MARK, icode)
    empty = marked == 0
    chopped = ((latched >> 3) & 1) == 1
    ms = empty | ~((marked == STICKS) | ((marked == TREE) & chopped))
    ma, mh = empty | (marked != AXE), empty | (marked != HAMMER)
    hs, ha, hh = hold == 1, hold == 2, hold == 3
    clear = (1 << 5) | bit(ha, 6) | bit(hh, 7) | bit(hs, 8)
    setb = bit(cell == HOUSE, 5) | bit(ha & ma, 6) | bit(hh & mh, 7) | bit(hs & ms, 8)
    achieved = np.where(is_move, (latched & ~clear) | setb, s["achieved"])
    changed = move_ok | pick | drop
    success = achieved == s["desired"]
    reward = np.where(changed & success, max_steps, -1).astype(np.int32)
    step_num = np.minimum(s["step_num"] + 1, max_steps)
    out = dict(s, slot_key=key2, slot_type=typ,
               agent_r=np.where(move_ok, nr, s["agent_r"]),
               agent_c=np.where(move_ok, nc, s["agent_c"]),
               holding=np.where(pick, here, np.where(drop, 0, hold)),
               obj_here=np.where(move_ok, cell, np.where(pick, 0, np.where(drop, hold, here))),
               icode_here=np.where(move_ok, icode_there, s["icode_here"]),
               achieved=achieved, step_num=step_num)
    done = (step_num >= max_steps) | (reward == max_steps)
    return out, reward, done


def take(env: dict, cols) -> dict:
    return {k: v[..., cols] for k, v in env.items()}


def where(mask: np.ndarray, a: dict, b: dict) -> dict:
    return {k: np.where(mask, a[k], b[k]) for k in FIELDS}


def mismatched(prog: dict, ref: dict) -> np.ndarray:
    """bool[B]: the worlds whose fields differ anywhere."""
    bad = np.zeros(ref["agent_r"].shape, dtype=bool)
    for k in FIELDS:
        d = prog[k].astype(np.int64) != ref[k].astype(np.int64)
        bad |= d.any(axis=0) if d.ndim == 2 else d
    return bad


# ---------------------------------------------------------------------------
# Philox4x32-10 (torch int64 words and numpy uint64 words)
# ---------------------------------------------------------------------------


def philox(c, key):
    """Philox4x32-10 of counters ``c`` (four int64 tensors or uint64 arrays
    holding 32-bit words) under ``key`` (two ints): four words."""
    c0, c1, c2, c3 = c
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mul(PHILOX_M[0], c0)
        hi1, lo1 = _mul(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _mul(m: int, x):
    """(high, low) 32-bit words of the product of the constant ``m`` and the
    32-bit words ``x``, from two 16 x 32-bit partial products (< 2**48, so
    int64 holds them)."""
    lo = x * (m & 0xFFFF)
    hi = x * (m >> 16)
    t = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (t >> 32), t & MASK32


def bench_actions(seed: int, envs: np.ndarray, steps: int) -> np.ndarray:
    """The bench kernel's actions of ``envs`` (their batch indices) for
    ``steps`` steps: int32[T, n], word ``t % 4`` of Philox at counter
    ``(t // 4, env, 0, 0)`` under ``(seed, ACTION_KEY)``, modulo 6."""
    n4 = (steps + 3) // 4
    t4 = np.arange(n4, dtype=np.uint64)[:, None] + np.zeros((1, len(envs)), np.uint64)
    e = np.broadcast_to(envs.astype(np.uint64)[None, :], t4.shape)
    z = np.zeros_like(t4)
    w = philox((t4, e, z, z), (np.uint64(seed & MASK32), np.uint64(ACTION_KEY)))
    return (np.stack(w, axis=1).reshape(4 * n4, len(envs))[:steps] % N_ACTIONS).astype(np.int32)


# ---------------------------------------------------------------------------
# fresh worlds
# ---------------------------------------------------------------------------


def _picks(scores: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` rounds of (max over rows, the first row attaining it, excluded)."""
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
    out = []
    for _ in range(n):
        m = scores.max(dim=0).values
        a = torch.where(scores == m[None], rows, scores.shape[0]).min(dim=0).values
        out.append(a)
        scores = torch.where(rows == a[None], -1, scores)
    return torch.stack(out)


def _assemble(cells: torch.Tensor, desired: torch.Tensor, width: int) -> dict:
    """A batch of fresh worlds from its 9 ordered cells [9, n] and task masks [n]."""
    cells = cells.to(torch.int64).cpu().numpy().astype(np.int32)
    n = cells.shape[1]
    types = np.repeat(np.arange(1, N_OBJ + 1, dtype=np.int32)[:, None], n, axis=1)
    zero = np.zeros(n, np.int32)
    agent = cells[N_OBJ]
    return {k: v.astype(np.int16) for k, v in dict(
        slot_key=cells[:N_OBJ], slot_type=types, init_key=cells[:N_OBJ], init_type=types,
        agent_r=agent // width, agent_c=agent % width, holding=zero, obj_here=zero,
        icode_here=zero + AGENT_MARK, achieved=zero,
        desired=desired.to(torch.int64).cpu().numpy().astype(np.int32),
        init_agent_key=agent, step_num=zero).items()}


def pool(seed: int, seed2: int, n: int, height: int, width: int, n_tasks: int,
         device) -> dict:
    """The pool kernel's ``n`` worlds from its two seed words (all nine tasks
    selectable, stacked up to ``n_tasks``)."""
    hw = height * width
    groups = -(-hw // 4)
    g = torch.arange(groups + 4, dtype=torch.int64, device=device)[:, None]
    w = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    g, w = torch.broadcast_tensors(g, w)
    z = torch.zeros_like(g)
    words = philox((g, w, z + (seed2 & MASK32), z), (seed, POOL_KEY))
    keys = (torch.stack(words, dim=1).reshape(-1, n) >> 1)
    cells = _picks(keys[:hw], N_OBJ + 1)
    tkeys = keys[4 * groups:]
    tscores = torch.where(torch.arange(16, device=device)[:, None] < N_TASKS, tkeys, -1)
    k = tkeys[N_TASKS] % n_tasks + 1
    tp = _picks(tscores, N_TASKS)
    chosen = torch.arange(N_TASKS, device=device)[:, None] < k[None]
    desired = torch.where(chosen, 1 << tp, 0).sum(0)
    return _assemble(cells, desired, width)


def keyed_batch(key: torch.Tensor, n: int, height: int, width: int, n_tasks: int) -> dict:
    """``fresh_packed_batch(key, n)``: ``k_place, k_task = split(key)``;
    uniform scores [n, H*W] from ``k_place`` with the 9 best cells in order
    (ties to the lower cell); env ``i``'s tasks from key ``i`` of
    ``split(k_task, n)``: ``k_num, k_perm = split``, ``randint(k_num, (), 0,
    n_tasks) + 1`` tasks, the first of ``permutation(k_perm, 9)``."""
    k_place, k_task = K.split(key, 2)
    scores = K.uniform(k_place, (n, height * width))
    cells = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :N_OBJ + 1].T
    per_env = K.split(K.split(k_task, n), 2)  # [n, 2, 2]
    k = K.randint(per_env[:, 0], (), 0, n_tasks) + 1
    perm = K.permutation(per_env[:, 1], N_TASKS)  # [n, 9]
    chosen = torch.arange(N_TASKS, device=key.device)[None] < k[:, None]
    desired = torch.where(chosen, 1 << perm, 0).sum(1)
    return _assemble(cells, desired, width)


# ---------------------------------------------------------------------------
# the policies' inputs
# ---------------------------------------------------------------------------


def to_torch(env: dict, device) -> dict:
    return {k: torch.from_numpy(v.astype(np.int32)).to(device) for k, v in env.items()}


def features(env: dict, height: int, width: int, max_steps: int) -> torch.Tensor:
    """The MLP policy's bf16[67, B] features of worlds ``env`` (torch int32):
    per slot its type / 8, row / H and column / W while on the grid (else 0),
    on-grid and held flags; the agent's row / H and column / W; the held
    item's one-hot (none, sticks, axe, hammer); the desired and achieved
    task bits; the object / 8 and reset code / 10 under the agent; the step
    / max_steps. Each product of bf16 values, rounded to bf16."""
    bf = torch.bfloat16
    dev = env["agent_r"].device
    c = lambda x: torch.tensor(x, dtype=bf, device=dev)
    key = env["slot_key"]
    hw = height * width
    on = key < hw
    r, col = torch.where(on, key // width, 0), torch.where(on, key % width, 0)
    bits = torch.arange(N_TASKS, device=dev)[:, None]
    return torch.cat([
        env["slot_type"].to(bf) * c(1 / 8), r.to(bf) * c(1 / height), col.to(bf) * c(1 / width),
        on.to(bf), (key == hw).to(bf),
        env["agent_r"].to(bf)[None] * c(1 / height), env["agent_c"].to(bf)[None] * c(1 / width),
        (env["holding"][None] == torch.arange(4, device=dev)[:, None]).to(bf),
        ((env["desired"][None] >> bits) & 1).to(bf), ((env["achieved"][None] >> bits) & 1).to(bf),
        env["obj_here"].to(bf)[None] * c(1 / 8), env["icode_here"].to(bf)[None] * c(1 / 10),
        env["step_num"].to(bf)[None] * c(1 / max_steps)])


def render(env: dict, height: int, width: int):
    """The conv policy's inputs: the one-hot grid bf16[B, H, W, 12] (8
    object channels, the agent, the held item in the agent's cell) and the
    22 bits bf16[B, 22] (desired, achieved, held one-hot)."""
    bf = torch.bfloat16
    dev = env["agent_r"].device
    B, hw = env["agent_r"].shape[0], height * width
    cells = torch.arange(hw, device=dev)
    code = torch.zeros((B, hw), dtype=torch.int32, device=dev)
    for i in range(N_OBJ):
        code += env["slot_type"][i][:, None] * (env["slot_key"][i][:, None] == cells)
    obj = code[:, :, None] == torch.arange(1, N_OBJ + 1, device=dev)
    agent = (env["agent_r"] * width + env["agent_c"])[:, None] == cells
    held = agent[:, :, None] & ((env["holding"] - 1)[:, None, None] == torch.arange(3, device=dev))
    grid = torch.cat([obj, agent[:, :, None], held], dim=-1).to(bf).reshape(B, height, width, 12)
    t = torch.arange(N_TASKS, device=dev)
    b = torch.cat([(env["desired"][:, None] >> t) & 1, (env["achieved"][:, None] >> t) & 1,
                   env["holding"][:, None] == torch.arange(4, device=dev)], dim=1)
    return grid, b.to(bf)
