"""The world pool: fresh PackedState batches from one kernel launch.

Counterpart of ``gym_craftingworld_tpu/ops/fused_reset.py``, whose Pallas
kernel (``_kernel``, :71) becomes ``cw_pool_kernel`` in
``csrc/fused_reset.cu``. Each world draws ``H*W + 16`` 31-bit keys and
takes

* its ordered 9-of-H*W cells by 9 rounds of (max, first index, mask) over
  the ``H*W`` placement keys: iterated argmax of iid keys is a uniform
  ordered 9-subset, the reference's shuffle-take-9
  (craftingworld_ray.py:599-628);
* its task mask from 16 more keys (craftingworld_ray.py:169-176): key row 9
  gives ``k = key % number_of_tasks + 1`` when stacking (1 otherwise), and
  the first ``k`` argmax picks over the selected tasks' keys are desired.

Ties go to the lower index (a tie costs ~441**2 / 2**31 ~ 9e-5 per world).

Hopper has no TPU PRNG, so the keys come from Philox4x32-10
(``ops/philox.py``): key word ``j`` of world ``w`` is word ``j % 4`` of the
generator at counter ``(j // 4, w, seed2, 0)`` under key ``(seed,
POOL_KEY)``, shifted right by one. Placement keys are words ``0 .. H*W - 1``;
task key ``t`` is word ``4 * ceil(H*W / 4) + t``. Every key depends on
``(seed, seed2, world, j)`` only, so the plain version reproduces the
kernel's pool bit for bit. Two seed words, as in the JAX kernel: a pool is
drawn every update, and with one 31-bit word two updates would share a seed
after ~2**15.5 updates (birthday bound); the pair makes that ~2**31.

The plain version comes in two parts, so that tests can feed keys directly:
``pool_keys_plain`` draws the keys and ``fresh_packed_from_keys`` is the
iterated argmax, a pure function of them. ``fresh_packed_fused`` launches the
kernel for a CUDA device and runs the plain version on the CPU; the seed
words may be device tensors, so drawing a pool never waits on the host.
"""

from __future__ import annotations

import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.ops import _build
from gym_craftingworld_tpu_torch.ops.packed_rollout import PackedState
from gym_craftingworld_tpu_torch.ops.philox import MASK32, philox4x32

# second Philox key word of the pool stream ("CWPL"); csrc/fused_reset.cu
POOL_KEY = 0x4357504C
N_TASK_KEYS = 16  # task keys per world; row C.N_TASKS draws k
_N_PICKS = C.N_OBJECTS + 1  # 8 objects + the agent
_NO_ROW = 2**30
MAX_CELLS = 1024  # the kernel holds up to 32 keys a lane in registers


def _placement_groups(n_cells: int) -> int:
    """Philox groups (4 words each) of one world's placement keys."""
    return -(-n_cells // 4)


def pool_keys_plain(seed, seed2, n: int, n_cells: int):
    """The kernel's keys: (int32[H*W, n] placement keys, int32[16, n] task keys).

    ``seed``, ``seed2``: Python ints or 0-dim integer tensors (their low 32
    bits are used); tensors fix the device.
    """
    device = seed.device if torch.is_tensor(seed) else torch.device("cpu")
    u32 = lambda s: (s.to(torch.int64) if torch.is_tensor(s) else torch.tensor(s)).to(device) & MASK32
    pg = _placement_groups(n_cells)
    groups = torch.arange(pg + N_TASK_KEYS // 4, dtype=torch.int64, device=device)
    worlds = torch.arange(n, dtype=torch.int64, device=device)
    c0, c1 = torch.broadcast_tensors(groups[:, None], worlds[None, :])
    c2 = torch.zeros_like(c0) + u32(seed2)
    words = philox4x32((c0, c1, c2, torch.zeros_like(c0)), (u32(seed), POOL_KEY))
    keys = (torch.stack(words, dim=1).reshape(-1, n) >> 1).to(torch.int32)
    return keys[:n_cells], keys[4 * pg:]


def _take_picks(scores: torch.Tensor, picks: int):
    """``picks`` rounds of (max over rows, first row attaining it, mask it).

    ``scores`` int32[R, n] (valid keys >= 0, -1 excluded). Returns int32[picks, n].
    """
    rows = torch.arange(scores.shape[0], dtype=torch.int32, device=scores.device)[:, None]
    out = []
    for _ in range(picks):
        m = scores.max(dim=0).values
        a = torch.where(scores == m[None, :], rows, _NO_ROW).min(dim=0).values
        out.append(a)
        scores = torch.where(rows == a[None, :], -1, scores)
    return torch.stack(out)


def assemble(cfg: EnvConfig, picks: torch.Tensor) -> PackedState:
    """PackedState from int[10, n]: 8 slot cells, the agent's cell, the task mask."""
    i16 = torch.int16
    n = picks.shape[1]
    picks = picks.to(i16)
    slot_key = picks[: C.N_OBJECTS].contiguous()
    agent_key = picks[C.N_OBJECTS].contiguous()
    types = torch.arange(1, C.N_OBJECTS + 1, dtype=i16, device=picks.device)
    types = types[:, None].expand(C.N_OBJECTS, n).contiguous()
    zeros = torch.zeros((n,), dtype=i16, device=picks.device)
    return PackedState(
        slot_key=slot_key,
        slot_type=types,
        init_key=slot_key,
        init_type=types,
        agent_r=agent_key // cfg.width,
        agent_c=agent_key % cfg.width,
        holding=zeros,
        obj_here=zeros,
        icode_here=torch.full_like(zeros, C.AGENT_INIT_MARK),
        achieved=zeros,
        desired=picks[C.N_OBJECTS + 1].contiguous(),
        init_agent_key=agent_key,
        step_num=zeros,
    )


def picks_from_keys(cfg: EnvConfig, keys: torch.Tensor, tkeys: torch.Tensor):
    """int32[10, n]: the 9 ordered cells and the desired-task mask."""
    cells = _take_picks(keys, _N_PICKS)
    trows = torch.arange(N_TASK_KEYS, device=tkeys.device)[:, None]
    sel = torch.tensor(cfg.selected_task_indices, device=tkeys.device)
    valid = (trows == sel[None, :]).any(dim=1, keepdim=True)
    tscores = torch.where(valid, tkeys, -1)
    if cfg.stacking:
        kdraw = tkeys[C.N_TASKS] % cfg.number_of_tasks + 1
    else:
        kdraw = torch.ones_like(tkeys[0])
    task_picks = _take_picks(tscores, len(cfg.selected_task_indices))
    order = torch.arange(len(task_picks), device=tkeys.device)[:, None]
    desired = torch.where(order < kdraw[None, :], 1 << task_picks, 0).sum(
        dim=0, dtype=torch.int32)  # the picks are distinct: sum == or
    return torch.cat([cells, desired[None]]).to(torch.int32)


def fresh_packed_from_keys(cfg: EnvConfig, keys: torch.Tensor,
                           tkeys: torch.Tensor) -> PackedState:
    """The pool as a pure function of its keys (int32[H*W, n], int32[16, n])."""
    return assemble(cfg, picks_from_keys(cfg, keys, tkeys))


def fresh_packed_plain(cfg: EnvConfig, seeds: torch.Tensor, n: int) -> PackedState:
    """Plain version of the pool kernel; ``seeds`` int32[2] = (seed, seed2)."""
    fresh_packed_plain.calls += 1
    keys, tkeys = pool_keys_plain(seeds[0], seeds[1], n, cfg.n_cells)
    return fresh_packed_from_keys(cfg, keys, tkeys)


def pool_picks(cfg: EnvConfig, seeds: torch.Tensor, n: int) -> torch.Tensor:
    """The pool kernel: int32[10, n] picks for the seed words int32[2] on the card."""
    if seeds.device.type != "cuda":
        raise ValueError(f"pool_picks launches on a CUDA device, not {seeds.device}")
    if seeds.dtype != torch.int32 or tuple(seeds.shape) != (2,) or not seeds.is_contiguous():
        raise ValueError(f"seeds: want contiguous int32[2], got {seeds.dtype}{list(seeds.shape)}")
    if cfg.n_cells > MAX_CELLS:
        raise ValueError(f"the pool kernel takes grids of up to {MAX_CELLS} cells")
    sel_mask = sum(1 << t for t in cfg.selected_task_indices)
    lib = _build.load()
    picks = torch.empty((_N_PICKS + 1, n), dtype=torch.int32, device=seeds.device)
    code = lib.cw_pool(seeds.data_ptr(), picks.data_ptr(), n, cfg.n_cells,
                       sel_mask, len(cfg.selected_task_indices),
                       cfg.number_of_tasks, int(cfg.stacking),
                       torch.cuda.current_stream(seeds.device).cuda_stream)
    _build.check("cw_pool", code)
    pool_picks.launches += 1
    return picks


fresh_packed_plain.calls = 0
pool_picks.launches = 0


def fresh_packed_fused(cfg: EnvConfig, seed, n: int, *, seed2=0,
                       device=None) -> PackedState:
    """``n`` fresh worlds as a PackedState, from two seed words.

    ``seed``/``seed2`` are ints or 0-dim integer tensors; ``device``
    defaults to the seed tensor's device, else the card. A CUDA device
    launches the pool kernel; the CPU runs ``fresh_packed_plain``. Any ``n``
    is taken (the kernel masks the ragged edge).
    """
    if device is None:
        device = seed.device if torch.is_tensor(seed) else "cuda"
    device = torch.device(device)
    as32 = lambda s: torch.as_tensor(s, device=device).to(torch.int64) & MASK32
    seeds = torch.stack([as32(seed), as32(seed2)]).to(torch.int32)  # same bits
    if device.type == "cuda":
        return assemble(cfg, pool_picks(cfg, seeds, n))
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return fresh_packed_plain(cfg, seeds, n)
