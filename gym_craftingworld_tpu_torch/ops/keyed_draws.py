"""The env layer's keyed draws: a kernel on the card, ``ops/threefry.py`` on the CPU.

The JAX package draws every reset from a per-env Threefry key with
``jax.random`` (``core/reset.py``, ``core/imagine.py``). The port makes the
same draws, bit for bit, from the same key data (int64 ``[..., 2]``, see
``ops/threefry.py``), through two functions:

* ``reset_draws(cfg, keys, mode)``: from per-env keys ``[B, 2]``, what one
  ``_reset_one`` (``mode="fresh"``) or ``_reset_one_from_pool``
  (``"pool"``) draws: ``k`` and ``perm`` (``sample_desired``), the world's
  uniform scores ``[B, H*W]`` or the pool pick, the 7 goal score rows
  ``[B, 7, H*W]`` (``split(k_goal, 6)`` and ``fold_in(gk[5], 1)``) and
  ``k_next``; ``"world"`` gives ``sample_world``'s scores of each key
  alone (``generate_pool``).
* ``counter_draws``: one key's draws over a ``rows x width`` box of counters
  (row ``r``, column ``c`` at linear index ``r * row_stride + col0 + c``):
  keys of a split, or ``randint``. ``split_keys`` and ``randint_cols`` take
  a slice of a split's keys or a ``(T, B)`` randint's columns, so a rank of
  a mesh draws its own envs and nothing else.

A CUDA tensor launches the kernel of ``csrc/keyed_draws.cu``
(``cw_keyed_reset``, ``cw_keyed_counter``) or raises; a CPU tensor runs the
plain version. The kernel wrappers count ``launches``, the plain versions
``calls``; both count the envs (``envs``) or counters (``elements``) they
drew, which shows what a rank drew.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.ops import _build
from gym_craftingworld_tpu_torch.ops import threefry as tf

N_GOAL_ROWS = 7
MAX_SELECTED = 16  # the kernel sorts a permutation of up to 16 tasks in registers
MODES = {"fresh": 0, "pool": 1, "world": 2}
COUNTER_MODES = {"split": 0, "randint": 1}


class ResetDraws(NamedTuple):
    """One reset's draws; None where the mode draws none."""

    k: torch.Tensor | None  # int32[B], tasks desired
    perm: torch.Tensor | None  # int32[B, n_sel]
    world: torch.Tensor | None  # float32[B, H*W] placement scores
    pick: torch.Tensor | None  # int32[B] pool index
    goal: torch.Tensor | None  # float32[B, 7, H*W] goal score rows
    k_next: torch.Tensor | None  # int64[B, 2], the env's next key


def _span(minval: int, maxval: int) -> int:
    return 1 if maxval <= minval else maxval - minval


def reset_draws_plain(cfg: EnvConfig, keys: torch.Tensor, mode: str = "fresh",
                      pool_size: int = 0) -> ResetDraws:
    """Plain version of ``cw_keyed_reset`` (``jax.random`` through ``ops/threefry``)."""
    reset_draws_plain.calls += 1
    reset_draws_plain.envs += keys.shape[0]
    n = cfg.n_cells
    if mode == "world":
        return ResetDraws(None, None, tf.uniform(keys, (n,)), None, None, None)
    k_task, k_world, k_goal, k_next = tf.split(keys, 4).unbind(-2)
    k_num, k_perm = tf.split(k_task).unbind(-2)
    if cfg.stacking:
        k = tf.randint(k_num, (), 0, cfg.number_of_tasks) + 1
    else:
        k = torch.ones(keys.shape[:1], dtype=torch.int32, device=keys.device)
    perm = tf.permutation(k_perm, len(cfg.selected_task_indices))
    gk = tf.split(k_goal, 6)
    goal = tf.uniform(torch.cat([gk, tf.fold_in(gk[:, 5], 1)[:, None]], dim=1), (n,))
    world = tf.uniform(k_world, (n,)) if mode == "fresh" else None
    pick = tf.randint(k_world, (), 0, pool_size) if mode == "pool" else None
    return ResetDraws(k, perm, world, pick, goal, k_next)


def _check_keys(keys: torch.Tensor, what: str) -> None:
    if keys.device.type != "cuda":
        raise ValueError(f"{what} launches on a CUDA device, not {keys.device}")
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2 \
            or not keys.is_contiguous():
        raise ValueError(f"keys: want contiguous int64[B, 2], got {keys.dtype}{list(keys.shape)}")


def reset_draws_kernel(cfg: EnvConfig, keys: torch.Tensor, mode: str = "fresh",
                       pool_size: int = 0) -> ResetDraws:
    """The reset-draws kernel on the card: ``reset_draws_plain``'s result."""
    _check_keys(keys, "reset_draws_kernel")
    n_sel = len(cfg.selected_task_indices)
    if n_sel > MAX_SELECTED:
        raise ValueError(f"the kernel permutes up to {MAX_SELECTED} selected tasks, not {n_sel}")
    B, n, dev = keys.shape[0], cfg.n_cells, keys.device
    m = MODES[mode]
    out = ResetDraws(
        *(torch.empty(s, dtype=d, device=dev) if want else None for s, d, want in (
            ((B,), torch.int32, m != 2), ((B, n_sel), torch.int32, m != 2),
            ((B, n), torch.float32, m != 1), ((B,), torch.int32, m == 1),
            ((B, N_GOAL_ROWS, n), torch.float32, m != 2), ((B, 2), torch.int64, m != 2))))
    ptr = lambda t: None if t is None else t.data_ptr()
    code = _build.load().cw_keyed_reset(
        keys.data_ptr(), B, n, m, n_sel, _span(0, cfg.number_of_tasks), int(cfg.stacking),
        _span(0, pool_size), tf.shuffle_rounds(n_sel), *(ptr(t) for t in out),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("cw_keyed_reset", code)
    reset_draws_kernel.launches += 1
    reset_draws_kernel.envs += B
    return out


def reset_draws(cfg: EnvConfig, keys: torch.Tensor, mode: str = "fresh",
                pool_size: int = 0) -> ResetDraws:
    """A reset's draws from per-env keys int64[B, 2] (module docstring): the
    kernel for keys on the card, the plain version for keys on the CPU."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if keys.device.type == "cuda":
        return reset_draws_kernel(cfg, keys.contiguous(), mode, pool_size)
    if keys.device.type != "cpu":
        raise ValueError(f"unsupported device {keys.device}")
    return reset_draws_plain(cfg, keys, mode, pool_size)


def counter_draws_plain(key: torch.Tensor, mode: str, rows: int, row_stride: int, col0: int,
                        width: int, minval: int = 0, maxval: int = 1) -> torch.Tensor:
    """Plain version of ``cw_keyed_counter``: int64[rows, width, 2] keys
    (``"split"``) or int32[rows, width] (``"randint"``)."""
    counter_draws_plain.calls += 1
    counter_draws_plain.elements += rows * width
    dev = key.device
    index = (torch.arange(rows, device=dev)[:, None] * row_stride + col0
             + torch.arange(width, device=dev)[None, :])
    if mode == "split":
        return tf.keys_at(key, index)
    k = tf.split(key)
    return tf.randint_from_bits(tf.bits_at(k[0], index), tf.bits_at(k[1], index), minval, maxval)


def counter_draws_kernel(key: torch.Tensor, mode: str, rows: int, row_stride: int, col0: int,
                         width: int, minval: int = 0, maxval: int = 1) -> torch.Tensor:
    """The counter-draws kernel on the card: ``counter_draws_plain``'s result."""
    if key.device.type != "cuda":
        raise ValueError(f"counter_draws_kernel launches on a CUDA device, not {key.device}")
    if key.dtype != torch.int64 or tuple(key.shape) != (2,) or not key.is_contiguous():
        raise ValueError(f"key: want contiguous int64[2], got {key.dtype}{list(key.shape)}")
    m = COUNTER_MODES[mode]
    out = (torch.empty((rows, width, 2), dtype=torch.int64, device=key.device) if m == 0 else
           torch.empty((rows, width), dtype=torch.int32, device=key.device))
    code = _build.load().cw_keyed_counter(
        key.data_ptr(), m, rows, row_stride, col0, width, _span(minval, maxval), minval,
        out.data_ptr(), torch.cuda.current_stream(key.device).cuda_stream)
    _build.check("cw_keyed_counter", code)
    counter_draws_kernel.launches += 1
    counter_draws_kernel.elements += rows * width
    return out


def counter_draws(key: torch.Tensor, mode: str, rows: int, row_stride: int, col0: int,
                  width: int, minval: int = 0, maxval: int = 1, device=None) -> torch.Tensor:
    """One key's draws over a box of counters on ``device`` (the key's by
    default): the kernel on the card, the plain version on the CPU."""
    if mode not in COUNTER_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    device = key.device if device is None else torch.device(device)
    key = key.to(device=device, dtype=torch.int64).contiguous()
    args = (key, mode, rows, row_stride, col0, width, minval, maxval)
    if device.type == "cuda":
        return counter_draws_kernel(*args)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return counter_draws_plain(*args)


def _bounds(cols: slice, n: int):
    r = range(n)[cols]
    if r.step != 1:
        raise ValueError(f"columns must be contiguous, not {cols}")
    return r.start, len(r)


def split_keys(key: torch.Tensor, num: int, cols: slice = slice(None), device=None):
    """Keys ``cols`` of ``jax.random.split(key, num)``: int64[len(cols), 2]."""
    col0, width = _bounds(cols, num)
    return counter_draws(key, "split", 1, num, col0, width, device=device)[0]


def randint_cols(key: torch.Tensor, shape, minval: int, maxval: int,
                 cols: slice = slice(None), device=None) -> torch.Tensor:
    """Columns ``cols`` of ``jax.random.randint(key, (T, B), minval,
    maxval)``: int32[T, len(cols)]."""
    T, B = shape
    col0, width = _bounds(cols, B)
    return counter_draws(key, "randint", T, B, col0, width, minval, maxval, device=device)


reset_draws_plain.calls = reset_draws_plain.envs = 0
reset_draws_kernel.launches = reset_draws_kernel.envs = 0
counter_draws_plain.calls = counter_draws_plain.elements = 0
counter_draws_kernel.launches = counter_draws_kernel.elements = 0
