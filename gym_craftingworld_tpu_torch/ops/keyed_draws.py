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
  alone (``generate_pool``), ``"tasks"`` ``sample_desired``'s ``k`` and
  ``perm`` of each key alone (``train/fast_ppo.fresh_packed_batch``).
* ``counter_draws``: draws over a ``rows x width`` box of counters (row
  ``r``, column ``c`` at linear index ``r * row_stride + col0 + c``) under
  one key or under each of P plane keys (given, or ``split(parent, P)``):
  keys of a split, ``randint``, the raw 32 bits or ``uniform`` floats.
  ``split_keys``, ``randint_cols`` and ``uniform_cols`` take a slice of a
  split's keys or of a draw's columns, so a rank of a mesh draws its own
  envs and nothing else; ``fold_in``, ``randint``, ``normal`` and
  ``permutation`` are ``jax.random``'s on the key's device (the trainers'
  keys stay there), ``split_permutation`` an epoch's shuffle.

A CUDA tensor launches the kernel of ``csrc/keyed_draws.cu``
(``cw_keyed_reset``, ``cw_keyed_counter``) or raises; a CPU tensor runs the
plain version. The kernel wrappers count ``launches``, the plain versions
``calls``; both count the envs (``envs``) or counters (``elements``) they
drew, which shows what a rank drew.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.ops import _build
from gym_craftingworld_tpu_torch.ops import threefry as tf

N_GOAL_ROWS = 7
MAX_SELECTED = 16  # the kernel sorts a permutation of up to 16 tasks in registers
MODES = {"fresh": 0, "pool": 1, "world": 2, "tasks": 3}
COUNTER_MODES = {"split": 0, "randint": 1, "bits": 2, "uniform": 3}
MASK32 = tf.MASK32


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
    k_num, k_perm = tf.split(keys if mode == "tasks" else k_task).unbind(-2)
    if cfg.stacking:
        k = tf.randint(k_num, (), 0, cfg.number_of_tasks) + 1
    else:
        k = torch.ones(keys.shape[:1], dtype=torch.int32, device=keys.device)
    perm = tf.permutation(k_perm, len(cfg.selected_task_indices))
    if mode == "tasks":
        return ResetDraws(k, perm, None, None, None, None)
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
            ((B, n), torch.float32, m in (0, 2)), ((B,), torch.int32, m == 1),
            ((B, N_GOAL_ROWS, n), torch.float32, m < 2), ((B, 2), torch.int64, m < 2))))
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


def fastmod_magic(d: int):
    """(magic, s1, s2): ``n % d`` for every 32-bit ``n`` as ``n - q * d`` with
    ``t = umulhi(magic, n)`` and ``q = (t + ((n - t) >> s1)) >> s2`` (the
    kernel's ``cw_fastmod``; Granlund and Montgomery, PLDI'94, fig. 4.1)."""
    if not 1 <= d <= MASK32:
        raise ValueError(f"divisor {d} outside [1, 2**32)")
    ell = (d - 1).bit_length()  # ceil(log2 d)
    return (2**32 * (2**ell - d)) // d + 1, min(ell, 1), max(ell - 1, 0)


def fastmod_plain(n: torch.Tensor, d: int) -> torch.Tensor:
    """``cw_fastmod`` in int64 arithmetic on 32-bit values (held to ``%`` by
    ``tests/test_torch_threefry.py``)."""
    magic, s1, s2 = fastmod_magic(d)
    t = ((n >> 16) * magic + (((n & 0xFFFF) * magic) >> 16)) >> 16  # umulhi, in 64 bits
    q = (t + ((n - t) >> s1)) >> s2
    return n - q * d


def randint_multiplier(span: int) -> int:
    """``randint``'s ``(2**16 % span)**2 % span``, the square wrapping at 2**32."""
    return (((2**16 % span) ** 2) & MASK32) % span


def _planes(key: torch.Tensor, derive: int) -> torch.Tensor:
    """The plane keys int64[P, 2]: ``split(key, derive)`` of a parent, or
    ``key`` itself ([P, 2], or one key [2] as one plane)."""
    if derive:
        return tf.split(key, derive)
    return key.reshape(-1, 2)


def _squeeze(out: torch.Tensor, key: torch.Tensor, derive: int) -> torch.Tensor:
    """One key's draws lose the plane axis: ``[rows, width(, 2)]``."""
    return out[0] if key.dim() == 1 and not derive else out


def counter_draws_plain(key: torch.Tensor, mode: str, rows: int, row_stride: int, col0: int,
                        width: int, minval=0, maxval=1, derive: int = 0) -> torch.Tensor:
    """Plain version of ``cw_keyed_counter``: ``[P, rows, width]`` of int64
    key pairs (``"split"``, a trailing axis of 2), int32 (``"randint"``), the
    32 bits as int32 (``"bits"``) or float32 (``"uniform"`` on [minval,
    maxval)); one key [2] with ``derive`` 0 drops the plane axis."""
    planes = _planes(key, derive)
    counter_draws_plain.calls += 1
    counter_draws_plain.elements += planes.shape[0] * rows * width
    dev = key.device
    index = (torch.arange(rows, device=dev)[:, None] * row_stride + col0
             + torch.arange(width, device=dev)[None, :])
    if mode == "split":
        out = tf.keys_at(planes, index)
    elif mode == "randint":
        k = tf.split(planes)
        out = tf.randint_from_bits(tf.bits_at(k[:, 0], index), tf.bits_at(k[:, 1], index),
                                   minval, maxval)
    elif mode == "bits":
        out = tf.bits_at(planes, index)
        out = torch.where(out > 0x7FFFFFFF, out - 2**32, out).to(torch.int32)
    else:
        out = tf.uniform_at(planes, index, minval, maxval)
    return _squeeze(out, key, derive)


def counter_draws_kernel(key: torch.Tensor, mode: str, rows: int, row_stride: int, col0: int,
                         width: int, minval=0, maxval=1, derive: int = 0) -> torch.Tensor:
    """The counter-draws kernel on the card: ``counter_draws_plain``'s result."""
    if key.device.type != "cuda":
        raise ValueError(f"counter_draws_kernel launches on a CUDA device, not {key.device}")
    if key.dtype != torch.int64 or key.dim() not in (1, 2) or key.shape[-1] != 2 \
            or (derive and key.dim() != 1) or not key.is_contiguous() or key.data_ptr() % 16:
        raise ValueError(f"key: want a contiguous, 16-byte aligned int64[2] or [P, 2], got "
                         f"{key.dtype}{list(key.shape)}")
    P = derive or (1 if key.dim() == 1 else key.shape[0])
    m = COUNTER_MODES[mode]
    shape = (P, rows, width)
    out = (torch.empty(shape + (2,), dtype=torch.int64, device=key.device) if m == 0 else
           torch.empty(shape, dtype=torch.float32 if m == 3 else torch.int32, device=key.device))
    span = _span(minval, maxval) if m == 1 else 1
    lo, fspan = tf.uniform_span(minval, maxval) if m == 3 else (0.0, 1.0)
    code = _build.load().cw_keyed_counter(
        key.data_ptr(), P, int(bool(derive)), m, rows, row_stride, col0, width, span,
        int(minval) if m == 1 else 0, randint_multiplier(span), *fastmod_magic(span),
        float(lo), float(fspan), out.data_ptr(), torch.cuda.current_stream(key.device).cuda_stream)
    _build.check("cw_keyed_counter", code)
    counter_draws_kernel.launches += 1
    counter_draws_kernel.elements += P * rows * width
    return _squeeze(out, key, derive)


def counter_draws(key: torch.Tensor, mode: str, rows: int, row_stride: int, col0: int,
                  width: int, minval=0, maxval=1, device=None, derive: int = 0) -> torch.Tensor:
    """Draws over a box of counters on ``device`` (the key's by default): the
    kernel on the card, the plain version on the CPU. ``key`` int64[2], one
    key, or [P, 2], a key a plane; ``derive`` P > 0 makes a parent key [2]
    into the planes ``split(key, P)``."""
    if mode not in COUNTER_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    device = key.device if device is None else torch.device(device)
    key = key.to(device=device, dtype=torch.int64).contiguous()
    args = (key, mode, rows, row_stride, col0, width, minval, maxval, derive)
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


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` on the key's device: the key at
    counter ``data`` (``ops/threefry.fold_in``), one launch on the card."""
    return counter_draws(key, "split", 1, 1, int(data) & MASK32, 1)[0, 0]


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


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) on the key's device."""
    n = math.prod(shape)
    return counter_draws(key, "randint", 1, n, 0, n, minval, maxval)[0].reshape(shape)


def uniform_cols(key: torch.Tensor, shape, cols: slice = slice(None), minval: float = 0.0,
                 maxval: float = 1.0, planes: int = 0) -> torch.Tensor:
    """Columns ``cols`` of ``jax.random.uniform(k, (R, W), minval=minval,
    maxval=maxval)``: float32[R, len(cols)] for ``k = key`` (one key [2]),
    or [P, R, len(cols)] for each key ``k`` of ``key`` [P, 2] or, with
    ``planes`` P, of ``split(key, P)``."""
    R, W = shape
    col0, width = _bounds(cols, W)
    return counter_draws(key, "uniform", R, W, col0, width, minval, maxval, derive=planes)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` on the key's device: its uniforms bit
    for bit, ``erfinv`` torch's (``ops/threefry.normal``)."""
    n = math.prod(shape)
    u = uniform_cols(key, (1, n), minval=tf.NORMAL_LOW)[0]
    return tf.normal_from_uniform(u).reshape(shape)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int32[n]) on the key's device: each
    of ``shuffle_rounds(n)`` rounds splits the key, draws 32-bit sort keys and
    sorts by them, stably, on the device."""
    x = torch.arange(n, dtype=torch.int32, device=key.device)
    for _ in range(tf.shuffle_rounds(n)):
        k = split_keys(key, 2)
        key = k[0]
        bits = counter_draws(k[1], "bits", 1, n, 0, n)[0].to(torch.int64) & MASK32
        x = x[torch.sort(bits, stable=True).indices]
    return x


def split_permutation(key: torch.Tensor, n: int):
    """``key, k = split(key)`` then ``permutation(k, n)``, an epoch's shuffle
    in JAX's trainers: (the next key, int32[n]) on the key's device."""
    key, k = split_keys(key, 2)
    return key, permutation(k, n)


reset_draws_plain.calls = reset_draws_plain.envs = 0
reset_draws_kernel.launches = reset_draws_kernel.envs = 0
counter_draws_plain.calls = counter_draws_plain.elements = 0
counter_draws_kernel.launches = counter_draws_kernel.elements = 0
