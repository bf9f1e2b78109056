"""The port's world pool on the CPU, where it takes its plain version, against
the JAX package's pool kernel.

The iterated argmax is a pure function of the keys: fed the same keys it must
give JAX ``_take_picks``'s cells and task mask bit for bit, and on the
all-zero bits that the TPU interpreter draws it must equal the JAX kernel run
in interpret mode. The keys themselves come from Philox, pinned here by
known answers; the pool's distribution is held to the chi-square bounds of
tests_tpu/test_fused_reset_tpu.py. chip_smoke.py holds the CUDA kernel
bit-exact against this plain version on the card.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.ops import fused_reset as jfr
from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.ops import fused_reset as fr
from gym_craftingworld_tpu_torch.ops import fused_update as fu

from test_torch_packed_rollout import assert_tree_equal, np_tree, tcfg

torch.set_num_threads(1)

TASK_CONFIGS = {
    "ray": jcw.ray_config(),
    "flat_single": dataclasses.replace(jcw.flat_config(), stacking=False),
    "flat_sel14": dataclasses.replace(jcw.flat_config(), selected_task_indices=(1, 4),
                                      number_of_tasks=2),
}


def jax_picks(cfg, keys, tkeys):
    """JAX ``_take_picks`` and the task draw of fused_reset.py:94-111 on given keys."""
    rows = jnp.arange(keys.shape[0], dtype=jnp.int32)[:, None]
    cells = jfr._take_picks(jnp.asarray(keys), rows, C.N_OBJECTS + 1)
    trows = np.arange(fr.N_TASK_KEYS)[:, None]
    valid = np.isin(trows, cfg.selected_task_indices)
    tscores = jnp.asarray(np.where(valid, tkeys, -1))
    kdraw = tkeys[C.N_TASKS] % cfg.number_of_tasks + 1 if cfg.stacking else 1
    tpicks = jfr._take_picks(tscores, jnp.asarray(trows, jnp.int32),
                             len(cfg.selected_task_indices))
    desired = np.zeros(keys.shape[1], np.int32)
    for t, a in enumerate(tpicks):
        desired |= np.where(t < kdraw, 1 << np.asarray(a), 0)
    return np.concatenate([np.stack([np.asarray(c) for c in cells]), desired[None]])


@pytest.mark.parametrize("name", list(TASK_CONFIGS))
def test_picks_from_keys_equal_jax_take_picks(name):
    """Random keys from a narrow range, so ties are common: exact match."""
    cfg = TASK_CONFIGS[name]
    rng = np.random.default_rng(7)
    n = 384
    keys = rng.integers(0, 60, (cfg.n_cells, n), dtype=np.int32)
    tkeys = rng.integers(0, 5, (fr.N_TASK_KEYS, n), dtype=np.int32)
    tkeys[C.N_TASKS] = rng.integers(0, 2**31 - 1, n, dtype=np.int32)
    got = fr.picks_from_keys(tcfg(cfg), torch.as_tensor(keys), torch.as_tensor(tkeys))
    np.testing.assert_array_equal(got.numpy(), jax_picks(cfg, keys, tkeys))


@pytest.mark.parametrize("name", list(TASK_CONFIGS))
def test_zero_keys_equal_jax_kernel_interpret(name):
    """The TPU interpreter draws all-zero bits: the port fed zero keys must give
    the JAX kernel's PackedState field for field."""
    cfg = TASK_CONFIGS[name]
    n = jfr.BLOCK
    want = jfr.fresh_packed_fused(cfg, 3, n, interpret=True)
    zeros = lambda rows: torch.zeros((rows, n), dtype=torch.int32)
    got = fr.fresh_packed_from_keys(tcfg(cfg), zeros(cfg.n_cells), zeros(fr.N_TASK_KEYS))
    assert_tree_equal(interop.packed_state_to_numpy(got), np_tree(want))


def _philox_ref(counter, key):
    """Philox4x32-10 on Python ints: an independent reference."""
    M = 0xFFFFFFFF
    c, (k0, k1) = list(counter), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M, (k1 + 0xBB67AE85) & M
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & M, p1 & M, ((p0 >> 32) ^ c[3] ^ k1) & M, p0 & M]
    return c


def test_pool_keys_known_answers():
    """Key j of world w is word j % 4 of Philox((j // 4, w, seed2, 0), (seed, POOL_KEY)) >> 1;
    task key t is word 4 * ceil(HW / 4) + t."""
    assert _philox_ref((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    HW, n = 441, 40
    seed, seed2 = 0x7FFFFFF0, 0x12345
    keys, tkeys = fr.pool_keys_plain(seed, seed2, n, HW)
    assert keys.dtype == torch.int32 and tuple(keys.shape) == (HW, n)
    assert tuple(tkeys.shape) == (16, n) and int(keys.min()) >= 0
    for j, w in [(0, 0), (5, 3), (440, 39), (123, 17)]:
        word = _philox_ref((j // 4, w, seed2, 0), (seed, fr.POOL_KEY))[j % 4]
        assert int(keys[j, w]) == word >> 1
    for t, w in [(0, 0), (9, 11), (15, 39)]:
        g = 111 + t // 4
        assert int(tkeys[t, w]) == _philox_ref((g, w, seed2, 0), (seed, fr.POOL_KEY))[t % 4] >> 1
    # tensors on the device and negative int32 seeds give the same bits
    s32 = torch.tensor([seed, seed2], dtype=torch.int32)
    k2, t2 = fr.pool_keys_plain(s32[0], s32[1], n, HW)
    assert torch.equal(k2, keys) and torch.equal(t2, tkeys)
    neg = fr.pool_keys_plain(torch.tensor(-1, dtype=torch.int32), 0, 4, 9)[0]
    assert torch.equal(neg, fr.pool_keys_plain(0xFFFFFFFF, 0, 4, 9)[0])


def test_pool_invariants():
    """tests/test_fused_reset.py's invariants, on the plain version's pool."""
    cfg = tcfg(jcw.ray_config())
    n = 1000  # not a multiple of anything: the port takes any n
    p = fr.fresh_packed_fused(cfg, 3, n)
    slot_key, agent_key = p.slot_key.numpy(), p.init_agent_key.numpy()
    HW = cfg.n_cells
    assert slot_key.shape == (C.N_OBJECTS, n)
    assert (slot_key >= 0).all() and (slot_key < HW).all()
    assert (agent_key >= 0).all() and (agent_key < HW).all()
    cells = np.sort(np.concatenate([slot_key, agent_key[None]]), axis=0)
    assert (np.diff(cells, axis=0) > 0).all()
    np.testing.assert_array_equal(p.agent_r.numpy(), agent_key // cfg.width)
    np.testing.assert_array_equal(p.agent_c.numpy(), agent_key % cfg.width)
    des = p.desired.numpy().astype(np.int64)
    assert (des >= 1).all() and (des < 2**C.N_TASKS).all()
    np.testing.assert_array_equal(p.init_key.numpy(), slot_key)
    np.testing.assert_array_equal(p.slot_type.numpy(), np.arange(1, 9)[:, None].repeat(n, 1))
    assert (p.holding.numpy() == 0).all() and (p.obj_here.numpy() == 0).all()
    assert (p.icode_here.numpy() == C.AGENT_INIT_MARK).all()
    assert (p.achieved.numpy() == 0).all() and (p.step_num.numpy() == 0).all()
    assert all(x.dtype == torch.int16 and x.is_contiguous() for x in p)


def test_pool_respects_task_config():
    """stacking=False draws exactly one task; selected_task_indices bound the mask."""
    single = tcfg(TASK_CONFIGS["flat_single"])
    des = fr.fresh_packed_fused(single, 5, 1024).desired.numpy().astype(np.int64)
    assert all(bin(int(d)).count("1") == 1 for d in des)
    sel = tcfg(TASK_CONFIGS["flat_sel14"])
    des2 = fr.fresh_packed_fused(sel, 5, 1024).desired.numpy().astype(np.int64)
    assert (des2 & ~((1 << 1) | (1 << 4)) == 0).all() and (des2 != 0).all()
    assert {bin(int(d)).count("1") for d in des2} == {1, 2}


def test_pool_distribution():
    """The chi-square checks of tests_tpu/test_fused_reset_tpu.py at n = 8192."""
    cfg = tcfg(jcw.ray_config())
    n, HW = 8192, cfg.n_cells
    p = fr.fresh_packed_fused(cfg, 1234, n, seed2=77)
    slot_key = p.slot_key.numpy().astype(np.int64)
    agent_key = p.init_agent_key.numpy().astype(np.int64)
    expected = n / HW
    bound = 440 + 6 * np.sqrt(2 * 440)  # dof 440, 6 sigma
    for cells in (agent_key, slot_key[0]):
        chi2 = ((np.bincount(cells, minlength=HW) - expected) ** 2 / expected).sum()
        assert chi2 < bound, chi2
    des = p.desired.numpy().astype(np.int64)
    pop = np.array([bin(int(d)).count("1") for d in des])
    hist = np.bincount(pop, minlength=10)[1:10]
    chi2_k = ((hist - n / 9) ** 2 / (n / 9)).sum()
    assert chi2_k < 8 + 6 * np.sqrt(16), (hist, chi2_k)
    freq = ((des[:, None] >> np.arange(9)[None, :]) & 1).mean(0)
    assert np.abs(freq - freq.mean()).max() < 0.02, freq
    again = fr.fresh_packed_fused(cfg, 1234, n, seed2=77)
    assert all(torch.equal(a, b) for a, b in zip(again, p))
    assert not torch.equal(fr.fresh_packed_fused(cfg, 99, n, seed2=77).slot_key, p.slot_key)
    assert not torch.equal(fr.fresh_packed_fused(cfg, 1234, n, seed2=78).slot_key, p.slot_key)


def test_pool_wrapper_counts_plain_calls_and_checks_its_kernel_inputs():
    cfg = tcfg(jcw.ray_config())
    before = fr.fresh_packed_plain.calls
    fr.fresh_packed_fused(cfg, torch.tensor(1), 8, seed2=torch.tensor(2))
    assert fr.fresh_packed_plain.calls == before + 1 and fr.pool_picks.launches == 0
    with pytest.raises(ValueError):
        fr.pool_picks(cfg, torch.zeros(2, dtype=torch.int32), 8)  # not on a card


def _cuda_defines(name):
    text = (Path(fr.__file__).resolve().parents[1] / "csrc" / name).read_text()
    return {k: int(v.rstrip("u"), 0)
            for k, v in re.findall(r"^#define CW_(\w+) (0x[0-9A-Fa-f]+u?|\d+)\b", text, re.M)}


def test_cuda_constants_match_python():
    """The kernels' constants are the plain versions' and wrappers'."""
    pool = _cuda_defines("fused_reset.cu")
    assert pool["POOL_KEY"] == fr.POOL_KEY and pool["N_PICKS"] == C.N_OBJECTS + 1
    assert pool["POOL_KEY"] != _cuda_defines("philox.cuh")["ACTION_KEY"]
    upd = _cuda_defines("fused_update.cu")
    assert (upd["GM"], upd["GN"], upd["GK"]) == (fu._GEMM_TILE, fu._GEMM_TILE, fu._GEMM_K)
    assert upd["HSTRIDE"] == fu._HEAD_STRIDE and upd["NA"] == C.N_ACTIONS
