"""The port's fused slot-layout rollouts (``ops/fused_rollout.py``,
``ops/fused_rollout_t.py``) on the CPU, where they take their plain versions,
against the JAX package's Pallas kernels and their step functions.

The CUDA kernels cannot run here; chip_smoke.py holds each one against its
plain version on the card. Every value is an integer: comparisons are exact,
dtypes included.
"""

import importlib
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import gym_craftingworld_tpu as jcw
import gym_craftingworld_tpu_torch as tcw
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core import slots as tsm
from gym_craftingworld_tpu_torch.ops import _build
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops import transposed_rollout as ttr

from test_torch_packed_rollout import (
    assert_tree_equal,
    crafting_actions,
    jax_and_port_slots,
    np_tree,
    tcfg,
)
from test_torch_slot_engines import jax_slots, synthetic_slots

# the packages re-export the entry-point functions, shadowing the module names
jfr = importlib.import_module("gym_craftingworld_tpu.ops.fused_rollout")
jfrt = importlib.import_module("gym_craftingworld_tpu.ops.fused_rollout_t")
jtr = importlib.import_module("gym_craftingworld_tpu.ops.transposed_rollout")
fr = importlib.import_module("gym_craftingworld_tpu_torch.ops.fused_rollout")
frt = importlib.import_module("gym_craftingworld_tpu_torch.ops.fused_rollout_t")

torch.set_num_threads(1)


@pytest.mark.parametrize("cfg,seed", [
    (jcw.ray_config(), 0),
    (jcw.flat_config(reward_equal=False), 1),
], ids=["ray", "flat_subset"])
def test_fused_rollout_actions_equals_jax_kernel(cfg, seed, monkeypatch):
    """Against the JAX Pallas kernel in interpret mode with 8-env blocks, on the
    same actions; every field compared, positions of removed slots included."""
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=pltpu.InterpretParams()))
    monkeypatch.setattr(jfr, "BLOCK", 8)
    B, T = 16, 64
    jsl, tsl = jax_and_port_slots(cfg, seed, B)
    actions = crafting_actions(seed, T, B)
    jst, jrew, jdone = jfr.fused_rollout_actions(cfg, jsl, jnp.asarray(actions))
    tst, trew, tdone = tcw.ops.fused_rollout_actions(tcfg(cfg), tsl, torch.as_tensor(actions))
    assert trew.dtype == torch.int32 and tdone.dtype == torch.bool
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    assert_tree_equal(interop.slot_state_to_numpy(tst), np_tree(jst))
    assert (tst.slot_stat == tsm.REMOVED).any() and tst.achieved.any()


@pytest.mark.parametrize("reward_equal", [True, False])
def test_plain_versions_equal_jax_kernel_steps(reward_equal):
    """The plain versions of the three slot kernels against the JAX kernels'
    own step functions (``_step_block``, ``_step_tk``), stepped outside Pallas
    from synthetic states over the Philox stream."""
    cfg = jcw.ray_config(height=9, width=9, max_steps=12, reward_equal=reward_equal)
    B, T, seed = 64, 24, 5
    d = synthetic_slots(6, B, 9, 9)
    stream = pf.action_stream_plain(B, seed, T)

    step_block = jax.jit(partial(jfr._step_block, cfg))
    state = tuple(jfr._pack_inputs(jax_slots(d)))
    rewards, dones = [], []
    for t in range(T):
        state, r, dn = step_block(state, jnp.asarray(stream[t].numpy())[:, None])
        rewards.append(np.asarray(r)[:, 0])
        dones.append(np.asarray(dn)[:, 0].astype(bool))
    want = jfr._unpack_outputs(jax_slots(d), tuple(state[i] for i in (0, 1, 2, 3, 4, 5, 7, 13))
                               + (np.stack(rewards), np.stack(dones)))
    for got in (fr.rollout_slots_actions_plain(tcfg(cfg), interop.slot_state_from_numpy(d, device="cpu"), stream),
                fr.rollout_slots_seeded_plain(tcfg(cfg), interop.slot_state_from_numpy(d, device="cpu"), seed, T)):
        assert_tree_equal(interop.slot_state_to_numpy(got[0]), np_tree(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (np.stack(rewards) == cfg.max_steps).any()

    step_tk = jax.jit(partial(jfrt._step_tk, cfg))
    jts = jtr.transpose_in(jax_slots(d))
    row = lambda x: x[None, :]
    state = tuple(row(x) if x.ndim == 1 else x for x in jts)
    rewards = []
    for t in range(T):
        state, r, _ = step_tk(state, jnp.asarray(stream[t].numpy())[None, :])
        rewards.append(np.asarray(r)[0])
    want_ts = jts._replace(**{f: (state[i][0] if state[i].shape[0] == 1 else state[i])
                              for i, f in enumerate(jts._fields)})
    ts, rew, _ = frt.rollout_t_seeded_plain(
        tcfg(cfg), ttr.transpose_in(interop.slot_state_from_numpy(d, device="cpu")), seed, T)
    assert_tree_equal(interop.tslot_state_to_numpy(ts), np_tree(want_ts))
    np.testing.assert_array_equal(rew.numpy(), np.stack(rewards))


def off_grid_at_origin(slots):
    """The packed layout keeps no cell for a held or removed slot (its unpack
    writes (0, 0), as the JAX one does); the slot layouts keep the last one."""
    on = (slots.slot_stat == tsm.ON_GRID)[..., None]
    return slots._replace(slot_pos=torch.where(on, slots.slot_pos, 0))


def test_seeded_rollouts_share_the_packed_stream():
    """On one seed, ``fused_rollout`` and ``fused_rollout_t`` equal
    ``fused_rollout_actions`` fed ``action_stream_plain``, reach the final
    state of ``fused_rollout_packed_bench`` (off-grid cells aside), and their
    rewards sum to its checksum; the grid rollout fed the stream agrees too."""
    cfg = tcw.ray_config()
    B, T, seed = 128, 96, 7
    grid = tcw.reset_from_seed(cfg, 3, B, device="cpu")
    sl = tsm.from_env_state(grid)
    stream = pf.action_stream_plain(B, seed, T)
    want = tcw.ops.fused_rollout_actions(cfg, sl, stream)
    packed, checksum = pf.fused_rollout_packed_bench(cfg, sl, seed, T)
    gst, gout = tcw.rollout(cfg, grid, stream)
    for x, y in zip(tsm.to_grid(want[0], cfg), (gst.objects, gst.agent, gst.holding)):
        assert torch.equal(x, y)
    assert not torch.equal(want[0].slot_pos, off_grid_at_origin(want[0]).slot_pos)
    for got in (tcw.ops.fused_rollout(cfg, sl, seed, T), frt.fused_rollout_t(cfg, sl, seed, T)):
        assert_tree_equal(interop.slot_state_to_numpy(got[0]), interop.slot_state_to_numpy(want[0]))
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert_tree_equal(interop.slot_state_to_numpy(off_grid_at_origin(got[0])),
                          interop.slot_state_to_numpy(packed))
        assert int(got[1].sum(dtype=torch.int64)) == int(checksum)
        assert torch.equal(got[1], gout.reward) and torch.equal(got[2], gout.done)


def test_entry_points_take_any_batch_and_dtypes():
    """No block rule: a ragged batch works, and the entry points cast their
    inputs as the JAX ``_pack_inputs`` does."""
    cfg = tcw.flat_config(reward_equal=False)
    sl = tsm.from_env_state(tcw.reset_from_seed(cfg, 2, 13, device="cpu"))
    actions = torch.as_tensor(crafting_actions(3, 30, 13))
    want = tcw.ops.fused_rollout_actions(cfg, sl, actions)
    wide = sl._replace(slot_type=sl.slot_type.long(), desired=sl.desired.int(),
                       slot_pos=sl.slot_pos.transpose(1, 2).contiguous().transpose(1, 2))
    got = tcw.ops.fused_rollout_actions(cfg, wide, actions.long())
    assert_tree_equal(interop.slot_state_to_numpy(got[0]), interop.slot_state_to_numpy(want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_cpu_tensors_take_plain_versions():
    """A CPU tensor never reaches a kernel: the launch counters stay put and
    each plain version runs once per call."""
    cfg = tcw.flat_config()
    sl = tsm.from_env_state(tcw.reset_from_seed(cfg, 4, 8, device="cpu"))
    wrappers = (fr.rollout_slots_seeded, fr.rollout_slots_actions, frt.rollout_t_seeded)
    plains = (fr.rollout_slots_seeded_plain, fr.rollout_slots_actions_plain,
              frt.rollout_t_seeded_plain)
    launches = [w.launches for w in wrappers]
    calls = [p.calls for p in plains]
    tcw.ops.fused_rollout(cfg, sl, 1, 5)
    tcw.ops.fused_rollout_actions(cfg, sl, torch.zeros((5, 8), dtype=torch.int32))
    frt.fused_rollout_t(cfg, sl, 1, 5)
    assert [w.launches for w in wrappers] == launches
    assert [p.calls for p in plains] == [c + 1 for c in calls]
    meta = sl._replace(agent=sl.agent.to("meta"))
    with pytest.raises(ValueError):
        fr.rollout_slots_seeded(cfg, meta, 1, 5)


def _c_functions():
    """{name: parameter count} of every ``extern "C"`` function in csrc/*.cu."""
    out = {}
    for cu in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" [\w\s\*]+?\b(cw_\w+)\(([^)]*)\)',
                                       cu.read_text()):
            out[name] = len([p for p in params.split(",") if p.strip()])
    return out


def test_kernel_sources_match_python():
    """The C entry points have the arity ``_SIGNATURES`` declares, the slot
    status codes, the layouts' field counts and the actions kernel's ring
    depth are the Python ones."""
    fns = _c_functions()
    for name, argtypes in _build._SIGNATURES.items():
        assert fns.get(name) == len(argtypes), name
    text = (_build.CSRC / "slot_step.cuh").read_text()
    codes = dict(re.findall(r"^#define CW_(ON_GRID|HELD|REMOVED) (\d+)", text, re.M))
    assert {k: int(v) for k, v in codes.items()} == dict(
        ON_GRID=tsm.ON_GRID, HELD=tsm.HELD, REMOVED=tsm.REMOVED)
    counts = [tuple(map(int, m)) for m in re.findall(r"N_IN = (\d+), N_OUT = (\d+)", text)]
    assert counts == [(len(fr._IN_FIELDS), len(fr._OUT_FIELDS)),
                      (len(ttr.TSlotState._fields), len(frt._OUT_FIELDS))]
    ring = re.findall(r"^#define CW_SLOT_AHEAD (\d+)",
                      (_build.CSRC / "fused_rollout.cu").read_text(), re.M)
    assert [int(k) for k in ring] == [fr.SLOT_AHEAD]
