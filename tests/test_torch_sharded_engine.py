"""The sharded engines (``parallel/sharded_engine.py``) over CPU ranks.

Four gloo ranks are spawned once; each runs the packed scan, the actions
kernel and the bench kernel (their plain versions here) on its columns at
world 4 and at world 2 (ranks {0, 1}). The scan is held to the JAX
package's ``rollout_p_sharded`` on its 8 virtual devices, from a JAX reset
carried across by ``interop``; the actions rollout to JAX ``rollout_p``;
the bench to the port's unsharded bench (its stream is the port's Philox,
keyed by the env's index in the whole batch). All bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.ops import packed_rollout as jpr
from gym_craftingworld_tpu.parallel import sharded_engine as jse
from gym_craftingworld_tpu.parallel.mesh import make_env_mesh as jmesh
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops import packed_rollout as tpr
from gym_craftingworld_tpu_torch.ops import transposed_rollout as ttr

import torch_ranks
from test_torch_packed_rollout import crafting_actions, jax_and_port_slots, np_tree, tcfg

torch.set_num_threads(1)

CFG = jcw.ray_config()
B, T, T_BENCH, SEED = 64, 40, 300, 7


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("engine")
    jslots, slots = jax_and_port_slots(CFG, 3, B)
    actions = crafting_actions(5, T, B)
    torch.save({"slots": slots._asdict(), "actions": torch.as_tensor(actions), "T": T,
                "T_bench": T_BENCH, "seed": SEED}, out / "inputs.pt")
    torch_ranks.spawn("torch_ranks:engine_checks", 4, out, B)
    return jslots, slots, actions, [torch_ranks.load(out, r) for r in range(4)]


def shards(ranks, key, world):
    """The ranks' results of ``key`` at ``world`` (world 2: the first pair)."""
    return [ranks[r][f"{key}_w{world}"] for r in range(world)]


def cat_slots(parts):
    return {k: np.concatenate([np.asarray(getattr(p, k)) for p in parts]) for k in parts[0]._fields}


@pytest.mark.parametrize("world", [2, 4])
def test_rollout_p_sharded_equals_jax_sharded(run, world):
    jslots, _, actions, ranks = run
    mesh = jmesh(8)
    j_sl, j_out = jse.rollout_p_sharded(CFG, jse.shard_slots(jslots, mesh),
                                        jnp.asarray(actions), T, mesh)
    parts = shards(ranks, "scan", world)
    got = cat_slots([p[0] for p in parts])
    want = np_tree(j_sl)
    for k in ("slot_type", "slot_pos", "slot_stat", "agent", "achieved", "step_num"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for i, f in enumerate(("reward", "done")):
        np.testing.assert_array_equal(np.concatenate([p[1][i].numpy() for p in parts], axis=1),
                                      np.asarray(getattr(j_out, f)), err_msg=f)


@pytest.mark.parametrize("world", [2, 4])
def test_fused_rollout_packed_sharded_equals_jax(run, world):
    jslots, _, actions, ranks = run
    j_sl, j_out = jpr.rollout_p(CFG, jslots, jnp.asarray(actions), T)
    parts = shards(ranks, "actions", world)
    got = cat_slots([p[0] for p in parts])
    want = np_tree(j_sl)
    for k in ("slot_type", "slot_pos", "slot_stat", "agent", "achieved", "step_num"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(torch.cat([p[1] for p in parts], dim=1).numpy(),
                                  np.asarray(j_out.reward))
    np.testing.assert_array_equal(torch.cat([p[2] for p in parts], dim=1).numpy(),
                                  np.asarray(j_out.done))


@pytest.mark.parametrize("world", [2, 4])
def test_fused_bench_sharded_equals_unsharded(run, world):
    _, slots, _, ranks = run
    want_sl, want_sum = pf.fused_rollout_packed_bench(tcfg(CFG), slots, SEED, T_BENCH)
    parts = shards(ranks, "bench", world)
    assert all(int(p[1]) == int(want_sum) for p in parts)  # every rank holds the whole sum
    got = cat_slots([p[0] for p in parts])
    for k in want_sl._fields:
        np.testing.assert_array_equal(got[k], getattr(want_sl, k).numpy(), err_msg=k)
    assert int(want_sum) != 0


@pytest.mark.parametrize("k", [0, 24, 37])
def test_bench_plain_at_env0_is_the_batch_columns(k):
    cfg = tcfg(CFG)
    _, slots = jax_and_port_slots(CFG, 4, 64)
    p = tpr.pack(cfg, ttr.transpose_in(slots))
    whole_p, whole_acc = pf.rollout_packed_bench_plain(cfg, p, SEED, 60)
    n = 27 if k == 37 else 24
    part = tpr.PackedState(*(x[..., k:k + n].contiguous() for x in p))
    got_p, got_acc = pf.rollout_packed_bench(cfg, part, SEED, 60, env0=k)
    assert torch.equal(got_acc, whole_acc[k:k + n])
    for a, b in zip(got_p, whole_p):
        assert torch.equal(a, b[..., k:k + n])
    assert torch.equal(pf.action_stream_plain(n, SEED, 60, env0=k),
                       pf.action_stream_plain(64, SEED, 60)[:, k:k + n])
