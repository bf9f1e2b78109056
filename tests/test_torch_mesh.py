"""The port's env mesh (``parallel/mesh.py``) over CPU ranks of gloo.

Four ranks are spawned once (``torch_ranks.spawn``); each checks the mesh at
world 4 (the process group) and at world 2 (ranks {0, 1} and {2, 3}). Each
shard of ``reset_sharded`` must equal its columns of ``reset_from_seed``,
bit for bit. The backend choice, the one-process no-op and
``scaling_report`` need no ranks.
"""

import math

import numpy as np
import pytest
import torch

import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.parallel import mesh as pm

import torch_ranks

torch.set_num_threads(1)

B = 16
CFG = cw.ray_config()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    torch_ranks.spawn("torch_ranks:mesh_checks", 4, out, B)
    return [torch_ranks.load(out, r) for r in range(4)]


def state_equal(got, want):
    a, b = interop.env_state_to_numpy(got), interop.env_state_to_numpy(want)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def columns(state, lo, hi):
    return pm.tree_map(lambda x: x[lo:hi], state)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_reset_sharded_is_the_unsharded_columns(ranks, world):
    whole = cw.reset_from_seed(CFG, 5, B, device="cpu")
    if world == 1:
        state_equal(pm.reset_sharded(CFG, 5, B, pm.make_env_mesh(device="cpu")), whole)
        return
    n = B // world
    for r in range(world):  # world 2: the first pair's meshes
        state_equal(ranks[r][f"reset_w{world}"], columns(whole, r * n, (r + 1) * n))


@pytest.mark.parametrize("world", [2, 4])
def test_shard_state_and_collectives(ranks, world):
    whole = cw.reset_from_seed(CFG, 9, B, device="cpu")
    n = B // world
    for r in range(4):
        mr = r % world
        state_equal(ranks[r][f"shard_w{world}"], columns(whole, mr * n, (mr + 1) * n))
        want = torch.cat([torch.arange(6, dtype=torch.int32).reshape(2, 3) + 100 * i
                          for i in range(world)], dim=-1)
        assert torch.equal(ranks[r][f"gather_w{world}"], want)
        assert int(ranks[r][f"sum_w{world}"]) == world * (world + 1) // 2


def test_batch_must_divide_over_the_ranks(ranks):
    assert all(ranks[r][f"raises_w{w}"] for r in range(4) for w in (2, 4))
    with pytest.raises(ValueError, match="divide evenly over 3 devices"):
        pm.EnvMesh(0, 3, torch.device("cpu")).cols(16)


def test_initialize_distributed_is_a_no_op_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    pm.initialize_distributed()
    pm.initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    mesh = pm.make_env_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    t = torch.ones(3)
    assert mesh.all_reduce(t) is t and mesh.gather(t) is t


def test_a_collective_takes_only_the_ranks_device():
    mesh = pm.EnvMesh(0, 2, torch.device("meta"), group=object())
    with pytest.raises(ValueError, match="a collective takes tensors on meta"):
        mesh.all_reduce(torch.ones(3))


def test_backend_choice():
    assert pm.choose_backend("cuda", 4, 4) == "nccl"
    assert pm.choose_backend("cuda", 2, 1) == "gloo"  # two ranks share the card
    assert pm.choose_backend("cpu", 2, 0) == "gloo"
    assert pm.choose_backend("cuda", 1, 1, "gloo") == "gloo"
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one card"):
        pm.choose_backend("cuda", 2, 1, "nccl")
    with pytest.raises(ValueError, match="CPU takes gloo"):
        pm.choose_backend("cpu", 2, 0, "nccl")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pm.choose_backend("cuda", 1, 0)


def test_a_mesh_on_the_card_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card on this rank"):
        pm.make_env_mesh()


def test_scaling_report_at_world_1():
    rep = pm.scaling_report(CFG, 16, num_steps=4, engines=("grid", "packed_scan", "fused"),
                            iters=1, device="cpu")
    assert set(rep) == {"grid", "packed_scan", "fused"}
    for r in rep.values():
        assert r["devices"] == 1 and r["n1"] > 0 and math.isfinite(r["n1"])
        assert r["efficiency"] == 1.0
