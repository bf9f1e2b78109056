"""The grid policy's features and forward (``models/grid_policy``) against the
JAX package's, on the CPU.

States come from JAX's reset and random rollout, carried over by
``interop``. Snapshot columns, planes and extras are integers or exact bf16
and must match bit for bit; the bf16 forward within the tolerance stated at
its test, beside the error measured when it was written.
"""

import jax
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.models import grid_policy as jgp
from gym_craftingworld_tpu.train import dagger as jdagger
from gym_craftingworld_tpu.train import demos as jdemos
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.models import grid_policy as tgp
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import demos as tdemos

from test_torch_packed_rollout import np_tree, tcfg

torch.set_num_threads(1)

CONFIGS = {"8x8": jcw.EnvConfig(height=8, width=8, max_steps=100),
           "21x21": jcw.EnvConfig(height=21, width=21, max_steps=300)}
COLS = ("occ_key", "occ_code", "init_key", "init_agent_key", "agent_key", "holding", "desired",
        "achieved")


def host(tree):
    return jax.tree.map(np.asarray, tree)


def grid_init(cfg, seed, channels, hidden):
    """``init_grid_policy``'s (model, variables), the init jitted (flax's
    eager init compiles op by op)."""
    model = jgp.GridPolicy(channels=channels, hidden=hidden)
    dummy = (jax.numpy.zeros((1, cfg.height, cfg.width, jgp.N_PLANES), jax.numpy.bfloat16),
             jax.numpy.zeros((1, jgp.N_EXTRAS), jax.numpy.bfloat16))
    return model, jax.jit(model.init)(jax.random.PRNGKey(seed), *dummy)


def mid_episode(cfg, seed, steps, batch=16):
    """A JAX state after ``steps`` random steps (held items, crafted and
    removed objects) and the port's copy of it."""
    st = jcw.reset_from_seed(cfg, seed, batch)
    st, _ = jcw.rollout_random(cfg, st, jax.random.PRNGKey(seed), steps)
    return st, interop.env_state_from_numpy(np_tree(st), device="cpu")


def bits(x) -> np.ndarray:
    """A bf16 tensor or array as its raw 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_snap_columns_equal_jax_and_the_host_extraction(name):
    """``snap_columns_from_state`` (argsort of the empty flags, the init
    argmaxes, the goal masks as an int32 sum) equals JAX's column for column,
    dtypes included, and the host numpy extraction of ``train/demos``."""
    cfg = CONFIGS[name]
    st, tst = mid_episode(cfg, 3, 37)
    got = tgp.snap_columns_from_state(tcfg(cfg), tst)
    want = host(jgp.snap_columns_from_state(cfg, st))
    assert set(got) == set(want) == set(COLS)
    for k in COLS:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    flat = np.asarray(st.objects).reshape(16, -1)
    occ_key, occ_code = tdemos.occupancy_from_grids(flat, cfg.n_cells)
    init_key, init_agent_key = tdemos.init_keys_from_grids(
        np.asarray(st.init_objects).reshape(16, -1))
    for k, v in dict(occ_key=occ_key, occ_code=occ_code, init_key=init_key,
                     init_agent_key=init_agent_key,
                     desired=tdemos.bits_to_mask(np.asarray(st.desired)),
                     achieved=tdemos.bits_to_mask(np.asarray(st.achieved))).items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_planes_equal_jax_both_ways(name):
    """``planes_from_state`` and ``planes_from_snaps`` equal JAX's, bf16 bit
    for bit (the extras' row and column divided in bf16 included), and each
    other."""
    cfg = CONFIGS[name]
    st, tst = mid_episode(cfg, 9, 55)
    tc = tcfg(cfg)
    jp, je = jgp.planes_from_state(cfg, st)
    tp, te = tgp.planes_from_state(tc, tst)
    assert tp.dtype == te.dtype == torch.bfloat16
    assert tuple(tp.shape) == (16, cfg.height, cfg.width, tgp.N_PLANES) == jp.shape
    assert tuple(te.shape) == (16, tgp.N_EXTRAS) == je.shape
    np.testing.assert_array_equal(bits(tp), bits(jp))
    np.testing.assert_array_equal(bits(te), bits(je))
    cols = tgp.snap_columns_from_state(tc, tst)
    sp, se = tgp.planes_from_snaps(tc, *(cols[k] for k in COLS))
    assert torch.equal(sp.view(torch.int16), tp.view(torch.int16))
    assert torch.equal(se.view(torch.int16), te.view(torch.int16))
    jc = jgp.snap_columns_from_state(cfg, st)
    jsp, jse = jgp.planes_from_snaps(cfg, *(jc[k] for k in COLS))
    np.testing.assert_array_equal(bits(sp), bits(jsp))
    np.testing.assert_array_equal(bits(se), bits(jse))


def test_extras_divide_every_row_as_jax():
    """The agent's row and column over the grid size, in bf16, for every cell
    of grids 1..256 wide (every size a bf16 holds exactly): JAX's bf16
    division by the weak-typed size, bit for bit."""
    n = np.concatenate([np.full(k, k) for k in range(1, 257)]).astype(np.int32)
    r = np.concatenate([np.arange(k) for k in range(1, 257)]).astype(np.int32)
    bf = jax.numpy.bfloat16
    want = jax.numpy.asarray(r).astype(bf) / jax.numpy.asarray(n).astype(bf)
    t = torch.from_numpy(r).to(torch.bfloat16)
    np.testing.assert_array_equal(bits(t / torch.from_numpy(n).to(torch.bfloat16)), bits(want))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grids_from_snaps_round_trip(name):
    """The port's snapshot columns rebuild the state's grids through the
    copied ``grids_from_snaps``."""
    cfg = CONFIGS[name]
    st, tst = mid_episode(cfg, 5, 40)
    cols = {k: v.numpy() for k, v in tgp.snap_columns_from_state(tcfg(cfg), tst).items()}
    n = len(cols["agent_key"])
    snaps = tdemos.SnapDataset(action=np.zeros(n, np.int8), episode=np.zeros(n, np.int32),
                               **{k: cols[k] for k in jdagger._COL_FIELDS})
    objects, init_objects = tdemos.grids_from_snaps(tcfg(cfg), snaps, np.arange(n))
    np.testing.assert_array_equal(objects, np.asarray(st.objects))
    np.testing.assert_array_equal(init_objects, np.asarray(st.init_objects))
    jo, ji = jdemos.grids_from_snaps(cfg, snaps, np.arange(n))
    np.testing.assert_array_equal(objects, jo)
    np.testing.assert_array_equal(init_objects, ji)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grid_policy_matches_flax(name):
    """Three 3x3 SAME convs, the 1x1 squeeze, dense layers on the flattened
    (h, w, c) features and the extras, against flax's apply. rtol 2e-2 /
    atol 2e-2 (measured max 1.5e-8 on 8x8, 9.8e-9 on 21x21: the same
    rounding points, f32 head products summed in another order)."""
    cfg = CONFIGS[name]
    st, tst = mid_episode(cfg, 1, 30)
    model, v = grid_init(cfg, 0, channels=16, hidden=64)
    jl, jv = jax.jit(model.apply)(v, *jgp.planes_from_state(cfg, st))
    port = interop.grid_policy_from_numpy(host(v), device="cpu")
    with torch.no_grad():
        tl, tv = tgp.apply_from_state(port, tcfg(cfg), tst)
    assert tl.dtype == tv.dtype == torch.float32 and tuple(tv.shape) == (16,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-2, atol=2e-2)


def test_flax_tree_round_trips():
    """A flax tree into the port's module and back, exactly; the port's own
    initialiser gives every parameter the tree's name and shape."""
    cfg = CONFIGS["8x8"]
    tree = host(grid_init(cfg, 0, 8, 32)[1])
    back = interop.flax_params_to_numpy(interop.grid_policy_from_numpy(tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    drawn = tgp.init_grid_policy(prng_key(0), tcfg(cfg), 8, 32)
    assert jax.tree.map(np.shape, interop.flax_params_to_numpy(drawn)) == \
        jax.tree.map(np.shape, tree)
