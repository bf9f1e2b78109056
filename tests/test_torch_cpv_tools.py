"""The CPV tools (``gym_craftingworld_tpu_torch/tools/``: ``cpv_canonical``,
``cpv_matrix`` and their shared ``_cpv``) against the JAX package's
``tools/cpv_canonical.py`` and ``tools/cpv_matrix.py`` on the CPU, at 8x8
with ``max_steps`` 60.

The JAX tools are loaded from their files (``jax_tool``). Pools, datasets and
parameters cross as numpy (``interop``). The integer paths (world edits,
start states, expert collection, relabels, the salvageable filter) must
match bit for bit and leave the shared RandomState where JAX's leaves it;
greedy rollouts match on the envs where the two bf16 forwards order the
logits alike at every visited state; ``sample`` and ``argmax_eps`` draw
from JAX's keys (held to JAX's draws bit for bit by
``tests/test_torch_keyed_imitation.py``) and are held to their
distributions here.
Each tool's ``main`` also runs tiny with ``--device cpu``.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_craftingworld_tpu.api.gym_env import CraftingWorldEnvRay as JEnv
from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.models import grid_policy as jgp
from gym_craftingworld_tpu.train import bc as jbc
from gym_craftingworld_tpu.train import dagger as jdagger
from gym_craftingworld_tpu.train import demos as jdemos
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.api.gym_env import CraftingWorldEnvRay as TEnv
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.models import grid_policy as tgp
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools import _cpv
from gym_craftingworld_tpu_torch.tools import cpv_canonical as cc
from gym_craftingworld_tpu_torch.tools import cpv_matrix as cm
from gym_craftingworld_tpu_torch.train import bc as tbc
from gym_craftingworld_tpu_torch.train import dagger as tdagger
from gym_craftingworld_tpu_torch.train.demos import SnapDataset

from test_torch_canonical_tools import REPO, jax_tool
from test_torch_cpv import cpv_grid_init
from test_torch_packed_rollout import np_tree, tcfg

torch.set_num_threads(1)

CFG = EnvConfig(height=8, width=8, max_steps=60)
FIELDS = [f.name for f in dataclasses.fields(EnvState) if f.name != "rng"]


@pytest.fixture(scope="module")
def jcc():
    return jax_tool("cpv_canonical")


@pytest.fixture(scope="module")
def jcm():
    return jax_tool("cpv_matrix")


@pytest.fixture(scope="module")
def pool(jcc):
    """JAX's 8x8 pool of 16 worlds, as numpy."""
    return jcc.make_pool(CFG, 3, 16)


def same_state(got: EnvState, want) -> None:
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def aligned(r1: np.random.RandomState, r2: np.random.RandomState) -> bool:
    s1, s2 = r1.get_state(), r2.get_state()
    return all(np.array_equal(a, b) for a, b in zip(s1[1:], s2[1:]))


def test_shared_tables_are_jax_s(jcc, jcm):
    assert _cpv.ORDER == jcc._ORDER == jcm._ORDER and _cpv.RANK == jcc._RANK == jcm._RANK
    assert _cpv.EFFECT == jcc._EFFECT == jcm._EFFECT
    assert _cpv.MOVE_ITEM == jcc._MOVE_ITEM == jcm._MOVE_ITEM
    assert _cpv.TOOL_OF == jcc._TOOL_OF and _cpv.MOVE_BIT == jcc._MOVE_BIT


@pytest.mark.parametrize("seed", range(6))
def test_apply_predecessors_np_matches_jax(jcc, pool, seed):
    """Rank-sorted predecessor sets of up to three tasks on one world (every
    task but GoToHouse, the last rank, can precede): the grid, bits, agent
    and holding equal JAX's, and the stream is left where JAX's leaves it."""
    objects, agent = pool
    sets = [[]] + [[t] for t in range(9) if t != 5] + [
        sorted(s, key=_cpv.RANK.get) for s in ([0, 1], [3, 2], [3, 8], [4, 8, 2], [6, 7], [2, 6, 7])]
    r_j, r_t = np.random.RandomState(seed), np.random.RandomState(seed)
    for S in sets:
        w = seed % len(objects)
        o_j, o_t = objects[w].copy(), objects[w].copy()
        a_j, a_t = np.zeros(9, np.int8), np.zeros(9, np.int8)
        start = tuple(int(x) for x in agent[w])
        want = jcc.apply_predecessors_np(o_j, a_j, start, 0, S, r_j)
        got = _cpv.apply_predecessors_np(o_t, a_t, start, 0, S, r_t)
        assert got == want, S
        np.testing.assert_array_equal(o_t, o_j)
        np.testing.assert_array_equal(a_t, a_j)
        assert aligned(r_t, r_j)


@pytest.mark.parametrize("weighted", [False, True])
def test_draw_handoff_batch_matches_jax(jcc, pool, weighted):
    """Two handoff batches from one RandomState: every state field but the
    (never read) key, and the tasks, equal JAX's; the stream stays aligned
    across ``build_start_states``' key draw."""
    w = np.arange(1.0, 10.0)
    p = w / w.sum() if weighted else None
    r_j, r_t = np.random.RandomState(11), np.random.RandomState(11)
    for B in (24, 7):
        js, jt = jcc.draw_handoff_batch(CFG, *pool, B, r_j, task_weights=p)
        ts, tt = cc.draw_handoff_batch(tcfg(CFG), *pool, B, r_t, task_weights=p, device="cpu")
        same_state(ts, js)
        np.testing.assert_array_equal(tt, jt)
        assert aligned(r_t, r_j)
    assert int(ts.holding.sum()) > 0 and int(ts.achieved.sum()) > 0


def test_build_start_states_singles_match_jax(jcc, pool):
    r_j, r_t = np.random.RandomState(5), np.random.RandomState(5)
    widx = np.arange(20) % len(pool[0])
    js, _ = jcc.build_start_states(CFG, *pool, widx, [4] * 20, [[]] * 20, r_j)
    ts, tasks = cc.build_start_states(tcfg(CFG), *pool, widx, [4] * 20, [[]] * 20, r_t, "cpu")
    same_state(ts, js)
    assert aligned(r_t, r_j) and tasks.tolist() == [4] * 20


@pytest.fixture(scope="module")
def expert(jcc, pool):
    """One handoff batch collected by both tools from the same start state."""
    r_j, r_t = np.random.RandomState(2), np.random.RandomState(2)
    js, jt = jcc.draw_handoff_batch(CFG, *pool, 24, r_j)
    ts, tt = cc.draw_handoff_batch(tcfg(CFG), *pool, 24, r_t, device="cpu")
    want = jcc.collect_expert_from(CFG, js, jt, 9, noise_eps=0.1)
    got = cc.collect_expert_from(tcfg(CFG), ts, tt, 9, noise_eps=0.1)
    return want, got


def test_collect_expert_from_matches_jax(expert):
    (w_snaps, w_tasks, w_sr), (g_snaps, g_tasks, g_sr) = expert
    assert g_snaps.num_rows == w_snaps.num_rows > 0 and 0 < g_sr == w_sr
    for k in SnapDataset._fields:
        a, b = getattr(g_snaps, k), getattr(w_snaps, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(g_tasks, w_tasks)


def test_augment_pending_matches_jax(jcc, expert):
    (snaps, tasks, _), _ = expert
    want = jcc.augment_pending(snaps, tasks, 999)
    got = cc.augment_pending(SnapDataset(*snaps), tasks, 999)
    assert 0 < got.num_rows == want.num_rows
    for k in SnapDataset._fields:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k


@pytest.mark.parametrize("workers", [1, 3])
def test_relabel_matches_jax(expert, workers):
    """``relabel`` of the collected rows, in one process and in three spawned
    ones, equals JAX's ``expert_relabel`` row for row."""
    (snaps, _, _), _ = expert
    cols = {k: getattr(snaps, k) for k in tdagger._COL_FIELDS}
    want = jdagger.expert_relabel(CFG, cols)
    got = cc.relabel(tcfg(CFG), cols, workers)
    for k in SnapDataset._fields:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k


def test_phase1_cache_reads_back_as_jax_reads_it(tmp_path, expert):
    """``save_phase1`` writes JAX's layout: JAX's loader (``SnapDataset`` of
    the file's columns, ``tasks``) reads it back equal, dtypes and all."""
    (snaps, tasks, _), _ = expert
    cc.save_phase1(tmp_path / "phase1.npz", SnapDataset(*snaps), tasks)
    z = np.load(tmp_path / "phase1.npz")
    want = jdemos.SnapDataset(**{f: z[f] for f in jdemos.SnapDataset._fields})
    for k in SnapDataset._fields:
        np.testing.assert_array_equal(getattr(want, k), getattr(snaps, k), err_msg=k)
        assert getattr(want, k).dtype == getattr(snaps, k).dtype
    np.testing.assert_array_equal(z["tasks"], tasks)
    data, t = cc.load_phase1(tmp_path / "phase1.npz")
    assert all(np.array_equal(a, b) for a, b in zip(data, snaps)) and np.array_equal(t, tasks)


def test_the_8x8_augment_pending_matches_jax(jcm):
    rng = np.random.default_rng(0)
    n, dim = 200, 8 * 8 * 12 + 18
    feats = (rng.random((n, dim)) < 0.1).astype(np.float32)
    demos = jbc.Demos(feats, rng.integers(0, 6, n).astype(np.int32), np.arange(n, dtype=np.int32))
    tasks = rng.integers(0, 9, n)
    want = jcm.augment_pending(demos, tasks, jcm._RANK, 104, 8 * 8 * 12)
    got = cm.augment_pending(tbc.Demos(*demos), tasks, _cpv.RANK, 104, 8 * 8 * 12)
    assert 0 < len(got.actions) == len(want.actions) < n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_8x8_apply_predecessors_matches_jax(jcm, seed):
    """The façade edit: from the same reset state (the JAX env's, carried
    across), both envs hold the same state afterwards, the port's cache is
    cleared, and the stream is aligned."""
    jenv = JEnv(seed=seed, size=(8, 8), max_steps=60, stacking=False, fixed_init_state=4)
    tenv = TEnv(seed=seed, size=(8, 8), max_steps=60, stacking=False, device="cpu")
    r_j, r_t = np.random.RandomState(seed), np.random.RandomState(seed)
    for S, j in (([0], 1), ([3, 4], 5), ([2, 6], 7), ([], 8)):
        jenv.reset()
        tenv.reset()
        tenv._state = interop.env_state_from_numpy(np_tree(jenv._state), device="cpu")
        tenv._cached = {"observation": None}
        assert jcm.apply_predecessors(jenv, S, j, r_j) == cm.apply_predecessors(tenv, S, j, r_t)
        same_state(tenv._state, jenv._state)
        assert tenv._cached == {} and aligned(r_t, r_j)


# ---------------------------------------------------------------------------
# the policy's rollouts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(jcc, pool):
    """A CPVGridPolicy JAX trained on singles and handoffs from the pool (its
    greedy episodes neither all won nor all lost), its variables as numpy,
    the port's module holding them, the rows it trained on and its optimizer
    state as numpy (JAX's epoch donates the state it is given)."""
    rng = np.random.RandomState(0)
    parts = []
    for j in range(9):
        widx = np.arange(12) % len(pool[0])
        st, tasks = jcc.build_start_states(CFG, *pool, widx, [j] * 12, [[]] * 12, rng)
        parts.append(jcc.collect_expert_from(CFG, st, tasks, j, noise_eps=0.1)[0])
    st, tasks = jcc.draw_handoff_batch(CFG, *pool, 64, rng)
    parts.append(jcc.collect_expert_from(CFG, st, tasks, 50, noise_eps=0.1)[0])
    snaps = jdemos.SnapDataset.concat(*parts)
    model, v = cpv_grid_init(0, channels=16, hidden=64, embed_dim=8)
    ts = jdagger.BCTrainState(v, jdagger._make_tx(3e-3).init(v))
    model, ts, _ = jdagger.bc_train_snaps(CFG, snaps, key=1, model_and_state=(model, ts),
                                          epochs=16, batch_size=128, lr=3e-3)
    params, opt_state = jax.tree.map(np.asarray, (ts.params, ts.opt_state))
    return (model, params, interop.cpv_grid_policy_from_numpy(params, device="cpu"), snaps,
            opt_state)


def agreeing(model, params, port, cols, live) -> np.ndarray:
    """bool[B]: the envs on whose every live visited state (JAX's columns
    [T, B]) the port's forward picks JAX's argmax."""
    T, B = live.shape
    rows = [np.asarray(cols[k]).reshape((T * B,) + np.shape(cols[k])[2:]) for k in tdagger._COL_FIELDS]
    jl, _ = jax.jit(model.apply)(jax.tree.map(jnp.asarray, params), *jgp.planes_from_snaps(CFG, *rows))
    with torch.no_grad():
        tl, _ = port(*tgp.planes_from_snaps(tcfg(CFG), *(torch.from_numpy(r) for r in rows)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
    same = (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).reshape(T, B)
    return (same | ~np.asarray(live)).all(axis=0)


def test_argmax_rollout_and_cell_success_match_jax(jcc, pool, trained):
    """The argmax rollout from a handoff batch (columns, live rows, success)
    and ``eval_cell``'s argmax success per env on a cell, against JAX's, on
    the envs whose argmaxes agree at every visited state (at least all but
    two of 32); the rates equal JAX's where all agree. Some episodes of
    each are won, some lost."""
    model, params, port, *_ = trained
    r_j, r_t = np.random.RandomState(4), np.random.RandomState(4)
    js, _ = jcc.draw_handoff_batch(CFG, *pool, 32, r_j)
    ts, _ = cc.draw_handoff_batch(tcfg(CFG), *pool, 32, r_t, device="cpu")
    cols, live, succ = jcc._rollout_from(CFG, model, params, js, jax.random.PRNGKey(0), "argmax")
    ok = agreeing(model, params, port, cols, live)
    assert ok.sum() >= 30
    tcols, tlive, tsucc = tdagger._rollout_states(tcfg(CFG), port, ts,
                                                  *cc.mode_draws("argmax", 60, 32, prng_key(0)))
    live_j = np.asarray(live)
    np.testing.assert_array_equal(tlive.numpy()[:, ok], live_j[:, ok])
    for k, v in tcols.items():  # the live rows; the port leaves rows past the end zero
        m = live_j[:, ok]
        np.testing.assert_array_equal(v.numpy()[:, ok][m], np.asarray(cols[k])[:, ok][m], err_msg=k)
    np.testing.assert_array_equal(tsucc.numpy()[ok], np.asarray(succ)[ok])
    assert 0 < np.asarray(succ).sum() < 32

    # eval_cell's start state (desired = exactly the cell's bits) and success
    cell, seed, n = (1,), 8041, 32
    widx = np.arange(n) % len(pool[0])
    js, _ = jcc.build_start_states(CFG, *pool, widx, [1] * n, [[]] * n, np.random.RandomState(seed))
    des = np.zeros((n, 9), np.int8)
    des[:, list(cell)] = 1
    js = js.replace(desired=jnp.asarray(des))
    cols, live, _ = jcc._rollout_from(CFG, model, params, js, jax.random.PRNGKey(0), "argmax")
    ok = agreeing(model, params, port, cols, live)
    assert ok.sum() >= n - 2
    want, _ = jcc._success_from(CFG, model, params, js, jax.random.PRNGKey(seed + 17), "argmax")
    ts = interop.env_state_from_numpy(np_tree(js), device="cpu")
    got, _ = cc._success_from(tcfg(CFG), port, ts, "argmax", prng_key(seed + 17))
    np.testing.assert_array_equal(got.numpy()[ok], np.asarray(want)[ok])
    assert 0 < np.asarray(want).sum() < n
    if ok.all():
        w = jcc.eval_cell(CFG, model, params, *pool, cell, seed, n)["argmax"]
        assert cc.eval_cell(tcfg(CFG), port, *pool, cell, seed, n)["argmax"] == w


def test_bc_train_snaps_one_epoch_of_the_cpv_policy_matches_jax(trained):
    """One epoch of ``bc_train_snaps`` on the CPVGridPolicy (goal through the
    plan vector only), continued from JAX's carried ``BCTrainState`` with
    JAX's permutation over the CPV tool's own rows, as
    ``tests/test_torch_dagger.py`` holds it for the GridPolicy: the loss
    within rtol 1e-3 / atol 1e-3 (measured 1.2e-5), the accuracy within 2
    rows a minibatch, atol 2/256 (measured 4.9e-4), every parameter within
    2e-3 relative L2 (measured max 4.4e-4, ``conv0.bias``), the Adam count
    exact."""
    model, params, _, snaps, opt_state = trained
    key = jax.random.PRNGKey(7)
    start = jdagger.BCTrainState(*jax.tree.map(jnp.asarray, (params, opt_state)))
    _, jts, jh = jdagger.bc_train_snaps(CFG, snaps, key, model_and_state=(model, start), epochs=1,
                                        batch_size=256, lr=3e-4)
    # the permutation bc_train_snaps draws from ``key``
    key, _ = jax.random.split(key)
    _, k_perm = jax.random.split(key)
    perm = np.array(jax.random.permutation(k_perm, snaps.num_rows))
    tts, th = tdagger.bc_train_snaps(tcfg(CFG), snaps, prng_key(7),
                                     state=interop.bc_train_state_from_numpy(params, opt_state,
                                                                             device="cpu"),
                                     epochs=1, batch_size=256, lr=3e-4, perms=[perm])
    assert snaps.num_rows > 2 * 256
    np.testing.assert_allclose(th[0]["loss"], jh[0]["loss"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(th[0]["accuracy"], jh[0]["accuracy"], rtol=0, atol=2 / 256)
    want = interop._flat_tree(jax.tree.map(np.asarray, jts.params["params"]))
    got = {k: v.detach().numpy() for k, v in tts.params.named_parameters()}
    assert sorted(got) == sorted(want) and "task_embed" in got
    for k, w in want.items():  # (the value head takes no gradient: zeros both)
        assert np.linalg.norm(got[k] - w) <= 2e-3 * np.linalg.norm(w), k
    assert int(tts.opt_state.count) == int(jax.tree.map(np.asarray, jts.opt_state)[1][0].count)


def test_cell_seeds_are_jax_s():
    """The seeds JAX's matrix gives a single, a pair and a triple
    (``tools/cpv_canonical.py:672-694``)."""
    assert cc.cell_seed(7, (3,)) == 7 + 7001 + 3
    assert cc.cell_seed(7, (2, 5)) == 7 + 8001 + 10 * 2 + 5
    assert cc.cell_seed(7, (1, 4, 8)) == 7 + 9001 + 1 + 10 * 4 + 100 * 8


def test_trace_cell_replays_eval_cell(pool, trained):
    """``trace_cell`` rolls a cell's episodes as ``eval_cell`` does: the same
    success rate in both modes; its failure classes add up to the failures,
    and every failure misses a desired bit or holds an undesired one."""
    _, _, port, *_ = trained
    for cell in ((1,), (1, 3)):
        seed = cc.cell_seed(5, cell)
        rates = cc.eval_cell(tcfg(CFG), port, *pool, cell, seed, 32)
        trace = cc.trace_cell(tcfg(CFG), port, *pool, cell, seed, 32)
        for mode, rec in trace.items():
            assert rec["success"] == rates[mode]
            failed = round(32 * (1 - rec["success"]))
            assert rec["wrong_latch"] + rec["stall"] + rec["timeout"] == failed > 0
            assert sum(rec["missing"].values()) + sum(rec["undesired"].values()) >= failed
    assert rates["sample"] < 1 and trace["sample"]["success"] == rates["sample"]


class Fixed(torch.nn.Module):
    """A policy whose logits are one row for every env."""

    def __init__(self, logits):
        super().__init__()
        self.logits = torch.nn.Parameter(torch.tensor(logits, dtype=torch.float32))

    def forward(self, planes, extras):
        B = planes.shape[0]
        return self.logits.expand(B, -1), torch.zeros(B)


def test_sample_draws_follow_the_softmax(pool):
    """``sample``: the action of ``_greedy`` under ``mode_draws``' Gumbel noise
    is a draw from the policy's softmax; each action's share over 60 x 2,000
    draws within 4 binomial sigma of its probability."""
    logits = [1.0, 0.0, -1.0, 2.0, 0.5, -3.0]
    p = torch.softmax(torch.tensor(logits), 0).numpy()
    T, B = 60, 2000
    _, _, eps, noise = cc.mode_draws("sample", T, B, prng_key(3))
    assert eps == 0.0 and noise.shape == (T, B, 6)
    ts, _ = cc.build_start_states(tcfg(CFG), *pool, np.arange(B) % 16, [0] * B, [[]] * B,
                                  np.random.RandomState(0), "cpu")
    acts = torch.stack([tdagger._greedy(tcfg(CFG), Fixed(logits), ts, noise[t]) for t in range(T)])
    share = np.bincount(acts.numpy().reshape(-1), minlength=6) / acts.numel()
    sigma = np.sqrt(p * (1 - p) / acts.numel())
    assert np.all(np.abs(share - p) <= 4 * sigma), (share, p)
    assert tdagger._greedy(tcfg(CFG), Fixed(logits), ts).unique().tolist() == [3]


def test_argmax_eps_moves_five_percent():
    """``argmax_eps``: 5% of the steps take a random move, each of the four
    moves a quarter of them, within 4 binomial sigma; ``argmax`` none."""
    T, B = 300, 4000
    u, a, eps, noise = cc.mode_draws("argmax_eps", T, B, prng_key(5))
    assert eps == 0.05 and noise is None
    moved = (u < eps).numpy()
    n = moved.size
    assert abs(moved.mean() - 0.05) <= 4 * np.sqrt(0.05 * 0.95 / n)
    picks = a.numpy()[moved]
    assert picks.min() >= 0 and picks.max() <= 3
    share = np.bincount(picks, minlength=4) / len(picks)
    assert np.all(np.abs(share - 0.25) <= 4 * np.sqrt(0.25 * 0.75 / len(picks))), share
    u, a, eps, noise = cc.mode_draws("argmax", T, B, prng_key(5))
    assert u is None and a is None and eps == 0.0 and noise is None


def test_salvageable_filter_matches_jax(jcc, monkeypatch):
    """``dagger_collect``'s filter on the same columns: JAX's (its rollout and
    relabel replaced by the given columns and the identity) against
    ``salvageable``."""
    rng = np.random.default_rng(1)
    T, B = 20, 12
    cols = {k: rng.integers(0, 100, (T, B)).astype(np.int16) for k in tdagger._COL_FIELDS}
    cols["occ_key"] = rng.integers(0, 66, (T, B, 8)).astype(np.int16)
    cols["achieved"] = rng.integers(0, 512, (T, B)).astype(np.int16)
    cols["desired"] = rng.integers(0, 512, (T, B)).astype(np.int16) | cols["achieved"] * (
        rng.random((T, B)) < 0.5)
    live = rng.random((T, B)) < 0.8
    tasks = rng.integers(0, 9, B)
    monkeypatch.setattr(jcc, "_rollout_from", lambda *a: (
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(live), jnp.zeros(B, bool)))
    monkeypatch.setattr(jcc, "dagger", SimpleNamespace(_LATCH_MASK=jdagger._LATCH_MASK,
                                                       expert_relabel=lambda cfg, host: host))
    want, want_tasks, _ = jcc.dagger_collect(CFG, None, None, None, tasks, 0)
    got, got_tasks = cc.salvageable(cols, live, tasks)
    assert 0 < len(got_tasks) < live.sum()
    np.testing.assert_array_equal(got_tasks, want_tasks)
    for k in cols:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the tools' main, tiny
# ---------------------------------------------------------------------------


class Cut(Exception):
    pass


def test_cpv_canonical_main_resumes_and_reruns_its_matrix(tmp_path, monkeypatch):
    """``--smoke`` with two DAgger rounds writes ``docs/cpv_matrix.json``'s
    keys and the card; a run cut after round 0 and carried on with
    ``--resume`` writes the same JSON, and ``--matrix-only`` from the
    unbroken run's ``params.pt`` the same matrix; each round appended its
    relabelled rows and their copies."""
    pairs = cc.PAIRS[:4]
    base = ["--smoke", "--dagger-rounds", "2"]
    full = cc.main(base + ["--out", str(tmp_path / "full.json"), "--save-params", str(tmp_path / "a")],
                   pairs)
    doc = json.loads((tmp_path / "full.json").read_text())
    jax_doc = json.loads((REPO / "docs" / "cpv_matrix.json").read_text())
    assert set(doc) == set(jax_doc) | {"card"} and doc["card"] == "cpu"
    assert set(doc["config"]) == set(jax_doc["config"]) and doc == full["results"]
    assert [len(doc[k]) for k in ("singles", "pairs", "triples")] == [9, 4, 1]
    rounds = full["rounds"]
    assert [r["mode"] for r in rounds] == ["argmax_eps", "sample"]
    assert all(r["rows_after"] == r["rows_before"] + r["relabelled"] + r["augmented"] > r["rows_before"]
               for r in rounds)

    save_round = cc.save_round

    def cut(out, r, *args):
        save_round(out, r, *args)
        raise Cut

    monkeypatch.setattr(cc, "save_round", cut)
    cut_args = base + ["--out", str(tmp_path / "cut.json"), "--save-params", str(tmp_path / "b")]
    with pytest.raises(Cut):
        cc.main(cut_args, pairs)
    monkeypatch.setattr(cc, "save_round", save_round)
    resumed = cc.main(cut_args + ["--resume"], pairs)
    assert [r["round"] for r in resumed["rounds"]] == [1] and resumed["rounds"][0] == {
        **rounds[1], "collect_s": resumed["rounds"][0]["collect_s"],
        "train_s": resumed["rounds"][0]["train_s"]}
    assert json.loads((tmp_path / "cut.json").read_text()) == doc
    again = cc.main(base + ["--matrix-only", "--out", str(tmp_path / "again.json"),
                            "--save-params", str(tmp_path / "a")], pairs)
    assert again["results"] == doc and again["rounds"] == [] and again["phase1"] is None


def test_compare_with_jax_on_the_jax_record(tmp_path):
    """The record against itself: every difference 0 and every bound held
    (JAX's pair min 0.617, triple mean 0.724, worst cell 0.305); one pair cut
    to 0.49 misses the pair-min bound and leads the cells most below JAX's.
    ``--compare`` writes the comparison beside the file it reads."""
    jax_doc = json.loads(cc.JAX_RECORD.read_text())
    same = cc.compare_with_jax(jax_doc, jax_doc)
    assert all(b["held"] and b["value"] == b["jax"] for b in same["bounds"].values())
    assert same["bounds"]["cell_min"]["value"] == pytest.approx(0.3046875)
    assert len(same["sampled"]["diff"]) == 36 + 84 and set(same["argmax"]["diff"].values()) == {0.0}
    worse = json.loads(json.dumps(jax_doc))
    worse["pairs"]["MakeBread+ChopTree"] = worse["pair_min"] = 0.49
    got = cc.compare_with_jax(worse, jax_doc)
    assert not got["bounds"]["pair_min"]["held"] and got["bounds"]["pair_mean"]["held"]
    assert got["sampled"]["most_below_jax"][0][0] == "MakeBread+ChopTree"
    path = tmp_path / "m.json"
    path.write_text(json.dumps(worse))
    cmp = cc.main(["--compare", str(path)])["compare"]
    assert json.loads(json.dumps(cmp)) == json.loads((tmp_path / "m_vs_jax.json").read_text())


JAX_MATRIX_KEYS = {  # the keys tools/cpv_matrix.py:main writes (:464-533)
    "train_accuracy", "config", "singles", "pairs", "triples", "pairs_argmax", "triples_argmax",
    "pair_mean", "pair_min", "pair_mean_argmax", "pair_min_argmax", "execution"}


def test_cpv_matrix_main_writes_the_jax_keys(tmp_path):
    out = tmp_path / "m.json"
    doc = cm.main(["--device", "cpu", "--episodes-per-task", "2", "--epochs", "1",
                   "--pair-episodes", "1", "--dagger-rounds", "1", "--dagger-episodes", "2",
                   "--hidden", "16", "--triples", "1", "--triple-episodes", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == doc
    assert set(doc) == JAX_MATRIX_KEYS | {"card"} and doc["card"] == "cpu"
    assert len(doc["singles"]) == 9 and len(doc["pairs"]) == len(doc["pairs_argmax"]) == 36
    assert len(doc["triples"]) == 1 and 0.0 <= doc["train_accuracy"] <= 1.0
