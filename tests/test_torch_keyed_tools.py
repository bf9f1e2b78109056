"""The tools' draws on JAX's keys (``gym_craftingworld_tpu_torch/tools/``,
``parallel/dryrun.py``) against the JAX package's tools on the CPU.

``finetune_canonical``'s update, ``pixel_distill``'s rollouts, flips and
sampled evaluation, and the synthetic inputs of ``scaling_artifact``,
``ppo_prof``, ``fused_update_bench`` and the dry run's path 6 draw what
the JAX tools draw from the same key data: keys, resets, ``randint``,
``permutation``, ``bernoulli`` and uniforms bit for bit, Gumbel noise within
2 ulps and normals within 128 ulps (``tests/test_torch_threefry.py``'s
bounds; bfloat16 normals within 2 bfloat16 ulps). The package is also read
for draws that bypass the key chain (``test_no_generator_draws_left``).
Everything runs on the CPU, where the keyed draws take their plain version.
"""

import ast
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_craftingworld_tpu.core.reset import reset as jreset
from gym_craftingworld_tpu.models import grid_policy as jgp
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.models.cnn import init_student
from gym_craftingworld_tpu_torch.ops import fused_update as fu
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.parallel import sharded_engine as se
from gym_craftingworld_tpu_torch.tools import finetune_canonical as ftc
from gym_craftingworld_tpu_torch.tools import fused_update_bench, ppo_prof
from gym_craftingworld_tpu_torch.tools import pixel_distill as pd
from gym_craftingworld_tpu_torch.tools import scaling_artifact as sa
from gym_craftingworld_tpu_torch.train import ppo as tppo

from test_torch_canonical_tools import REPO, jax_tool
from test_torch_dagger import CFG, host
from test_torch_finetune_distill import assert_same, jax_flips
from test_torch_keyed_ladder import bf16_ulps, port_key
from test_torch_keyed_trainers import NOISE_ULPS, noise_ulps
from test_torch_packed_rollout import assert_tree_equal, np_tree, tcfg
from test_torch_threefry import ulps

torch.set_num_threads(1)

NORMAL_ULPS = 128  # float32 normals: torch's erfinv against XLA's (test_torch_threefry.py)


def jax_noise(keys, B: int) -> np.ndarray:
    """``categorical``'s float32 Gumbel noise of each step key: [T, B, 6]."""
    return np.stack([np.asarray(jax.random.gumbel(k, (B, 6), jnp.float32)) for k in keys])


# ---------------------------------------------------------------------------
# finetune_canonical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [9, 10])
def test_finetune_draw_is_jax_s(seed):
    """``finetune_canonical.draw`` from ``PRNGKey(seed)``, as JAX's
    ``train_step`` splits it (8x8, 16 envs, T = 8, two epochs): the next key,
    the pool (the reset of ``split(k_pool, 2B)``, every field), the Gumbel
    noise of ``split(k_roll, T)`` within 2 ulps and the permutations of
    ``split(k_perm, 2)`` equal JAX's."""
    B, ft = 16, ftc.FTConfig(rollout_steps=8, update_epochs=2)
    key = jax.random.PRNGKey(seed)
    nxt, k_pool, k_roll, k_perm = jax.random.split(key, 4)
    got_key, (pool, noise, perms) = ftc.draw(tcfg(CFG), ft, B, port_key(key))
    assert torch.equal(got_key, port_key(nxt))
    assert_tree_equal(interop.env_state_to_numpy(pool),
                      np_tree(jreset(CFG, jax.random.key_data(jax.random.split(k_pool, 2 * B)))))
    want = jax_noise(jax.random.split(k_roll, ft.rollout_steps), B)
    assert noise.dtype == torch.float32 and noise_ulps(noise, want) <= NOISE_ULPS
    assert_same(perms, np.stack([np.asarray(jax.random.permutation(k, ft.rollout_steps * B))
                                 for k in jax.random.split(k_perm, ft.update_epochs)]))


# ---------------------------------------------------------------------------
# pixel_distill
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jpd():
    return jax_tool("pixel_distill")


@pytest.fixture(scope="module")
def fresh_teacher():
    """A fresh GridPolicy(8, 32) of JAX's init and the port's module holding
    its parameters: their forwards agree to ~1e-8, far inside any gap of two
    logits a greedy rollout meets here."""
    model, params = jgp.init_grid_policy(jax.random.PRNGKey(0), CFG, 8, 32)
    return model, params, interop.grid_policy_from_numpy(host(params), device="cpu")


def test_collect_round_draws_and_rows_are_jax_s(jpd, fresh_teacher, monkeypatch):
    """``collect_round`` of a fresh teacher (two chunks of 12 episodes, eps
    0.3): chunk ``i`` resets from JAX's ``split(PRNGKey(seed + i), B)`` and
    explores with JAX's draws of ``PRNGKey(seed ^ (7 + i))`` (step ``t``'s
    ``k_u, k_a = split(split(key, T)[t])``, ``uniform(k_u, (B,))`` and
    ``randint(k_a, (B,), 0, 4)``), and the rows it keeps, with and without
    ``fail_cap``, and its success rate equal the JAX tool's."""
    model, params, port = fresh_teacher
    B, seed, T = 12, 21, CFG.max_steps
    seen = []
    rollout = pd._rollout_collect

    def record(cfg, kind, model_, state, u, a, eps):
        seen.append((state, u, a))
        return rollout(cfg, kind, model_, state, u, a, eps)

    monkeypatch.setattr(pd, "_rollout_collect", record)
    rows = []
    for fail_cap in (None, 5):
        want, wsr = jpd.collect_round(CFG, "grid", model, params, 2 * B, seed, 0.3, chunk=B,
                                      fail_cap=fail_cap)
        got, sr = pd.collect_round(tcfg(CFG), "grid", port, 2 * B, seed, 0.3, chunk=B,
                                   fail_cap=fail_cap)
        assert sr == wsr and sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], k)
        rows.append(len(want["agent_key"]))
    assert 0 < rows[1] < rows[0]  # the cap dropped rows of failed episodes
    for i, (state, u, a) in enumerate(seen[:2]):
        keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed + B * i), B))
        assert_tree_equal(interop.env_state_to_numpy(state), np_tree(jreset(CFG, keys)))
        ks = [jax.random.split(k) for k in jax.random.split(jax.random.PRNGKey(seed ^ (7 + B * i)), T)]
        assert_same(u, np.stack([np.asarray(jax.random.uniform(k[0], (B,))) for k in ks]))
        assert_same(a, np.stack([np.asarray(jax.random.randint(k[1], (B,), 0, 4)) for k in ks]))


@pytest.mark.parametrize("seed", [5, 1003])
def test_flip_bits_are_augment_flips_draws(seed):
    """An epoch's ``flip_bits`` of ``PRNGKey(seed)``: minibatch ``i``'s row is
    JAX's ``augment_flips`` draw from ``fold_in(PRNGKey(seed), i)``."""
    key = jax.random.PRNGKey(seed)
    fh, fw = pd.flip_bits(port_key(key), 5, 64)
    assert fh.shape == fw.shape == (5, 64) and fh.dtype == torch.bool
    for i in range(5):
        wh, ww = jax_flips(jax.random.fold_in(key, i), 64)
        np.testing.assert_array_equal(fh[i].numpy(), wh)
        np.testing.assert_array_equal(fw[i].numpy(), ww)


def test_eval_student_sample_chain_is_jax_s(monkeypatch):
    """``eval_student(mode="sample")`` over two chunks of 8: chunk ``i``'s
    worlds are the reset of ``split(PRNGKey(seed + 31 i), 8)`` and its noise
    is the JAX tool's ``while_loop`` chain from the first env's key, ``k, k_t
    = split(k)`` a step, ``gumbel(k_t, (B, 6))`` (within 2 ulps), not
    ``split(k, T)``; the argmax mode draws nothing."""
    student = init_student(prng_key(1), tcfg(CFG), channels=8, hidden=32, stem=8)
    seen = []
    ev = pd._eval_student
    monkeypatch.setattr(pd, "_eval_student", lambda cfg, model, state, noise=None: (
        seen.append((state, noise)), ev(cfg, model, state, noise))[1])
    res = pd.eval_student(tcfg(CFG), student, 16, 3, chunk=8, mode="sample")
    assert res["episodes"] == 16 and len(seen) == 2
    for i, (state, noise) in enumerate(seen):
        keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(3 + 31 * 8 * i), 8))
        assert_tree_equal(interop.env_state_to_numpy(state), np_tree(jreset(CFG, keys)))
        k, steps = jax.random.wrap_key_data(keys[0]), []
        for _ in range(CFG.max_steps):
            k, k_t = jax.random.split(k)
            steps.append(k_t)
        assert noise.shape == (CFG.max_steps, 8, 6)
        assert noise_ulps(noise, jax_noise(steps, 8)) <= NOISE_ULPS
        wrong = jax_noise(jax.random.split(jax.random.wrap_key_data(keys[0]), 4), 8)
        assert not np.allclose(noise[:4].numpy(), wrong)
    seen.clear()
    pd.eval_student(tcfg(CFG), student, 8, 3, chunk=8)
    assert seen[0][1] is None


# ---------------------------------------------------------------------------
# the synthetic inputs of the bench tools and the dry run
# ---------------------------------------------------------------------------


def test_scaling_artifact_scan_actions_are_jax_s(monkeypatch):
    """Each timed run of ``run_gpu``'s plain packed scan steps JAX's
    ``randint(PRNGKey(2), (T, B), 0, 6)`` (int32), at T and T/2."""
    seen = []
    scan = se.rollout_p_sharded
    monkeypatch.setattr(se, "rollout_p_sharded", lambda cfg, slots, actions, T, mesh: (
        seen.append(actions), scan(cfg, slots, actions, T, mesh))[1])
    sa.run_gpu(None, iters=1, scan_steps=8, device="cpu", envs=32, fused_steps=8)
    assert [a.shape[0] for a in seen] == [8, 8, 4, 4]  # a warm-up and a timed run each
    for a in seen:
        want = jax.random.randint(jax.random.PRNGKey(2), (a.shape[0], 32), 0, 6, jnp.int32)
        assert_same(a, np.asarray(want))


def test_ppo_prof_stage_inputs_are_jax_s(monkeypatch):
    """``ppo_prof``'s stages draw as the JAX tool's scans from its one key
    ``PRNGKey(0)``: the resets from ``split(c, B)`` of the chain ``c =
    ks[0]``, the steps ``randint(ka, (B,), 0, 6)`` of ``kk, ka = split(kk)``,
    and the update epoch's rows ``permutation(PRNGKey(0), T * B)``."""
    B, steps = 16, 3
    monkeypatch.setenv("B", str(B))
    monkeypatch.setattr(ppo_prof.P, "PPOConfig",
                        functools.partial(tppo.PPOConfig, hidden=32, rollout_steps=8))
    monkeypatch.setattr(ppo_prof, "STAGE_STEPS", steps)
    resets, actions, perms = [], [], []
    reset, step, permutation = ppo_prof.reset, ppo_prof.step, kd.permutation
    monkeypatch.setattr(ppo_prof, "reset", lambda cfg, keys: (resets.append(keys),
                                                              reset(cfg, keys))[1])
    monkeypatch.setattr(ppo_prof, "step", lambda cfg, st, a: (actions.append(a),
                                                              step(cfg, st, a))[1])
    monkeypatch.setattr(kd, "permutation", lambda key, n: (
        lambda p: (perms.append((key, n, p)), p)[1])(permutation(key, n)))
    ppo_prof.main(["--device", "cpu", "--reps", "1"])
    key = jax.random.PRNGKey(0)
    c, kk, want_keys, want_actions = key, key, [], []
    for _ in range(steps):
        ks = jax.random.split(c, B)
        want_keys.append(port_key(ks))
        c = ks[0]
        kk, ka = jax.random.split(kk)
        want_actions.append(np.asarray(jax.random.randint(ka, (B,), 0, 6)))
    assert len(resets) == len(actions) == 2 * steps  # the warm-up and one timed run
    for got, want in zip(resets, want_keys * 2):
        assert torch.equal(got, want)
    for got, want in zip(actions, want_actions * 2):
        assert_same(got, want)
    n = 8 * B
    mine = [p for k, m, p in perms if m == n and torch.equal(k, prng_key(0))]
    assert len(mine) == 2
    for p in mine:
        assert_same(p, np.asarray(jax.random.permutation(key, n)))


def check_minibatch(got, kb, n: int, F: int, rows: int = 0) -> None:
    """``got`` (features, action, old_lp, old_v, adv, ret) against the JAX
    draws of ``kb``: features ``normal(kb[0], (rows or n, F), bf16)``."""
    x, action, old_lp, *normals = got
    assert x.dtype == torch.bfloat16 and x.shape == (rows or n, F)
    assert bf16_ulps(x, jax.random.normal(kb[0], (rows or n, F), jnp.bfloat16)) <= 2
    assert_same(action, np.asarray(jax.random.randint(kb[1], (n,), 0, 6, jnp.int32)))
    assert_same(old_lp, np.full((n,), -np.log(6.0), np.float32))
    for got_i, k in zip(normals, kb[2:5]):
        assert got_i.dtype == torch.float32
        assert ulps(got_i, jax.random.normal(k, (n,), jnp.float32)) <= NORMAL_ULPS


def test_fused_update_bench_inputs_are_jax_s(monkeypatch, capsys):
    """``fused_update_bench``'s minibatch is the JAX tool's draw of
    ``split(PRNGKey(1), 6)`` (its features drawn for the eight minibatches'
    blocks), its blocks ``permutation(kb[5], blocks)``'s first."""
    seen = []
    grads = fu.fused_minibatch_grads_indexed
    monkeypatch.setattr(fu, "fused_minibatch_grads_indexed", lambda fppo, params, featb, ids, rest:
                        (seen.append((featb, ids, rest)), grads(fppo, params, featb, ids, rest))[1])
    line = fused_update_bench.main(["256", "64", "--device", "cpu"])
    featb, ids, rest = seen[0]
    NB, BLK, F = featb.shape
    n = line["rows"]
    kb = jax.random.split(jax.random.PRNGKey(1), 6)
    check_minibatch((featb.reshape(NB * BLK, F), *rest), kb, n, F, rows=NB * BLK)
    assert_same(ids, np.asarray(jax.random.permutation(kb[5], NB))[: n // BLK])


def test_dryrun_path_6_minibatch_is_the_graft_entry_s():
    """``random_minibatch(PRNGKey(12), N, F)``, the dry run's path 6, against
    ``__graft_entry__.py``'s ``split(PRNGKey(12), 5)`` draws."""
    kb, got = fu.random_minibatch(prng_key(12), 512, 67)
    assert torch.equal(kb, port_key(jax.random.split(jax.random.PRNGKey(12), 5)))
    check_minibatch(got, jax.random.split(jax.random.PRNGKey(12), 5), 512, 67)
    assert math.isclose(float(got[2][0]), -math.log(6.0), rel_tol=1e-7)


# ---------------------------------------------------------------------------
# no draw left outside the key chain
# ---------------------------------------------------------------------------

GENERATOR_CALLS = {"Generator", "rand", "randn", "randint", "randperm", "rand_like",
                   "randn_like", "randint_like", "bernoulli", "multinomial", "normal",
                   "manual_seed", "seed"}
# (file, call) -> why JAX has no key there; empty: every draw follows JAX's keys
EXCEPTIONS: dict = {}


def generator_draws() -> list:
    """Every call ``torch.<name>(...)`` (or ``torch.cuda.<name>``) of a draw
    outside the key chain in the package: (file, line, name)."""
    found = []
    for path in sorted((REPO / "gym_craftingworld_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                continue
            owner = ast.unparse(node.func.value)
            if owner in ("torch", "torch.cuda", "torch.random") and node.func.attr in GENERATOR_CALLS:
                found.append((str(path.relative_to(REPO)), node.lineno, node.func.attr))
            elif node.func.attr in ("manual_seed", "random_", "uniform_", "normal_",
                                    "exponential_", "bernoulli_"):
                found.append((str(path.relative_to(REPO)), node.lineno, node.func.attr))
    return found


def test_no_generator_draws_left():
    """No module of the port draws from ``torch``'s generators (``torch.rand*``,
    ``torch.randperm``, ``torch.Generator``, in-place ``uniform_`` and the
    like) where its JAX counterpart draws from ``jax.random``: the list of
    such calls is the listed exceptions, with their reasons, and that list
    is empty."""
    found = generator_draws()
    assert {(f, name) for f, _, name in found} == set(EXCEPTIONS), found
