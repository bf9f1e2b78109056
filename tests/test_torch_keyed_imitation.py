"""The imitation trainers and the DAgger tools on JAX's key chain, against JAX, on the CPU.

From the same seed, the port's own draws equal JAX's: the expert demos
(``train/demos.collect_expert_demos``, integers: bit for bit), the
permutations of ``train/dagger.bc_train_snaps`` and ``train/bc.bc_train``,
DAgger's exploration draws (``train/dagger.explore_draws``), the rows of
``tools/_canonical.train_chunk`` and ``mixed_rows`` and the draws of
``tools/cpv_canonical.mode_draws`` and ``eval_noise`` against the JAX
tools' own. Where floats follow (a training epoch, the greedy policy's
episodes), the tolerances of the lockstep tests apply.

The file also writes the digests that ``chip_smoke.py --keys`` (phase 27e)
holds the card's imitation draws to (``DIGESTS``, ``"imitation"``):
``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_keyed_imitation.py``.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.train import bc as jbc
from gym_craftingworld_tpu.train import dagger as jdagger
from gym_craftingworld_tpu.train import demos as jdemos
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools import _canonical as cn
from gym_craftingworld_tpu_torch.tools import cpv_canonical as cc
from gym_craftingworld_tpu_torch.train import bc as tbc
from gym_craftingworld_tpu_torch.train import dagger as tdagger
from gym_craftingworld_tpu_torch.train import demos as tdemos

from test_torch_canonical_tools import jax_tool
from test_torch_dagger import CFG, agreeing_envs, host, on_jax, port_state, trained  # noqa: F401
from test_torch_demos import demos  # noqa: F401 (a fixture)
from test_torch_keyed_reset import DIGESTS, sha
from test_torch_packed_rollout import tcfg

torch.set_num_threads(1)

CANON = jcw.EnvConfig(height=21, width=21, max_steps=300, stacking=True)
# Gumbel noise: torch's log of log against XLA's (tests/test_torch_threefry.py)
NOISE_ULPS = 2
# bc_train_snaps' parameters after one epoch, relative L2 (the test's docstring)
PARAM_RTOL = {"carried": 2e-3, "fresh": 1e-2}
# chip_smoke.py phase 27e's sizes
DEMO_EPISODES, DEMO_BATCH, EXPLORE_EPISODES, EXPLORE_SEED = 64, 32, 256, 1000


def bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def ulps(got, want) -> float:
    """The largest difference in ulps of ``max(|want|, 1)`` (float32)."""
    want = np.asarray(want, np.float32)
    step = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    return float((np.abs(np.asarray(got, np.float64) - want) / step).max())


def recording(monkeypatch, module, name):
    """Wrap ``module.name`` so each call's result is kept; returns the list."""
    seen, fn = [], getattr(module, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)
    return seen


def test_collect_expert_demos_equals_jax():
    """24 episodes on canonical 21x21 stacked, in two batches of 12, the port
    resetting from its own keys: JAX's dataset column for column."""
    want = jdemos.collect_expert_demos(CANON, 24, seed=3, noise_eps=0.05, batch=12)
    got = tdemos.collect_expert_demos(tcfg(CANON), 24, seed=3, noise_eps=0.05, batch=12,
                                      device="cpu")
    assert got.num_episodes == want.num_episodes >= 22 and got.num_rows > 1000
    for k in tdemos.SnapDataset._fields:
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


@pytest.mark.parametrize("start", ["carried", "fresh"])
def test_bc_train_snaps_from_an_int_seed_matches_jax(trained, start, monkeypatch):
    """One epoch of ``bc_train_snaps`` from the int seed 7 and no ``perms``:
    the port's permutation is JAX's, bit for bit; continued from JAX's
    carried state, or from a fresh GridPolicy of ``k_init`` (flax's init,
    tests/test_torch_keyed_init.py). The loss within rtol 1e-3 / atol 1e-3,
    the accuracy within atol 2/256, every parameter within ``PARAM_RTOL``
    relative L2 and the Adam count exact: the lockstep epoch tests'
    tolerances, and for a fresh policy a wider relative bound on its
    parameters, whose biases hold only Adam's first steps (measured max
    4.2e-3, ``squeeze.bias``; carried, 1.9e-4)."""
    snaps, model, ts = trained
    kw = dict(epochs=1, batch_size=256, lr=3e-4)
    if start == "carried":
        _, jts, jh = jdagger.bc_train_snaps(CFG, snaps, 7, model_and_state=(model, on_jax(ts)), **kw)
        state = port_state(ts)
    else:
        _, jts, jh = jdagger.bc_train_snaps(CFG, snaps, 7, channels=8, hidden=32, **kw)
        state = None
    key, _ = jax.random.split(jax.random.PRNGKey(7))
    _, k_perm = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k_perm, snaps.num_rows))
    drawn = recording(monkeypatch, tdagger.kd, "split_permutation")
    tts, th = tdagger.bc_train_snaps(tcfg(CFG), snaps, 7, state=state, channels=8, hidden=32,
                                     device="cpu", **kw)
    assert len(drawn) == 1
    np.testing.assert_array_equal(drawn[0][1].numpy(), perm)
    np.testing.assert_allclose(th[0]["loss"], jh[0]["loss"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(th[0]["accuracy"], jh[0]["accuracy"], rtol=0, atol=2 / 256)
    want = interop._flat_tree(host(jts.params["params"]))
    got = {k: v.detach().numpy() for k, v in tts.params.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.linalg.norm(got[k] - w) <= PARAM_RTOL[start] * np.linalg.norm(w), k
    assert int(tts.opt_state.count) == int(host(jts.opt_state)[1][0].count)


def jax_explore(key, T, B, fold=None):
    """JAX's eps-mix draws from ``key``: ``dagger._rollout_states``' (no
    ``fold``) or ``cpv_canonical._rollout_from``'s (``fold_in(k_t, 1)``)."""
    us, acts = [], []
    for k in jax.random.split(key, T):
        if fold is not None:
            k = jax.random.fold_in(k, fold)
        k_u, k_a = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(k_u, (B,))))
        acts.append(np.asarray(jax.random.randint(k_a, (B,), 0, 4)))
    return np.stack(us), np.stack(acts)


def test_collect_policy_states_draws_jax_s_exploration(trained, monkeypatch):
    """``collect_policy_states(explore_eps=0.05)`` with JAX's parameters
    carried across, the port drawing its resets and exploration itself: the
    exploration draws are JAX's bit for bit, and the snapshot columns and
    liveness of every env whose visited states the two bf16 forwards order
    alike (``agreeing_envs``; asserted to be at least 10 of 12) equal JAX's;
    the whole collection and success rate too where all agree."""
    snaps, model, ts = trained
    B, seed, T = 12, 6, CFG.max_steps
    keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed), B))
    cols, live, _ = jdagger._rollout_states(CFG, model, on_jax(ts).params, keys,
                                            jax.random.PRNGKey(seed ^ 0xDA66E4), 0.05)
    ok = agreeing_envs(model, ts, cols, live)
    assert ok.sum() >= B - 2
    draws = recording(monkeypatch, tdagger, "explore_draws")
    rolled = recording(monkeypatch, tdagger, "_rollout_states")
    port = interop.grid_policy_from_numpy(ts.params, device="cpu")
    got, sr = tdagger.collect_policy_states(tcfg(CFG), port, B, seed=seed, explore_eps=0.05)
    u, a = jax_explore(jax.random.PRNGKey(seed ^ 0xDA66E4), T, B)
    (tu, ta), = draws
    np.testing.assert_array_equal(bits(tu.numpy()), bits(u))
    np.testing.assert_array_equal(ta.numpy(), a)
    (tcols, tlive, _), = rolled
    live = np.asarray(live)
    np.testing.assert_array_equal(tlive.numpy()[:, ok], live[:, ok])
    for k, v in tcols.items():
        m = live[:, ok]
        np.testing.assert_array_equal(v.numpy()[:, ok][m], np.asarray(cols[k])[:, ok][m], err_msg=k)
    if ok.all():
        want, wsr = jdagger.collect_policy_states(CFG, model, on_jax(ts).params, B, seed=seed,
                                                  explore_eps=0.05)
        assert sr == wsr and set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bc_train_draws_jax_s_permutations(demos, monkeypatch):  # noqa: F811
    """``bc.bc_train`` from ``PRNGKey(5)`` without ``perms``: each epoch's
    permutation is JAX's (``key, init_key = split(key)``, then ``key, k =
    split(key)``), and the per-epoch losses follow JAX's within rtol 1e-3, as
    ``tests/test_torch_demos.py`` holds them."""
    from gym_craftingworld_tpu.models import actor_critic as jac

    got_d, want_d = demos
    model = jac.ActorCritic(hidden=32)
    v = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.zeros((1, jac.feature_dim(8, 8))))
    _, _, jm = jbc.bc_train(want_d, jax.random.PRNGKey(5), 8, 8, epochs=3, batch_size=64,
                            lr=1e-3, model_and_params=(model, v))
    key, _ = jax.random.split(jax.random.PRNGKey(5))
    perms = []
    for _ in range(3):
        key, k = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(k, want_d.actions.shape[0])))
    drawn = recording(monkeypatch, tbc.kd, "split_permutation")
    port = interop.actor_critic_from_numpy(host(v), device="cpu")
    _, tm = tbc.bc_train(got_d, prng_key(5), 8, 8, epochs=3, batch_size=64, lr=1e-3, model=port)
    assert len(drawn) == 3
    for (_, p), w in zip(drawn, perms):
        np.testing.assert_array_equal(p.numpy(), w)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-3)


@pytest.fixture(scope="module")
def tools():
    return {name: jax_tool(name) for name in ("train_canonical", "targeted_dagger")}


def epoch_rows(monkeypatch, module):
    """Make ``module._bc_epoch`` keep the rows it is given and train nothing."""
    rows = []

    def epoch(*args):  # (cfg, [model,] lr, ts, data, idx, batch)
        rows.append(np.asarray(args[-2]))
        return args[-4], {}

    monkeypatch.setattr(module, "_bc_epoch", epoch)
    return rows


@pytest.mark.parametrize("fail_lo,frac_fail", [(0, 0.0), (900, 0.5), (1000, 0.5)])
def test_train_chunk_and_mixed_rows_are_the_jax_tools_draws(tools, monkeypatch, fail_lo,
                                                            frac_fail):
    """The row ids of a chunk from one key: ``train_chunk``'s are
    ``tools/train_canonical.py``'s and ``mixed_rows``' ``targeted_dagger``'s
    (``split(key, 3)``, then ``randint``, ``randint``, ``uniform``), bit for
    bit; with no row past ``fail_lo`` both tools draw the uniform rows."""
    steps, batch, n_valid, seed = 3, 64, 1000, 11
    jrows = epoch_rows(monkeypatch, jdagger)
    tools["train_canonical"].train_chunk(None, None, None, n_valid, steps, batch, 1e-3,
                                         jax.random.PRNGKey(seed))
    tools["targeted_dagger"].mixed_train_chunk(None, None, None, n_valid, fail_lo, steps, batch,
                                               1e-3, frac_fail, jax.random.PRNGKey(seed))
    trows = epoch_rows(monkeypatch, tdagger)
    cn.train_chunk(tcfg(CFG), None, None, n_valid, steps, batch, 1e-3, prng_key(seed))
    cn.mixed_train_chunk(tcfg(CFG), None, None, n_valid, fail_lo, steps, batch, 1e-3, frac_fail,
                         prng_key(seed))
    assert len(jrows) == len(trows) == 2
    for g, w in zip(trows, jrows):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_cpv_canonical_mode_draws_are_jax_s():
    """``mode_draws`` from ``PRNGKey(seed)`` draws what JAX's ``_rollout_from``
    draws from it: ``argmax_eps``' uniforms and moves of ``split(fold_in(k_t,
    1))`` bit for bit; ``sample``'s Gumbel noise of ``categorical(k_t)``
    within ``NOISE_ULPS``; ``eval_noise`` the noise of ``_success_from``'s
    chain ``k, k_t = split(k)``, within ``NOISE_ULPS``. The sampled actions
    of random logits under the port's noise equal JAX's ``categorical``."""
    T, B, seed = 40, 96, 305
    key = jax.random.PRNGKey(seed)
    u, a, eps, noise = cc.mode_draws("argmax_eps", T, B, prng_key(seed))
    wu, wa = jax_explore(key, T, B, fold=1)
    assert eps == 0.05 and noise is None
    np.testing.assert_array_equal(bits(u.numpy()), bits(wu))
    np.testing.assert_array_equal(a.numpy(), wa)
    logits = jax.random.normal(jax.random.PRNGKey(9), (B, 6)) * 3
    _, _, _, noise = cc.mode_draws("sample", T, B, prng_key(seed))
    want = np.stack([np.asarray(jax.random.gumbel(k, (B, 6))) for k in jax.random.split(key, T)])
    assert ulps(noise.numpy(), want) <= NOISE_ULPS
    acts = np.stack([np.asarray(jax.random.categorical(k, logits)) for k in jax.random.split(key, T)])
    np.testing.assert_array_equal((noise + torch.as_tensor(np.asarray(logits))).argmax(-1).numpy(),
                                  acts)
    k, chain = key, []
    for _ in range(T):
        k, k_t = jax.random.split(k)
        chain.append(np.asarray(jax.random.gumbel(k_t, (B, 6))))
    assert ulps(cc.eval_noise("sample", T, B, prng_key(seed)).numpy(), np.stack(chain)) <= NOISE_ULPS
    assert cc.eval_noise("argmax", T, B, prng_key(seed)) is None


class Rolled(Exception):
    """Raised in place of a rollout."""


def test_cpv_canonical_dagger_collect_draws_from_its_seed(monkeypatch):
    """``dagger_collect`` rolls with the draws of ``PRNGKey(seed)``, as JAX's."""
    seen = recording(monkeypatch, cc, "mode_draws")

    def rollout(*args):
        raise Rolled

    monkeypatch.setattr(tdagger, "_rollout_states", rollout)
    state = reset(tcfg(CFG), kd.split_keys(prng_key(0), 4))
    with pytest.raises(Rolled):
        cc.dagger_collect(tcfg(CFG), None, state, [0] * 4, 321, mode="argmax_eps")
    u, a, _, _ = seen[0]
    wu, wa = jax_explore(jax.random.PRNGKey(321), CFG.max_steps, 4, fold=1)
    np.testing.assert_array_equal(bits(u.numpy()), bits(wu))
    np.testing.assert_array_equal(a.numpy(), wa)


# ---------------------------------------------------------------------------
# the JAX digests that chip_smoke.py --keys holds the card's imitation draws to
# ---------------------------------------------------------------------------


def jax_imitation_digests() -> dict:
    """SHA-256 of each column of JAX's ``collect_expert_demos(CANON,
    DEMO_EPISODES, seed=0, noise_eps=0.05, batch=DEMO_BATCH)``, and of the
    exploration draws of ``collect_policy_states(..., EXPLORE_EPISODES,
    seed=EXPLORE_SEED, explore_eps=0.05)`` on CANON (uniforms f32[T, B],
    moves int32[T, B])."""
    d = jdemos.collect_expert_demos(CANON, DEMO_EPISODES, seed=0, noise_eps=0.05,
                                    batch=DEMO_BATCH)
    u, a = jax_explore(jax.random.PRNGKey(EXPLORE_SEED ^ 0xDA66E4), CANON.max_steps,
                       EXPLORE_EPISODES)
    return {"demos": {k: sha(getattr(d, k)) for k in jdemos.SnapDataset._fields},
            "explore": {"uniform": sha(u), "moves": sha(a)},
            "sizes": {"demo_episodes": DEMO_EPISODES, "demo_batch": DEMO_BATCH,
                      "explore_episodes": EXPLORE_EPISODES, "explore_seed": EXPLORE_SEED}}


def test_imitation_digests_are_jax():
    assert json.loads(DIGESTS.read_text())["imitation"] == jax_imitation_digests()


if __name__ == "__main__":
    digests = json.loads(DIGESTS.read_text())
    digests["imitation"] = jax_imitation_digests()
    DIGESTS.write_text(json.dumps(digests, indent=1) + "\n")
    print(f"wrote {DIGESTS}", file=sys.stderr)
