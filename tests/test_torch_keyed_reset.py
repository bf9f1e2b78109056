"""The port's keyed env layer against the JAX package, bit for bit.

From the same seed or keys, every field (``rng`` included) of the resets,
the pool, the auto-reset rollout, the vector env and the fast-mode façade
equals JAX's; a JAX state carried over by ``interop`` continues under
auto-reset as in JAX; a rank of a mesh derives only its own envs' keys and
draws only its own envs; ``cpv_canonical.make_pool`` draws JAX's pool.

``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_keyed_reset.py``
writes the JAX digests that ``chip_smoke.py --keys`` holds the card to
(``DIGESTS``); ``test_digests_are_jax`` regenerates them and checks the file.
"""

import dataclasses
import hashlib
import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
import gym_craftingworld_tpu_torch as tcw
from gym_craftingworld_tpu.api import gym_env as jge
from gym_craftingworld_tpu.api import vector as jvec
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.api import gym_env as tge
from gym_craftingworld_tpu_torch.api import vector as tvec
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key

import torch_ranks

jreset = importlib.import_module("gym_craftingworld_tpu.core.reset")
treset = importlib.import_module("gym_craftingworld_tpu_torch.core.reset")

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DIGESTS = ROOT / "gym_craftingworld_tpu_torch" / "tools" / "records" / "keyed_digests.json"

CONFIGS = {
    "ray": jcw.ray_config(),
    "flat_stacked": jcw.flat_config(stacking=True),
    "selected_1_4_7": jcw.flat_config(selected_task_indices=(1, 4, 7), number_of_tasks=2),
}


def tcfg(cfg):
    return tcw.EnvConfig(**dataclasses.asdict(cfg))


def np_tree(st) -> dict:
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def assert_state_equal(got, want) -> None:
    """Every field of a port state equals the JAX state's, dtypes included."""
    got = interop.env_state_to_numpy(got)
    for k, w in np_tree(want).items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def port_keys(keys) -> torch.Tensor:
    return torch.as_tensor(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_resets_equal_jax(name):
    cfg, c = CONFIGS[name], tcfg(CONFIGS[name])
    B = 48
    assert_state_equal(tcw.reset_from_seed(c, 5, B, device="cpu"), jcw.reset_from_seed(cfg, 5, B))
    keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(6), B))
    assert_state_equal(treset.reset(c, port_keys(keys)), jreset.reset(cfg, keys))
    jobj, jagent = jreset.generate_pool(cfg, jax.random.PRNGKey(7), 24)
    tobj, tagent = treset.generate_pool(c, prng_key(7), 24)
    for got, want in ((tobj, jobj), (tagent, jagent)):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_state_equal(treset.reset_from_pool(c, port_keys(keys), tobj, tagent),
                       jreset.reset_from_pool(cfg, keys, jobj, jagent))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_auto_reset_rollout_equals_jax(name):
    """``rollout_random`` and an auto-reset ``rollout`` of its actions
    (``randint(PRNGKey(3), (T, B), 0, 6)``) over a short ``max_steps``, so
    most envs restart two or three times."""
    cfg = CONFIGS[name].replace(max_steps=10)
    c, B, T = tcfg(cfg), 32, 30
    jst = jcw.reset_from_seed(cfg, 2, B)
    tst = tcw.reset_from_seed(c, 2, B, device="cpu")
    key = jax.random.PRNGKey(3)
    js, jout = jcw.rollout_random(cfg, jax.tree.map(jnp.copy, jst), key, T)
    ts, tout = tcw.rollout_random(c, tst, prng_key(3), T)
    assert_state_equal(ts, js)
    actions = jax.random.randint(key, (T, B), 0, 6, jnp.int32)
    js, jout = jcw.rollout(cfg, jst, actions, auto_reset=True)
    ts, tout = tcw.rollout(c, tst, torch.as_tensor(np.asarray(actions)), auto_reset=True)
    assert_state_equal(ts, js)
    for f in ("reward", "done"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)))
    assert np.asarray(jout.done).sum() >= 2 * B


def test_interop_state_continues_as_in_jax():
    """A JAX state mid-episode, carried over by ``interop``, goes on under
    auto-reset as the JAX rollout does: its envs restart from the JAX keys."""
    cfg = jcw.flat_config(max_steps=8)
    B, T = 24, 20
    key = jax.random.PRNGKey(9)
    jst, _ = jcw.rollout(cfg, jcw.reset_from_seed(cfg, 4, B),
                         jax.random.randint(key, (5, B), 0, 6, jnp.int32), auto_reset=True)
    tst = interop.env_state_from_numpy(np_tree(jst), device="cpu")
    actions = jax.random.randint(jax.random.fold_in(key, 1), (T, B), 0, 6, jnp.int32)
    js, jout = jcw.rollout(cfg, jst, actions, auto_reset=True)
    ts, tout = tcw.rollout(tcfg(cfg), tst, torch.as_tensor(np.asarray(actions)), auto_reset=True)
    assert_state_equal(ts, js)
    np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))


def test_vector_env_equals_jax():
    """3 resets (the second reseeded) and 50 steps with auto-reset: obs,
    rewards, terminations, truncations and the state every step."""
    kw = dict(size=(8, 8), max_steps=12, obs_mode="onehot", seed=5)
    jv = jvec.CraftingWorldVectorEnv(32, **kw)
    tv = tvec.CraftingWorldVectorEnv(32, **kw, device="cpu")
    rng = np.random.default_rng(0)
    dones = 0
    for reset_seed in (None, 9, None):
        jo, _ = jv.reset(seed=reset_seed)
        to, _ = tv.reset(seed=reset_seed)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert_state_equal(tv.state, jv.state)
    for _ in range(50):
        a = rng.integers(0, 6, 32).astype(np.int32)
        jout = jv.step(a)
        tout = tv.step(a)
        for got, want in zip(tout[:4], jout[:4]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        dones += int(np.asarray(jout[2]).sum() + np.asarray(jout[3]).sum())
    assert_state_equal(tv.state, jv.state)
    assert dones > 32


def test_fast_mode_facade_equals_jax(monkeypatch, tmp_path):
    """A fast-mode Ray episode from seed 0 with its GIF id, two more resets,
    a pool (``fixed_init_state``) and ``sample_state``."""
    monkeypatch.chdir(tmp_path)  # the GIF recorders make their folders here
    je = jge.CraftingWorldEnvRay(seed=0, max_steps=40, rng_mode="fast")
    te = tge.CraftingWorldEnvRay(seed=0, max_steps=40, rng_mode="fast", device="cpu")
    je.allow_gif_storage()
    te.allow_gif_storage()
    assert te.env_id == je.env_id
    je._recorder = te._recorder = None
    rng = np.random.default_rng(1)
    for _ in range(3):
        jo, to = je.reset(), te.reset()
        for k in jo:
            np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
        np.testing.assert_array_equal(te.observation_vector["desired_goal"],
                                      je.observation_vector["desired_goal"])
        for _ in range(40):
            a = int(rng.integers(0, 6))
            jout, tout = je.step(a), te.step(a)
            for k in jout[0]:
                np.testing.assert_array_equal(tout[0][k], jout[0][k], err_msg=k)
            assert tout[1:3] == jout[1:3]
            if jout[2]:
                break
    js, jpos = je.sample_state()
    ts, tpos = te.sample_state()
    np.testing.assert_array_equal(ts, js)
    assert (tpos.row, tpos.col) == (jpos.row, jpos.col)
    jp = jge.CraftingWorldEnvFlat(seed=3, fixed_init_state=4, batch_size=8, rng_mode="fast")
    tp = tge.CraftingWorldEnvFlat(seed=3, fixed_init_state=4, batch_size=8, rng_mode="fast",
                                  device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(tp.reset(), jp.reset())
        assert_state_equal(tp._state, jp._state)


def test_reset_sharded_draws_only_its_columns(tmp_path):
    """Two gloo ranks: each rank's ``reset_sharded`` is its columns of JAX's
    ``reset_from_seed``, its auto-reset rollout of ``randint_cols`` its
    columns of JAX's, and it drew B/2 keys and B/2 envs a reset, no more."""
    B, T = 32, 16
    torch_ranks.spawn("torch_ranks:keyed_reset_ranks", 2, tmp_path, B, T)
    ranks = [torch_ranks.load(tmp_path, r) for r in range(2)]
    want = np_tree(jcw.reset_from_seed(jcw.ray_config(), 5, B))
    cfg = jcw.flat_config(max_steps=6)
    actions = jax.random.randint(jax.random.PRNGKey(3), (T, B), 0, 6, jnp.int32)
    rolled, out = jcw.rollout(cfg, jcw.reset_from_seed(cfg, 5, B), actions, auto_reset=True)
    rolled, n = np_tree(rolled), B // 2
    for r, res in enumerate(ranks):
        cols = slice(r * n, (r + 1) * n)
        for name, whole in (("reset", want), ("rolled", rolled)):
            got = interop.env_state_to_numpy(res[name])
            for k in whole:
                np.testing.assert_array_equal(got[k], whole[k][cols], err_msg=f"{name} {k}")
        np.testing.assert_array_equal(res["done"].numpy(), np.asarray(out.done)[:, cols])
        assert res["reset_draws"] == {"envs": n, "keys": n}
        assert res["rollout_draws"] == {"envs": n + T * n, "keys": n + T * n}


def test_make_pool_is_jax_pool():
    """``cpv_canonical.make_pool(ray_config(), 7, 256)`` is the saved JAX
    pool, ``generate_pool(ray_config(), PRNGKey(7), 256)``."""
    from gym_craftingworld_tpu_torch.tools import cpv_canonical

    objects, agent = cpv_canonical.make_pool(tcw.ray_config(), 7, 256, device="cpu")
    with np.load(ROOT / "gym_craftingworld_tpu_torch" / "tools" / "records"
                 / "cpv_pool_jax_seed7.npz") as z:
        np.testing.assert_array_equal(objects, z["objects"])
        np.testing.assert_array_equal(agent, z["agent"])
    assert objects.dtype == np.int8 and agent.dtype == np.int32


# ---------------------------------------------------------------------------
# the JAX digests that chip_smoke.py --keys holds the card to
# ---------------------------------------------------------------------------


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def jax_digests() -> dict:
    """SHA-256 of each field (JAX dtypes, C order) of ``reset_from_seed(
    ray_config(), 0, 16384)``, and of the final state, rewards and dones of
    a T = 64 auto-reset rollout of ``randint(PRNGKey(3), (64, 4096), 0, 6)``
    from ``reset_from_seed(flat_config(max_steps=10), 0, 4096)``."""
    reset = {k: sha(v) for k, v in np_tree(jcw.reset_from_seed(jcw.ray_config(), 0, 16384)).items()}
    cfg = jcw.flat_config(max_steps=10)
    actions = jax.random.randint(jax.random.PRNGKey(3), (64, 4096), 0, 6, jnp.int32)
    st, out = jcw.rollout(cfg, jcw.reset_from_seed(cfg, 0, 4096), actions, auto_reset=True)
    rollout = {k: sha(v) for k, v in np_tree(st).items()}
    rollout.update(reward=sha(np.asarray(out.reward)), done=sha(np.asarray(out.done)))
    return {"reset_from_seed(ray_config(), 0, 16384)": reset,
            "rollout(flat_config(max_steps=10), 4096 envs, T=64, auto_reset)": rollout}


def test_digests_are_jax():
    want = jax_digests()
    assert {k: v for k, v in json.loads(DIGESTS.read_text()).items() if k in want} == want


if __name__ == "__main__":
    digests = json.loads(DIGESTS.read_text())  # the inits' entries stay (test_torch_keyed_init.py)
    digests.update(jax_digests())
    DIGESTS.write_text(json.dumps(digests, indent=1) + "\n")
    print(f"wrote {DIGESTS}", file=sys.stderr)
