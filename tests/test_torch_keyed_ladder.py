"""The engine ladder's random rollouts and ``tools/bench.py``'s runs on JAX's
keys: from the same key data the port draws the JAX package's actions, so
its rollouts give the JAX package's final states, outputs, reward sums and
checksums bit for bit.

The draws these rest on are pinned here too: JAX's narrower integer
``randint`` is its int32 draw cast, and its bfloat16 ``uniform`` keeps the low
byte of each 32-bit Threefry word (its ``normal`` follows, each operation
rounded to bfloat16), as ``ops/keyed_draws.py`` draws them.
Everything runs on the CPU, where the keyed draws take their plain version.

Run as a script, the file writes the ``"ladder"`` entry of
``gym_craftingworld_tpu_torch/tools/records/keyed_digests.json``: JAX's
digests that ``chip_smoke.py --keys`` (phase 27f) holds the card to, which
``test_ladder_digests_are_jax`` regenerates and checks.
"""

import importlib.util
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.core import slots as jsm
from gym_craftingworld_tpu.ops import obs_rollout as jobr
from gym_craftingworld_tpu.ops import packed_rollout as jpr
from gym_craftingworld_tpu.ops import transposed_rollout as jtr
import gym_craftingworld_tpu_torch as tcw
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core import slots as tsm
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops import obs_rollout as tobr
from gym_craftingworld_tpu_torch.ops import packed_rollout as tpr
from gym_craftingworld_tpu_torch.ops import threefry as tf
from gym_craftingworld_tpu_torch.ops import transposed_rollout as ttr
from gym_craftingworld_tpu_torch.tools import bench

from test_torch_canonical_tools import REPO
from test_torch_packed_rollout import assert_tree_equal, jax_and_port_slots, np_tree, tcfg

torch.set_num_threads(1)

B, T = 48, 64
CFG = jcw.ray_config()
# each rung: (JAX's function, the port's); both return (state, outputs),
# the outputs a StepResult, a reward sum or a checksum
ENGINES = {
    "slots": (jsm.rollout_slots_random, tsm.rollout_slots_random),
    "transposed": (jtr.rollout_t_random, ttr.rollout_t_random),
    "packed_random": (jpr.rollout_p_random, tpr.rollout_p_random),
    "packed_bench": (jpr.rollout_p_bench, tpr.rollout_p_bench),
    **{f"obs_{m}": (lambda c, s, k, n, m=m: jobr.rollout_obs_random(c, s, k, n, m),
                    lambda c, s, k, n, m=m: tobr.rollout_obs_random(c, s, k, n, m))
       for m in ("ray", "altobs", "onehot")},
}


def port_key(key) -> torch.Tensor:
    """JAX's key data as the port's int64[..., 2]."""
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_random_rollout_equals_jax(engine):
    """``engine``'s random rollout from ``PRNGKey(5)`` at 48 envs on 21x21 over
    64 steps: the port's final slot state and outputs (``StepResult`` fields,
    the int64 reward sum of ``rollout_p_bench``, the uint32 checksum of the
    observation rollout) equal JAX's; the port's actions are
    ``core/slots.random_actions``, JAX's ``randint(key, (T, B), 0, 6)``."""
    jfn, tfn = ENGINES[engine]
    jsl, tsl = jax_and_port_slots(CFG, 3, B)
    key = jax.random.PRNGKey(5)
    jst, jout = jfn(CFG, jsl, key, T)
    tst, tout = tfn(tcfg(CFG), tsl, port_key(key), T)
    assert_tree_equal(interop.slot_state_to_numpy(tst), np_tree(jst))
    if torch.is_tensor(tout):
        assert tout.dtype == torch.int64 and tout.shape == ()
        assert int(tout) == int(jout) and int(tout) != 0
    else:
        assert_tree_equal({k: v.numpy() for k, v in tout._asdict().items()}, np_tree(jout))
    want = np.asarray(jax.random.randint(key, (T, B), 0, 6, jnp.int32))
    np.testing.assert_array_equal(tsm.random_actions(tsl, port_key(key), T).numpy(), want)


def jax_bench():
    """The root ``bench.py`` as a module (its globals only; JAX is imported
    inside its functions)."""
    spec = importlib.util.spec_from_file_location("jax_root_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PLAIN_LAYOUTS = [layout for layout in bench.LAYOUTS if layout != "packed_fused"]


@pytest.mark.parametrize("layout", PLAIN_LAYOUTS)
def test_bench_roll_equals_jax_s(layout):
    """``tools/bench.make_engine``'s ``roll`` against the root ``bench.py``'s
    ``_make_engine`` for each plain layout: the warm-up from ``PRNGKey(0)``
    and runs 0 and 1 from ``fold_in(PRNGKey(0), i)``, chained from one reset
    of 32 envs on 21x21 for 16 steps a run as ``_median_time`` chains them,
    give JAX's checksums and final states."""
    jb = jax_bench()
    cfg, n = jcw.ray_config(), 32
    jroll, jst = jb._make_engine(layout, cfg, jcw.reset_from_seed(cfg, 0, n))
    troll, tst = bench.make_engine(layout, tcfg(cfg), tcw.reset_from_seed(tcfg(cfg), 0, n,
                                                                           device="cpu"))
    key = jax.random.PRNGKey(0)
    for k in (key, jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)):
        jst, jsum = jroll(jst, k, 16)
        tst, tsum = troll(tst, port_key(k), 16)
        assert tsum.dtype == torch.int64 and int(tsum) == int(jsum)
    got = (interop.env_state_to_numpy(tst) if layout == "grid"
           else interop.slot_state_to_numpy(tst))
    assert_tree_equal(got, np_tree(jst))
    assert torch.equal(kd.fold_in(tf.prng_key(0), 1), port_key(jax.random.fold_in(key, 1)))


def test_packed_fused_seed_is_jax_s():
    """``packed_fused``'s Philox seed of a run is JAX's ``randint(key, (), 0,
    2**31 - 1)`` of the run's key, for the warm-up's and eight runs' keys."""
    key = jax.random.PRNGKey(0)
    for k in [key] + [jax.random.fold_in(key, i) for i in range(8)]:
        want = int(jax.random.randint(k, (), 0, 2**31 - 1, jnp.int32))
        assert bench.bench_seed(port_key(k)) == want


def bf16_ulps(got: torch.Tensor, want) -> float:
    """Largest |got - want| in bfloat16 ulps of ``want`` (at least 1's)."""
    w = np.asarray(want, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1.0))) - 7)
    return float((np.abs(got.float().numpy().astype(np.float64) - w) / step).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_narrow_and_bfloat16_draws_are_jax_s(seed):
    """From ``PRNGKey(seed)``: JAX's int16 and int8 ``randint`` are its int32
    draw cast (at (300, 4096)) and the port's int16 ``randint_cols`` is that
    draw; JAX's 8- and 16-bit ``bits`` are the low byte and half of its 32-bit
    words, and the port's bfloat16 ``uniform_bf16`` (on [0, 1), [-1, 3),
    [0.3, 0.7)) and ``normal_bf16`` equal JAX's (the uniforms bit for bit,
    the normals within 2 bfloat16 ulps, measured 0 against XLA's CPU
    backend); ``bernoulli`` and ``chain_keys`` are JAX's."""
    key = jax.random.PRNGKey(seed)
    k = port_key(key)
    i32 = np.asarray(jax.random.randint(key, (300, 4096), 0, 6, jnp.int32))
    for dt in (jnp.int16, jnp.int8):
        np.testing.assert_array_equal(np.asarray(jax.random.randint(key, (300, 4096), 0, 6, dt)),
                                      i32.astype(dt))
    got = kd.randint_cols(k, (300, 4096), 0, 6, cols=slice(0, 64), dtype=torch.int16)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), i32[:, :64].astype(np.int16))
    n = 4000
    words = tf.random_bits(k, (n,)).numpy()
    np.testing.assert_array_equal(np.asarray(jax.random.bits(key, (n,), jnp.uint8)), words & 0xFF)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(key, (n,), jnp.uint16)),
                                  words & 0xFFFF)
    for lo, hi in ((0.0, 1.0), (-1.0, 3.0), (0.3, 0.7)):
        got = kd.uniform_bf16(k, (n,), lo, hi)
        want = np.asarray(jax.random.uniform(key, (n,), jnp.bfloat16, lo, hi))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    assert bf16_ulps(kd.normal_bf16(k, (n,)), jax.random.normal(key, (n,), jnp.bfloat16)) <= 2
    flips = kd.bernoulli(k, 0.5, (n,))
    np.testing.assert_array_equal(flips.numpy(), np.asarray(jax.random.bernoulli(key, 0.5, (n,))))
    ks = kd.split_keys(k, 3)
    np.testing.assert_array_equal(kd.bernoulli(ks, 0.3, (64,)).numpy(), np.stack(
        [np.asarray(jax.random.bernoulli(kk, 0.3, (64,)))
         for kk in jax.random.split(key, 3)]))
    last, chain = kd.chain_keys(k, 5)
    want, jk = [], key
    for _ in range(5):
        jk, k_t = jax.random.split(jk)
        want.append(port_key(k_t))
    assert torch.equal(chain, torch.stack(want)) and torch.equal(last, port_key(jk))


# ---------------------------------------------------------------------------
# the JAX digests that chip_smoke.py --keys (phase 27f) holds the card to
# ---------------------------------------------------------------------------

LADDER = {"envs": 16384, "steps": 64, "key": 5, "reset_seed": 0}  # 21x21
FINETUNE = {"envs": 2048, "key": 12}  # finetune_canonical's defaults: --seed 11, key seed + 1
# pixel_distill's defaults (--seed 3): round 0's collect chunk (seed + 100), its
# first epoch's flips (64 minibatches of --batch 512), round 0's sampled eval
DISTILL = {"chunk": 2048, "collect_seed": 103, "flip_seed": 3, "flip_steps": 64,
           "batch": 512, "eval_seed": 903}
LADDER_ENGINES = {
    "rollout_slots_random": jsm.rollout_slots_random,
    "rollout_t_random": jtr.rollout_t_random,
    "rollout_p_random": jpr.rollout_p_random,
    "rollout_p_bench": jpr.rollout_p_bench,
    "rollout_obs_random(ray)": lambda c, s, k, n: jobr.rollout_obs_random(c, s, k, n, "ray"),
}


def jax_gumbel_uniforms(keys, B: int) -> np.ndarray:
    """The uniforms on [tiny, 1) under ``categorical``'s float32 Gumbel noise
    of each step key, [T, B, 6]: the noise's exact part."""
    tiny = float(jnp.finfo(jnp.float32).tiny)
    return np.stack([np.asarray(jax.random.uniform(k, (B, 6), jnp.float32, tiny, 1.0))
                     for k in keys])


def jax_ladder_digests() -> dict:
    """SHA-256 (JAX dtypes, C order) of the five ladder rollouts' final slot
    states and outputs from ``LADDER`` (their int totals as numbers), of
    ``finetune_canonical``'s first update's draws (``FINETUNE``: the next
    key, the pool, the Gumbel noise's uniforms, the permutation) and of
    ``pixel_distill``'s draws of a round (``DISTILL``: the collect chunk's
    reset and exploration, an epoch's flips, the sampled evaluation's reset
    and its chain's Gumbel uniforms), all on 21x21."""
    from gym_craftingworld_tpu.core.reset import reset as jreset

    from test_torch_keyed_reset import sha

    cfg = jcw.ray_config()
    key = jax.random.PRNGKey(LADDER["key"])
    rollouts = {}
    for name, fn in LADDER_ENGINES.items():
        sl = jsm.from_env_state(jcw.reset_from_seed(cfg, LADDER["reset_seed"], LADDER["envs"]))
        st, out = fn(cfg, sl, key, LADDER["steps"])
        d = {k: sha(v) for k, v in np_tree(st).items()}
        if hasattr(out, "_asdict"):
            d.update({f"out.{k}": sha(v) for k, v in np_tree(out).items()})
        else:
            d["total"] = int(out)
        rollouts[name] = d
    reset_sha = lambda keys: {k: sha(v) for k, v in np_tree(jreset(cfg, keys)).items()}
    B, T, N = FINETUNE["envs"], 128, 128 * FINETUNE["envs"]  # FTConfig's T and one epoch
    nxt, k_pool, k_roll, k_perm = jax.random.split(jax.random.PRNGKey(FINETUNE["key"]), 4)
    finetune = {"next_key": [int(x) for x in np.asarray(jax.random.key_data(nxt))],
                "pool": reset_sha(jax.random.key_data(jax.random.split(k_pool, 2 * B))),
                "noise_uniforms": sha(jax_gumbel_uniforms(jax.random.split(k_roll, T), B)),
                "perms": sha(np.stack([np.asarray(jax.random.permutation(k, N))
                                       for k in jax.random.split(k_perm, 1)]))}
    D, Tm = DISTILL["chunk"], cfg.max_steps
    steps = [jax.random.split(k) for k in jax.random.split(
        jax.random.PRNGKey(DISTILL["collect_seed"] ^ 7), Tm)]
    flips = [jax.random.split(jax.random.fold_in(jax.random.PRNGKey(DISTILL["flip_seed"]), i))
             for i in range(DISTILL["flip_steps"])]
    eval_keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(DISTILL["eval_seed"]), D))
    k, chain = jax.random.wrap_key_data(eval_keys[0]), []
    for _ in range(Tm):
        k, k_t = jax.random.split(k)
        chain.append(k_t)
    distill = {
        "collect_reset": reset_sha(jax.random.key_data(
            jax.random.split(jax.random.PRNGKey(DISTILL["collect_seed"]), D))),
        "explore_uniform": sha(np.stack([np.asarray(jax.random.uniform(s[0], (D,)))
                                         for s in steps])),
        "explore_moves": sha(np.stack([np.asarray(jax.random.randint(s[1], (D,), 0, 4))
                                       for s in steps])),
        "flip_h": sha(np.stack([np.asarray(jax.random.bernoulli(f[0], 0.5, (DISTILL["batch"],)))
                                for f in flips])),
        "flip_w": sha(np.stack([np.asarray(jax.random.bernoulli(f[1], 0.5, (DISTILL["batch"],)))
                                for f in flips])),
        "eval_reset": reset_sha(eval_keys),
        "eval_noise_uniforms": sha(jax_gumbel_uniforms(chain, D)),
    }
    return {"sizes": {"ladder": LADDER, "finetune": FINETUNE, "distill": DISTILL},
            "rollouts": rollouts, "finetune_draw": finetune, "distill_round": distill}


def test_ladder_digests_are_jax():
    """``tools/records/keyed_digests.json``'s ``"ladder"`` entry is JAX's
    (``jax_ladder_digests``, regenerated here)."""
    from test_torch_keyed_reset import DIGESTS

    assert json.loads(DIGESTS.read_text())["ladder"] == jax_ladder_digests()


if __name__ == "__main__":
    from test_torch_keyed_reset import DIGESTS

    digests = json.loads(DIGESTS.read_text())
    digests["ladder"] = jax_ladder_digests()
    DIGESTS.write_text(json.dumps(digests, indent=1) + "\n")
    print(f"wrote {DIGESTS}", file=sys.stderr)
