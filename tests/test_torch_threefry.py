"""``ops/threefry.py`` and the plain keyed draws against ``jax.random``.

Every function must give JAX's bits exactly, on single and batched keys:
Threefry-2x32 itself (the Salmon et al. test vector), ``PRNGKey`` for each
seed form the package's callers pass, ``split``, ``fold_in``, bits,
``uniform``, ``randint`` and ``permutation``; then ``ops/keyed_draws``'s
plain versions against the draws the JAX reset takes from its keys.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

import gym_craftingworld_tpu as jcw
import gym_craftingworld_tpu_torch as tcw
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops import threefry as tf
from gym_craftingworld_tpu_torch.train import fast_ppo as fp

torch.set_num_threads(1)

# 0, 1, 7, int32's top, and a seed of the façade's default form,
# np.random.SeedSequence().entropy % 2**31 (one such draw, fixed so that
# every test worker collects the same tests)
SEEDS = [0, 1, 7, 2**31 - 1, 1_297_578_658]


def np_key(key) -> torch.Tensor:
    """JAX key data (uint32[..., 2]) as the port's int64 key data."""
    return torch.as_tensor(np.asarray(key).astype(np.int64))


def same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))
    assert got.shape == want.shape


def test_threefry2x32_known_answer():
    """The Random123 known-answer vector, and JAX's hash of a counter array."""
    key = torch.tensor([0x13198A2E, 0x03707344])
    y0, y1 = tf.threefry2x32(key, (torch.tensor([0x243F6A88]), torch.tensor([0x85A308D3])))
    assert (int(y0), int(y1)) == (0xC4923A9C, 0x483DF7A0)
    count = np.arange(16, dtype=np.uint32)
    want = np.asarray(jprng.threefry_2x32(jnp.array([5, 9], jnp.uint32), jnp.asarray(count)))
    c = torch.as_tensor(count.astype(np.int64))
    y0, y1 = tf.threefry2x32(torch.tensor([5, 9]), (c[:8], c[8:]))
    same(torch.cat([y0, y1]), want)


@pytest.mark.parametrize("seed", SEEDS + [2**31, 2**32 + 5, -1])
def test_prng_key(seed):
    same(tf.prng_key(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 4, 6, 64])
def test_split(seed, num):
    key = jax.random.PRNGKey(seed)
    same(tf.split(tf.prng_key(seed), num), jax.random.split(key, num))
    # a batch of keys, and any slice of a split's keys alone
    keys = jax.random.split(key, 5)
    same(tf.split(np_key(keys), num), jax.vmap(lambda k: jax.random.split(k, num))(keys))
    idx = torch.arange(num // 2, num)
    same(tf.keys_at(tf.prng_key(seed), idx), jax.random.split(key, num)[num // 2:])


@pytest.mark.parametrize("data", [0, 1, 5, 2**31 + 3])
def test_fold_in(data):
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        same(tf.fold_in(tf.prng_key(seed), data), jax.random.fold_in(key, data))


@pytest.mark.parametrize("shape", [(), (441,), (64, 32)])
def test_bits_and_uniform(shape):
    for seed in SEEDS:
        key, tkey = jax.random.PRNGKey(seed), tf.prng_key(seed)
        same(tf.random_bits(tkey, shape), jax.random.bits(key, shape))
        u = tf.uniform(tkey, shape)
        assert u.dtype == torch.float32
        same(u, jax.random.uniform(key, shape))
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    same(tf.uniform(np_key(keys), shape), jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
    flat = int(np.prod(shape))
    idx = torch.arange(flat).reshape(shape)
    same(tf.bits_at(np_key(keys[0]), idx), jax.random.bits(keys[0], shape))


@pytest.mark.parametrize("span", [6, 9, 256, 32768, 1_000_000])
def test_randint(span):
    for seed in SEEDS:
        key, tkey = jax.random.PRNGKey(seed), tf.prng_key(seed)
        for shape, lo in (((), 0), ((64, 32), 0), ((441,), -3)):
            got = tf.randint(tkey, shape, lo, lo + span)
            assert got.dtype == torch.int32
            same(got, jax.random.randint(key, shape, lo, lo + span))
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    same(tf.randint(np_key(keys), (), 0, span),
         jax.vmap(lambda k: jax.random.randint(k, (), 0, span))(keys))


@pytest.mark.parametrize("n", [1, 2, 9, 2000])
def test_permutation(n):
    assert tf.shuffle_rounds(n) == (0 if n == 1 else 2 if n == 2000 else 1)
    for seed in SEEDS:
        got = tf.permutation(tf.prng_key(seed), n)
        assert got.dtype == torch.int32
        same(got, jax.random.permutation(jax.random.PRNGKey(seed), n))
    keys = jax.random.split(jax.random.PRNGKey(8), 5)
    same(tf.permutation(np_key(keys), n),
         jax.vmap(lambda k: jax.random.permutation(k, n))(keys))


def jax_draws(cfg, keys, pool_size=0):
    """What ``_reset_one`` (or ``_reset_one_from_pool``) draws from each key,
    split for split (core/reset.py:32-42, :74-76, :108-110, core/imagine.py:66, :113)."""
    n, n_sel = cfg.n_cells, len(cfg.selected_task_indices)

    def one(key):
        k_task, k_world, k_goal, k_next = jax.random.split(key, 4)
        k_num, k_perm = jax.random.split(k_task)
        if cfg.stacking:
            k = jax.random.randint(k_num, (), 0, cfg.number_of_tasks) + 1
        else:
            k = jnp.int32(1)
        perm = jax.random.permutation(k_perm, n_sel)
        world = (jax.random.randint(k_world, (), 0, pool_size) if pool_size
                 else jax.random.uniform(k_world, (n,)))
        gk = jax.random.split(k_goal, 6)
        rows = [jax.random.uniform(gk[i], (n,)) for i in range(6)]
        rows.append(jax.random.uniform(jax.random.fold_in(gk[5], 1), (n,)))
        return k, perm, world, jnp.stack(rows), jax.random.key_data(k_next)

    return jax.vmap(one)(jax.vmap(jax.random.wrap_key_data)(keys))


@pytest.mark.parametrize("name,cfg,pool", [
    ("ray", jcw.ray_config(), 0),
    ("ray_pool", jcw.ray_config(), 24),
    ("flat_single_task", jcw.flat_config(stacking=False), 0),
    ("selected_1_4_7", jcw.flat_config(selected_task_indices=(1, 4, 7), number_of_tasks=2), 5),
])
def test_reset_draws_plain_equal_jax(name, cfg, pool):
    keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(11), 48))
    k, perm, world, goal, k_next = jax_draws(cfg, keys, pool)
    tcfg = tcw.EnvConfig(**dataclasses.asdict(cfg))
    calls, envs = kd.reset_draws_plain.calls, kd.reset_draws_plain.envs
    d = kd.reset_draws(tcfg, np_key(keys), "pool" if pool else "fresh", pool)
    assert (kd.reset_draws_plain.calls, kd.reset_draws_plain.envs) == (calls + 1, envs + 48)
    for got, want, dtype in ((d.k, k, torch.int32), (d.perm, perm, torch.int32),
                             (d.goal, goal, torch.float32), (d.k_next, k_next, torch.int64),
                             (d.pick if pool else d.world, world,
                              torch.int32 if pool else torch.float32)):
        assert got.dtype == dtype
        same(got, want)
    assert (d.world if pool else d.pick) is None
    w = kd.reset_draws(tcfg, np_key(keys), "world")
    same(w.world, jax.vmap(lambda key: jax.random.uniform(key, (cfg.n_cells,)))(
        jax.vmap(jax.random.wrap_key_data)(keys)))
    assert w.goal is None and w.k_next is None


def test_counter_draws_plain_equal_jax():
    """A slice of a split's keys and columns of a (T, B) randint, alone."""
    key, tkey = jax.random.PRNGKey(3), tf.prng_key(3)
    same(kd.split_keys(tkey, 40), jax.random.split(key, 40))
    same(kd.split_keys(tkey, 40, slice(20, 40)), jax.random.split(key, 40)[20:])
    want = jax.random.randint(key, (16, 40), 0, 6)
    got = kd.randint_cols(tkey, (16, 40), 0, 6)
    assert got.dtype == torch.int32
    same(got, want)
    elements = kd.counter_draws_plain.elements
    same(kd.randint_cols(tkey, (16, 40), 0, 6, slice(10, 30)), want[:, 10:30])
    assert kd.counter_draws_plain.elements == elements + 16 * 20
    with pytest.raises(ValueError):
        kd.split_keys(tkey, 40, slice(0, 40, 2))


# ---------------------------------------------------------------------------
# the draws the trainers take: uniform(minval, maxval), gumbel, categorical,
# normal, bits, the column-addressed forms, and the counter kernel's modes
# ---------------------------------------------------------------------------

RANGES = [(0.0, 1.0), (1e-7, 1.0), (-2.5, 3.7), (tf.TINY, 1.0), (tf.NORMAL_LOW, 1.0)]


def ulps(got: torch.Tensor, want) -> float:
    """The largest difference in ulps of ``max(|want|, 1)`` (float32)."""
    want = np.asarray(want, np.float32)
    step = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    return float((np.abs(got.numpy().astype(np.float64) - want) / step).max())


@pytest.mark.parametrize("lo,hi", RANGES)
def test_uniform_with_bounds_bit_exact(lo, hi):
    """JAX's ``_uniform``: XLA's CPU backend fuses ``f * span + minval`` into
    one multiply-add, and the plain version rounds once as it does; the
    column form gives the same elements."""
    key, tkey = jax.random.PRNGKey(5), tf.prng_key(5)
    want = np.asarray(jax.random.uniform(key, (6, 3000), minval=lo, maxval=hi))
    got = tf.uniform(tkey, (6, 3000), lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    idx = torch.arange(3000)[None, 100:900] + 3000 * torch.arange(6)[:, None]
    np.testing.assert_array_equal(tf.uniform_at(tkey, idx, lo, hi).numpy().view(np.int32),
                                  want[:, 100:900].view(np.int32))


def test_fma_f32_rounds_once():
    """``fma_f32`` is the float32 nearest the exact ``a * b + c`` (rational
    arithmetic), ties to even, where a product and a sum rounded apart miss
    it (fast PPO's ``f * 0.9999999 + 1e-7``)."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.random(3000, np.float32)
    for b, c in ((np.float32(0.9999999), np.float32(1e-7)), (np.float32(6.2), np.float32(-2.5))):
        got = tf.fma_f32(torch.as_tensor(a), float(b), float(c)).numpy()
        twice = (a * b) + c
        assert (twice != got).any()
        for x, g in zip(a.tolist(), got.tolist()):
            exact = Fraction(x) * Fraction(float(b)) + Fraction(float(c))
            g32 = np.float32(g)
            for nb in (np.nextafter(g32, np.float32(-np.inf)), np.nextafter(g32, np.float32(np.inf))):
                d, dn = abs(Fraction(float(g32)) - exact), abs(Fraction(float(nb)) - exact)
                assert d < dn or (d == dn and int(g32.view(np.int32)) % 2 == 0)


def test_gumbel_categorical_normal_within_tolerance():
    """Bits and uniforms are JAX's; ``log`` and ``erfinv`` are torch's.
    Gumbel within 2 ulps of max(|x|, 1) (measured 1.0 over 6 keys x 24,576
    draws); normal within 128 ulps (measured 91: torch's ``erfinv`` against
    XLA's, ~1.1e-5 at |x| <= 1); ``categorical`` takes JAX's index wherever
    the top two Gumbel scores are further apart than 1e-5 (everywhere here)."""
    for seed in (0, 1):
        key, tkey = jax.random.PRNGKey(seed), tf.prng_key(seed)
        assert ulps(tf.gumbel(tkey, (4096, 6)), jax.random.gumbel(key, (4096, 6))) <= 2
        assert ulps(tf.normal(tkey, (4096, 8)), jax.random.normal(key, (4096, 8))) <= 128
        logits = np.random.default_rng(seed).standard_normal((4096, 6)).astype(np.float32)
        g = np.sort(np.asarray(jax.random.gumbel(key, (4096, 6))) + logits, axis=1)
        clear = g[:, -1] - g[:, -2] > 1e-5
        got = tf.categorical(tkey, torch.as_tensor(logits)).numpy()
        want = np.asarray(jax.random.categorical(key, logits))
        assert clear.mean() > 0.999 and (got == want)[clear].all()


def test_fastmod_magic_is_exact():
    """The counter kernel's ``n % span`` by a reciprocal (``fastmod_plain``
    repeats its arithmetic) equals ``%`` for every divisor class: small,
    around 2**16 and 2**31, the top of uint32, random ones, and dividends at
    both ends of uint32."""
    rng = np.random.default_rng(1)
    ds = [*range(1, 70), 2**16 - 1, 2**16, 2**16 + 1, 2**31 - 1, 2**31, 2**32 - 1,
          *rng.integers(1, 2**32, 40).tolist()]
    n = torch.as_tensor(np.concatenate([np.arange(2000), 2**32 - 1 - np.arange(2000),
                                        rng.integers(0, 2**32, 20000)]))
    for d in ds:
        assert torch.equal(kd.fastmod_plain(n, int(d)), n % int(d)), d
    assert kd.randint_multiplier(6) == (2**16 % 6) ** 2 % 6 and kd.randint_multiplier(2**20) == 0


def test_counter_modes_equal_jax():
    """Each mode of ``counter_draws`` (the kernel's plain version) against
    ``jax.random``: bits, uniform over plane keys split from a parent or
    given, fast PPO's uniforms, randint and permutation on the key's device,
    and a column box equal to those columns of the whole draw."""
    key, tkey = jax.random.PRNGKey(8), tf.prng_key(8)
    want = np.asarray(jax.random.bits(key, (5, 40)))
    got = kd.counter_draws(tkey, "bits", 5, 40, 0, 40)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    T, B = 6, 40
    want = np.stack([np.asarray(jax.random.uniform(k, (6, B), minval=1e-7, maxval=1.0))
                     for k in jax.random.split(key, T)])
    for cols in (slice(None), slice(8, 28)):
        got = fp.gumbel_uniforms(tkey, T, B, cols)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want[..., cols].view(np.int32))
    planes = tf.split(tkey, T)
    got = kd.uniform_cols(planes, (6, B), slice(8, 28), 1e-7, 1.0)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want[..., 8:28].view(np.int32))
    same(kd.randint(tkey, (2,), 0, 2**31 - 1), jax.random.randint(key, (2,), 0, 2**31 - 1))
    for n in (9, 512, 70000):
        same(kd.permutation(tkey, n), jax.random.permutation(key, n))


def test_reset_draws_tasks_mode_equal_jax():
    """``"tasks"``: ``sample_desired``'s draws of each key itself, as JAX's
    ``fresh_packed_batch`` takes them over ``split(k_task, n)``."""
    for cfg in (jcw.ray_config(), dataclasses.replace(jcw.flat_config(), stacking=False)):
        keys = jax.random.split(jax.random.PRNGKey(2), 50)

        def one(k):
            k_num, k_perm = jax.random.split(k)
            num = (jax.random.randint(k_num, (), 0, cfg.number_of_tasks) + 1 if cfg.stacking
                   else jnp.int32(1))
            return num, jax.random.permutation(k_perm, len(cfg.selected_task_indices))

        num, perm = jax.vmap(one)(keys)
        d = kd.reset_draws(tcw.EnvConfig(**dataclasses.asdict(cfg)), np_key(keys), "tasks")
        same(d.k, num)
        same(d.perm, perm)
        assert d.world is None and d.goal is None and d.k_next is None
