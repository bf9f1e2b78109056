"""The flax families' parameters from JAX's key, against flax's ``model.init``, on the CPU.

``init_params(prng_key(s))`` of each family at a narrow width, over two
seeds, against flax's ``model.init(PRNGKey(s), ...)``: the same parameter
names and shapes; each drawn parameter's key is the one flax derives from its
module path (``models/flax_rng.py``), checked through its value: the test
rebuilds the parameter's uniforms with ``jax.random.uniform`` from that key,
holds the port's uniforms to them bit for bit, and checks that flax's value
is the initializer's transform of them. Then the values: truncated normals
and normals within ``VALUE_ULPS`` (torch's ``erfinv`` against XLA's, as
``tests/test_torch_threefry.py`` bounds it), orthogonal kernels within
``ORTHO_ABS`` (LAPACK's QR against XLA's), zeros and ones exact.

The file also writes the JAX digests of the families at the main path's
widths that ``chip_smoke.py --keys`` holds the card to (``DIGESTS``, beside
the reset digests): ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
tests/test_torch_keyed_init.py``; ``test_init_digests_are_jax`` checks them.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static
from jax import lax

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.models import actor_critic as jac
from gym_craftingworld_tpu.models import cnn as jcnn
from gym_craftingworld_tpu.models import cpv as jcpv
from gym_craftingworld_tpu.models import grid_policy as jgp
from gym_craftingworld_tpu.models import rnn as jrnn
from gym_craftingworld_tpu.models import vit as jvit
from gym_craftingworld_tpu_torch.models import actor_critic as tac
from gym_craftingworld_tpu_torch.models import cnn as tcnn
from gym_craftingworld_tpu_torch.models import cpv as tcpv
from gym_craftingworld_tpu_torch.models import grid_policy as tgp
from gym_craftingworld_tpu_torch.models import layers
from gym_craftingworld_tpu_torch.models import rnn as trnn
from gym_craftingworld_tpu_torch.models import vit as tvit
from gym_craftingworld_tpu_torch.models.actor_critic import feature_dim
from gym_craftingworld_tpu_torch.models.flax_rng import Rngs, fold_in_static
from gym_craftingworld_tpu_torch.ops.threefry import NORMAL_LOW, prng_key

from test_torch_keyed_reset import DIGESTS, sha
from test_torch_packed_rollout import tcfg

torch.set_num_threads(1)

CFG = jcw.flat_config()  # 8x8
CANON = jcw.EnvConfig(height=21, width=21, max_steps=300, stacking=True)
SEEDS = (0, 1)
# torch's erfinv against XLA's, in ulps of max(|x|, the draw's scale): the
# normal's bound of tests/test_torch_threefry.py (measured 91 there); here
# measured max 22 over every family and seed
VALUE_ULPS = 128
# LAPACK's Householder QR against XLA's, the GRU's 16 x 16 recurrent
# kernels: measured max 1.2e-6
ORTHO_ABS = 1e-5
# XLA's fused truncated-normal and normal against the transform op by op:
# measured max 1 ulp
TRANSFORM_ULPS = 2

# family: (flax init of a key -> variables, the port's init of a key)
FAMILIES = {
    "ActorCritic": (lambda k: jac.init_params(k, 8, 8, hidden=32)[1],
                    lambda k: tac.init_params(k, 8, 8, 32)),
    "PixelActorCritic": (lambda k: jcnn.init_params(k, 8, 8, 32)[1],
                         lambda k: tcnn.init_params(k, 8, 8, 32)),
    "PixelDistillStudent": (lambda k: jcnn.init_student(k, CFG, 16, 64, 8)[1],
                            lambda k: tcnn.init_student(k, tcfg(CFG), 16, 64, 8)),
    "GridPolicy": (lambda k: jgp.init_grid_policy(k, CFG, 8, 32)[1],
                   lambda k: tgp.init_grid_policy(k, tcfg(CFG), 8, 32)),
    "CPVPolicy": (lambda k: jcpv.init_cpv(k, 8, 8, 8, 32)[1],
                  lambda k: tcpv.init_cpv(k, 8, 8, 8, 32)),
    "CPVPolicy(with_init)": (lambda k: jcpv.init_cpv(k, 8, 8, 8, 32, True)[1],
                             lambda k: tcpv.init_cpv(k, 8, 8, 8, 32, True)),
    "CPVGridPolicy": (lambda k: jcpv.init_cpv_grid(k, CFG, 8, 32, 8)[1],
                      lambda k: tcpv.init_cpv_grid(k, tcfg(CFG), 8, 32, 8)),
    "GridActorCritic": (lambda k: jvit.init_params(k, 8, 8, 32)[1],
                        lambda k: tvit.init_params(k, 8, 8, 32)),
    "RecurrentActorCritic": (lambda k: jrnn.init_params(k, feature_dim(8, 8), 16)[1],
                             lambda k: trnn.init_params(k, feature_dim(8, 8), 16)),
}

# the main path's widths, as chip_smoke.py's phase 27d builds them
FULL = {
    "GridPolicy(96, 1536)": lambda k: jgp.init_grid_policy(k, CANON, 96, 1536)[1],
    "CPVGridPolicy(96, 1024, 32)": lambda k: jcpv.init_cpv_grid(k, CANON, 96, 1024, 32)[1],
    "PixelDistillStudent(64, 96, 1536)": lambda k: jcnn.init_student(k, CANON, 96, 1536, 64)[1],
    "ActorCritic(512)": lambda k: jac.init_params(k, 21, 21, 512)[1],
    "PixelActorCritic(256)": lambda k: jcnn.init_params(k, 21, 21, 256)[1],
    "RecurrentActorCritic(512)": lambda k: jrnn.init_params(k, feature_dim(21, 21), 512)[1],
    "GridActorCritic(512)": lambda k: jvit.init_params(k, 21, 21, 512)[1],
}
FULL_SEED = 19


def flat(tree, prefix=()) -> dict:
    """A flax parameter tree as {path tuple: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_inits():
    """Each family's jitted flax init (eagerly it compiles op by op)."""
    return {name: jax.jit(jinit) for name, (jinit, _) in FAMILIES.items()}


def port_init(name: str, seed: int):
    """(module, its draws) of the port's init of ``prng_key(seed)``."""
    log = []
    model = FAMILIES[name][1](Rngs(prng_key(seed), log=log))
    return model, {tuple(d.path.split("/")): d for d in log}


def ulps(got: np.ndarray, want: np.ndarray, unit: float) -> float:
    """The largest difference in ulps of ``max(|want|, unit)`` (float32)."""
    step = np.spacing(np.maximum(np.abs(want), unit).astype(np.float32))
    return float((np.abs(got.astype(np.float64) - want) / step).max())


def jax_uniforms(key, init: str, shape):
    """The uniforms flax's initializer draws from ``key`` for a parameter of ``shape``."""
    lo, hi = (layers.TRUNC_LO, layers.TRUNC_HI) if init == "truncated_normal" else (NORMAL_LOW, 1.0)
    if init == "orthogonal":
        shape = layers._orthogonal_shape(shape)
    return np.asarray(jax.random.uniform(key, (int(np.prod(shape)),), jnp.float32, lo, hi))


def scale_of(init: str, shape, path) -> float:
    """The draw's scale: lecun_normal's standard deviation, or the normal's."""
    if init == "truncated_normal":
        # flax's DenseGeneral draws [prod(in), prod(out)]: the attention's
        # query, key and value contract one axis, its out two
        fan_in = shape[0] if path[-2] in ("query", "key", "value") else int(np.prod(shape[:-1]))
        return float(np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978))
    return 0.02 if path[-1] == "pos" else 1.0


def test_path_hash_is_flax():
    """``fold_in_static`` equals flax's ``_fold_in_static`` as key data, for
    nested string and int paths (ints of one to five bytes, unicode)."""
    paths = [(), ("torso0", 1), ("block1", "MultiHeadDotProductAttention_0", "query", 2),
             ("gru", "hn", 1), (3,), ("a", 255, "b", 256, 2**32 + 7), ("é", 0)]
    for s in (0, 7, 2**31 + 5):
        for path in paths:
            want = np.asarray(jax.random.key_data(_fold_in_static(jax.random.PRNGKey(s), path)))
            got = fold_in_static(prng_key(s), path).numpy()
            np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=str(path))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(FAMILIES))
def test_init_is_flax(name, seed, jax_inits):
    want = flat(jax_inits[name](jax.random.PRNGKey(seed))["params"])
    model, draws = port_init(name, seed)
    got = {tuple(k.split(".")): p.detach().numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == np.float32, path
        d = draws.get(path)
        if d is None:  # a constant init: zeros, or a LayerNorm's ones
            assert np.all(w == (1.0 if path[-1] == "scale" else 0.0)), path
            np.testing.assert_array_equal(g, w, err_msg=str(path))
            continue
        assert d.shape == w.shape
        key = jax.random.wrap_key_data(jnp.asarray(d.key.numpy(), jnp.uint32))
        u = jax_uniforms(key, d.init, w.shape)
        np.testing.assert_array_equal(
            layers.init_uniforms(d.key, d.init, w.shape).numpy().view(np.int32),
            u.view(np.int32), err_msg=f"{path}: uniforms bit for bit")
        if d.init == "orthogonal":
            # flax's value is orthogonal() of the key: the key is flax's
            np.testing.assert_array_equal(
                w, np.asarray(jax.nn.initializers.orthogonal()(key, w.shape)), err_msg=str(path))
            assert np.abs(g - w).max() <= ORTHO_ABS, (path, np.abs(g - w).max())
            continue
        scale = scale_of(d.init, w.shape, path)
        z = np.float32(np.sqrt(2)) * np.asarray(lax.erf_inv(jnp.asarray(u)))
        if d.init == "truncated_normal":
            z = np.clip(z, -layers.TRUNC_CLIP, layers.TRUNC_CLIP)
        transform = (z * np.float32(scale)).reshape(w.shape)
        assert ulps(w, transform, scale) <= TRANSFORM_ULPS, (path, ulps(w, transform, scale))
        assert ulps(g, w, scale) <= VALUE_ULPS, (path, ulps(g, w, scale))


# ---------------------------------------------------------------------------
# the JAX digests that chip_smoke.py --keys holds the card's inits to
# ---------------------------------------------------------------------------


def jax_init_digests() -> dict:
    """For each family at the main path's widths from ``PRNGKey(FULL_SEED)``,
    each drawn parameter's flax key data and the SHA-256 of its uniforms
    (float32, C order); the keys come from flax's own scope, through a
    wrapped ``make_rng``."""
    from flax.core import scope as fscope

    out = {}
    for name, jinit in FULL.items():
        keys = {}
        make_rng = fscope.Scope.make_rng

        def recording(self, rng_name="params"):
            k = make_rng(self, rng_name)
            keys.setdefault(self.path, []).append(k)
            return k

        fscope.Scope.make_rng = recording
        try:
            params = flat(jinit(jax.random.PRNGKey(FULL_SEED))["params"])
        finally:
            fscope.Scope.make_rng = make_rng
        rows = {}
        for path, w in params.items():
            init = init_kind(path)
            if init is None:
                continue
            k = keys[path[:-1]][0]  # a drawn parameter is its scope's first
            u = jax_uniforms(k, init, w.shape)
            rows["/".join(path)] = {
                "key": [int(x) for x in np.asarray(jax.random.key_data(k))],
                "init": init, "shape": list(w.shape), "uniforms": sha(u)}
        out[name] = rows
    return out


def init_kind(path) -> str | None:
    """The initializer of a flax family's parameter, by its path."""
    if path[-1] in ("bias", "scale"):
        return None
    if path[-1] in ("task_embed", "pos"):
        return "normal"
    if path[-1] == "kernel" and len(path) >= 3 and path[-3] == "gru" and path[-2][0] == "h":
        return "orthogonal"
    return "truncated_normal"


def test_init_digests_are_jax():
    assert json.loads(DIGESTS.read_text())["init"] == {"seed": FULL_SEED, **jax_init_digests()}


if __name__ == "__main__":
    digests = json.loads(DIGESTS.read_text())
    digests["init"] = {"seed": FULL_SEED, **jax_init_digests()}
    DIGESTS.write_text(json.dumps(digests, indent=1) + "\n")
    print(f"wrote {DIGESTS}", file=sys.stderr)
