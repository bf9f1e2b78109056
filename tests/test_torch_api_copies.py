"""Pins of the port's copied code, the front end's registry and its lazy imports.

The port never imports the JAX package (importing it imports JAX), so the
framework-free modules of ``agents``, ``api``, ``parity`` and ``utils`` are
copies, and so are the framework-free parts of the imitation trainers
(``train/demos``, ``train/bc``, ``train/dagger``). Each copy's code must
equal its JAX source's once the package name is unified and docstrings are
set aside. The oracle's default place for the reference may differ: the port
looks inside its own checkout.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_craftingworld_tpu.api import registry as jreg
from gym_craftingworld_tpu_torch.api import gym_env as tge
from gym_craftingworld_tpu_torch.api import registry as treg
from gym_craftingworld_tpu_torch.parity import oracle as toracle

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "gym_craftingworld_tpu", ROOT / "gym_craftingworld_tpu_torch"
SHIM = "parity/gymshim"
COPIES = ["agents/expert.py", "api/spaces.py", "parity/seeding.py", "parity/oracle.py", "utils/coordinates.py",
          "utils/gif.py"] + sorted(str(p.relative_to(JAX)) for p in (JAX / SHIM).rglob("*.py"))
MAY_DIFFER = {"parity/oracle.py": {"_REFERENCE_PATH"}}
IDS = ["craftingworld-v3", "craftingworldflat-v3", "craftingworldonehot-v3",
       "craftingworldaltobs-v3"]


def stripped(path: Path) -> ast.Module:
    """The module's AST with the port's package name read as the JAX
    package's and docstrings dropped."""
    tree = ast.parse(path.read_text().replace("gym_craftingworld_tpu_torch",
                                              "gym_craftingworld_tpu"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def code(path: Path, skip=()) -> str:
    """The module's code as an AST dump (``stripped``), module-level
    assignments to the names in ``skip`` left out."""
    tree = stripped(path)
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.Assign) and any(getattr(t, "id", None) in skip for t in n.targets))]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_jax_source(rel):
    skip = MAY_DIFFER.get(rel, ())
    assert code(PORT / rel, skip) == code(JAX / rel, skip)


# framework-free code copied out of JAX modules (which import JAX): the
# snapshot dataset, its host extraction and the array expert of
# ``train/demos.py``, the flat dataset helpers of ``train/bc.py`` and the
# relabelling of ``train/dagger.py``
COPIED_PARTS = {
    "train/demos.py": ["_BITS9", "_DELTAS", "SnapDataset", "occupancy_from_grids",
                       "init_keys_from_grids", "bits_to_mask", "mask_to_bits", "grids_from_snaps",
                       "_ArrayView", "NumpyExpert", "label_snapshot"],
    "train/bc.py": ["Demos", "augment_stacked_goals", "concat_demos"],
    "train/dagger.py": ["_COL_FIELDS", "_LATCH_MASK", "expert_relabel"],
}


def parts(path: Path, names) -> dict:
    """{name: AST dump} of the module's top-level definitions and assignments
    named, read as ``stripped`` reads a module."""
    out = {}
    for n in stripped(path).body:
        here = ([n.name] if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                else [getattr(t, "id", None) for t in getattr(n, "targets", [])])
        out.update({name: ast.dump(n) for name in here if name in names})
    return out


@pytest.mark.parametrize("rel", list(COPIED_PARTS))
def test_copied_parts_equal_jax_source(rel):
    names = COPIED_PARTS[rel]
    got, want = parts(PORT / rel, names), parts(JAX / rel, names)
    assert sorted(got) == sorted(want) == sorted(names)
    for name in names:
        assert got[name] == want[name], name


def test_shim_and_copies_are_whole():
    assert sorted(p.relative_to(PORT / SHIM) for p in (PORT / SHIM).rglob("*.py")) == \
        sorted(p.relative_to(JAX / SHIM) for p in (JAX / SHIM).rglob("*.py"))
    # the statement that differs honours the JAX package's setting, else
    # stays inside the checkout
    assert toracle._REFERENCE_PATH == os.environ.get("CRAFTINGWORLD_REFERENCE",
                                                     str(ROOT / "reference"))


def test_registry_has_the_jax_ids_and_kwargs():
    assert list(treg.REGISTRY) == list(jreg.REGISTRY) == IDS
    for env_id, (cls, kwargs) in jreg.REGISTRY.items():
        tcls, tkwargs = treg.REGISTRY[env_id]
        assert tcls is getattr(tge, cls.__name__) and tkwargs == kwargs
        assert tkwargs == {"stacking": True, "render_save_rate": 10}


@pytest.mark.parametrize("env_id", IDS)
def test_make_each_id(env_id):
    env = treg.make(env_id, seed=0, device="cpu")
    jenv = jreg.make(env_id, seed=0)
    assert type(env).__name__ == type(jenv).__name__
    assert env.render_save_rate == 10
    assert dataclasses.asdict(env.cfg) == dataclasses.asdict(jenv.cfg)
    space, jspace = env.observation_space, jenv.observation_space
    assert type(space).__name__ == type(jspace).__name__
    for k in getattr(jspace, "spaces", {None: jspace}):
        a, b = (s.spaces[k] if k else s for s in (space, jspace))
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    obs = env.reset()
    first = obs["observation"] if isinstance(obs, dict) else obs
    assert isinstance(first, np.ndarray)
    obs, reward, done, info = env.step(0)
    assert type(reward) is int and type(done) is bool
    treg.register("custom-v0", tge.CraftingWorldEnvFlat, {"max_steps": 7})
    try:
        assert treg.make("custom-v0", seed=1, device="cpu").MAX_STEPS == 7
    finally:
        del treg.REGISTRY["custom-v0"]


def test_register_legacy_gym_through_the_shim():
    assert treg.register_legacy_gym(use_bundled_shim=True)
    import gym

    env = gym.make("craftingworld-v3", device="cpu")
    assert isinstance(env, tge.CraftingWorldEnvRay)
    assert env.cfg.stacking is True and env.render_save_rate == 10
    env = gym.make("craftingworldflat-v3", size=(5, 5), device="cpu")
    assert isinstance(env, tge.CraftingWorldEnvFlat) and env.reset().shape == (20, 20, 3)


def test_register_gymnasium():
    gymnasium = pytest.importorskip("gymnasium")
    assert treg.register_gymnasium(prefix="torch/")
    env = gymnasium.make("torch/craftingworldflat-v3", seed=0, device="cpu")
    obs, info = env.reset()
    assert obs.shape == (32, 32, 3) and info == {}
    obs, reward, terminated, truncated, info = env.step(0)
    assert not terminated and not truncated
    assert isinstance(env.unwrapped._env, tge.CraftingWorldEnvFlat)


def test_front_end_imports_no_jax_matplotlib_or_gymnasium():
    """matplotlib and gymnasium stay lazy: the machine with the card has
    neither, and importing the front end must not need them."""
    mods = ("api", "parity", "render", "utils.gif", "utils.coordinates", "ops.obs_rollout",
            "models.actor_critic")
    code_ = ("import sys\n" + "".join(f"import gym_craftingworld_tpu_torch.{m}\n" for m in mods)
             + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
               "'matplotlib', 'gymnasium', 'gym', 'gym_craftingworld_tpu'))\nassert not bad, bad")
    subprocess.run([sys.executable, "-c", code_], check=True, cwd=ROOT, timeout=120)
    for f in PORT.rglob("*.py"):
        assert not re.search(r"^(import|from)\s+(matplotlib|gymnasium)\b", f.read_text(), re.M), f
