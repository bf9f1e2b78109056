"""The port's ``entry()`` (``gym_craftingworld_tpu_torch/entry.py``) against
``__graft_entry__.entry()`` of the JAX package, and the ``record_episode``
example, on the CPU."""

import ast
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gym_craftingworld_tpu_torch import entry as tentry
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.examples import record_episode

from test_torch_packed_rollout import np_tree

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "gym_craftingworld_tpu_torch"


def graft_entry():
    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_forward_matches_graft_entry():
    """The flagship actor-critic's forward over JAX's 64 worlds with JAX's
    parameters, both carried by ``interop``: logits and values within rtol /
    atol 2e-2 (a bf16 torso; measured 1.9e-8); the port's own ``entry`` on
    the CPU gives the same shapes, from its own seeded draws."""
    fn, (params, state) = graft_entry().entry()
    logits, value = jax.jit(fn)(params, state)
    model = interop.actor_critic_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    port_state = interop.env_state_from_numpy(np_tree(state), "cpu")
    forward, (own_model, own_state) = tentry.entry("cpu")
    with torch.no_grad():
        got = forward(model, port_state)
        own = forward(own_model, own_state)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(logits), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(value), rtol=2e-2, atol=2e-2)
    assert [tuple(x.shape) for x in own] == [(64, 6), (64,)]
    assert all(bool(torch.isfinite(x).all()) for x in own)
    assert own_state.objects.shape == (64, 21, 21)


def test_entry_main_prints_the_shapes(capsys):
    out = tentry.main(["--device", "cpu"])
    assert "entry forward: [(64, 6), (64,)]" in capsys.readouterr().out
    assert [tuple(x.shape) for x in out] == [(64, 6), (64,)]


@pytest.mark.parametrize("writer", ["default", "pillow"])
def test_record_episode_writes_a_gif(tmp_path, monkeypatch, capsys, writer):
    """One random episode of 40 steps recorded under ``renders/env{id}/`` of the
    working directory: through ``utils/gif.py`` (matplotlib) and through
    ``PillowGifRecorder`` (where matplotlib is absent), one GIF of several
    frames, named as the reference names it."""
    monkeypatch.chdir(tmp_path)
    if writer == "pillow":
        monkeypatch.setattr(record_episode, "matplotlib_installed", lambda: False)
    where = Path(record_episode.main(["--device", "cpu"]))
    used = "PillowGifRecorder" if writer == "pillow" else "GifRecorder"
    assert f"({used})" in capsys.readouterr().out
    assert where.parts[0] == "renders" and where.name.startswith("env")
    gifs = list((tmp_path / where).glob("*.gif"))
    assert len(gifs) == 1 and gifs[0].name.startswith("E0(40)_")
    with Image.open(gifs[0]) as im:
        assert im.n_frames > 1


@pytest.mark.parametrize("path", [PORT / "entry.py", *sorted((PORT / "examples").glob("*.py"))],
                         ids=lambda p: p.name)
def test_entry_and_examples_import_no_jax(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "optax", "gym_craftingworld_tpu"}, roots
