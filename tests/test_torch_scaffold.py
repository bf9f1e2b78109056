"""The PyTorch port's scaffolding: copies pinned to the JAX package, no JAX
import, the Philox generator, and the constants the CUDA sources hard-code."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_craftingworld_tpu import config as jcfg
from gym_craftingworld_tpu import constants as jC
from gym_craftingworld_tpu_torch import config as tcfg
from gym_craftingworld_tpu_torch import constants as tC
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops import philox

torch.set_num_threads(1)

PORT = Path(tcfg.__file__).resolve().parent


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and not callable(v)
            and not isinstance(v, type(np))}


def test_constants_equal_jax():
    j, t = _public(jC), _public(tC)
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_array_equal(np.asarray(j[k]), np.asarray(t[k]), err_msg=k)
        assert type(j[k]) is type(t[k]), k


@pytest.mark.parametrize("kw", [
    {},
    {"stacking": False},
    {"selected_task_indices": (1, 4), "number_of_tasks": 5},  # clamps to 2
    {"height": 5, "width": 7, "max_steps": 10, "reward_equal": False},
])
def test_config_equal_jax(kw):
    assert [f.name for f in dataclasses.fields(jcfg.EnvConfig)] == \
        [f.name for f in dataclasses.fields(tcfg.EnvConfig)]
    for make in ("ray_config", "flat_config"):
        j = getattr(jcfg, make)(**kw)
        t = getattr(tcfg, make)(**kw)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.n_cells, j.n_tasks) == (t.n_cells, t.n_tasks)
        assert hash(t) == hash(t.replace())
    names = ("ChopTree", "MakeBread")
    assert jcfg.resolve_selected_tasks(names) == tcfg.resolve_selected_tasks(names)
    with pytest.raises(ValueError):
        tcfg.EnvConfig(height=2, width=4)


def test_import_pulls_in_no_jax():
    code = ("import sys, gym_craftingworld_tpu_torch, gym_craftingworld_tpu_torch.ops, "
            "gym_craftingworld_tpu_torch.interop\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'gym_craftingworld_tpu')]\n"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=PORT.parent, timeout=120)
    for f in PORT.rglob("*.py"):
        text = f.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|gym_craftingworld_tpu)\b",
                             text, re.M), f


@pytest.mark.parametrize("counter,key,expect", [
    # Random123 known-answer vectors for philox4x32_10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expect):
    out = philox.philox4x32([torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(w) for w in out) == expect


def _defines(name):
    text = (PORT / "csrc" / name).read_text()
    return {k: int(v.rstrip("u"), 0)
            for k, v in re.findall(r"^#define CW_(\w+) (0x[0-9A-Fa-f]+u?|\d+)\b",
                                   text, re.M)}


def test_cuda_constants_match_python():
    step = _defines("packed_step.cuh")
    for k, v in step.items():
        if hasattr(tC, k):
            assert getattr(tC, k) == v, k
    assert {"ROCK", "ACTION_PICKUP", "T_MOVE_STICKS", "N_ACTIONS"} <= set(step)
    masks = {"DYNTYPE_SLOTS": "_DYNTYPE_SLOTS", "REMOVABLE_SLOTS": "_REMOVABLE_SLOTS",
             "PICKUP_SLOTS": "_PICKUP_SLOTS"}
    from gym_craftingworld_tpu_torch.ops import packed_rollout as pr

    for c_name, py_name in masks.items():
        assert step[c_name] == sum(1 << i for i in getattr(pr, py_name)), c_name
    ph = _defines("philox.cuh")
    assert ph["ACTION_KEY"] == pf.ACTION_KEY
    assert (ph["PHILOX_M0"], ph["PHILOX_M1"], ph["PHILOX_W0"], ph["PHILOX_W1"]) == (
        philox.PHILOX_M0, philox.PHILOX_M1, philox.PHILOX_W0, philox.PHILOX_W1)
