"""Tiny cells for the benchmark's CPU tests: the real configurations and
mixes, cut to 256 envs, 16 steps an iteration and one check iteration (the
simulator: 512 envs, 300 steps a launch)."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark.run import ROOT, cell_spec, load_json


@pytest.fixture(scope="session")
def bench():
    return load_json(ROOT / "BENCHMARK.json")


def tiny(bench: dict, workload: str) -> dict:
    spec = copy.deepcopy(cell_spec(bench, workload))
    if spec["traffic"]["entry"] == "train":
        spec["traffic"].update(envs=256, check_steps=3)
        spec["conf"]["rollout_steps"] = 16
    else:
        spec["traffic"].update(envs=512, steps_per_launch=300, check_envs=64)
    return spec


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
