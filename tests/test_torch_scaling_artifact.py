"""``tools/scaling_artifact`` (the port's counterpart of the JAX package's
``tools/scaling_artifact.py``) on the CPU.

The ``cpu_virtual8`` section runs over two gloo ranks (``torch_ranks``) at a
tiny size and writes the JAX record's keys; the ``gpu_single_chip`` section
runs tiny on the CPU through the bench kernel's plain version, counting its
calls; ``_delta_rate`` is held to a clock whose times are known. The host
clock times these runs: no number here is a device number.
"""

import json
from pathlib import Path

import pytest
import torch

import torch_ranks
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.tools import scaling_artifact as sa

torch.set_num_threads(1)

JAX = json.loads((Path(__file__).resolve().parents[1] / "docs" / "scaling.json").read_text())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling")
    torch_ranks.spawn("torch_ranks:scaling_cpu", 2, out)
    return out / "scaling.json"


def test_cpu_section_at_world_2_has_the_jax_keys(two_ranks):
    sec = json.loads(two_ranks.read_text())["cpu_virtual8"]
    want = JAX["cpu_virtual8"]
    assert set(sec) == set(want) and set(sec["config"]) == set(want["config"])
    assert sec["config"]["devices"] == 2 and sec["config"]["batch_per_device"] == 8
    assert "2 gloo ranks" in sec["note"]
    assert set(sec["engines"]) == {"grid", "packed_scan"}
    for rates in sec["engines"].values():
        assert set(rates) == {"n1", "n2", "devices", "efficiency"} and rates["devices"] == 2
        assert rates["efficiency"] == pytest.approx(rates["n2"] / (2 * rates["n1"]), rel=1e-12)


def test_gpu_section_tiny_on_the_cpu_merges_beside_the_other(two_ranks):
    """Both T of both engines run a warm-up and ``iters`` timed runs: the
    bench's plain version (4 + 4 calls at ``iters`` 3); the section has the
    JAX record's keys and the card, and the file keeps the CPU section."""
    pf.rollout_packed_bench_plain.calls = 0
    sec = sa.run_gpu(two_ranks, iters=3, scan_steps=4, device="cpu", envs=32, fused_steps=8)
    assert pf.rollout_packed_bench_plain.calls == (1 + 3) * 2
    want = JAX["tpu_single_chip"]
    assert set(sec) == set(want) | {"card"} and sec["card"] == "cpu"
    assert set(want["config"]) < set(sec["config"]) and sec["config"]["scan_steps"] == 4
    assert "host clock" in sec["config"]["timing"]
    doc = json.loads(two_ranks.read_text())
    assert doc["gpu_single_chip"] == sec and set(doc) == {"cpu_virtual8", "gpu_single_chip"}


@pytest.mark.parametrize("T", [1000, 7])
def test_delta_rate_on_a_known_clock(monkeypatch, T):
    """A run of T steps takes 2 + 0.25 T ms on a fake clock: the extra
    T - T // 2 steps take 0.25 (T - T // 2) ms, so B envs step at 4,000 B a
    second whatever the fixed cost; each T gets its warm-up and timed runs."""
    seen = []

    def fake_timed_runs(fn, device, reps, warmup):
        for _ in range(warmup + reps):
            fn()
        return {"median_ms": 2.0 + 0.25 * seen[-1]}

    monkeypatch.setattr(sa, "timed_runs", fake_timed_runs)
    rate = sa._delta_rate(seen.append, 10, T, iters=3, device="cpu")
    assert seen == [T] * 4 + [T // 2] * 4
    assert rate == pytest.approx(40_000, rel=1e-12)
