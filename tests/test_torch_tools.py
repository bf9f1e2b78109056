"""The port's tools (``gym_craftingworld_tpu_torch/tools/``) on the CPU.

Each tool's ``main`` runs with ``--device cpu`` at a tiny size and writes its
JSON, or prints its JSON line, with the JAX tool's keys; the JAX tool's
noise rule gives the JAX record's own answer; and no tool imports JAX or the
JAX package. The tools time with CUDA events on the card; here their timer
reads the host clock, and no number they print here is a device number.
"""

import ast
import json
from pathlib import Path

import pytest
import torch

from gym_craftingworld_tpu_torch.tools import (fast_pixel_bench, fast_ppo_bench, fast_ppo_sweep,
                                               fused_bench, fused_update_bench, fused_update_e2e)
from gym_craftingworld_tpu_torch.utils import profiling

torch.set_num_threads(1)

TOOLS = Path(fast_ppo_sweep.__file__).parent
REPO = TOOLS.parents[1]


def test_sweep_writes_the_jax_schema(tmp_path):
    out = tmp_path / "sweep.json"
    doc = fast_ppo_sweep.main(["--device", "cpu", "--candidates", "2ep_8mb", "--seeds", "0",
                               "--updates", "2", "--envs", "64", "--hidden", "64",
                               "--bench-envs", "64", "--bench-updates", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == doc
    jax = json.loads((REPO / "docs" / "fast_ppo_sweep.json").read_text())
    assert list(doc)[0] == "card" and doc["card"] == "cpu"
    assert set(jax) <= set(doc)
    for part in ("bench", "learning"):
        assert set(jax["config"][part]) <= set(doc["config"][part])
    (name, got), = doc["candidates"].items()
    assert name == "2ep_8mb (default)"
    assert set(jax["candidates"][name]) <= set(got)
    assert len(got["curves_success_per_step"]["seed0"]) == got["wall_clock_updates"] == 2
    ref = doc["reference"]["by_candidate"][name]
    assert ref["jax_tail_seed_mean"] == pytest.approx(0.0101200, abs=1e-6)
    assert ref["jax_half_tail_update"] == {"seed0": 58, "seed1": 60}
    assert ref["tail_ratio"] == pytest.approx(ref["port_tail_seed_mean"] / ref["jax_tail_seed_mean"])


def test_jax_reference_reads_the_record():
    """The windows and tails phase 22 holds the port to, from the JAX record."""
    ref = fast_ppo_sweep.jax_reference()
    default = ref["2ep_8mb (default)"]
    assert default["tail"] == pytest.approx({"seed0": 0.010134, "seed1": 0.010106}, abs=1e-6)
    assert default["early_seed_mean"] == pytest.approx(0.004074, abs=1e-6)
    assert all(len(w) == 6 for w in default["windows"].values())
    assert ref["1ep_8mb"]["tail_seed_mean"] == pytest.approx(0.00862, abs=1e-5)


def test_e2e_writes_the_jax_schema(tmp_path):
    out = tmp_path / "e2e.json"
    doc = fused_update_e2e.main(["--device", "cpu", "--envs", "64", "--updates", "2",
                                 "--hidden", "64", "--out", str(out)])
    assert json.loads(out.read_text()) == doc
    jax = json.loads((REPO / "docs" / "fused_update_e2e.json").read_text())
    assert list(doc)[0] == "card" and set(jax) <= set(doc)
    assert set(jax["config"]) <= set(doc["config"])
    assert set(doc["curves_success_per_step"]) == set(jax["curves_success_per_step"])
    assert all(len(c) == 2 for by in doc["curves_success_per_step"].values() for c in by.values())
    assert set(doc["reference"]["tail_mean"]) == {"fused_kernel", "autodiff"}


def test_within_noise_rule_gives_the_records_answer():
    """``cross_path_summary`` on the JAX record's own tails gives its noise,
    gap and verdict (``tools/fused_update_e2e.py:93-106``)."""
    jax = json.loads((REPO / "docs" / "fused_update_e2e.json").read_text())
    got = fused_update_e2e.cross_path_summary(jax["tail_mean"])
    for k in ("cross_seed_noise", "cross_path_gap"):
        assert got[k] == pytest.approx(jax[k], rel=1e-12)
    assert got["within_noise"] is jax["within_noise"] is True
    far = {"fused_kernel": {"seed0": 0.0100, "seed1": 0.0101},
           "autodiff": {"seed0": 0.0080, "seed1": 0.0081}}
    assert fused_update_e2e.cross_path_summary(far)["within_noise"] is False


def last_json_line(capsys) -> dict:
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


def test_fast_ppo_bench_prints_one_json_line(capsys):
    line = fast_ppo_bench.main(["64", "1", "--device", "cpu"])
    assert last_json_line(capsys) == line
    assert line["card"] == "cpu" and line["envs"] == 64 and line["peak_memory_gib"] is None
    assert set(line["stages_ms"]) == {"pool", "collect", "gae", "update_phase"}
    lo, hi = line["env_steps_per_s_spread"]
    assert lo <= line["env_steps_per_s"] <= hi


def test_fast_pixel_bench_prints_one_json_line(capsys):
    line = fast_pixel_bench.main(["32", "1", "preset", "--device", "cpu"])
    assert last_json_line(capsys) == line
    assert line["preset"] == "preset" and line["conv"] == [16, 32]
    assert set(line["stages_ms"]) == {"pool", "collect", "gae", "update_phase"}


def test_fused_update_bench_prints_one_json_line(capsys):
    line = fused_update_bench.main(["256", "64", "--device", "cpu"])
    assert last_json_line(capsys) == line
    assert line["flop"] == 6 * 256 * (67 * 64 + 64 * 64 + 7 * 64)
    assert line["device_ms"] is None and line["share_of_peak"] is None  # no card, no device metric


def test_fused_bench_prints_a_line_an_engine(capsys, monkeypatch):
    monkeypatch.setenv("B", "32")
    monkeypatch.setenv("T", "4")
    monkeypatch.setenv("ITERS", "1")
    lines = fused_bench.main(["--device", "cpu"])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert printed == lines and [l["engine"] for l in lines] == ["packed_scan", "packed_fused"]
    assert all({"engine", "steps_per_s"} <= set(l) and l["steps"] == 4 for l in lines)


def test_timed_runs_and_card_identity_on_the_cpu():
    calls = []
    t = profiling.timed_runs(lambda: calls.append(1), "cpu", reps=4, warmup=2)
    assert len(calls) == 6 and len(t["runs_ms"]) == 4
    assert t["min_ms"] <= t["median_ms"] <= t["max_ms"]
    assert profiling.card_identity("cpu") == "cpu"


@pytest.mark.parametrize("path", sorted(TOOLS.glob("*.py")), ids=lambda p: p.name)
def test_tools_import_no_jax(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "optax", "gym_craftingworld_tpu"}, roots
