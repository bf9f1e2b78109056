"""BENCHMARK.json against the contract's form, and every file it names found by name."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import model_flops
from benchmark.model_flops.fastppo import ppo_grads
from benchmark.run import HERE, ROOT, FORBIDDEN, cell_spec, load_json, metrics_of, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_names_and_units_use_the_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    for text in [w["why"] for w in bench["workloads"]] + [m["layer"] for m in bench["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_cell_finds_its_files_by_name(bench):
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        spec = cell_spec(bench, w["name"])
        for part in ("drivers", "reference"):
            assert (HERE / part / f"{spec['module']}.py").exists()
        conf = next(c for c in bench["configs"] if c["name"] == w["config"])
        assert (ROOT / conf["file"]).resolve() == (HERE / "configs" / f"{w['config']}.json")
        for m in metrics_of(bench, w["name"], False) + metrics_of(bench, w["name"], True):
            assert callable(reader(m["name"]))


def test_each_per_layer_metric_moves_a_metric_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    for w in bench["workloads"]:
        reported = [m["name"] for m in metrics_of(bench, w["name"], False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert metrics_of(bench, w["name"], True)


def test_flop_counters_match_hand_counts():
    assert ppo_grads(131072, 67, 512) == 2.3595476582400e11
    fast = load_json(HERE / "configs" / "fastppo-mlp512-ray21.json")
    assert model_flops.forward(fast) == 2 * (67 * 512 + 512 * 512 + 7 * 512)
    # 65,536 envs: (T B + B) forwards and 3 E T B more, 600,064 FLOP a forward
    assert model_flops.train_iteration(fast, 65536) == 600064 * (64 * 65536 * 7 + 65536)
    pixel = load_json(HERE / "configs" / "pixelppo-conv32-ray21.json")
    # 11 x 11 x 32 x 108 + 6 x 6 x 64 x 288 + 2,326 x 256 + 256 x 7 multiply-adds
    assert model_flops.forward(pixel) == 2 * (418176 + 663552 + 595456 + 1792)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_neither_jax_nor_the_program():
    for path in (HERE / "reference").glob("*.py"):
        found = _imports(path)
        assert not found & set(FORBIDDEN), (path.name, found)
        assert "gym_craftingworld_tpu_torch" not in found, path.name
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(FORBIDDEN), path


@pytest.mark.parametrize("workload", ["fastppo-mlp512-ray21.train64k",
                                      "fastppo-mlp512-ray21.rollout16k"])
def test_a_cpu_rehearsal_of_a_run_loads_no_jax(workload):
    code = f"""
import sys, torch
torch.set_num_threads(2)
from benchmark.tests.conftest import tiny
from benchmark.run import ROOT, load_json, run_cell, FORBIDDEN
bench = load_json(ROOT / "BENCHMARK.json")
result, lines = run_cell(bench, {workload!r}, 2**31 + 5, 0.01, False, "cpu", tiny(bench, {workload!r}))
assert result["correct"], lines
print(sorted({{m.split(".")[0] for m in sys.modules}} & set(FORBIDDEN)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "fastppo-mlp512-ray21.train64k", "--seed", "3", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
