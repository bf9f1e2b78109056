"""``benchmark/spans.py``: the program's spans in a hand-written trace, and
in a traced tiny run on the CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import spans, trace as tracing
from benchmark.run import run_cell
from benchmark.tests.conftest import tiny

FAST, PIXEL = "fastppo-mlp512-ray21.train64k", "pixelppo-conv32-ray21.train16k"


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def unit_events(t0: float, c0: int) -> list:
    """One unit at ``t0`` (µs) of 100 µs: a collect with two policy spans, an
    update with one gradient span whose kernel a second host thread
    launches, a sync in the update and a graph of two kernels launched
    outside every phase; correlation ids from ``c0``."""
    a, run, k = (lambda cat, name, ts, dur, **kw: _x(cat, name, t0 + ts, dur, **kw)), \
        "cuda_runtime", "kernel"
    return [
        a("user_annotation", "bench.unit", 0, 100),
        a("user_annotation", "ppo.collect", 5, 45),
        a("user_annotation", "ppo.policy", 10, 10),
        a("user_annotation", "ppo.policy", 30, 10),
        a("user_annotation", "ppo.update", 55, 40),
        a("user_annotation", "ppo.grads", 60, 20),
        a("cpu_op", "aten::mm", 11, 3),
        a(run, "cudaLaunchKernel", 12, 1, corr=c0),
        a(k, "policy_gemm", 15, 10, corr=c0),
        a(run, "cudaLaunchKernel", 45, 1, corr=c0 + 1),
        a(k, "env_step", 48, 12, corr=c0 + 1),
        a(run, "cudaMemcpyAsync", 57, 1, corr=c0 + 2),
        a("gpu_memcpy", "Memcpy DtoD", 61, 2, corr=c0 + 2),
        a(run, "cudaLaunchKernel", 70, 1, tid=2, corr=c0 + 3),
        a(k, "grad_kernel", 70, 20, corr=c0 + 3),
        a(run, "cudaStreamSynchronize", 92, 2),
        a(run, "cudaGraphLaunch", 96, 1, corr=c0 + 4),
        a(k, "graph_a", 97, 2, corr=c0 + 4),
        a(k, "graph_b", 99.5, 1.5, corr=c0 + 4),
    ]


def events() -> list:
    early = [_x("cuda_runtime", "cudaLaunchKernel", -5, 1, corr=99),
             _x("kernel", "warm", -3, 2, corr=99)]
    return early + unit_events(0, 1) + unit_events(100, 11)


def test_device_time_by_span_through_correlation():
    sp = spans.reduce(events())
    assert sp.units == 2
    got = {n: (s.count, s.device_s) for n, s in sp.by_name.items()}
    # the collect: its policy kernel and its env step; the update: a copy and
    # the gradient kernel launched from the second thread; the graph's kernels
    # were launched outside every phase
    want = {"ppo.collect": (2, 44e-6), "ppo.policy": (4, 20e-6),
            "ppo.update": (2, 44e-6), "ppo.grads": (2, 40e-6)}
    assert sorted(got) == sorted(want)
    for n, (count, device_s) in want.items():
        assert got[n][0] == count and got[n][1] == pytest.approx(device_s), n
    assert sp.by_name["ppo.collect"].host_s == pytest.approx(90e-6)


def test_the_idle_split_and_the_rest_make_the_traces_idle():
    evs = events()
    sp, tr = spans.reduce(evs), tracing.reduce(evs, 2)
    assert (sp.window_s, sp.busy_s) == pytest.approx((tr.window_s, tr.busy_s))
    idle = {n: s.idle_s for n, s in sp.by_name.items()}
    assert idle["ppo.collect"] == pytest.approx(66e-6)
    assert idle["ppo.policy"] == pytest.approx(30e-6)
    assert idle["ppo.update"] == pytest.approx(26e-6)
    assert idle["ppo.grads"] == pytest.approx(16e-6)
    assert sp.idle_outside_s == pytest.approx(14e-6)
    assert idle["ppo.collect"] + idle["ppo.update"] + sp.idle_outside_s == \
        pytest.approx(tr.window_s - tr.busy_s)


def test_launches_and_syncs_by_innermost_span_inside_units():
    sp = spans.reduce(events())
    # the early launch lies outside every unit; the copy is no launch
    assert sp.launches == {"ppo.policy": 2, "ppo.collect": 2, "ppo.grads": 2, "": 2}
    assert sp.syncs == {"ppo.update": 2}
    nums = spans.per_layer(sp, {"family": "pixelppo"}, {}, {})
    assert nums == pytest.approx({
        "launches_per_iter.train": 4.0, "host_syncs_per_iter.train": 1.0,
        "collect_device_ms.train": 22e-3, "policy_device_ms.train": 10e-3,
        "update_device_ms.train": 22e-3,
        "collect_idle_pct.train": 100 * 66 / 201, "update_idle_pct.train": 100 * 26 / 201})


def test_the_roofline_reads_the_gradient_span():
    conf = {"family": "fastppo", "rollout_steps": 64, "num_minibatches": 8, "update_epochs": 2,
            "features": 67, "hidden": 512}
    nums = spans.per_layer(spans.reduce(events()), conf, {"envs": 16384},
                           {"bf16_flop_per_s": 989e12})
    flops = 2.3595476582400e11 * 16 * 2  # N = 131,072 rows, 16 minibatches, 2 units
    assert nums["ppo_grads_span_roofline.train"] == pytest.approx(100 * flops / 40e-6 / 989e12)
    printed = json.loads(json.dumps(spans.report(spans.reduce(events()), conf, {"envs": 16384},
                                                 {"bf16_flop_per_s": 989e12})))
    assert printed["launches"] == {"ppo.policy": 2, "ppo.collect": 2, "ppo.grads": 2, "": 2}
    assert printed["by_name"]["ppo.grads"]["count"] == 2
    assert printed["traced_iteration_ms"] == pytest.approx(201e-3 / 2)
    assert printed["per_layer"] == pytest.approx(nums)


def test_the_traces_fields_ignore_the_program_spans():
    evs = events()
    stripped = [e for e in evs if not e["name"].startswith("ppo.")]
    assert tracing.reduce(evs, 2) == tracing.reduce(stripped, 2)
    assert spans.reduce(stripped).by_name == {}


def test_no_device_operation_gives_no_numbers():
    evs = [e for e in events() if e["cat"] not in tracing.DEVICE_CATS]
    sp = spans.reduce(evs)
    assert sp.busy_s == 0 and spans.per_layer(sp, {"family": "fastppo"}, {}, {}) == {}
    assert spans.reduce([]) == spans.Spans()
    assert np.isclose(sp.by_name["ppo.collect"].host_s, 90e-6)


@pytest.mark.parametrize("workload", [FAST, PIXEL])
def test_a_traced_cpu_rehearsal_finds_the_program_spans(bench, workload):
    spec = tiny(bench, workload)
    with spans.captured({}) as box:
        result, lines = run_cell(bench, workload, 2**31 + 7, 0.01, True, "cpu", spec)
    assert result["correct"], lines
    sp, conf = box["spans"], spec["conf"]
    n = sp.units
    assert n == result["traced_units"] >= 1
    counts = {name: s.count for name, s in sp.by_name.items()}
    assert counts == {"ppo.collect": n, "ppo.policy": conf["rollout_steps"] * n,
                      "ppo.update": n,
                      "ppo.grads": conf["update_epochs"] * conf["num_minibatches"] * n}
    # the CPU's trace has no device operation: no numbers, no error
    assert spans.per_layer(sp, conf, spec["traffic"], {}) == {}
    assert set(result["metrics"]) <= {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
