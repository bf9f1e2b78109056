"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m benchmark.run --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

A cell is ``<config>.<mix>`` of ``BENCHMARK.json``; everything about it is
found by name: ``configs/<config>.json`` (its sizes, precision and
``family``), ``traffic/<mix>.json`` (its ``entry``, envs and check steps),
the driver ``drivers/<family>_<entry>.py`` that runs the program, the
reference ``reference/<family>_<entry>.py`` that makes the inputs and judges
the outputs, ``limits/<cell>.json`` (each compared number's limit), and a
reader ``metrics/<metric>.py`` (or ``metrics/<name before the first
dot>.py``) for each metric.

A run makes its inputs from ``--seed``, builds the program's state, drives
the first ``check_steps`` units through the window's own call (they warm up
every shape), and then measures whole units for ``--seconds``. With
``--trace 1`` it goes on for about two more seconds of units under the
profiler. It then frees the program's state, runs the reference over the
recorded units and prints, last on standard error, each compared number
beside its limit. Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache the program may build sits at a fixed path inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

from benchmark import peaks  # noqa: E402
from benchmark import trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gym_craftingworld_tpu")
TRACE_SECONDS = 2.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic and limits, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    conf = load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return {"workload": w, "conf": conf, "traffic": traffic,
            "limits": load_json(HERE / "limits" / f"{workload}.json"),
            "module": f"{conf['family']}_{traffic['entry']}"}


def reader(name: str):
    """``metrics/<name>.py``, else ``metrics/<name before the first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {name!r} under metrics/")


def metrics_of(bench: dict, workload: str, per_layer: bool) -> list:
    """The cell's end-to-end metrics, or its per-layer ones: those that list
    it, or that list no cells and move a metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not per_layer:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device, spec: dict | None = None) -> tuple[dict, list]:
    """One run of a cell on ``device``: (result line, lines of the check).
    ``spec`` overrides ``cell_spec``'s (the tests run tiny cells on the CPU)."""
    spec = spec or cell_spec(bench, workload)
    conf, traffic = spec["conf"], spec["traffic"]
    driver = importlib.import_module(f"benchmark.drivers.{spec['module']}")
    ref = importlib.import_module(f"benchmark.reference.{spec['module']}")
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    inp = ref.inputs(conf, traffic, seed, device)
    cell = driver.Cell(conf, traffic, inp, device)
    sync()
    setup_s = time.perf_counter() - T_START
    units, t0 = 0, time.perf_counter()
    while units == 0 or time.perf_counter() - t0 < seconds:
        cell.unit()
        units += 1
    sync()
    window_s = time.perf_counter() - t0
    tr = tracing.profile(cell.unit, TRACE_SECONDS, cuda) if trace else None
    peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    work = cell.work_per_unit
    record = cell.finish()
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, detail = ref.check(conf, traffic, inp, record, device)
    checks = {k: {"value": v, "limit": spec["limits"][k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    name = torch.cuda.get_device_name() if cuda else "cpu"
    ctx = {"setup_s": setup_s, "units": units, "window_s": window_s,
           "work_per_unit": work,
           "conf": conf, "traffic": traffic, "trace": tr,
           "peak": peaks.peak(name) if cuda else {"bf16_flop_per_s": float("nan")}}
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": units, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": name,
                         "count": 1, "memory_peak_bytes": peak_bytes}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
        result["traced_units"] = tr.units
    result["checks"] = checks
    lines = [f"detail: {json.dumps(detail)}"]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    spec = cell_spec(bench, args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), spec)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
