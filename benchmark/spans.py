"""The program's own spans in the profiler's trace, reduced by span name.

    python3 -m benchmark.spans --workload <config>.<mix> --seed <n> --seconds <s>

The port's trainers mark their phases with ``utils/profiling.trace``
(``ppo.collect``, ``ppo.policy``, ``ppo.update``, ``ppo.grads``). In the
profiler's trace such a span is a ``user_annotation`` event on the host's
clock, which is the device operations' clock too. ``reduce`` takes the same
events and window as ``trace.reduce`` and gives, for each span name other
than the harness's unit span ``bench.unit``:

* ``count`` and ``host_s``: how many such spans, and their host seconds;
* ``device_s``: the device seconds of every kernel, copy and fill whose
  launch lies inside one of them. A device operation is matched to the
  runtime call that launched it by ``args.correlation`` (a graph's kernels
  carry their ``cudaGraphLaunch``'s), and the launch is contained by time,
  on any host thread: the autograd engine launches a backward from a thread
  of its own;
* ``idle_s``: the device's idle seconds (the gaps in the union of its
  kernels, copies and fills over the window) that overlap them.

It also counts, inside the unit spans, the runtime's launches and host
syncs, each by the innermost program span it lies in (``""``: in none), and
``per_layer`` turns all of it into numbers an iteration. Every time is in
seconds.

``trace.Trace`` does not keep these yet (it would take one field filled
from ``reduce``); until it does, the command above runs one cell as
``benchmark.run --trace 1`` does and prints its result line with a
``spans`` part: the reduction and ``per_layer``'s numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from benchmark import run as bench_run
from benchmark import trace as tracing
from benchmark.model_flops.fastppo import ppo_grads

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SYNC_NAMES = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                        "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
                        "cuEventSynchronize"})


@dataclass
class SpanTime:
    count: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0


@dataclass
class Spans:
    units: int = 0  # unit spans in the trace
    window_s: float = 0.0  # as trace.reduce's
    busy_s: float = 0.0
    by_name: dict = field(default_factory=dict)  # {span name: SpanTime}
    launches: Counter = field(default_factory=Counter)  # in unit spans, by innermost span
    syncs: Counter = field(default_factory=Counter)  # the same, of the host syncs
    idle_outside_s: float = 0.0  # idle seconds outside every program span


def _merged(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals of [start, end] rows (any number of rows)."""
    iv = np.asarray(iv, dtype=float).reshape(-1, 2)
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def _below(iv: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The length of the merged intervals ``iv`` that lies below each ``x``."""
    if len(iv) == 0:
        return np.zeros(len(x))
    k = np.searchsorted(iv[:, 0], x, side="right")
    j = np.maximum(k - 1, 0)
    before = np.concatenate([[0.0], np.cumsum(iv[:, 1] - iv[:, 0])])[j]
    part = np.clip(np.minimum(iv[j, 1], x) - iv[j, 0], 0.0, None)
    return np.where(k > 0, before + part, 0.0)


def overlap(a: np.ndarray, b: np.ndarray) -> float:
    """The length of the intersection of two sets of merged intervals."""
    if len(a) == 0 or len(b) == 0:
        return 0.0
    return float((_below(b, a[:, 1]) - _below(b, a[:, 0])).sum())


def _within(iv: np.ndarray, t: np.ndarray):
    """(inside, index): whether each time lies in one of the merged
    intervals ``iv``, and which (valid where inside)."""
    if len(iv) == 0:
        return np.zeros(len(t), bool), np.zeros(len(t), int)
    j = np.maximum(np.searchsorted(iv[:, 0], t, side="right") - 1, 0)
    return (iv[j, 0] <= t) & (t <= iv[j, 1]), j


def _interval(e) -> list:
    return [float(e["ts"]), float(e["ts"]) + float(e["dur"])]


def reduce(events: list) -> Spans:
    """The profiler's chrome-trace events reduced by program span; the
    window and busy union are ``trace.reduce``'s."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ann = [e for e in xs if e.get("cat") == "user_annotation"]
    unit_iv = [_interval(e) for e in ann if e["name"] == tracing.SPAN]
    dev = [e for e in xs if e.get("cat") in tracing.DEVICE_CATS]
    raw = {}
    for e in ann:
        if e["name"] != tracing.SPAN:
            raw.setdefault(e["name"], []).append(e)
    if not unit_iv:
        return Spans()
    start = min(s for s, _ in unit_iv)
    end = max([e for _, e in unit_iv] + [_interval(e)[1] for e in dev])
    busy = _merged(np.clip(np.array([_interval(e) for e in dev]).reshape(-1, 2), start, end))
    edges = np.concatenate([[start], busy.ravel(), [end]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    merged = {n: _merged([_interval(e) for e in es]) for n, es in raw.items()}
    runtime = [e for e in xs if e.get("cat") in RUNTIME_CATS]
    launched_at = {e["args"]["correlation"]: float(e["ts"]) for e in runtime
                   if "correlation" in e.get("args", {})}
    t_dev = np.array([launched_at.get(e.get("args", {}).get("correlation"), np.nan)
                      for e in dev])
    d_dev = np.array([float(e["dur"]) for e in dev])
    by_name = {}
    for n, es in sorted(raw.items()):
        inside, _ = _within(merged[n], t_dev)
        by_name[n] = SpanTime(len(es), sum(float(e["dur"]) for e in es) * 1e-6,
                              float(d_dev[inside].sum()) * 1e-6, overlap(gaps, merged[n]) * 1e-6)
    every = _merged(np.concatenate([np.zeros((0, 2))] + list(merged.values())))
    idle = float((gaps[:, 1] - gaps[:, 0]).sum())
    units = _merged(unit_iv)

    def innermost(events) -> Counter:
        t = np.array([float(e["ts"]) for e in events])
        label = np.full(len(t), "", dtype=object)
        best = np.full(len(t), np.inf)
        for n, iv in merged.items():
            inside, j = _within(iv, t)
            length = iv[j, 1] - iv[j, 0]
            take = inside & (length < best)
            label[take], best[take] = n, length[take]
        return Counter(label[_within(units, t)[0]].tolist())

    launches = innermost([e for e in runtime
                          if any(k in e["name"] for k in tracing.LAUNCH_NAMES)])
    syncs = innermost([e for e in runtime if e["name"] in SYNC_NAMES])
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6 if len(busy) else 0.0
    return Spans(len(unit_iv), (end - start) * 1e-6, busy_s, by_name, launches, syncs,
                 (idle - overlap(gaps, every)) * 1e-6)


def per_layer(sp: Spans, conf: dict, traffic: dict, peak: dict) -> dict:
    """The reduction's numbers an iteration, under the names their metrics
    would take: device ms and idle shares of the window by phase, launches
    and host syncs in a unit, and the gradient call's share of the bf16 peak
    (fast PPO: 6 N (F H + H H + 7 H) a minibatch over the device seconds
    under ``ppo.grads``). Empty where the trace has no device operation; a
    number whose span is missing is left out."""
    if sp.units <= 0 or sp.busy_s <= 0 or sp.window_s <= 0:
        return {}
    out = {"launches_per_iter.train": sum(sp.launches.values()) / sp.units,
           "host_syncs_per_iter.train": sum(sp.syncs.values()) / sp.units}
    for phase in ("collect", "policy", "update"):
        s = sp.by_name.get(f"ppo.{phase}")
        if s is not None:
            out[f"{phase}_device_ms.train"] = 1e3 * s.device_s / sp.units
            if phase != "policy":
                out[f"{phase}_idle_pct.train"] = 100.0 * s.idle_s / sp.window_s
    grads = sp.by_name.get("ppo.grads")
    if conf["family"] == "fastppo" and grads is not None and grads.device_s > 0:
        n = conf["rollout_steps"] * traffic["envs"] // conf["num_minibatches"]
        flops = ppo_grads(n, conf["features"], conf["hidden"])
        flops *= conf["update_epochs"] * conf["num_minibatches"] * sp.units
        out["ppo_grads_span_roofline.train"] = 100.0 * flops / grads.device_s / \
            peak["bf16_flop_per_s"]
    return out


def report(sp: Spans, conf: dict, traffic: dict, peak: dict) -> dict:
    """The reduction and ``per_layer``'s numbers as plain JSON."""
    return {**vars(sp), "by_name": {n: vars(t) for n, t in sp.by_name.items()},
            "traced_iteration_ms": 1e3 * sp.window_s / sp.units if sp.units else None,
            "per_layer": per_layer(sp, conf, traffic, peak)}


@contextlib.contextmanager
def captured(box: dict):
    """While the block runs, every trace that ``trace.profile`` reduces is
    also reduced here, into ``box["spans"]``."""
    reduce_trace = tracing.reduce

    def both(events, units):
        box["spans"] = reduce(events)
        return reduce_trace(events, units)

    tracing.reduce = both
    try:
        yield box
    finally:
        tracing.reduce = reduce_trace


def main(argv=None) -> int:
    import torch

    from benchmark import peaks

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    bench = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    spec = bench_run.cell_spec(bench, args.workload)
    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    with captured({}) as box:
        result, lines = bench_run.run_cell(bench, args.workload, args.seed, args.seconds,
                                           True, torch.device("cuda", 0), spec)
    if bench_run.forbidden_modules():
        print(f"benchmark.spans: the run loaded {bench_run.forbidden_modules()}", file=sys.stderr)
        return 4
    result["spans"] = report(box["spans"], spec["conf"], spec["traffic"],
                             peaks.peak(torch.cuda.get_device_name()))
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
