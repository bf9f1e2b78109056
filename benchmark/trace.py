"""The profiler's trace of a window, reduced to what the per-layer metrics read.

``profile(unit, seconds)`` runs whole units under ``torch.profiler`` (host
and device activities) until ``seconds`` have passed, each inside the
harness's own span ``bench.unit``, and returns a ``Trace``: the window from
the first unit's span to the end of the last device operation or span,
the device's busy seconds (the union of its kernels, copies and fills), the
host's launches of kernels and graphs, the device time by kernel name, and
the idle gaps labelled by the innermost host operation running when each
gap began. All times are the trace's own clock, in seconds.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("LaunchKernel", "GraphLaunch", "LaunchCooperativeKernel")
SPAN = "bench.unit"


@dataclass
class Trace:
    units: int
    window_s: float
    busy_s: float
    launches: int
    kernel_s: Counter = field(default_factory=Counter)  # device seconds by kernel name
    idle_by_host: Counter = field(default_factory=Counter)  # idle seconds by host operation

    def kernel_time(self, names) -> float:
        """Device seconds of the kernels whose names contain any of ``names``."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))

    def breakdown(self) -> dict:
        top = lambda c: [[k, v] for k, v in c.most_common(10)]
        return {"device_ops": top(self.kernel_s), "idle_gaps": top(self.idle_by_host)}


def profile(unit, seconds: float, cuda: bool = True) -> Trace:
    """``cuda`` False traces the host alone (a rehearsal on the CPU)."""
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        n, t0 = 0, time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < seconds:
            with record_function(SPAN):
                unit()
            n += 1
        sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events, n)


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals of [start, end] rows."""
    iv = iv[np.argsort(iv[:, 0])]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def reduce(events: list, units: int) -> Trace:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == SPAN]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not spans or not dev:
        return Trace(units, 0.0, 0.0, 0)
    start = min(float(e["ts"]) for e in spans)
    end = max(max(float(e["ts"]) + float(e["dur"]) for e in spans),
              max(float(e["ts"]) + float(e["dur"]) for e in dev))
    iv = np.array([[float(e["ts"]), float(e["ts"]) + float(e["dur"])] for e in dev])
    iv = np.clip(iv, start, end)
    busy = _union(iv)
    kernel_s = Counter()
    for e in dev:
        kernel_s[e["name"][:160]] += float(e["dur"]) * 1e-6
    launches = sum(1 for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and any(n in e["name"] for n in LAUNCH_NAMES))
    gaps = np.stack([np.concatenate([[start], busy[:, 1]]),
                     np.concatenate([busy[:, 0], [end]])], axis=1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    ops = [e for e in xs if e.get("cat") in ("cpu_op", "cuda_runtime")]
    ops.sort(key=lambda e: float(e["ts"]))
    o_start = np.array([float(e["ts"]) for e in ops])
    o_end = o_start + np.array([float(e["dur"]) for e in ops])
    idle = Counter()
    for g0, g1 in gaps:
        i = int(np.searchsorted(o_start, g0, side="right"))
        label, best = "host: no operation", np.inf
        for j in range(i - 1, max(i - 256, 0) - 1, -1):
            if o_end[j] >= g0 and o_end[j] - o_start[j] < best:
                label, best = ops[j]["name"][:160], o_end[j] - o_start[j]
        idle[label] += (g1 - g0) * 1e-6
    return Trace(units, (end - start) * 1e-6, float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6,
                 launches, kernel_s, idle)
