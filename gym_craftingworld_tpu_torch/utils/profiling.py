"""Tracing / profiling helpers.

Counterpart of ``gym_craftingworld_tpu/utils/profiling.py``: ``trace``
annotates a region for ``torch.profiler`` (the JAX package's
``TraceAnnotation``), ``capture_trace`` records a Chrome trace of the host
and, where there is one, the card; ``Throughput`` is a copy of the JAX
package's framework-free counter.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(name: str):
    """Annotate a region for torch.profiler traces."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Record a trace of the block, host and card, as ``log_dir/trace.json``
    (Chrome trace format; open it in Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """Env-steps/s counter with exponential smoothing."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.rate = None
        self._t = None

    def tick(self, steps: int) -> float | None:
        now = time.perf_counter()
        if self._t is not None:
            inst = steps / (now - self._t)
            self.rate = (
                inst
                if self.rate is None
                else self.alpha * inst + (1 - self.alpha) * self.rate
            )
        self._t = now
        return self.rate
