"""Tracing / profiling helpers.

Counterpart of ``gym_craftingworld_tpu/utils/profiling.py``. ``trace(name)``
is the port's one span API (the JAX package's ``TraceAnnotation``): while a
``torch.profiler`` session records, it enters
``torch.profiler.record_function(name)``, so the span lands in the
profiler's trace beside the device operations it launches, on the same
clock; otherwise it is an empty context and costs one check of the
profiler's state. Spans live only in the profiler's trace: the port keeps
no file, thread or buffer of its own for them.

The trainers' spans, the same names in ``train/fast_ppo.py`` and
``train/fast_pixel_ppo.py``, which ``benchmark/spans.py`` reduces to device
and idle time by phase:

* ``ppo.collect``: the collect of an iteration (once an iteration);
* ``ppo.policy``: step t's policy forward and action draw, inside the
  collect (T an iteration);
* ``ppo.update``: the update phase (once an iteration);
* ``ppo.grads``: a minibatch's gradient call, inside the update (epochs x
  minibatches an iteration).

``train/run.py`` wraps each step in ``train_step``.

The port adds what its tools (``gym_craftingworld_tpu_torch/tools/``) share:
``card_identity`` names the card and its power limit, ``timed_runs`` times a
function with CUDA events (median and spread of n runs after a warm-up),
``graph_ms`` times a short call's device work from a CUDA graph of n calls,
and ``device_time_ms`` reads a call's device time from ``torch.profiler``;
``kernel_wrappers`` and ``plain_versions`` name the hand-written kernels'
wrappers and their plain versions, whose ``launches`` and ``calls`` counters
``counted`` reads around a call.
"""

from __future__ import annotations

import contextlib
import importlib
import statistics
import subprocess
import time

import torch


_NO_SPAN = contextlib.nullcontext()


def trace(name: str):
    """A span named ``name`` in the profiler's trace while one records, else
    an empty context. Enters no ``record_function`` and makes no host sync
    when no profiler records."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def card_identity(device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for
    ``device``'s index; ``"cpu"`` for a CPU device. Raises if ``nvidia-smi``
    fails on a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[device.index or 0].strip()


def timed_runs(fn, device, reps: int = 5, warmup: int = 1) -> dict:
    """``fn()`` run ``warmup`` times, then timed ``reps`` times: the median,
    least and most ms of a run, and every run's ms.

    On a CUDA device each run lies between two CUDA events (the device span
    of the work it enqueues, host pacing included); on the CPU, which only
    the tests use, between two reads of the host clock.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    runs = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            runs.append(1e3 * (time.perf_counter() - t0))
    return {"median_ms": statistics.median(runs), "min_ms": min(runs), "max_ms": max(runs),
            "runs_ms": runs}


def graph_ms(fn, n: int = 20, replays: int = 5) -> float:
    """Device ms a call of ``fn()`` on the card: ``n`` calls captured in one
    CUDA graph, replayed ``replays`` times, each between CUDA events; the
    median replay over ``n``. CUDA events around calls made one by one read
    the host's pace instead when a call's Python outlasts its kernel."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return statistics.median(runs)


def device_time_ms(fn, reps: int = 10) -> dict:
    """Device time of a call of ``fn()`` on the card (``torch.profiler``).

    One warm-up call, then ``reps`` calls inside a ``record_function`` range;
    the device records of the launches made inside that range, matched to
    their host calls by correlation id, are summed by kernel name. Returns
    ``{"ms": total per call, "kernels": {name: ms per call}, "launches":
    launches per call, "lost": launches that left no device record}``.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    window_name = "timed calls"
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(window_name):
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    recs = list(prof.profiler.kineto_results.events())
    on_card = lambda e: "CUDA" in str(e.device_type())
    (window,) = [e for e in recs if e.name() == window_name and not on_card(e)]
    launches = [e for e in recs if not on_card(e) and "LaunchKernel" in e.name()
                and window.start_ns() <= e.start_ns() <= window.end_ns()]
    device = {e.correlation_id(): e for e in recs if on_card(e)}
    kernels = {}
    for c in launches:
        d = device.get(c.correlation_id())
        if d is not None:
            kernels[d.name()] = kernels.get(d.name(), 0.0) + d.duration_ns() / 1e6 / reps
    lost = sum(c.correlation_id() not in device for c in launches)
    return {"ms": sum(kernels.values()), "kernels": kernels,
            "launches": len(launches) / reps, "lost": lost}


def kernel_wrappers(*names) -> dict:
    """{name: wrapper} of the nine hand-written kernels, or of those named,
    each counting its launches in ``launches``."""
    from gym_craftingworld_tpu_torch.ops import fused_reset as fre
    from gym_craftingworld_tpu_torch.ops import fused_update as fu
    from gym_craftingworld_tpu_torch.ops import packed_fused as pf

    fr = importlib.import_module("gym_craftingworld_tpu_torch.ops.fused_rollout")
    frt = importlib.import_module("gym_craftingworld_tpu_torch.ops.fused_rollout_t")
    every = {"packed_bench": pf.rollout_packed_bench, "packed_actions": pf.rollout_packed_actions,
             "action_stream": pf.fused_action_stream, "pool": fre.pool_picks,
             "ppo_grads": fu.fused_minibatch_grads,
             "ppo_grads_indexed": fu.fused_minibatch_grads_indexed,
             "fused_rollout": fr.rollout_slots_seeded,
             "fused_rollout_actions": fr.rollout_slots_actions,
             "fused_rollout_t": frt.rollout_t_seeded}
    return {k: every[k] for k in names} if names else every


def plain_versions() -> list:
    """Every kernel's plain version, each counting its calls in ``calls``."""
    from gym_craftingworld_tpu_torch.ops import fused_reset as fre
    from gym_craftingworld_tpu_torch.ops import fused_update as fu
    from gym_craftingworld_tpu_torch.ops import packed_fused as pf

    fr = importlib.import_module("gym_craftingworld_tpu_torch.ops.fused_rollout")
    frt = importlib.import_module("gym_craftingworld_tpu_torch.ops.fused_rollout_t")
    return [fre.fresh_packed_plain, fu.ppo_grads_plain, pf.rollout_packed_actions_plain,
            pf.rollout_packed_bench_plain, pf.action_stream_plain, fr.rollout_slots_seeded_plain,
            fr.rollout_slots_actions_plain, frt.rollout_t_seeded_plain]


def counted(fn):
    """``(fn(), launches, calls)``: the kernels ``fn()`` launched and the plain
    versions it called, as {name: count} of those that ran."""
    wrappers, plains = kernel_wrappers(), plain_versions()
    before = ({k: w.launches for k, w in wrappers.items()}, [f.calls for f in plains])
    out = fn()
    launches = {k: w.launches - before[0][k] for k, w in wrappers.items()}
    calls = {f.__name__: f.calls - c for f, c in zip(plains, before[1])}
    return (out, {k: n for k, n in launches.items() if n},
            {k: n for k, n in calls.items() if n})
