#!/usr/bin/env python3
"""Drive the PyTorch port's headline path once on an NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (on PATH or under CUDA_HOME); imports
nothing of JAX. Phases, each of which must pass:

1. device and build: print the card's name and power limit, build
   ``gym_craftingworld_tpu_torch/csrc`` with nvcc for sm_90a;
2. main path, with the kernels' launch counters set to 0 just before: reset
   16,384 worlds on the 21x21 grid, convert them to slots, run the fused bench
   rollout, then fetch its action stream and replay it step by step; the
   replay must give the bench's final state and checksum;
3. actions kernel against its plain version (bit-exact);
4. action-stream kernel against the plain Philox (bit-exact, uniform, seeded);
5. bench kernel against its plain version (bit-exact);
6. timings with CUDA events, median of 5 runs after a warm-up.

It prints one JSON line of per-kernel results, then, as its last line,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
SOURCE = "gym_craftingworld_tpu_torch/csrc/packed_fused.cu"
JAX_KERNELS = "gym_craftingworld_tpu/ops/packed_fused.py"
B_MAIN = 16384
DEVICE = "cuda"


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def max_abs_diff(pairs) -> int:
    """Max |a - b| over pairs of integer tensors (0 when all are equal)."""
    worst = 0
    for a, b in pairs:
        check(a.shape == b.shape, f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


def time_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def world_invariants(state, cfg) -> None:
    """Every world holds one of each object on 9 distinct cells with the agent."""
    B = state.objects.shape[0]
    flat = state.objects.reshape(B, -1).to(torch.int64)
    counts = torch.zeros((B, 10), dtype=torch.int64, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    check(bool((counts[:, 1:9] == 1).all()), "one of each of the 8 objects per world")
    agent = state.agent[:, 0].to(torch.int64) * cfg.width + state.agent[:, 1]
    check(bool((flat.gather(1, agent[:, None]) == 0).all()), "agent on an empty cell")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    import gym_craftingworld_tpu_torch as cw

    pkg_root = Path(cw.__file__).resolve().parents[1]
    check(pkg_root == HERE, f"the port must come from this checkout, not {pkg_root}")
    from gym_craftingworld_tpu_torch.core import slots as sm
    from gym_craftingworld_tpu_torch.ops import _build
    from gym_craftingworld_tpu_torch.ops import packed_fused as pf
    from gym_craftingworld_tpu_torch.ops import packed_rollout as pr
    from gym_craftingworld_tpu_torch.ops import transposed_rollout as tr

    dev = torch.device(DEVICE, 0)

    # ---- 1. device and build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    tag = f"[{card}]"
    path, seconds, log = _build.build()
    print(f"{tag} built {path.relative_to(HERE)} in {seconds:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    _build.load()

    cfg = cw.ray_config()
    B = B_MAIN

    # ---- 2. the main path, counted ---------------------------------------
    wrappers = {
        "packed_bench": pf.rollout_packed_bench,
        "packed_actions": pf.rollout_packed_actions,
        "action_stream": pf.fused_action_stream,
    }
    T_MAIN, SEED = cfg.max_steps, 1
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    state = cw.reset_from_seed(cfg, 0, B, device=dev)
    slots = sm.from_env_state(state)
    torch.cuda.synchronize()
    t_reset = time.perf_counter() - t0
    final, checksum = pf.fused_rollout_packed_bench(cfg, slots, SEED, T_MAIN)
    stream = pf.fused_action_stream(B, SEED, T_MAIN, device=dev)
    replay, rewards, dones = pf.fused_rollout_packed(cfg, slots, stream, T_MAIN)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"{tag} main path B={B} T={T_MAIN}: reset+convert {t_reset * 1e3:.1f} ms "
          f"(cold), whole path {t_main * 1e3:.1f} ms (cold, host clock); "
          f"launches {launches}")
    check(all(n > 0 for n in launches.values()), f"every kernel ran: {launches}")
    world_invariants(state, cfg)
    check(tuple(rewards.shape) == (T_MAIN, B) and rewards.dtype == torch.int32,
          "reward shape")
    check(int(rewards.sum(dtype=torch.int64)) == int(checksum),
          "bench checksum equals the replay's reward sum")
    for f in sm.SlotState._fields:
        check(torch.equal(getattr(final, f), getattr(replay, f)),
              f"bench and replay agree on {f}")
    check(bool((final.step_num == T_MAIN).all()), "step_num saturates at max_steps")
    check(bool(dones[-1].all()), "every env is done at max_steps")
    objects, _, holding = sm.to_grid(final, cfg)
    n_on = (final.slot_stat == sm.ON_GRID).sum(dim=1)
    check(bool(((objects > 0).reshape(B, -1).sum(dim=1) == n_on).all()),
          "one object per cell after the rollout")
    check(bool(((holding >= 0) & (holding <= 3)).all()), "holding in range")
    n_success = int((rewards == cfg.max_steps).sum())
    print(f"{tag} main path checksum {int(checksum)}, successes {n_success}, "
          f"achieved bits {int(final.achieved.sum())}")
    state_warm = time_ms(lambda: sm.from_env_state(cw.reset_from_seed(cfg, 0, B, device=dev)))
    print(f"{tag} reset+from_env_state B={B}: {state_warm:.3f} ms (warm, median of 5)")

    results = {}

    def packed(cfg_, B_, seed):
        st = cw.reset_from_seed(cfg_, seed, B_, device=dev)
        return pr.pack(cfg_, tr.transpose_in(sm.from_env_state(st)))

    # ---- 3. actions kernel vs plain ----------------------------------------
    gen = torch.Generator(device=dev)
    worst = 0
    for cfg_, B_, mix in [(cfg, B, False),
                          (cw.flat_config(reward_equal=False), 4096, True)]:
        gen.manual_seed(1234)
        T = 64
        actions = torch.randint(0, 6, (T, B_), generator=gen, device=dev,
                                dtype=torch.int32)
        if mix:  # regular pickups and drops, so crafting fires
            t = torch.arange(T, device=dev)[:, None]
            actions = torch.where(t % 7 == 6, 4, torch.where(t % 11 == 10, 5, actions % 4))
            actions = actions.to(torch.int32).contiguous()
        p = packed(cfg_, B_, 2)
        pk, rk, dk = pf.rollout_packed_actions(cfg_, p, actions)
        pp, rp, dp = pf.rollout_packed_actions_plain(cfg_, p, actions)
        err = max_abs_diff(list(zip(pk, pp)) + [(rk, rp), (dk, dp)])
        check(err == 0, f"actions kernel bit-exact, tolerance 0 ({cfg_.height}x{cfg_.width}, err {err})")
        worst = max(worst, err)
        print(f"{tag} actions kernel == plain: {cfg_.height}x{cfg_.width} B={B_} T={T} "
              f"reward_equal={cfg_.reward_equal} successes {int((rk == cfg_.max_steps).sum())} "
              f"achieved bits {int(pk.achieved.sum())}")
    p = packed(cfg, B, 3)
    acts = torch.randint(0, 6, (64, B), generator=gen, device=dev, dtype=torch.int32)
    results["packed_actions"] = dict(
        err=worst,
        ms=time_ms(lambda: pf.rollout_packed_actions(cfg, p, acts)),
        plain_ms=time_ms(lambda: pf.rollout_packed_actions_plain(cfg, p, acts)),
        shape=f"B={B} T=64")
    ms_entry = time_ms(lambda: pf.fused_rollout_packed(cfg, slots, acts, 64))
    print(f"{tag} fused_rollout_packed (entry point, pack/unpack included) "
          f"B={B} T=64: {ms_entry:.3f} ms")

    # ---- 4. stream kernel vs plain Philox ----------------------------------
    T = 256
    sk = pf.fused_action_stream(B, 12345, T, device=dev)
    sp = pf.action_stream_plain(B, 12345, T, device=dev)
    err = max_abs_diff([(sk, sp)])
    check(err == 0, f"stream kernel bit-exact, tolerance 0 (err {err})")
    freq = torch.bincount(sk.reshape(-1).to(torch.int64), minlength=6).double() / sk.numel()
    dev_freq = float((freq - 1 / 6).abs().max())
    check(dev_freq < 2e-3, f"action frequencies within 2e-3 of 1/6 ({dev_freq:.2e})")
    s1 = pf.fused_action_stream(B, 1, T, device=dev)
    s2 = pf.fused_action_stream(B, 2, T, device=dev)
    agree = float((s1 == s2).float().mean())
    check(0.15 < agree < 0.18, f"seeds 1 and 2 give independent streams ({agree:.4f})")
    print(f"{tag} stream kernel == plain Philox: B={B} T={T}, max |freq - 1/6| "
          f"{dev_freq:.2e}, seed-1/seed-2 agreement {agree:.4f}")
    results["action_stream"] = dict(
        err=err,
        ms=time_ms(lambda: pf.fused_action_stream(B, 12345, T, device=dev)),
        plain_ms=time_ms(lambda: pf.action_stream_plain(B, 12345, T, device=dev)),
        shape=f"B={B} T={T}")

    # ---- 5. bench kernel vs plain ------------------------------------------
    T = 512
    p = packed(cfg, B, 4)
    pk, ck = pf.rollout_packed_bench(cfg, p, 99, T)
    pp, cp = pf.rollout_packed_bench_plain(cfg, p, 99, T)
    err = max_abs_diff(list(zip(pk, pp)) + [(ck, cp)])
    check(err == 0, f"bench kernel bit-exact, tolerance 0 (err {err})")
    print(f"{tag} bench kernel == plain: B={B} T={T}, checksum "
          f"{int(ck.sum(dtype=torch.int64))}")
    T = 256
    results["packed_bench"] = dict(
        err=err,
        ms=time_ms(lambda: pf.rollout_packed_bench(cfg, p, 99, T)),
        plain_ms=time_ms(lambda: pf.rollout_packed_bench_plain(cfg, p, 99, T)),
        shape=f"B={B} T={T}")

    # ---- 6. throughput -----------------------------------------------------
    for B_ in (B, 8 * B):
        p = packed(cfg, B_, 5)
        probe = time_ms(lambda: pf.rollout_packed_bench(cfg, p, 7, 4096), reps=3)
        # one run >= 0.2 s, capped so that a broken timer cannot run away
        T = min(4 * math.ceil(0.25 / (probe / 1e3 / 4096) / 4), 1 << 22)
        ms = time_ms(lambda: pf.rollout_packed_bench(cfg, p, 7, T))
        print(f"{tag} bench kernel B={B_} T={T}: {ms:.2f} ms/run, "
              f"{B_ * T / (ms / 1e3):.4e} env-steps/s (median of 5)")
    sl = sm.from_env_state(cw.reset_from_seed(cfg, 6, B, device=dev))
    gen.manual_seed(0)
    ms = time_ms(lambda: pr.rollout_p_bench(cfg, sl, gen, 256))
    print(f"{tag} plain rollout_p_bench B={B} T=256: {ms:.2f} ms/run, "
          f"{B * 256 / (ms / 1e3):.4e} env-steps/s (median of 5)")
    # the main path's stages at one episode (T = max_steps)
    ts = tr.transpose_in(sl)
    p = pr.pack(cfg, ts)
    stages = {
        "reset_from_seed": lambda: cw.reset_from_seed(cfg, 6, B, device=dev),
        "from_env_state": lambda: sm.from_env_state(state),
        "transpose_in+pack": lambda: pr.pack(cfg, tr.transpose_in(sl)),
        "bench kernel": lambda: pf.rollout_packed_bench(cfg, p, 7, T_MAIN),
        "unpack+transpose_out": lambda: tr.transpose_out(
            pr.unpack(cfg, p, ts.desired, pr._init_rows(ts)), sl.rng),
        "fused_rollout_packed_bench (entry point)":
            lambda: pf.fused_rollout_packed_bench(cfg, sl, 7, T_MAIN),
    }
    for name, fn in stages.items():
        print(f"{tag} stage {name} B={B} T={T_MAIN}: {time_ms(fn):.4f} ms "
              f"(device span, median of 5)")
    for name, r in results.items():
        print(f"{tag} {name} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms")
    print(f"launch counters of the main path: {launches}")

    replaces = {"packed_bench": f"{JAX_KERNELS}:101",
                "packed_actions": f"{JAX_KERNELS}:122",
                "action_stream": f"{JAX_KERNELS}:247"}
    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=replaces[name],
                    launches=launches[name], max_abs_err=r["err"], ms=r["ms"],
                    plain_ms=r["plain_ms"])
               for name, r in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
