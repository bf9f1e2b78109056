#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA GPU and check its kernels.

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
6. timings with CUDA events, median of 5 runs after a warm-up;
7. the fast-PPO trainer at full width, with every counter set to 0 just
   before: 16,384 envs on 21x21, the default ``FastPPOConfig`` (hidden 512,
   T=64, 2 epochs x 8 minibatches), ``train_many_fast`` for 3 updates, then
   the trained policy's loss and gradient on one fresh minibatch through
   ``fused_minibatch_grads``; the same 3 updates with ``throughput()``. The
   pool, indexed-gradient and actions kernels must have run 3, 48 and 192
   times, and no plain version at all;
8. pool kernel against its plain version (bit-exact) at n=32,768;
9. gradient kernels against their plain version at N=131,072, H=512, F=67
   (the CPU suite's tolerances), indexed against gathered (rtol 1e-6), and
   two launches bit-identical;
10. fast-PPO timings with CUDA events: ms per update, collect, update phase,
   pool and gradient kernels against their plain versions;
11. the engine ladder at full width, with every counter set to 0 just before:
   16,384 worlds on 21x21 and the Philox stream of one episode (T=300) run
   through the grid ``rollout``, ``fused_rollout_actions``, ``fused_rollout``,
   ``fused_rollout_t`` and ``fused_rollout_packed_bench`` from one state; all
   five must agree (rewards, dones, final states, checksum), the three slot
   kernels must have run once each and no plain version at all;
12. the three slot kernels against their plain versions (bit-exact) on 21x21
   at B=16,384, on 8x8 with pickups and drops, on a ragged batch, from the
   ladder's final state, and from synthetic states no reset reaches;
13. ladder timings with CUDA events: each slot kernel against its plain
   version, env-steps/s of the seeded slot kernels beside the packed bench
   kernel's, and ms per step of the three plain-torch engines.

It prints one JSON line of per-kernel results, then, as its last line,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import importlib
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
PPO_UPDATES = 3
# steps per launch when timing the seeded slot kernels: the [T, B] reward and
# done slabs (5 bytes an env-step, 671 MB at B_MAIN) bound one launch's T
T_CHUNK = 8192
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
    kernels += fast_ppo_phases(cw, dev, tag)
    kernels += ladder_phases(cw, dev, tag)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# the fast-PPO trainer (phases 7-10)
# ---------------------------------------------------------------------------


def grads_err(got: dict, want: dict):
    """(max |got - want|, max relative error, min cosine) over the gradients."""
    worst_abs, worst_rel, worst_cos = 0.0, 0.0, 1.0
    for k in want:
        a, b = got[k].double(), want[k].double()
        worst_abs = max(worst_abs, float((a - b).abs().max()))
        worst_rel = max(worst_rel, float((a - b).abs().max() / b.abs().max().clamp_min(1e-6)))
        worst_cos = min(worst_cos, float((a * b).sum() / (a.norm() * b.norm() + 1e-12)))
    return worst_abs, worst_rel, worst_cos


def random_minibatch(gen, dev, n, F):
    """The CPU suite's random minibatch (binary features at 30%), on the card."""
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    old_v = r(n)
    return ((torch.rand((n, F), generator=gen, device=dev) < 0.3).to(torch.bfloat16),
            torch.randint(0, 6, (n,), generator=gen, device=dev, dtype=torch.int32),
            -r(n).abs() - 0.5, old_v, r(n), old_v + 0.5 * r(n))


def fast_ppo_phases(cw, dev, tag):
    from gym_craftingworld_tpu_torch.ops import fused_reset as fr
    from gym_craftingworld_tpu_torch.ops import fused_update as fu
    from gym_craftingworld_tpu_torch.ops import packed_fused as pf
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp

    cfg, B, T_ = cw.ray_config(), B_MAIN, PPO_UPDATES
    F = fp.feature_rows(cfg)
    wrappers = {"pool": fr.pool_picks, "ppo_grads": fu.fused_minibatch_grads,
                "ppo_grads_indexed": fu.fused_minibatch_grads_indexed,
                "packed_actions": pf.rollout_packed_actions,
                "packed_bench": pf.rollout_packed_bench,
                "action_stream": pf.fused_action_stream}
    plains = [fr.fresh_packed_plain, fu.ppo_grads_plain, pf.rollout_packed_actions_plain,
              pf.rollout_packed_bench_plain, pf.action_stream_plain]
    gen = torch.Generator(device=dev)

    # ---- 7. the trainer at full width, counted ------------------------------
    main_launches = {}
    for preset, fppo in (("default", fp.FastPPOConfig()),
                         ("throughput", fp.FastPPOConfig.throughput())):
        gen.manual_seed(7)
        env = fr.fresh_packed_fused(cfg, 11, B, device=dev)
        ts = fp.init_fast_train_state(gen, cfg, fppo)
        w1_0 = ts.params.w1.detach().clone()
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        for f in plains:
            f.calls = 0
        t0 = time.perf_counter()
        ts, env, gen, m = fp.train_many_fast(cfg, fppo, ts, env, T_, gen)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}  # of the 3 updates
        if preset == "default":
            # score the trained policy: its loss and gradient on one fresh minibatch
            with torch.no_grad():
                pool = fp._fresh_pool(cfg, gen, 2 * B)
                u = fp.gumbel_uniforms(gen, (fppo.rollout_steps, 6, B))
                env, traj = fp._collect(cfg, fppo, ts.params, env, pool, u)
                _, last_value = fp.apply_policy(ts.params, fp.features(cfg, env))
                adv, ret = fp._gae(fppo, traj, last_value)
            n_mb = fppo.rollout_steps * B // fppo.num_minibatches
            batch = (traj.feat.permute(0, 2, 1).reshape(-1, F)[:n_mb],) + tuple(
                x.reshape(-1)[:n_mb] for x in (traj.action, traj.log_prob, traj.value, adv, ret))
            g_eval, aux_eval = fu.fused_minibatch_grads(fppo, ts.params, batch)
            torch.cuda.synchronize()
        calls = {f.__name__: f.calls for f in plains}
        n_mb_total = T_ * fppo.update_epochs * fppo.num_minibatches
        print(f"{tag} fast PPO {preset}: B={B} hidden={fppo.hidden} T={fppo.rollout_steps} "
              f"{fppo.update_epochs}x{fppo.num_minibatches} minibatches, {T_} updates in "
              f"{t_train * 1e3:.1f} ms (cold, host clock); launches {launches}; "
              f"plain calls {calls}")
        check(launches["pool"] == T_, f"pool kernel once per update ({launches['pool']})")
        check(launches["ppo_grads_indexed"] == n_mb_total,
              f"indexed gradient kernel once per minibatch ({launches['ppo_grads_indexed']})")
        check(launches["packed_actions"] == T_ * fppo.rollout_steps,
              f"actions kernel once per collect step ({launches['packed_actions']})")
        check(all(c == 0 for c in calls.values()), f"no plain version ran: {calls}")
        metrics = {k: v.tolist() for k, v in m.items()}
        print(f"{tag} fast PPO {preset} metrics: {json.dumps(metrics)}")
        check(all(math.isfinite(x) for v in metrics.values() for x in v), "finite metrics")
        check(all(len(v) == T_ for v in metrics.values()), "metrics stacked per update")
        check(not torch.equal(w1_0, ts.params.w1), "w1 changed")
        check(abs(metrics["entropy"][0] - math.log(6)) < 0.05,
              f"first update's entropy within 0.05 of log 6 ({metrics['entropy'][0]:.4f})")
        check(bool(((env.slot_key >= 0) & (env.slot_key <= cfg.n_cells + 1)).all()),
              "env keys in range after training")
        if preset == "default":
            main_launches = {k: w.launches for k, w in wrappers.items()}  # the whole path
            print(f"{tag} launches of the whole default path (training and scoring): "
                  f"{main_launches}")
            check(main_launches["ppo_grads"] == 1, "the scoring gradient ran through the kernel")
            check(all(f.calls == 0 for f in plains), "no plain version ran while scoring")
            check(all(torch.isfinite(g).all() for g in g_eval.values())
                  and all(math.isfinite(float(v)) for v in aux_eval.values()),
                  "finite scoring gradient and loss")
            check(all(g_eval[k].shape == getattr(ts.params, k).shape for k in g_eval),
                  "gradient shapes")
            print(f"{tag} trained policy on one fresh minibatch: "
                  f"{ {k: round(float(v), 6) for k, v in aux_eval.items()} }")

    results = {}
    # ---- 8. pool kernel vs plain ----------------------------------------------
    n_pool = 2 * B
    for cfg_ in (cfg, cw.flat_config(stacking=False), cw.flat_config(selected_task_indices=(1, 4))):
        for seeds in ((1234, 77), (-5, 2**31 - 1)):
            sd = torch.tensor(seeds, dtype=torch.int32, device=dev)
            got = fr.assemble(cfg_, fr.pool_picks(cfg_, sd, n_pool))
            want = fr.fresh_packed_plain(cfg_, sd, n_pool)
            err = max_abs_diff(list(zip(got, want)))
            check(err == 0, f"pool kernel bit-exact, tolerance 0 ({cfg_.height}x{cfg_.width} "
                  f"stacking={cfg_.stacking} tasks={cfg_.selected_task_indices}, err {err})")
        des = got.desired.to(torch.int64)
        bits = ((des[:, None] >> torch.arange(9, device=dev)) & 1).sum(dim=1)
        print(f"{tag} pool kernel == plain: {cfg_.height}x{cfg_.width} n={n_pool} "
              f"stacking={cfg_.stacking} tasks={cfg_.selected_task_indices}; tasks per world "
              f"{torch.bincount(bits, minlength=10).tolist()}")
    sd = torch.tensor([1234, 77], dtype=torch.int32, device=dev)
    agent = fr.fresh_packed_plain(cfg, sd, n_pool).init_agent_key.to(torch.int64)
    counts = torch.bincount(agent, minlength=cfg.n_cells).double()
    expected = n_pool / cfg.n_cells
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    check(chi2 < 440 + 6 * math.sqrt(880), f"agent cell uniform (chi2 {chi2:.1f}, dof 440)")
    results["pool"] = dict(
        err=0, ms=time_ms(lambda: fr.pool_picks(cfg, sd, n_pool)),
        plain_ms=time_ms(lambda: fr.fresh_packed_plain(cfg, sd, n_pool)),
        shape=f"n={n_pool} 21x21", replaces="gym_craftingworld_tpu/ops/fused_reset.py:71",
        source="gym_craftingworld_tpu_torch/csrc/fused_reset.cu")
    ms_entry = time_ms(lambda: fr.fresh_packed_fused(cfg, sd[0], n_pool, seed2=sd[1]))
    print(f"{tag} fresh_packed_fused (entry point, assembly included) n={n_pool}: "
          f"{ms_entry:.4f} ms; agent-cell chi2 {chi2:.1f} (dof 440)")

    # ---- 9. gradient kernels vs plain -----------------------------------------
    fppo = fp.FastPPOConfig()
    gen.manual_seed(3)
    params = fp.init_params(gen, cfg, fppo)
    N = fppo.rollout_steps * B // fppo.num_minibatches
    batch = random_minibatch(gen, dev, N, F)
    w = fu.weights(params)
    rest = fu._rest(*batch[1:])
    gk, ak = fu.fused_minibatch_grads(fppo, params, batch)
    gk2, _ = fu.fused_minibatch_grads(fppo, params, batch)
    gp, *rows = fu.ppo_grads_plain(fppo, w, batch[0], *rest)
    _, ap = fu._finish(fppo, N, gp, *rows)
    err_abs, err_rel, cos = grads_err(gk, gp)
    loss_err = max(abs(float(ak[k]) - float(ap[k])) / (2e-4 + 2e-3 * abs(float(ap[k]))) for k in ak)
    print(f"{tag} gradient kernel vs plain N={N} H={fppo.hidden} F={F}: max abs err {err_abs:.3e}, "
          f"max rel err {err_rel:.3e} (limit 3e-2), min cosine {cos:.7f} (limit 0.999), "
          f"loss err / tolerance {loss_err:.3e}; kernel {ak['loss']:.7f} plain {ap['loss']:.7f}")
    check(err_rel < 3e-2 and cos > 0.999 and loss_err <= 1, "gradient kernel within tolerance")
    check(all(torch.equal(gk[k], gk2[k]) for k in gk), "two launches give the same bits")
    BLK = fp.shuffle_block(fppo.rollout_steps, B, fppo.num_minibatches)
    NB = fppo.rollout_steps * B // BLK
    featb = (torch.rand((NB, BLK, F), generator=gen, device=dev) < 0.3).to(torch.bfloat16)
    ids = torch.randperm(NB, generator=gen, device=dev)[: NB // fppo.num_minibatches]
    gi, ai = fu.fused_minibatch_grads_indexed(fppo, params, featb, ids, batch[1:])
    gathered = (featb[ids].reshape(N, F),) + batch[1:]
    gg, ag = fu.fused_minibatch_grads(fppo, params, gathered)
    idx_rel = max(float(((gi[k] - gg[k]).abs() / gg[k].abs().clamp_min(1e-30)).max()) for k in gi)
    check(all(torch.allclose(gi[k], gg[k], rtol=1e-6, atol=0) for k in gi)
          and abs(float(ai["loss"]) - float(ag["loss"])) <= 1e-6 * abs(float(ag["loss"])),
          f"indexed equals gathered at rtol 1e-6 ({idx_rel:.3e})")
    gpi, *rows_i = fu.ppo_grads_plain(fppo, w, gathered[0], *fu._rest(*batch[1:]))
    err_abs_i, err_rel_i, cos_i = grads_err(gi, gpi)
    check(err_rel_i < 3e-2 and cos_i > 0.999, "indexed kernel within tolerance of plain")
    print(f"{tag} indexed kernel == gathered kernel (max rel diff {idx_rel:.3e}); vs plain: "
          f"max abs err {err_abs_i:.3e}, max rel err {err_rel_i:.3e}, min cosine {cos_i:.7f}")
    results["ppo_grads"] = dict(
        err=err_abs, ms=time_ms(lambda: fu.fused_minibatch_grads(fppo, params, batch)),
        plain_ms=time_ms(lambda: fu._finish(fppo, N, *fu.ppo_grads_plain(
            fppo, fu.weights(params), batch[0], *fu._rest(*batch[1:])))),
        shape=f"N={N} H={fppo.hidden}", replaces="gym_craftingworld_tpu/ops/fused_update.py:57",
        source="gym_craftingworld_tpu_torch/csrc/fused_update.cu")
    results["ppo_grads_indexed"] = dict(
        err=err_abs_i,
        ms=time_ms(lambda: fu.fused_minibatch_grads_indexed(fppo, params, featb, ids, batch[1:])),
        plain_ms=time_ms(lambda: fu._finish(fppo, N, *fu.ppo_grads_plain(
            fppo, fu.weights(params), featb[ids].reshape(N, F), *fu._rest(*batch[1:])))),
        shape=f"N={N} H={fppo.hidden} BLK={BLK}",
        replaces="gym_craftingworld_tpu/ops/fused_update.py:270",
        source="gym_craftingworld_tpu_torch/csrc/fused_update.cu")

    # ---- 10. fast-PPO timings ----------------------------------------------------
    for preset, fppo in (("default", fp.FastPPOConfig()),
                         ("throughput", fp.FastPPOConfig.throughput())):
        gen.manual_seed(5)
        state = {"ts": fp.init_fast_train_state(gen, cfg, fppo),
                 "env": fr.fresh_packed_fused(cfg, 12, B, device=dev)}

        def step(**kw):
            state["ts"], state["env"], _, _ = fp.train_step_fast(
                cfg, fppo, state["ts"], state["env"], gen, **kw)

        ms_k = time_ms(step)
        ms_p = time_ms(lambda: step(fused_pool=False, fused_update=False))
        ms_k2 = time_ms(step)
        env0 = state["env"]
        pool = fp._fresh_pool(cfg, gen, 2 * B)
        u = fp.gumbel_uniforms(gen, (fppo.rollout_steps, 6, B))
        with torch.no_grad():
            ms_collect = time_ms(lambda: fp._collect(cfg, fppo, state["ts"].params, env0, pool, u))
            _, traj = fp._collect(cfg, fppo, state["ts"].params, env0, pool, u)
            _, lv = fp.apply_policy(state["ts"].params, fp.features(cfg, env0))
            adv, ret = fp._gae(fppo, traj, lv)
        NBp = fppo.rollout_steps * B // fp.shuffle_block(fppo.rollout_steps, B, fppo.num_minibatches)
        perms = torch.stack([torch.randperm(NBp, generator=gen, device=dev)
                             for _ in range(fppo.update_epochs)])
        ms_update = time_ms(lambda: fp._update_phase(fppo, state["ts"], traj, adv, ret, perms))
        ms_pool = time_ms(lambda: fp._fresh_pool(cfg, gen, 2 * B))
        ms_gae = time_ms(lambda: fp._gae(fppo, traj, lv))
        env_steps = B * fppo.rollout_steps
        print(f"{tag} fast PPO {preset} B={B} hidden={fppo.hidden}: "
              f"{ms_k:.2f} / {ms_k2:.2f} ms per update through the kernels "
              f"({env_steps / (ms_k2 / 1e3):.4e} env-steps/s), {ms_p:.2f} ms with "
              f"fused_pool=False, fused_update=False (median of 5, CUDA events); stages: "
              f"pool {ms_pool:.3f} ms, collect {ms_collect:.2f} ms, GAE {ms_gae:.3f} ms, "
              f"update phase {ms_update:.2f} ms")
    for name, r in results.items():
        print(f"{tag} {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return [dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
                 launches=main_launches[name], max_abs_err=r["err"], ms=r["ms"],
                 plain_ms=r["plain_ms"])
            for name, r in results.items()]


# ---------------------------------------------------------------------------
# the engine ladder and the slot-layout kernels (phases 11-13)
# ---------------------------------------------------------------------------


def off_grid_at_origin(slots, sm):
    """The packed layout keeps no cell for a held or removed slot (its unpack
    writes (0, 0)); the slot layouts keep the last one."""
    on = (slots.slot_stat == sm.ON_GRID)[..., None]
    return slots._replace(slot_pos=torch.where(on, slots.slot_pos, 0))


def synthetic_slots(sm, cfg, B, gen, dev):
    """Slot states no reset reaches: any slot types (repeats included), slots
    crowded onto four cells per env, the agent on one of them half the time,
    any status mix (several held, removed), any task bits."""
    H, W = cfg.height, cfg.width
    r = lambda hi, shape: torch.randint(0, hi, shape, generator=gen, device=dev,
                                        dtype=torch.int32)
    hot = r(H * W, (B, 4))
    pos = torch.where(r(10, (B, 8)) < 7, hot.gather(1, r(4, (B, 8)).long()),
                      r(H * W, (B, 8)))
    agent = torch.where(r(2, (B,)) == 0, hot[:, 0], r(H * W, (B,)))
    init_pos = torch.where(r(2, (B, 8)) == 0, pos, r(H * W, (B, 8)))
    init_agent = torch.where(r(5, (B,)) < 2, agent, r(H * W, (B,)))
    rc = lambda lin: torch.stack([lin // W, lin % W], dim=-1).to(torch.int32)
    stat = torch.tensor([0, 0, 0, 0, 1, 2], dtype=torch.int32, device=dev)[r(6, (B, 8)).long()]
    achieved = r(2, (B, 9)).to(torch.int8)
    desired = torch.where(r(10, (B, 1)) < 3, achieved, r(2, (B, 9)).to(torch.int8))
    init_type = torch.argsort(torch.rand((B, 8), generator=gen, device=dev), dim=1) + 1
    return sm.SlotState(
        slot_type=r(8, (B, 8)) + 1, slot_pos=rc(pos), slot_stat=stat, agent=rc(agent),
        desired=desired, achieved=achieved, init_type=init_type.to(torch.int32),
        init_pos=rc(init_pos), init_agent=rc(init_agent), step_num=r(12, (B,)),
        rng=torch.zeros((B, 2), dtype=torch.int64, device=dev))


def ladder_phases(cw, dev, tag):
    from gym_craftingworld_tpu_torch.core import slots as sm
    from gym_craftingworld_tpu_torch.core import validate
    from gym_craftingworld_tpu_torch.ops import packed_fused as pf
    from gym_craftingworld_tpu_torch.ops import packed_rollout as pr
    from gym_craftingworld_tpu_torch.ops import transposed_rollout as tr

    # the package re-exports the entry-point function under the module's name
    fr = importlib.import_module("gym_craftingworld_tpu_torch.ops.fused_rollout")
    frt = importlib.import_module("gym_craftingworld_tpu_torch.ops.fused_rollout_t")

    cfg, B = cw.ray_config(), B_MAIN
    T_MAIN, SEED = cfg.max_steps, 11
    wrappers = {"fused_rollout": fr.rollout_slots_seeded,
                "fused_rollout_actions": fr.rollout_slots_actions,
                "fused_rollout_t": frt.rollout_t_seeded,
                "packed_bench": pf.rollout_packed_bench,
                "action_stream": pf.fused_action_stream}
    plains = [fr.rollout_slots_seeded_plain, fr.rollout_slots_actions_plain,
              frt.rollout_t_seeded_plain, pf.rollout_packed_bench_plain,
              pf.action_stream_plain]

    # ---- 11. the ladder at full width, counted --------------------------------
    state = cw.reset_from_seed(cfg, 21, B, device=dev)
    slots = sm.from_env_state(state)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    for f in plains:
        f.calls = 0
    t0 = time.perf_counter()
    stream = pf.fused_action_stream(B, SEED, T_MAIN, device=dev)
    grid, gout = cw.rollout(cfg, state, stream)
    s8, r8, d8 = cw.ops.fused_rollout_actions(cfg, slots, stream)
    s7, r7, d7 = cw.ops.fused_rollout(cfg, slots, SEED, T_MAIN)
    s9, r9, d9 = frt.fused_rollout_t(cfg, slots, SEED, T_MAIN)
    s1, checksum = pf.fused_rollout_packed_bench(cfg, slots, SEED, T_MAIN)
    torch.cuda.synchronize()
    t_ladder = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    calls = {f.__name__: f.calls for f in plains}
    print(f"{tag} ladder B={B} T={T_MAIN} seed={SEED}: grid rollout, kernels 8, 7, 9 and the "
          f"packed bench in {t_ladder * 1e3:.1f} ms (cold, host clock); launches {launches}; "
          f"plain calls {calls}")
    check(all(launches[k] == 1 for k in ("fused_rollout", "fused_rollout_actions",
                                         "fused_rollout_t")),
          f"each slot kernel launched once: {launches}")
    check(all(c == 0 for c in calls.values()), f"no plain version ran: {calls}")
    for name, (r, d) in {"8": (r8, d8), "7": (r7, d7), "9": (r9, d9)}.items():
        check(r.dtype == torch.int32 and d.dtype == torch.bool, f"kernel {name} output dtypes")
        check(torch.equal(r, gout.reward) and torch.equal(d, gout.done),
              f"kernel {name}'s rewards and dones equal the grid rollout's")
    for name, s in {"7": s7, "9": s9}.items():
        for f in sm.SlotState._fields:
            a, b = getattr(s, f), getattr(s8, f)
            check(a.dtype == b.dtype and torch.equal(a, b), f"kernels {name} and 8 agree on {f}")
    packed_view = off_grid_at_origin(s8, sm)
    for f in sm.SlotState._fields:
        check(torch.equal(getattr(packed_view, f), getattr(s1, f)),
              f"the slot kernels and the packed bench agree on {f}")
    for name, a, b in zip(("objects", "agent", "holding"), sm.to_grid(s8, cfg),
                          (grid.objects, grid.agent, grid.holding)):
        check(torch.equal(a, b), f"to_grid of the slot state equals the grid's {name}")
    total = int(r8.sum(dtype=torch.int64))
    check(total == int(checksum), f"reward sum {total} equals the bench checksum {int(checksum)}")
    check(bool(validate.check_state(cfg, grid).all()), "check_state passes on the grid state")
    objects, agent, holding = sm.to_grid(s7, cfg)
    check(bool(validate.check_state(cfg, dataclasses.replace(
        grid, objects=objects, agent=agent, holding=holding)).all()),
        "check_state passes on the slot state's grid")
    check(bool((grid.step_num == T_MAIN).all()) and bool(d8[-1].all()),
          "every env is done at max_steps")
    n_off = int((s8.slot_stat != sm.ON_GRID).sum())
    print(f"{tag} ladder agrees on all five rungs: reward sum {total}, successes "
          f"{int((r8 == cfg.max_steps).sum())}, achieved bits {int(s8.achieved.sum())}, "
          f"off-grid slots {n_off}")

    # ---- 12. slot kernels vs plain ----------------------------------------------
    gen = torch.Generator(device=dev)
    worst = {k: 0 for k in ("fused_rollout", "fused_rollout_actions", "fused_rollout_t")}

    def compare(name, got, want):
        err = max_abs_diff(list(zip(got[0], want[0])) + [(got[1], want[1]), (got[2], want[2])])
        worst[name] = max(worst[name], err)
        return err

    cfg9 = cw.ray_config(height=9, width=9, max_steps=12, reward_equal=False)
    gen.manual_seed(76)
    cases = [("21x21", cfg, B, False, None),
             ("8x8 mix", cw.flat_config(reward_equal=False), 4096, True, None),
             ("21x21 ragged", cfg, B - 1, False, None),
             ("ladder final state", cfg, B, False, s8),
             ("synthetic states", cfg9, B, False, synthetic_slots(sm, cfg9, B, gen, dev))]
    for label, cfg_, B_, mix, start in cases:
        T = 64
        sl = start if start is not None else sm.from_env_state(
            cw.reset_from_seed(cfg_, 31, B_, device=dev))
        gen.manual_seed(77)
        actions = torch.randint(0, 6, (T, B_), generator=gen, device=dev, dtype=torch.int32)
        if mix:  # regular pickups and drops, so crafting fires
            t = torch.arange(T, device=dev)[:, None]
            actions = torch.where(t % 7 == 6, 4, torch.where(t % 11 == 10, 5, actions % 4))
            actions = actions.to(torch.int32).contiguous()
        ts = tr.transpose_in(sl)
        errs = {
            "fused_rollout_actions": compare(
                "fused_rollout_actions", fr.rollout_slots_actions(cfg_, sl, actions),
                fr.rollout_slots_actions_plain(cfg_, sl, actions)),
            "fused_rollout": compare(
                "fused_rollout", fr.rollout_slots_seeded(cfg_, sl, 5, T),
                fr.rollout_slots_seeded_plain(cfg_, sl, 5, T)),
            "fused_rollout_t": compare(
                "fused_rollout_t", frt.rollout_t_seeded(cfg_, ts, 5, T),
                frt.rollout_t_seeded_plain(cfg_, ts, 5, T)),
        }
        check(all(e == 0 for e in errs.values()),
              f"slot kernels bit-exact, tolerance 0 ({label}: {errs})")
        got = fr.rollout_slots_actions(cfg_, sl, actions)
        print(f"{tag} slot kernels == plain: {label} {cfg_.height}x{cfg_.width} B={B_} T={T} "
              f"reward_equal={cfg_.reward_equal}; max |err| {errs}; actions kernel: successes "
              f"{int((got[1] == cfg_.max_steps).sum())}, achieved bits {int(got[0].achieved.sum())}, "
              f"removed slots {int((got[0].slot_stat == sm.REMOVED).sum())}")

    # ---- 13. ladder timings ----------------------------------------------------
    sl = sm.from_env_state(cw.reset_from_seed(cfg, 41, B, device=dev))
    ts = tr.transpose_in(sl)
    T = 256
    gen.manual_seed(3)
    acts = torch.randint(0, 6, (T, B), generator=gen, device=dev, dtype=torch.int32)
    results = {
        "fused_rollout": (lambda: fr.rollout_slots_seeded(cfg, sl, 9, T),
                          lambda: fr.rollout_slots_seeded_plain(cfg, sl, 9, T)),
        "fused_rollout_actions": (lambda: fr.rollout_slots_actions(cfg, sl, acts),
                                  lambda: fr.rollout_slots_actions_plain(cfg, sl, acts)),
        "fused_rollout_t": (lambda: frt.rollout_t_seeded(cfg, ts, 9, T),
                            lambda: frt.rollout_t_seeded_plain(cfg, ts, 9, T)),
    }
    results = {k: dict(ms=time_ms(kern), plain_ms=time_ms(plain))
               for k, (kern, plain) in results.items()}
    for name, r in results.items():
        print(f"{tag} {name} B={B} T={T}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    print(f"{tag} entry points B={B} T={T}: fused_rollout "
          f"{time_ms(lambda: cw.ops.fused_rollout(cfg, sl, 9, T)):.4f} ms, fused_rollout_t "
          f"(transposes included) {time_ms(lambda: frt.fused_rollout_t(cfg, sl, 9, T)):.4f} ms")

    # env-steps/s: a run is a chain of launches of T_CHUNK steps each, as many
    # as make one run take >= 0.2 s; the packed bench kernel by phase 6's
    # method beside them

    def chained(step_fn, start, n):
        def run():
            s = start
            for i in range(n):
                s = step_fn(s, i)
        return run

    rates = {}
    for name, fn, start in (
            ("fused_rollout (kernel 7)", lambda s, i: fr.rollout_slots_seeded(cfg, s, i, T_CHUNK)[0], sl),
            ("fused_rollout_t (kernel 9)", lambda s, i: frt.rollout_t_seeded(cfg, s, i, T_CHUNK)[0], ts)):
        probe = time_ms(chained(fn, start, 1), reps=3)
        n = max(1, math.ceil(250 / probe))
        ms = time_ms(chained(fn, start, n))
        rates[name] = B * T_CHUNK * n / (ms / 1e3)
        print(f"{tag} {name} B={B}: {n} launches x T={T_CHUNK}, {ms:.2f} ms/run, "
              f"{rates[name]:.4e} env-steps/s (median of 5)")
    p = pr.pack(cfg, ts)
    probe = time_ms(lambda: pf.rollout_packed_bench(cfg, p, 7, 4096), reps=3)
    T = min(4 * math.ceil(0.25 / (probe / 1e3 / 4096) / 4), 1 << 22)
    ms = time_ms(lambda: pf.rollout_packed_bench(cfg, p, 7, T))
    print(f"{tag} packed bench kernel (kernel 1) B={B} T={T}: {ms:.2f} ms/run, "
          f"{B * T / (ms / 1e3):.4e} env-steps/s (median of 5)")

    T = 32
    gen.manual_seed(4)
    for name, fn in (("grid rollout_random", lambda: cw.rollout_random(cfg, state, gen, T)),
                     ("rollout_slots_random", lambda: sm.rollout_slots_random(cfg, sl, gen, T)),
                     ("rollout_t_random", lambda: tr.rollout_t_random(cfg, sl, gen, T))):
        ms = time_ms(fn)
        print(f"{tag} {name} B={B} T={T}: {ms / T:.4f} ms per step (plain torch, median of 5)")

    source = "gym_craftingworld_tpu_torch/csrc/fused_rollout.cu"
    replaces = {"fused_rollout": "gym_craftingworld_tpu/ops/fused_rollout.py:227",
                "fused_rollout_actions": "gym_craftingworld_tpu/ops/fused_rollout.py:242",
                "fused_rollout_t": "gym_craftingworld_tpu/ops/fused_rollout_t.py:165"}
    return [dict(name=name, route="cuda", source=source, replaces=replaces[name],
                 launches=launches[name], max_abs_err=worst[name], ms=r["ms"],
                 plain_ms=r["plain_ms"])
            for name, r in results.items()]


if __name__ == "__main__":
    sys.exit(main())
