#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA GPU and check its kernels.

    python3 chip_smoke.py               # every phase
    python3 chip_smoke.py --gemm-core   # phases 1, 9a and 9 only
    python3 chip_smoke.py --imitation   # the card's name, then phases 19 and 20
    python3 chip_smoke.py --multi-device  # phases 1 and 21 only
    python3 chip_smoke.py --ladder      # phases 1 and 11-13 only (with
                                        # --multi-device: 1, 11-13 and 21)
    python3 chip_smoke.py --learning    # phases 1 and 22 only
    python3 chip_smoke.py --canonical   # phases 1 and 23 only
    python3 chip_smoke.py --cpv         # phases 1 and 24 only
    python3 chip_smoke.py --distill     # phases 1 and 25 only
    python3 chip_smoke.py --tools       # phases 1 and 26 only
    python3 chip_smoke.py --keys        # phases 1 and 27 only
    python3 chip_smoke.py --worker JOB  # one job of ``SIDE_BY_SIDE``, e.g. 23a or
                                        # 22:fused:0 (the whole script starts these)

Needs one CUDA card and ``nvcc`` (on PATH or under CUDA_HOME); imports
nothing of JAX. Phases, each of which must pass:

1. device and build: print the card's name and power limit, build
   ``gym_craftingworld_tpu_torch/csrc`` with nvcc for sm_90a, print ptxas's
   registers and spills, the max SM clock and each integer kernel's SASS
   instructions (``nvdisasm -g``), static and on a warp's path, the path by
   pipe class (integer, FMA, memory, other), from which its issue bounds are
   taken; then check the pipe classes on the card (``pipe_probe``);
2. main path, with the kernels' launch counters set to 0 just before: reset
   16,384 worlds on the 21x21 grid (the keyed-draw kernels, phase 27),
   convert them to slots, run the fused bench
   rollout, then fetch its action stream and replay it step by step; the
   replay must give the bench's final state and checksum;
3. actions kernel against its plain version (bit-exact) on 21x21 at
   B=16,384, on 8x8 with pickups and drops, on a ragged batch (B=16,421), at
   T=1, and on 181x181 with keys near int16's top (``near_top``);
4. action-stream kernel against the plain Philox (bit-exact, uniform, seeded);
5. bench kernel against its plain version (bit-exact) on 21x21 at T=512 and
   T=299, a ragged batch, 8x8 and 181x181; the device time of the actions
   kernel at T=1 and T=64, of the bench kernel and of phase 4's stream
   kernel at T=256 (``torch.profiler``) beside their CUDA-event times and
   bounds; a profiler session that reads below the kernel's bound, or lost
   events, is discarded and named, with the launches that left no device
   record, and the phase fails if no session of five is sound;
6. timings with CUDA events, median of 5 runs after a warm-up; the bench
   kernel's long-T rate at B=16,384 and 131,072 with its share of both
   issue bounds; the plain ``rollout_p_bench`` from a key (its actions the
   counter kernel's, one launch a run: 6, counted);
7. the fast-PPO trainer at full width, with every counter set to 0 just
   before: 16,384 envs on 21x21, the default ``FastPPOConfig`` (hidden 512,
   T=64, 2 epochs x 8 minibatches), ``train_many_fast`` for 3 updates, then
   the trained policy's loss and gradient on one fresh minibatch through
   ``fused_minibatch_grads``; the same 3 updates with ``throughput()``. The
   parameters, the first envs and every draw come from JAX's key chain (key
   data on the card). The pool, indexed-gradient and actions kernels must
   have run 3, 48 and 192 times, the keyed counter kernel 8 times an update
   (6 at ``throughput()``: ``keyed_update_launches``), and no plain version
   at all; one update's draws under ``torch.cuda.set_sync_debug_mode
   ("error")`` make no host sync;
8. pool kernel against its plain version (bit-exact) at n=32,768, and its
   device time there (``torch.profiler``) beside its bound;
9. (9a) the gradient's bf16 product core (``gemm_bf16_kernel``) against its
   plain version on one tile, a ragged shape and the five product shapes of a
   minibatch, each output within 1e-5 of the plain result relative to
   sum |a_i b_i|; then the gradient kernels against their plain version at
   N=131,072, H=512, F=67 (the CPU suite's tolerances), indexed against
   gathered (rtol 1e-6), also with block ids past either end (read as JAX's
   gather reads them), and two launches bit-identical;
10. fast-PPO timings with CUDA events: ms per update, collect, update phase,
   pool and gradient kernels against their plain versions, the peak device
   memory of one default update; the indexed gradient kernel's device time
   per sub-kernel (``torch.profiler``), its TFLOP/s and share of its bound,
   and the five products as five bf16 ``torch.matmul`` calls (the yardstick);
11. the engine ladder at full width, with every counter set to 0 just before:
   16,384 worlds on 21x21 and the Philox stream of one episode (T=300) run
   through the grid ``rollout``, ``fused_rollout_actions``, ``fused_rollout``,
   ``fused_rollout_t`` and ``fused_rollout_packed_bench`` from one state; all
   five must agree (rewards, dones, final states, checksum), the three slot
   kernels must have run once each and no plain version at all, and no
   keyed draw (the rungs step the Philox stream);
12. the three slot kernels against their plain versions (bit-exact) on 21x21
   at B=16,384, on 8x8 with pickups and drops, on a ragged batch, from the
   ladder's final state, and from synthetic states no reset reaches; the
   actions kernel also at the edges of its ring of actions loaded ahead
   (T = 1, ``SLOT_AHEAD`` - 1, ``SLOT_AHEAD`` + 1 and 256) on 21x21 at
   B=16,421, on 8x8 and on 181x181; its six resets from keys launch each
   keyed kernel six times (counted, as in every phase below that states
   keyed launches: exactly, and no plain version);
13. ladder timings with CUDA events: each slot kernel against its plain
   version, with its device time at T=256 (as phase 5 takes it) and share of
   its bound, env-steps/s of the seeded slot kernels beside the packed bench
   kernel's, and ms per step of the three plain-torch engines, each drawing
   its actions from a key (a reset and 18 runs: keyed reset 1, counter 19);
14. renders at 16,384 worlds on 21x21, from a reset and after 40 random
   steps: the three renderers and the ``state_images_*`` dicts on the card
   equal, byte for byte, the same functions on a CPU copy; renders/s of each
   renderer; ``rollout_obs_random`` per observation mode at T=64 (env-steps/s
   with a render every step, peak device memory), and at T=8 its checksum
   against a stepwise recompute and its final state against
   ``rollout_slots_random``'s from the same key (the phase: keyed reset 2,
   counter 48);
15. the Gym façade: the four registered ids in parity mode, seed 0, on the
   card against the same env on the CPU (one 8x8 Flat episode, 120 steps on
   21x21; obs, reward, done and info every step), ``fixed_init_state=4`` and
   ``incremental_render=True``, and ``batch_size=16384`` (reset and 3 steps,
   ms a step with the obs copied to the host);
16. the vector env at 16,384 envs per observation mode: 320 random steps,
   every env done by step 300, each done env restarted at step_num 0 in a
   valid state, obs on the card in the JAX package's shapes and dtypes, and
   env-steps/s. Phases 14-16 launch no hand-written kernel, and check so;
17. pixel PPO at 16,384 envs on 21x21, with every counter set to 0 just
   before: ``train_many_pixel`` for 3 updates at the default
   ``PixelPPOConfig`` (conv 32/64, hidden 256, stride 2, T=64, 2 epochs x 16
   minibatches) and at ``throughput()`` (conv 16/32, hidden 192, stride 3, 1
   epoch x 8), from keys; the actions kernel must have run 192 times and
   no other of the nine kernels, the keyed-draw kernels as
   ``pixel_keyed_launches`` counts (the keyed pool, the uniforms, the
   permutations), no plain version; then ``render_grid_obs`` on the card equal to the
   CPU's byte for byte, ``apply_pixel_policy`` (whole and in the collect's
   chunks) and one minibatch's loss and gradient within the CPU tests'
   tolerances, the collect's policy step from its CUDA graph equal to its
   chunks called one by one, which layers' rows depend on the call's width,
   and the times (CUDA events, median of 5): ms per update, pool, collect
   (also with the chunks called one by one and in one call of the whole
   batch), one policy step by kernel in each of those three ways, GAE,
   update phase, peak memory;
18. the policy families: ``ActorCritic``, ``PixelActorCritic``,
   ``PixelDistillStudent`` and ``GridActorCritic`` on the card against the
   CPU on the same parameters (carried by ``interop``); one ``train/ppo.py``
   update per family at hidden 512 on 21x21 (mlp and cnn at 4,096 envs, vit
   at 256), each step from a key (the flax init from a generator), ms per
   update (after a warm-up, median of 3; vit's of 1), and ``evaluate_policy``
   over 1,024 greedy episodes (vit: 256); none of the
   nine kernels runs, the keyed draws run on their kernels (the resets, the
   key chain, the noise, the permutations), and the phase checks so;
19. the canonical imitation path on 21x21 stacked goals (max_steps 300):
   ``collect_expert_demos`` of 384 episodes in batches of 192 (noise 0.05);
   ``expert_relabel`` of 256 collected rows reproducing their labels;
   ``snap_columns_from_state`` on the card equal to the host extraction and
   ``planes_from_state`` equal to ``planes_from_snaps`` and to the CPU's, byte
   for byte; ``bc_train_snaps`` of GridPolicy(96, 1536) and of
   CPVGridPolicy(96, 1024, embed 32) (batch 4,096, lr 1e-3, 2 epochs; the
   loss must fall), with one minibatch's forward, loss and gradient on the
   card against the CPU; ``evaluate_grid_policy`` over 4,096 greedy episodes;
   one ``dagger_round`` (768 episodes, 20,000 states, 1 epoch), its rollout,
   relabel and training timed;
20. ``train_step_rnn`` at 4,096 envs on 21x21 (default ``PPOConfig``) for 3
   updates from ``PRNGKey(20)``; ``RecurrentActorCritic`` over 8 steps with dones and ``CPVPolicy``
   with and without the init view, on the card against the CPU; ``bc.py``'s
   small-data path through the façade (16 episodes, 3 epochs at hidden 256,
   16 greedy episodes). Phases 19-20 launch no hand-written kernel and no
   plain version, and check so;
21. the multi-device paths (``parallel/``) at 16,384 envs on 21x21 against
   the unsharded run in this process: the bench kernel (T=300), the actions
   kernel on row 3's stream (T=300), one default fast-PPO update (counted,
   with its collect and first minibatch's gradient) and one default pixel-PPO
   update, over two ranks sharing the card under gloo (``torchrun``, this
   script with ``--rank-worker``; a rank that fails fails the phase) and over
   one rank under NCCL in this process: rows 1-2, both trajectories and both
   final envs bit for bit, both trainers' first-minibatch gradients, loss
   terms and update metrics within ``MD_*_TOL``, per rank the actions and
   indexed-gradient kernels 64 and at most 16 times and no plain version;
   the sharded update's ms and its ``all_reduce`` share; (21c, side by
   side) ``train/run.py`` under torchrun (4,096 envs, mlp hidden 512), 4
   updates with a checkpoint at 2, and a resume from it that repeats updates
   2-3 bit for bit; the cost of deterministic algorithms on its update;
   ``dryrun_multichip(1)``; ``scaling_report``'s one-card rates;
   ``train/ppo.py`` through ``ppo_train_step_sharded`` (mlp, 4,096 envs) at
   world 1 and 2: each rank's start state its columns of
   ``reset_from_seed``, each rank's draws (the keyed wrappers' counters) its
   B/W envs only (resets, auto-resets and noise), ms an update. The fast
   and pixel updates take keys; fast PPO takes its default pool, the keyed
   ``fresh_packed_batch`` over two ranks (JAX's sharded choice: the reset
   kernel once, the counter kernel 10 times) and the pool kernel on one
   (8), each held to an unsharded run of the same pool, and each rank's
   counter draws of an update are the unsharded update's less the other
   ranks' columns of the uniforms;
22. learning: the default ``FastPPOConfig`` on single-task 8x8 at 4,096 envs
   for 192 updates (``tools/fast_ppo_sweep.learning_curve``), seeds 0 and 1,
   through the gradient kernel and through autograd, every counter set to 0
   before each run, seed ``s`` taking JAX's tool's keys ``PRNGKey(100 + s)``,
   ``PRNGKey(200 + s)`` and ``PRNGKey(300 + s)``: the pool, actions and
   indexed-gradient kernels must have run 192, 12,288 and 3,072 times (0
   through autograd), the keyed counter kernel 8 an update and 8 to start,
   no plain version at all. Each run's success per step over updates 160-191 must lie within
   ``TAIL_BAND`` of the JAX record's seed mean (``docs/fast_ppo_sweep.json``,
   read as data), over updates 32-63 within ``EARLY_BAND``; the two paths'
   tails must agree within the JAX tool's noise rule
   (``tools/fused_update_e2e.cross_path_summary``);
23. the canonical-training tools (``gym_craftingworld_tpu_torch/tools/``):
   (a) ``fast_pixel_canonical``'s curve at its ``throughput()`` preset,
   16,384 envs on single-task 21x21, seed 0, 100 updates, every counter set
   to 0 just before, JAX's tool's keys: the actions kernel must have run
   6,400 times (64 an update) and no other of the nine kernels, the keyed
   draws as ``pixel_keyed_launches`` counts, no plain version; the mean success per step
   over updates 0-49 must lie within ``PIXEL_FIRST_BAND`` of the JAX
   record's (``docs/pixel_canonical.json``, read as data) and the ratio of
   updates 50-99 to 0-49 within ``PIXEL_DIP_BAND`` (JAX's dip, 0.494);
   (b) ``collect_canonical_demos``, ``train_canonical`` and
   ``targeted_dagger`` end to end through their ``main`` at a small size
   (384 demos; 300 BC steps, one DAgger round of 256 episodes and 100 steps;
   one targeted round of 512 episodes and 100 steps from the BC + DAgger
   parameters; evaluations of 256, 512 and 1,024 episodes) in a temporary
   directory: every file written reloads, the artifact has the keys of
   ``docs/canonical_policy.json`` and the card, its episodes by task count
   sum to its episodes, the BC loss falls, each round's appended rows are
   the rows its relabel returned, and no kernel and no plain version ran;
24. the CPV compositional matrix and the scaling artifact
   (``gym_craftingworld_tpu_torch/tools/``): (a) ``scaling_artifact``'s
   ``gpu_single_chip`` section (16,384 envs on 21x21, a 1-rank mesh; the
   bench kernel at T = 131,072 against 65,536 and the plain packed scan at
   T = 128, each delta-timed over 3 runs after a warm-up), every counter set
   to 0 just before: the bench kernel must have run (1 + 3) x 2 = 8 times,
   nothing else, the keyed reset once and the counter kernel 1 + 8 times
   (each scan run's actions); its sharded rate within ``RATE_BAND`` of phase 6's long-T
   rate at 16,384 envs (under ``--cpv``, of the unsharded entry point
   delta-timed the same way after the counters are read); (b)
   ``cpv_canonical``'s ``main`` on 21x21 at ``CPVGridPolicy(96, 1024)``, small
   (``CPV_ARGS``: pool 32, 4 singles a task, 32 handoffs, 1 BC epoch, two
   DAgger rounds of 32 episodes, cells of 16 episodes over the 9 singles, 4
   pairs (``CPV_PAIRS``) and one triple), then ``--matrix-only`` of the 9
   singles from its ``params.pt``: the JSON has the keys of
   ``docs/cpv_matrix.json`` and the card, ``phase1.npz`` reloads equal, each
   round appended its relabelled rows and their ``augment_pending`` copies,
   the two runs give the same argmax singles, and no kernel and no plain
   version ran; the phase takes at most ``CPV_BUDGET_S``;
25. the last tools and entry points, each with every counter set to 0 just
   before and no kernel and no plain version run after, the tools' keyed
   draws counted exactly (``finetune_keyed_launches``,
   ``distill_keyed_launches``): (a)
   ``finetune_canonical``'s ``main`` on 21x21 at a narrow GridPolicy
   (``FT_ARGS``: 256 envs, one value-only update and two joint ones,
   evaluations of 256 episodes): the JSON has the keys of
   ``docs/canonical_finetune.json`` and the card, the value-only update left
   the policy head's parameters bit-identical, and the policy shipped is the
   best evaluation's (the start's parameters, bit for bit, when nothing beat
   them); (b) ``pixel_distill``'s ``main`` on 21x21 at a narrow student and
   teacher (``DISTILL_ARGS``: 2 rounds of 256 episodes): the section has the
   keys of ``docs/pixel_canonical.json``'s ``distilled_student`` and the
   card, round 1 appended exactly its relabelled rows,
   ``images_from_cols`` of a live batch's columns (256 worlds after 48
   random steps) equals ``models/cnn.student_images`` of the same states,
   byte for byte, and ``GRAPH_STEPS`` student minibatch updates replayed
   from the epoch's CUDA graph equal them launched one by one, bit for bit; (c) ``entry()``'s forward on the card against the same
   forward on the CPU (``card_vs_cpu``); (d) ``examples/record_episode``
   writes a GIF into a temporary directory;
26. the last entry points (``gym_craftingworld_tpu_torch/tools/``), each
   through its ``main`` with every counter set to 0 just before: (a)
   ``bench`` at ``packed_fused``, 16,384 envs, its default T, 5 runs: the
   bench kernel launched once for the warm-up and once a run, nothing else
   and no plain version, its ``value`` within ``BENCH_BAND`` of a direct
   CUDA-event median of ``fused_rollout_packed_bench`` at the same shape,
   its metric ``bench.py``'s, and the keyed draws of its runs' keys and seeds
   (reset 1, counter 12); (b) ``bench`` at ``obs_ray``, T = 256: no
   kernel, no plain version, keyed reset 1 and counter 8; (c) ``fast_ppo_prof`` and ``collect_prof`` at
   K = 3: each phase launched its table rows' kernels as counted (the pool
   kernel once, the actions kernel 64 times, the indexed gradient kernel 16
   times a run), no plain version, and the sum of the parts within
   ``FAST_PROF_BAND`` / ``COLLECT_PROF_BAND`` of ``full``; (d) ``ppo_prof``
   at its default B, 3 runs a stage, its keyed draws as
   ``ppo_prof_keyed_launches`` counts them; (e) ``cpv_debug`` and
   ``expert_probe`` at their smallest settings. Every JSON line parses and
   carries the card's name; the phase takes at most ``TOOLS_BUDGET_S``;
27. the keyed draws (``ops/keyed_draws.py``, ``csrc/keyed_draws.cu``): (a)
   the reset kernel against its plain version bit for bit (fresh and pool
   modes at 16,384 envs on 21x21, 4,096 on 8x8, 256 on 181x181, a task
   selection, the world mode of ``generate_pool``, the tasks mode of
   ``fresh_packed_batch``) and the counter kernel in every mode at tolerance
   0 (``counter_cases``: split, randint, bits and uniform, one key, 64 given
   plane keys and 64 split from a parent, whole rows, a rank's column box
   and ragged widths); (b) with their counters set to 0 just before, the keyed main
   path: ``reset_from_seed(ray_config(), 0, 16384)`` and a T=64 auto-reset
   rollout of ``randint(PRNGKey(3))``'s actions at 4,096 envs on 8x8
   (max_steps 10), 66 reset and 3 counter launches, no plain version, every
   field hashing to the JAX package's digests
   (``tools/records/keyed_digests.json``, made on the CPU with JAX and held
   there by ``tests/test_torch_keyed_reset.py``); (c) both kernels' times
   beside their bounds and plain versions (device ms: a CUDA graph of 20
   launches replayed 5 times between CUDA events, the median,
   ``graph_ms``; bounds from the SASS each kind of warp issues at the
   timed launch, ``reset_bound`` and ``counter_bound``), the counter kernel
   at ``randint`` (64, 16,384) and at fast PPO's uniforms of 64 planes x
   (6, 16,384); fast PPO's pool of 2B worlds keyed (a multi-rank step's) and
   from the pool kernel; ``reset_from_seed``'s, the vector env's and the
   façade's; (d) and (e) the inits and the imitation draws (``keyed_init_phase``,
   ``keyed_imitation_phase``); (f) the engine ladder's five random rollouts
   (``rollout_slots_random``, ``rollout_t_random``, ``rollout_p_random``,
   ``rollout_p_bench``, ``rollout_obs_random`` at ray) from ``PRNGKey(5)`` at
   16,384 envs on 21x21 over T = 64, every counter set to 0 before each:
   one counter launch (the actions), no kernel of the nine, no plain version,
   final states and outputs hashing to JAX's digests; then
   ``finetune_canonical.draw`` and ``pixel_distill``'s draws of a round
   through the tool, counted, hashing to JAX's digests
   (``keyed_ladder_phase``).

The script runs phases 1-18 in order, then phases 19, 20, 21c, 22, 23 and 25
side by side (``side_by_side``: each in a process of its own, phase 22 one a path
and seed, all started together on the one card; none of them times a kernel
or has a time budget), then 21, then 24 and 26 each alone in a fresh process
(they keep their budgets; host-paced work steps slower at the end of a long
process), then 27. It prints when each group of phases ended, in seconds of
the script.

A phase that "launches no kernel" launches none of the nine kernels that
replace the JAX package's Pallas kernels (``kernel_wrappers``); an env that
resets from keys, in any phase, launches the keyed-draw kernels of phase 27.

It prints one JSON line of per-kernel results, then, as its last line,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
Each kernel's ``bound_ms`` is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the peak:
989 TFLOP/s bf16 for the gradient, and for the integer kernels the two-rate
issue bound of the SASS instructions a warp issues on the run's path
(``parse_nvdisasm``: a branch on the data takes its shorter side), less the
moves, compare and index of an actions kernel's ring of loads ahead (``AHEAD``:
the function's work, not the ring's), on each of 132 x 4 schedulers at the
max SM clock: one warp-instruction a clock, and one on the integer pipe every
second clock (``pipe_bound_ms``). The single-rate
bound (``instruction_bound_ms``) is printed beside it. The keyed-draw
kernels' warps take paths that their launch decides (the columns a thread
draws, a block's first warp deriving the env's keys); their bound is the same
two-rate bound summed over each kind of warp, on the path the timed launch
decides (``sass_under``, ``warps_bound_ms``).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import re
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
B_SMALL = 4096  # the 8x8 and 181x181 checks of phases 3 and 5
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
    """Median device time of ``fn()`` in ms over ``reps`` runs, after one
    warm-up (CUDA events, ``utils/profiling.timed_runs``)."""
    from gym_craftingworld_tpu_torch.utils.profiling import timed_runs

    return timed_runs(fn, DEVICE, reps)["median_ms"]


TIMED = "chip_smoke timed calls"


def device_events(fn, reps: int, complete, tries: int = 3):
    """``torch.profiler``'s device records ``[(name, count, us)]`` of ``reps``
    calls of ``fn()``, from the first of ``tries`` sessions whose records pass
    ``complete``; None if none does. Late in this script the profiler can
    lose a run of a session's device records: the first three of 20
    slot-kernel launches in every session, or with the warm-up below, now and
    then a longer run at the start or the end. So each session first makes
    five calls and a sync, only the records of launches made inside the
    timed range count, and each caller says what a whole session holds; an
    incomplete session prints which timed launches left no record."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            with record_function(TIMED):
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        events, lost = timed_records(prof)
        if complete(events):
            return events
        print(f"profiler session incomplete: {lost}")
    return None


def timed_records(prof):
    """The device records of the launches made inside the session's timed
    range, matched to the host's runtime calls by correlation id, as
    ``[(name, count, us)]``; and which of those calls left no record."""
    recs = list(prof.profiler.kineto_results.events())
    on_card = lambda e: "CUDA" in str(e.device_type())
    (window,) = [e for e in recs if e.name() == TIMED and not on_card(e)]
    calls = sorted((e for e in recs if not on_card(e) and e.name().startswith("cu")
                    and window.start_ns() <= e.start_ns() <= window.end_ns()),
                   key=lambda e: e.start_ns())
    device = {e.correlation_id(): e for e in recs if on_card(e)}
    totals = {}
    for c in calls:
        if c.correlation_id() in device:
            d = device[c.correlation_id()]
            n, ns = totals.get(d.name(), (0, 0))
            totals[d.name()] = (n + 1, ns + d.duration_ns())
    launches = [c for c in calls if "LaunchKernel" in c.name()]
    lost = [i for i, c in enumerate(launches) if c.correlation_id() not in device]
    return ([(k, n, ns / 1e3) for k, (n, ns) in totals.items()],
            f"{len(launches)} launches in the timed range; those at positions {lost} left no "
            f"device record")


def device_ms(fn, kernel: str, floor_ms: float, reps: int = 20, tries: int = 5):
    """Mean device time a call of ``fn()`` spends in the one kernel whose name
    holds ``kernel`` (``torch.profiler``), from the first of ``tries`` sessions
    that recorded it ``reps`` times at no less than ``floor_ms`` a call (the
    kernel's bound: a reading below it cannot be the kernel's). Returns (ms,
    discarded), ``discarded`` naming each session passed over and why; fails
    if no session gives a sound reading."""
    discarded = []

    def sound(events):
        hits = [(c, us) for k, c, us in events if kernel in k]
        if [c for c, _ in hits] != [reps]:
            discarded.append(f"{[c for c, _ in hits]} events where {reps} ran")
            return False
        ms = hits[0][1] / 1e3 / reps
        if ms < floor_ms:
            discarded.append(f"{ms:.5f} ms, below its bound {floor_ms:.5f} ms")
            return False
        return True

    events = device_events(fn, reps, sound, tries)
    check(events is not None, f"a sound device time of {kernel} in {tries} sessions "
          f"(discarded: {'; '.join(discarded)})")
    return sum(us for k, _, us in events if kernel in k) / 1e3 / reps, discarded


def kernel_wrappers(*names):
    """{name: wrapper} of the nine hand-written kernels, or of those named,
    each counting its launches in ``launches`` (``utils/profiling``)."""
    from gym_craftingworld_tpu_torch.utils import profiling

    return profiling.kernel_wrappers(*names)


def keyed_wrappers() -> dict:
    """{name: wrapper} of the keyed-draw kernels (``ops/keyed_draws.py``),
    which replace no Pallas kernel, each counting ``launches``."""
    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd

    return {"keyed_reset": kd.reset_draws_kernel, "keyed_counter": kd.counter_draws_kernel}


def prng_key(seed: int, device=None):
    """``jax.random.PRNGKey(seed)``'s key data (``ops/threefry.py``) on ``device``."""
    from gym_craftingworld_tpu_torch.ops.threefry import prng_key as key

    return key(seed, device=device)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
SMS, SCHEDULERS = 132, 4  # one warp-instruction a clock per scheduler
SASS = {}  # mangled kernel name -> SassPaths
DISASM = []  # (nvdisasm text, line_text) of each cubin, for ``sass_under``
SM_CLOCK_HZ = 0.0
# Conditions that the launch decides, and that some lane of every warp enters
# on the runs whose bounds are taken: the step guard of a trip of four
# unrolled steps (those runs' T are multiples of 4) and the pool kernel's lane
# tests and Philox-group test (at 21x21 every group of 32 lanes holds a cell).
# A branch on any other source line depends on the data.
ENTERED = re.compile(r"t0 \+ j < T|g < pg|lane [<>]=? 4|lane == p")
# Source lines of an actions kernel's ring of actions loaded ahead. Their
# moves, compare and index are how the kernel hides its load, not work of the
# function it computes, so the bounds count only their loads: a deeper ring
# does not raise the bound the kernel is held to.
AHEAD = re.compile(r"\bring\[|const int ahead\b")


# Pipe classes of the SASS a warp issues, after NVIDIA's Hopper white paper
# (each SM sub-partition has 16 INT32 lanes beside 32 FP32 lanes), the CUDA C
# programming guide's throughput table for compute capability 9.0 (64 results
# a clock an SM for 32-bit integer add, compare, logic, shift and min/max) and
# Nsight Compute's pipe names ("alu": integer and logic but IMAD/IMUL; "fma":
# FP32 arithmetic, IMAD, IMUL). A warp-instruction on the integer pipe holds
# it for two clocks; IMAD and IMUL go to the FMA pipe, where the compiler also
# puts moves and adds it writes as IMAD.MOV / IMAD.IADD / IMAD.SHL, and
# Hopper's add of an immediate, VIADD. Uniform (U-prefixed) instructions,
# branches and special-register reads are "other". Phase 1's probe
# (``pipe_probe``) holds the table to the card.
PIPES = ("int", "fma", "mem", "other")
INT_PIPE = frozenset(
    "IADD3 IADD LOP3 LOP ISETP ICMP SEL SHF SHL SHR PRMT IMNMX VIMNMX VIADDMNMX IABS LEA "
    "BMSK SGXT PLOP3 P2R R2P MOV FLO POPC BREV FSEL FSETP FMNMX".split())
FMA_PIPE = frozenset("IMAD IMUL IDP FFMA FMUL FADD VIADD".split())
MEM_PIPE = frozenset(
    "LDG STG LDS STS LD ST LDC SHFL ATOM ATOMS ATOMG RED LDGSTS LDSM".split())


def pipe_of(op: str) -> str:
    """The pipe class of one SASS instruction (its predicate stripped)."""
    base = op.split()[0].split(".")[0]
    for name, ops in (("int", INT_PIPE), ("fma", FMA_PIPE), ("mem", MEM_PIPE)):
        if base in ops:
            return name
    return "other"


@dataclasses.dataclass
class SassPaths:
    """One kernel's SASS instructions (NOPs left out), counted statically and
    on the path a warp issues: before its outermost loop, in one trip of the
    loop, and after it; ``pipes`` splits the path by ``PIPES`` class,
    ``{class: (pro, body, epi)}``, and counts under ``"ahead"`` (and
    ``"ahead_int"``, those on the integer pipe) the instructions of ``AHEAD``
    lines that the bounds leave out."""

    static: int
    static_body: int
    pro: int
    body: int
    epi: int
    pipes: dict = dataclasses.field(default_factory=dict)

    def on_pipe(self, pipe: str, trips: int) -> int:
        """Instructions of class ``pipe`` on the path with ``trips`` trips."""
        pro, body, epi = self.pipes[pipe]
        return pro + body * trips + epi


def sass_paths(library: Path) -> dict:
    """``parse_nvdisasm`` of each kernel of the built library: its cubins
    (``cuobjdump -xelf``) as ``nvdisasm -g`` prints them, with the source line
    of each instruction (the build passes ``-lineinfo``)."""
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME

    from gym_craftingworld_tpu_torch.ops import _build

    def tool(name):
        return shutil.which(name) or str(Path(CUDA_HOME or "/usr/local/cuda") / "bin" / name)

    sources = {}

    def line_text(where):  # "" for a line of the toolkit's headers
        path = _build.CSRC / Path(where[0]).name
        if path not in sources:
            sources[path] = path.read_text().splitlines() if path.is_file() else []
        return sources[path][where[1] - 1] if where[1] <= len(sources[path]) else ""

    tmp = _build.BUILD_DIR / f"sass.{os.getpid()}"
    tmp.mkdir(parents=True)
    try:
        subprocess.run([tool("cuobjdump"), "-xelf", "all", str(library.resolve())], cwd=tmp,
                       capture_output=True, check=True, timeout=300)
        out = {}
        for cubin in sorted(tmp.glob("*.cubin")):
            DISASM.append((subprocess.run(
                [tool("nvdisasm"), "-g", "-c", str(cubin)], capture_output=True, text=True,
                check=True, timeout=300).stdout, line_text))
            out.update(parse_nvdisasm(*DISASM[-1]))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parse_nvdisasm(text: str, line_text, entered=ENTERED, loop: bool = True) -> dict:
    """{kernel: SassPaths} of the text ``nvdisasm -g -c`` prints.

    A warp issues an instruction when any of its lanes runs it, and it issues
    predicated instructions whatever their predicate. So a warp's path takes,
    at each branch on a condition in ``entered`` (``line_text`` gives the
    branch's source line), the side with more instructions, and at any other
    branch the side with fewer: the count is the least the run's data lets a
    warp issue. An inner loop counts one trip. With ``loop`` False the whole
    path is ``pro``, a warp that leaves before any loop (no backward branch
    taken).
    """
    funcs, name, where = {}, None, None
    for raw in text.splitlines():
        line = raw.strip()
        m = re.fullmatch(r"\.text\.(\S+):", line)
        if m:
            name, where = m.group(1), None
            funcs[name] = ([], {})
            continue
        if name is None:
            continue
        ins, labels = funcs[name]
        m = re.fullmatch(r"(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(ins)
            continue
        m = re.match(r'//## File "([^"]+)", line (\d+)', line)
        if m:
            where = (m.group(1), int(m.group(2)))
            continue
        m = re.match(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if m and not m.group(1).startswith("NOP"):
            ins.append((m.group(1).strip(), where))
    return {k: _paths(ins, labels, line_text, entered, loop) for k, (ins, labels) in funcs.items()}


def _paths(ins, labels, line_text, entered_re, loop) -> SassPaths:
    end = len(ins)  # past an EXIT
    succ, entered, loops, unit = [], [], [], []
    for i, (op, where) in enumerate(ins):
        m = re.match(r"@(!?U?P\w+)\s+(.*)", op)
        cond, op = (m.group(1) not in ("PT", "UPT"), m.group(2)) if m else (False, op)
        mnem = op.split()[0]
        # (all, int, fma, mem, other, ahead, ahead_int): one instruction of
        # its class, and whether the bounds leave it out
        pipe = pipe_of(op)
        ahead = bool(where and AHEAD.search(line_text(where))) and pipe != "mem"
        unit.append((1,) + tuple(int(pipe == p) for p in PIPES)
                    + (int(ahead), int(ahead and pipe == "int")))
        entered.append(bool(where and entered_re.search(line_text(where))))
        if mnem.startswith(("EXIT", "RET")):
            succ.append([end, i + 1] if cond else [end])
        elif mnem.startswith("BRA"):
            m = re.search(r"`\((\.L_x_\d+)\)", op)
            check(m is not None, f"a branch with a label: {op}")
            t = labels[m.group(1)]
            cond = cond or "," in op  # BRA.DIV and uniform-predicate forms
            succ.append([i + 1, t] if cond else [t])
            if t < i:
                loops.append((i - t, t, i))
        else:
            succ.append([i + 1])

    add = lambda a, b: tuple(x + y for x, y in zip(a, b))
    zero = (0,) * (3 + len(PIPES))

    def walk(start, stop):
        """Counts (all, then by pipe) of the path from ``start`` to the exit,
        or to instruction ``stop`` included; the branch sides are chosen by
        the count of all instructions."""
        cost = [None] * (end + 1)
        cost[end] = zero if stop is None else None
        for i in range(end - 1, start - 1, -1):
            if stop is not None and i >= stop:
                cost[i] = unit[i] if i == stop else None
                continue
            opts = [cost[s] for s in succ[i] if s > i and cost[s] is not None]
            if opts:
                cost[i] = add(unit[i], (max if entered[i] else min)(opts, key=lambda c: c[0]))
        check(cost[start] is not None, f"a path from instruction {start}")
        return cost[start]

    if not loops or not loop:
        pro, body, epi = walk(0, None), zero, zero
        static_body = max(loops)[0] + 1 if loops else 0
    else:
        _, head, latch = max(loops)
        pro = tuple(x - u for x, u in zip(walk(0, head), unit[head])) if head else zero
        body, epi, static_body = walk(head, latch), walk(latch + 1, None), latch - head + 1
    return SassPaths(end, static_body, pro[0], body[0], epi[0],
                     {p: (pro[k], body[k], epi[k])
                      for k, p in enumerate(PIPES + ("ahead", "ahead_int"), 1)})


def sass_of(kernel: str) -> SassPaths:
    hits = [v for k, v in SASS.items() if kernel in k]
    check(len(hits) == 1, f"one SASS function matches {kernel} ({len(hits)})")
    return hits[0]


def sass_under(kernel: str, entered: str, loop: bool = True) -> SassPaths:
    """``kernel``'s path where the launch also decides, and every warp
    enters, the branches on source lines that ``entered`` matches (a
    regular expression, beside ``ENTERED``); ``loop`` as ``parse_nvdisasm``."""
    pattern = re.compile(f"{ENTERED.pattern}|{entered}")
    hits = [v for text, line_text in DISASM
            for k, v in parse_nvdisasm(text, line_text, pattern, loop).items() if kernel in k]
    check(len(hits) == 1, f"one SASS function matches {kernel} ({len(hits)})")
    return hits[0]


def warps_bound_ms(parts) -> float:
    """The two-rate issue bound of warps whose paths differ: ``parts`` are
    (warps, SassPaths, trips); the schedulers of 132 SMs at the max SM clock
    issue at least the warps' instructions, one a clock, and their
    integer-pipe instructions, one every second clock (``pipe_bound_ms``
    for one kind of warp)."""
    issued = sum(w * (p.pro + p.body * t + p.epi - p.on_pipe("ahead", t)) for w, p, t in parts)
    integer = sum(w * (p.on_pipe("int", t) - p.on_pipe("ahead_int", t)) for w, p, t in parts)
    return max(issued, 2 * integer) / (SMS * SCHEDULERS * SM_CLOCK_HZ) * 1e3


def instruction_bound_ms(kernel: str, warps: int, trips: int) -> float:
    """Least time at one warp-instruction a clock on every scheduler: ``warps``
    warps, each issuing the kernel's path (``parse_nvdisasm``) with ``trips``
    trips of its outermost loop, less its ``AHEAD`` instructions."""
    p = sass_of(kernel)
    issued = p.pro + p.body * trips + p.epi - p.on_pipe("ahead", trips)
    return warps * issued / (SMS * SCHEDULERS * SM_CLOCK_HZ) * 1e3


def pipe_bound_ms(kernel: str, warps: int, trips: int) -> float:
    """The two-rate issue bound: each scheduler issues at most one
    warp-instruction a clock, and one on the integer pipe every second clock
    (16 INT32 lanes a sub-partition), so a warp's path takes at least
    max(all, 2 x integer-pipe) clocks of its scheduler, its ``AHEAD``
    instructions left out of both."""
    p = sass_of(kernel)
    clocks = max((p.on_pipe("int", trips) - p.on_pipe("ahead_int", trips)) * 2,
                 p.pro + p.body * trips + p.epi - p.on_pipe("ahead", trips))
    return warps * clocks / (SMS * SCHEDULERS * SM_CLOCK_HZ) * 1e3


def shares(kernel: str, warps: int, trips: int, ms: float) -> str:
    """The kernel's share of its single-rate and two-rate issue bounds; a
    share over 100% would mean the pipe classes are wrong, and is not shown."""
    one, two = (f(kernel, warps, trips) / ms for f in (instruction_bound_ms, pipe_bound_ms))
    if two > 1.0:
        return (f"{one:.1%} of its single-rate issue bound; two-rate share over 100% "
                f"({two:.1%}): the pipe class table is wrong, share not published")
    return f"{one:.1%} of its single-rate and {two:.1%} of its two-rate issue bound"


def pipe_line(kernel: str) -> str:
    """A warp's path by pipe class: before the loop, a trip, after it."""
    p = sass_of(kernel)
    return ", ".join(f"{k} {p.pipes[k]}" for k in PIPES)


# Phase 1's check of the pipe classes: loops of eight independent chains of
# one or two instruction kinds, eight warps a scheduler, timed with clock64.
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#define J(d) x[(i + d) % 8]
template <int OP>
__global__ void __launch_bounds__(1024) cw_pipe_probe(long long* cycles, int* sink, int iters, int k) {
  int x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = threadIdx.x * (i + 3) + k;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (OP == 0) x[i] = (x[i] + 7) ^ J(1);
        if (OP == 1) x[i] = (x[i] == J(1)) ? J(2) : x[i] + 1;
        if (OP == 2) x[i] = min(x[i], J(1)) * J(2);
        if (OP == 3) x[i] = __byte_perm(x[i], J(1), 0x3210 + k);
        if (OP == 4) x[i] *= J(1);
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  int s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s ^= x[i];
  if (s == 0x12345678) sink[threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int cw_pipe_probe_run(int op, void* cycles, void* sink, int blocks, int iters, int k) {
  void (*fns[])(long long*, int*, int, int) = {cw_pipe_probe<0>, cw_pipe_probe<1>, cw_pipe_probe<2>,
                                               cw_pipe_probe<3>, cw_pipe_probe<4>};
  fns[op]<<<blocks, 1024>>>((long long*)cycles, (int*)sink, iters, k);
  return (int)cudaDeviceSynchronize();
}
"""
PROBES = ("(x + 7) ^ y", "x == y ? z : x + 1", "min(x, y) * z", "byte_perm(x, y)", "x * y")


def pipe_probe(tag: str) -> None:
    """Check the pipe classes on the card: each probe loop's measured
    warp-instructions a clock a scheduler must not exceed what its two-rate
    bound allows (its instructions over the larger of them and twice its
    integer-pipe ones), within 2% for the clock64 windows; a probe above that
    means the class table is wrong, and fails. The probe of x == y ? z : x + 1
    (ISETP and SEL on the integer pipe, VIADD beside them) runs at its bound."""
    import ctypes

    from gym_craftingworld_tpu_torch.ops import _build

    d = _build.BUILD_DIR / f"probe.{os.getpid()}"
    d.mkdir(parents=True)
    try:
        (d / "probe.cu").write_text(PROBE_SOURCE)
        base = [_build._nvcc(), *_build.ARCH, "-O3", "-lineinfo"]
        procs = [subprocess.Popen(base + extra + [str(d / "probe.cu")], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for extra in (["-cubin", "-o", str(d / "probe.cubin")],
                               ["-shared", "-Xcompiler", "-fPIC", "-o", str(d / "probe.so")])]
        for proc in procs:
            out, _ = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"the pipe probe builds: {out}")
        nvdisasm = str(Path(_build._nvcc()).parent / "nvdisasm")
        paths = parse_nvdisasm(subprocess.run([nvdisasm, "-g", "-c", str(d / "probe.cubin")],
                                              capture_output=True, text=True, check=True,
                                              timeout=300).stdout, lambda where: "")
        lib = ctypes.CDLL(str(d / "probe.so"))
        lib.cw_pipe_probe_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int]
        blocks = torch.cuda.get_device_properties(0).multi_processor_count
        cycles = torch.zeros(blocks, dtype=torch.int64, device=DEVICE)
        sink = torch.zeros(1024, dtype=torch.int32, device=DEVICE)
        iters, lines = 20000, []
        for op, name in enumerate(PROBES):
            (p,) = [v for k, v in paths.items() if f"cw_pipe_probeILi{op}E" in k]
            for n in (200, iters):  # a warm-up, then the timed run
                check(lib.cw_pipe_probe_run(op, cycles.data_ptr(), sink.data_ptr(), blocks, n, 0) == 0,
                      "the pipe probe runs")
            clocks = float(cycles.double().median())
            warps = 1024 // 32 // SCHEDULERS
            rate = warps * iters * p.body / clocks
            allowed = p.body / max(p.body, 2 * p.pipes["int"][1])
            check(rate <= 1.02 * allowed, f"pipe probe {name}: {rate:.3f} a clock where its "
                  f"two-rate bound allows {allowed:.3f}; the class table is wrong")
            lines.append(f"{name}: a trip {p.body} ({', '.join(f'{k} {p.pipes[k][1]}' for k in PIPES)}), "
                         f"{rate:.3f} a clock, the two-rate bound allows {allowed:.3f}")
        print(f"{tag} pipe probe, warp-instructions a clock a scheduler at {warps} warps a "
              f"scheduler (clock64): " + "; ".join(lines))
    finally:
        import shutil
        shutil.rmtree(d, ignore_errors=True)


def bound(instr_ms: float, nbytes: float, flop: float = 0.0):
    """(bound_ms, bound_by): the larger of the byte time and the operation time."""
    byte_ms = nbytes / PEAK_BYTES * 1e3
    op_ms = max(instr_ms, flop / PEAK_BF16 * 1e3)
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def world_invariants(state, cfg) -> None:
    """Every world holds one of each object on 9 distinct cells with the agent."""
    B = state.objects.shape[0]
    flat = state.objects.reshape(B, -1).to(torch.int64)
    counts = torch.zeros((B, 10), dtype=torch.int64, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    check(bool((counts[:, 1:9] == 1).all()), "one of each of the 8 objects per world")
    agent = state.agent[:, 0].to(torch.int64) * cfg.width + state.agent[:, 1]
    check(bool((flat.gather(1, agent[:, None]) == 0).all()), "agent on an empty cell")


def near_top(p, cfg):
    """A packed state with keys at int16's top end: even envs hold their axe
    (slot 1 at key H*W, holding the axe) and every third env has lost its
    rock (slot 3 at H*W + 1), as after a pickup and a chop."""
    env = torch.arange(p.agent_r.shape[0], device=p.agent_r.device)
    key = p.slot_key.clone()
    hold = env % 2 == 0
    key[1] = torch.where(hold, cfg.n_cells, key[1])
    key[3] = torch.where(env % 3 == 0, cfg.n_cells + 1, key[3])
    return p._replace(slot_key=key, holding=torch.where(hold, 2, p.holding).to(torch.int16))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    t_start = time.perf_counter()
    argv = sys.argv[1:]
    if "--rank-worker" in argv:  # one rank of phase 21's world, started by torchrun
        return rank_worker(Path(argv[argv.index("--rank-worker") + 1]),
                           argv[argv.index("--device") + 1])
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

    if "--worker" in argv:  # one job of side_by_side
        return phase_worker(cw, argv[argv.index("--worker") + 1], argv)
    dev = torch.device(DEVICE, 0)

    # ---- 1. device and build ---------------------------------------------
    smi = card_line()
    card = smi.splitlines()[0].strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    tag = f"[{card}]"
    if "--imitation" in sys.argv[1:]:  # phases 19-20 alone: the keyed kernels build at first use
        torch.backends.cuda.matmul.allow_tf32 = False
        imitation_phase(cw, dev, tag)
        recurrent_phase(cw, dev, tag)
        return 0
    path, seconds, log = _build.build()
    print(f"{tag} built {path.relative_to(HERE)} in {seconds:.1f} s")
    for line in log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry", "Performance")):
            print("  ptxas:", line.strip())
    _build.load()
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    SASS.update(sass_paths(path))
    integer = ("cw_bench", "cw_actions", "cw_stream", "cw_pool", "cw_slot_rollout", "cw_keyed")
    print(f"{tag} max SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz; SASS instructions of the integer "
          f"kernels, static (all, outermost loop) and on a warp's path (before the loop, a "
          f"trip, after): " + "; ".join(
              f"{k}: ({v.static}, {v.static_body}) ({v.pro}, {v.body}, {v.epi})"
              for k, v in SASS.items() if any(n in k for n in integer)))
    for k in SASS:  # the keyed kernels' paths by launch: phase 27c
        if any(n in k for n in integer) and "cw_keyed" not in k:
            p = SASS[k]
            trip_int, ahead, ahead_int = p.pipes["int"][1], p.pipes["ahead"], p.pipes["ahead_int"]
            print(f"{tag} {k} path by pipe (before the loop, a trip, after): {pipe_line(k)}; "
                  f"a trip issues {p.body} at one a clock, {2 * trip_int} clocks of the integer "
                  f"pipe at one every second clock" + (
                      f"; left out of its bounds, its ring of actions loaded ahead (AHEAD lines) "
                      f"{ahead}, {ahead_int} of them on the integer pipe" if any(ahead) else ""))
    pipe_probe(tag)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products in full f32
    if "--gemm-core" in sys.argv[1:]:  # phase 9a alone: the first check of a new core
        gemm_core_phase(dev, tag)
        gradient_phase(cw, dev, tag)
        return 0
    alone = [a for a in ("--ladder", "--multi-device", "--learning", "--canonical", "--cpv",
                         "--distill", "--tools", "--keys") if a in sys.argv[1:]]
    if alone:  # phases 11-13, 21, 22, 23, 24, 25, 26 and/or 27 alone
        if "--ladder" in alone:
            ladder_phases(cw, dev, tag)
        if "--multi-device" in alone:
            multi_device_phase(cw, dev, tag)
            run_py_phase(cw, dev, tag)
        if "--learning" in alone:
            side_by_side(tag, LEARN_JOBS)
        if "--canonical" in alone:
            pixel_curve_phase(cw, dev, tag)
            canonical_tools_phase(cw, dev, tag)
        if "--cpv" in alone:
            cpv_phase(cw, dev, tag)
        if "--distill" in alone:
            distill_phase(cw, dev, tag)
        if "--tools" in alone:
            tools_phase(cw, dev, tag, card)
        if "--keys" in alone:
            keys_phase(cw, dev, tag)
        return 0

    cfg = cw.ray_config()
    B = B_MAIN

    # ---- 2. the main path, counted ---------------------------------------
    wrappers = kernel_wrappers("packed_bench", "packed_actions", "action_stream")
    wrappers.update(keyed_wrappers())
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
    flat = cw.flat_config(reward_equal=False)
    # a grid whose keys come near int16's top: held key 32,761, removed 32,762
    big = cw.ray_config(height=181, width=181)
    worst = 0
    for label, cfg_, B_, T, mix in [("21x21", cfg, B, 64, False), ("8x8 mix", flat, B_SMALL, 64, True),
                                    ("21x21 ragged", cfg, B + 37, 64, False),
                                    ("21x21 T=1", cfg, B, 1, False),
                                    ("181x181 mix", big, B_SMALL, 64, True)]:
        gen.manual_seed(1234)
        actions = torch.randint(0, 6, (T, B_), generator=gen, device=dev,
                                dtype=torch.int32)
        if mix:  # regular pickups and drops, so crafting fires
            t = torch.arange(T, device=dev)[:, None]
            actions = torch.where(t % 7 == 6, 4, torch.where(t % 11 == 10, 5, actions % 4))
            actions = actions.to(torch.int32).contiguous()
        p = packed(cfg_, B_, 2)
        if cfg_ is big:
            p = near_top(p, cfg_)
        pk, rk, dk = pf.rollout_packed_actions(cfg_, p, actions)
        pp, rp, dp = pf.rollout_packed_actions_plain(cfg_, p, actions)
        err = max_abs_diff(list(zip(pk, pp)) + [(rk, rp), (dk, dp)])
        check(err == 0, f"actions kernel bit-exact, tolerance 0 ({label}, err {err})")
        worst = max(worst, err)
        print(f"{tag} actions kernel == plain: {label} B={B_} T={T} "
              f"reward_equal={cfg_.reward_equal} successes {int((rk == cfg_.max_steps).sum())} "
              f"achieved bits {int(pk.achieved.sum())}, max key {int(pk.slot_key.max())}, "
              f"held or removed slots {int((pk.slot_key >= cfg_.n_cells).sum())}")
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
    # the collect's shape: one step a launch, 64 launches an update
    acts1 = acts[:1].contiguous()
    collect = dict(ms=time_ms(lambda: pf.rollout_packed_actions(cfg, p, acts1)),
                   plain_ms=time_ms(lambda: pf.rollout_packed_actions_plain(cfg, p, acts1)))

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
    worst = 0
    for label, cfg_, B_, T in [("21x21", cfg, B, 512), ("21x21 T=299", cfg, B, 299),
                               ("21x21 ragged", cfg, B + 37, 300), ("8x8", flat, B_SMALL, 300),
                               ("181x181", big, B_SMALL, 300)]:
        p = packed(cfg_, B_, 4)
        if cfg_ is big:
            p = near_top(p, cfg_)
        pk, ck = pf.rollout_packed_bench(cfg_, p, 99, T)
        pp, cp = pf.rollout_packed_bench_plain(cfg_, p, 99, T)
        err = max_abs_diff(list(zip(pk, pp)) + [(ck, cp)])
        check(err == 0, f"bench kernel bit-exact, tolerance 0 ({label}, err {err})")
        worst = max(worst, err)
        print(f"{tag} bench kernel == plain: {label} B={B_} T={T}, checksum "
              f"{int(ck.sum(dtype=torch.int64))}, {int((pk.achieved != 0).sum())} "
              f"envs with a task bit, held or removed slots "
              f"{int((pk.slot_key >= cfg_.n_cells).sum())}")
    T = 256
    p = packed(cfg, B, 4)
    results["packed_bench"] = dict(
        err=worst,
        ms=time_ms(lambda: pf.rollout_packed_bench(cfg, p, 99, T)),
        plain_ms=time_ms(lambda: pf.rollout_packed_bench_plain(cfg, p, 99, T)),
        shape=f"B={B} T={T}")

    # bounds at the timed shapes (instructions two-rate; bytes: state in and
    # out, actions, rewards, dones, stream)
    p3 = packed(cfg, B, 3)
    warps = -(-B // 32)
    state_bytes = 2 * sum(t.numel() * t.element_size() for t in p3)  # every field in and out
    trips = {"cw_bench_kernel": 256 // 4, "cw_actions_kernel": 64,
             "cw_stream_kernel": 256 // 4}
    bounds = {"packed_bench": bound(pipe_bound_ms("cw_bench_kernel", warps, trips["cw_bench_kernel"]),
                                    state_bytes + 4 * B),
              "packed_actions": bound(pipe_bound_ms("cw_actions_kernel", warps,
                                                    trips["cw_actions_kernel"]),
                                      state_bytes + 64 * B * (4 + 4 + 1)),
              "action_stream": bound(pipe_bound_ms("cw_stream_kernel", warps, trips["cw_stream_kernel"]),
                                     256 * B * 4)}
    b1 = bound(pipe_bound_ms("cw_actions_kernel", warps, 1), state_bytes + B * (4 + 4 + 1))
    # device time (torch.profiler) beside the CUDA-event time, which also
    # holds the wrapper's host work
    device = {
        "packed_actions T=1": (collect["ms"], b1[0], device_ms(
            lambda: pf.rollout_packed_actions(cfg, p3, acts1), "cw_actions_kernel", b1[0])),
        "packed_actions T=64": (results["packed_actions"]["ms"], bounds["packed_actions"][0],
                                device_ms(lambda: pf.rollout_packed_actions(cfg, p3, acts),
                                          "cw_actions_kernel", bounds["packed_actions"][0])),
        "packed_bench T=256": (results["packed_bench"]["ms"], bounds["packed_bench"][0],
                               device_ms(lambda: pf.rollout_packed_bench(cfg, p, 99, 256),
                                         "cw_bench_kernel", bounds["packed_bench"][0])),
        # phase 4's kernel (row 3), which no main path launches
        "action_stream T=256": (results["action_stream"]["ms"], bounds["action_stream"][0],
                                device_ms(lambda: pf.fused_action_stream(B, 12345, 256, device=dev),
                                          "cw_stream_kernel", bounds["action_stream"][0])),
    }
    for name, (ev, floor, (dv, discarded)) in device.items():
        print(f"{tag} {name} B={B}: CUDA events {ev:.4f} ms, device time {dv:.4f} ms "
              f"(torch.profiler, mean of 20 calls); bound {floor:.5f} ms, device share "
              f"{floor / dv:.1%}, event share {floor / ev:.1%}; profiler sessions discarded: "
              + ("; ".join(discarded) or "none"))
    results["packed_actions"]["device_ms"] = device["packed_actions T=64"][2][0]
    results["packed_bench"]["device_ms"] = device["packed_bench T=256"][2][0]
    results["action_stream"]["device_ms"] = device["action_stream T=256"][2][0]

    # ---- 6. throughput -----------------------------------------------------
    for B_ in (B, 8 * B):
        p = packed(cfg, B_, 5)
        probe = time_ms(lambda: pf.rollout_packed_bench(cfg, p, 7, 4096), reps=3)
        # one run >= 0.2 s, capped so that a broken timer cannot run away
        T = min(4 * math.ceil(0.25 / (probe / 1e3 / 4096) / 4), 1 << 22)
        ms = time_ms(lambda: pf.rollout_packed_bench(cfg, p, 7, T))
        LONG_T_RATE[B_] = B_ * T / (ms / 1e3)
        print(f"{tag} bench kernel B={B_} T={T}: {ms:.2f} ms/run, "
              f"{B_ * T / (ms / 1e3):.4e} env-steps/s (median of 5), "
              f"{shares('cw_bench_kernel', -(-B_ // 32), T // 4, ms)}")
    sl = sm.from_env_state(cw.reset_from_seed(cfg, 6, B, device=dev))
    mark = keyed_mark()
    ms = time_ms(lambda: pr.rollout_p_bench(cfg, sl, prng_key(0, device=dev), 256))
    print(f"{tag} plain rollout_p_bench B={B} T=256: {ms:.2f} ms/run, "
          f"{B * 256 / (ms / 1e3):.4e} env-steps/s (median of 5)")
    keyed_since(mark, f"{tag} phase 6 rollout_p_bench, its actions randint(key, (T, B)) a run",
                keyed_counts(0, 1 + 5))
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
    print(f"launch counters of the main path: {launches}")

    replaces = {"packed_bench": f"{JAX_KERNELS}:101",
                "packed_actions": f"{JAX_KERNELS}:122",
                "action_stream": f"{JAX_KERNELS}:247"}
    for name, r in results.items():
        kern = f"cw_{name.split('_', 1)[1]}_kernel"
        dv = r.get("device_ms")
        print(f"{tag} {name} {r['shape']}: kernel {r['ms']:.4f} ms"
              + (f" (device {dv:.4f} ms)" if dv else "") + f", plain {r['plain_ms']:.4f} ms, "
              f"bound {bounds[name][0]:.5f} ms ({bounds[name][1]}); CUDA events "
              f"{shares(kern, warps, trips[kern], r['ms'])}"
              + (f"; device time {shares(kern, warps, trips[kern], dv)}" if dv else ""))
    # one step a launch
    dv = device["packed_actions T=1"][2][0]
    print(f"{tag} packed_actions at the collect's shape B={B} T=1 (64 launches an update): "
          f"kernel {collect['ms']:.4f} ms (CUDA events), device {dv:.5f} ms, "
          f"plain {collect['plain_ms']:.4f} ms, bound {b1[0]:.5f} ms ({b1[1]}), "
          f"device share {b1[0] / dv:.1%}")
    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=replaces[name],
                    launches=launches[name], max_abs_err=r["err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=bounds[name][0], bound_by=bounds[name][1],
                    library_ms=None)
               for name, r in results.items()]

    def ended(phases: str) -> None:
        print(f"{tag} phases {phases} ended at {time.perf_counter() - t_start:.1f} s of the script")

    ended("1-6")
    kernels += fast_ppo_phases(cw, dev, tag)
    ended("7-10")
    kernels += ladder_phases(cw, dev, tag)
    ended("11-13")
    front_end_phases(cw, dev, tag)
    ended("14-16")
    pixel_ppo_phases(cw, dev, tag)
    ended("17")
    policy_families_phase(cw, dev, tag)
    ended("18")
    torch.cuda.empty_cache()  # room for the processes side by side
    side_by_side(tag, SIDE_BY_SIDE)
    ended("19, 20, 21c, 22, 23 and 25")
    multi_device_phase(cw, dev, tag)
    ended("21")
    side_by_side(tag, ("24",), args=["--long-t-rate", f"{B_MAIN}={LONG_T_RATE[B_MAIN]!r}"])
    ended("24")
    side_by_side(tag, ("26",))
    ended("26")
    kernels += keys_phase(cw, dev, tag)
    ended("27")
    for k in kernels:  # the counter kernel's main path is fast PPO's (phase 7)
        if k["name"] == "keyed_counter":
            k["launches"] = FAST_PPO_KEYED["launches"]
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


def gemm_core_phase(dev, tag, n=131072, H=512):
    """Phase 9a: the gradient kernel's bf16 product core against its plain
    version, on one tile, a ragged shape and the five products of a
    minibatch (n rows, hidden H, features padded to 128). Each output must be
    within 1e-5 of the plain result relative to sum |a_i b_i|."""
    from gym_craftingworld_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    shapes = [("one tile", 128, 128, 64), ("ragged", 300, 200, 192),
              ("z1 = x_pad w1_pad^T", n, H, 128), ("z2 = h1 w2^T", n, H, H),
              ("dz1 = dz2 w2", n, H, H), ("gw2 = dz2^T h1", H, H, n),
              ("gw1 = dz1^T x_pad", H, 128, n)]
    fu.gemm_bf16_kernel.launches = 0
    worst = 0.0
    for label, M, N, K in shapes:
        a = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((N, K), generator=gen, device=dev).to(torch.bfloat16)
        got = fu.gemm_bf16_kernel(a, b)
        torch.cuda.synchronize()
        want = fu.gemm_bf16_plain(a, b)
        scale = a.float().abs() @ b.float().abs().T
        err = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
        worst = max(worst, err)
        print(f"{tag} GEMM core {label} M={M} N={N} K={K}: max |kernel - plain| / sum|a b| "
              f"{err:.3e} (limit 1e-5), max |err| {float((got - want).abs().max()):.3e}")
        check(tuple(got.shape) == (M, N) and got.dtype == torch.float32, f"{label} shape")
        check(err < 1e-5, f"GEMM core within 1e-5 on {label} ({err:.3e})")
    check(fu.gemm_bf16_kernel.launches == len(shapes), "the core launched once a shape")
    return worst


def grad_work(n, F, H, A=6):
    """(FLOP, bytes) a minibatch gradient needs: the five products, counted at
    F and not the padding, and the three 7-wide head products; each input
    (features, 5 row vectors, weights) read once, each output written once."""
    flop = 2 * n * (2 * F * H + 3 * H * H) + 3 * 2 * n * (A + 1) * H
    weights = 2 * (H * F + H * H + (A + 1) * H) + 4 * (2 * H + A + 1)
    nbytes = 2 * n * F + 5 * 4 * n + weights + 4 * (H * F + H * H + 9 * H + 8) + 3 * 4 * n
    return flop, nbytes


def five_matmuls(gen, dev, n, F, H):
    """The gradient's five products as five bf16 ``torch.matmul`` calls
    (cuBLAS): the yardstick of the kernel's products, never called by the port."""
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x, h1, dz1, dz2, w1, w2 = r(n, F), r(n, H), r(n, H), r(n, H), r(H, F), r(H, H)

    def run():
        torch.matmul(x, w1.T)
        torch.matmul(h1, w2.T)
        torch.matmul(dz2, w2)
        torch.matmul(dz2.T, h1)
        torch.matmul(dz1.T, x)
    return run


def gradient_phase(cw, dev, tag):
    """Phase 9: the gradient kernels against their plain version at N=131,072,
    H=512, F=67; indexed against gathered; two launches bit-identical."""
    from gym_craftingworld_tpu_torch.ops import fused_update as fu
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp

    cfg, B = cw.ray_config(), B_MAIN
    F = fp.feature_rows(cfg)
    gen = torch.Generator(device=dev)
    results = {}
    fppo = fp.FastPPOConfig()
    gen.manual_seed(3)
    params = fp.init_params(prng_key(3).to(dev), cfg, fppo)
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
    # block ids past either end read featb[ids] as JAX's gather does: a
    # negative id wraps once, then every id clamps into [0, NB - 1]
    ids_oor = ids.clone()
    ids_oor[:4] = torch.tensor([NB, NB + 5, -1, -NB - 3], device=dev)
    go, ao = fu.fused_minibatch_grads_indexed(fppo, params, featb, ids_oor, batch[1:])
    x_oor = featb[fu.block_ids(ids_oor, NB)].reshape(N, F)
    check(fu.block_ids(ids_oor[:4], NB).tolist() == [NB - 1, NB - 1, NB - 1, 0],
          "block_ids wraps once, then clamps")
    gog, aog = fu.fused_minibatch_grads(fppo, params, (x_oor,) + batch[1:])
    oor_rel = max(float(((go[k] - gog[k]).abs() / gog[k].abs().clamp_min(1e-30)).max()) for k in go)
    check(all(torch.allclose(go[k], gog[k], rtol=1e-6, atol=0) for k in go)
          and abs(float(ao["loss"]) - float(aog["loss"])) <= 1e-6 * abs(float(aog["loss"])),
          f"out-of-range ids: indexed equals gathered featb[block_ids] at rtol 1e-6 ({oor_rel:.3e})")
    gpo, *_ = fu.ppo_grads_plain(fppo, w, x_oor, *fu._rest(*batch[1:]))
    err_abs_o, err_rel_o, cos_o = grads_err(go, gpo)
    check(err_rel_o < 3e-2 and cos_o > 0.999, "out-of-range ids: indexed kernel within tolerance of plain")
    print(f"{tag} indexed kernel with block ids {ids_oor[:4].tolist()} (NB={NB}) == gathered "
          f"featb[block_ids] (max rel diff {oor_rel:.3e}); vs plain: max abs err {err_abs_o:.3e}, "
          f"max rel err {err_rel_o:.3e}, min cosine {cos_o:.7f}")
    flop, nbytes = grad_work(N, F, fppo.hidden)
    library_ms = time_ms(five_matmuls(gen, dev, N, F, fppo.hidden))
    results["ppo_grads"] = dict(
        bound=bound(0.0, nbytes, flop), library_ms=library_ms,
        err=err_abs, ms=time_ms(lambda: fu.fused_minibatch_grads(fppo, params, batch)),
        plain_ms=time_ms(lambda: fu._finish(fppo, N, *fu.ppo_grads_plain(
            fppo, fu.weights(params), batch[0], *fu._rest(*batch[1:])))),
        shape=f"N={N} H={fppo.hidden}", replaces="gym_craftingworld_tpu/ops/fused_update.py:57",
        source="gym_craftingworld_tpu_torch/csrc/fused_update.cu")
    results["ppo_grads_indexed"] = dict(
        bound=bound(0.0, nbytes + 4 * (NB // fppo.num_minibatches), flop), library_ms=library_ms,
        err=err_abs_i,
        ms=time_ms(lambda: fu.fused_minibatch_grads_indexed(fppo, params, featb, ids, batch[1:])),
        plain_ms=time_ms(lambda: fu._finish(fppo, N, *fu.ppo_grads_plain(
            fppo, fu.weights(params), featb[ids].reshape(N, F), *fu._rest(*batch[1:])))),
        shape=f"N={N} H={fppo.hidden} BLK={BLK}",
        replaces="gym_craftingworld_tpu/ops/fused_update.py:270",
        source="gym_craftingworld_tpu_torch/csrc/fused_update.cu")

    return results


GRADIENT_PARTS = {"cw_pad_kernel": "pad pre-pass", "cw_wgmma_gemm": "products",
                  "cw_heads_kernel": "heads", "cw_head_partial_kernel": "head partials",
                  "cw_reduce_kernel": "reduces", "cw_transpose_kernel": "transposes"}


def gradient_breakdown(cw, dev, tag, r, reps=5):
    """Phase 10's view of the indexed gradient kernel at the default minibatch:
    device time per sub-kernel (``torch.profiler``), TFLOP/s and share of the
    bound from the CUDA-event time ``r["ms"]``, and the five-matmul yardstick."""
    from gym_craftingworld_tpu_torch.ops import fused_update as fu
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp

    cfg, fppo = cw.ray_config(), fp.FastPPOConfig()
    F, B = fp.feature_rows(cfg), B_MAIN
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    params = fp.init_params(prng_key(13).to(dev), cfg, fppo)
    N = fppo.rollout_steps * B // fppo.num_minibatches
    BLK = fp.shuffle_block(fppo.rollout_steps, B, fppo.num_minibatches)
    NB = fppo.rollout_steps * B // BLK
    batch = random_minibatch(gen, dev, N, F)
    featb = (torch.rand((NB, BLK, F), generator=gen, device=dev) < 0.3).to(torch.bfloat16)
    ids = torch.randperm(NB, generator=gen, device=dev)[: NB // fppo.num_minibatches]
    run = lambda: fu.fused_minibatch_grads_indexed(fppo, params, featb, ids, batch[1:])
    # whole when every sub-kernel ran a whole number of times a launch
    whole = lambda ev: all(c % reps == 0 for k, c, _ in ev if any(n in k for n in GRADIENT_PARTS)) \
        and all(any(n in k for k, _, _ in ev) for n in GRADIENT_PARTS)
    events = device_events(run, reps, whole) or []
    parts = {v: 0.0 for v in GRADIENT_PARTS.values()}
    products, others = {}, {}
    for key, _, us in events:
        ms = us / 1e3 / reps
        part = next((v for k, v in GRADIENT_PARTS.items() if k in key), None)
        if part is None:
            others[key[:60]] = ms
            continue
        parts[part] += ms
        if part == "products":
            products[key.split("(")[0]] = ms
    if sum(parts.values()) > 0:
        print(f"{tag} gradient kernel N={N} H={fppo.hidden} per launch, device time by "
              f"sub-kernel (torch.profiler, {reps} launches): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
              + f"; sum {sum(parts.values()):.4f} ms; products by epilogue (0 relu, 1 mask, "
              f"2 f32 partials): " + ", ".join(f"{k} {v:.4f} ms" for k, v in products.items())
              + f"; the wrapper's torch kernels {sum(others.values()):.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(others.items(), key=lambda kv: -kv[1])[:4])
              + ")")
    else:
        print(f"{tag} gradient kernel per sub-kernel device time: not measured "
              f"(no profiler session recorded every sub-kernel whole)")
    flop, _ = grad_work(N, F, fppo.hidden)
    prod_flop = 2 * N * (2 * F * fppo.hidden + 3 * fppo.hidden ** 2)
    prod_ms = parts["products"]
    print(f"{tag} gradient kernel N={N} H={fppo.hidden} F={F}: {r['ms']:.4f} ms (CUDA events), "
          f"{flop / (r['ms'] / 1e3) / 1e12:.2f} TFLOP/s, {100 * r['bound'][0] / r['ms']:.2f}% of "
          f"its {r['bound'][0]:.4f} ms bound ({r['bound'][1]}); products "
          + (f"{prod_flop / (prod_ms / 1e3) / 1e12:.2f} TFLOP/s over {prod_ms:.4f} ms"
             if prod_ms > 0 else "not measured")
          + f"; five bf16 torch.matmul (cuBLAS, products only) {r['library_ms']:.4f} ms, "
          f"{prod_flop / (r['library_ms'] / 1e3) / 1e12:.2f} TFLOP/s")


def keyed_update_launches(fppo, B) -> int:
    """The counter kernel's launches of one fast-PPO update: ``split(key,
    4)``, the pool kernel's ``randint`` seeds, the uniforms of T planes,
    ``split(k_perm, epochs)``, and per epoch a split and a bits draw each
    round of ``permutation``."""
    from gym_craftingworld_tpu_torch.ops import threefry as tf
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp

    NB = fppo.rollout_steps * B // fp.shuffle_block(fppo.rollout_steps, B, fppo.num_minibatches)
    return 4 + 2 * fppo.update_epochs * tf.shuffle_rounds(NB)


FAST_PPO_KEYED = {"launches": 0}  # the counter kernel's launches on phase 7's default path


def pixel_keyed_launches(ppo, B) -> dict:
    """The keyed-draw kernels' launches of one pixel-PPO update: the counter
    kernel for ``split(key, 4)``, the pool's ``split``, scores and ``split``
    of 2B keys, the uniforms and the permutations; the reset kernel for the
    pool's tasks."""
    from gym_craftingworld_tpu_torch.ops import threefry as tf
    from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx

    NB = ppo.rollout_steps * B // fx.BLK
    return {"keyed_counter": 5 + 1 + 2 * ppo.update_epochs * tf.shuffle_rounds(NB),
            "keyed_reset": 1}


def zero_keyed():
    """The keyed-draw wrappers' launches and their plain versions' calls set
    to 0; returns (wrappers, plains) to read them back."""
    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd

    keyed, plains = keyed_wrappers(), [kd.counter_draws_plain, kd.reset_draws_plain]
    for w in keyed.values():
        w.launches = 0
    for f in plains:
        f.calls = 0
    return keyed, plains


def fast_ppo_phases(cw, dev, tag):
    from gym_craftingworld_tpu_torch.ops import fused_reset as fr
    from gym_craftingworld_tpu_torch.ops import fused_update as fu
    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
    from gym_craftingworld_tpu_torch.ops import packed_fused as pf
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp

    cfg, B, T_ = cw.ray_config(), B_MAIN, PPO_UPDATES
    F = fp.feature_rows(cfg)
    wrappers = kernel_wrappers("pool", "ppo_grads", "ppo_grads_indexed", "packed_actions",
                               "packed_bench", "action_stream")
    wrappers.update(keyed_wrappers())
    plains = [fr.fresh_packed_plain, fu.ppo_grads_plain, pf.rollout_packed_actions_plain,
              pf.rollout_packed_bench_plain, pf.action_stream_plain, kd.counter_draws_plain,
              kd.reset_draws_plain]
    gen = torch.Generator(device=dev)  # the synthetic minibatches of phases 9-10
    key = lambda seed: prng_key(seed).to(dev)

    # ---- 7. the trainer at full width, counted ------------------------------
    main_launches = {}
    for preset, fppo in (("default", fp.FastPPOConfig()),
                         ("throughput", fp.FastPPOConfig.throughput())):
        env = fr.fresh_packed_fused(cfg, 11, B, device=dev)
        ts = fp.init_fast_train_state(key(7), cfg, fppo)
        k_train = key(8)
        w1_0 = ts.params.w1.detach().clone()
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        for f in plains:
            f.calls = 0
        t0 = time.perf_counter()
        ts, env, k_train, m = fp.train_many_fast(cfg, fppo, ts, env, T_, k_train)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}  # of the 3 updates
        if preset == "default":
            # one update's draws from the key chain on the card make no host sync
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, k_pool, k_roll, k_perm = kd.split_keys(k_train, 4)
                pool = fp._fresh_pool(cfg, k_pool, 2 * B)
                u = fp.gumbel_uniforms(k_roll, fppo.rollout_steps, B)
                NBp = fppo.rollout_steps * B // fp.shuffle_block(fppo.rollout_steps, B,
                                                                 fppo.num_minibatches)
                fp.epoch_perms(k_perm, fppo.update_epochs, NBp)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            print(f"{tag} one update's draws (split, pool seeds and pool, {fppo.rollout_steps} "
                  f"planes of uniforms, {fppo.update_epochs} permutations of {NBp}) under "
                  f"torch.cuda.set_sync_debug_mode('error'): no host sync")
            # score the trained policy: its loss and gradient on one fresh minibatch
            with torch.no_grad():
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
        per_update = keyed_update_launches(fppo, B)
        check(launches["keyed_counter"] == T_ * per_update,
              f"counter kernel {per_update} times an update ({launches['keyed_counter']})")
        check(launches["keyed_reset"] == 0, "no reset kernel: the pool kernel draws the pool")
        print(f"{tag} fast PPO {preset}: the counter kernel launched {per_update} times an "
              f"update, the key chain on the card (split 4, pool seeds, {fppo.rollout_steps} "
              f"planes of uniforms in one launch, {fppo.update_epochs} epoch permutations)")
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
            FAST_PPO_KEYED["launches"] = main_launches["keyed_counter"]
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
        source="gym_craftingworld_tpu_torch/csrc/fused_reset.cu", library_ms=None,
        bound=bound(pipe_bound_ms("cw_pool_kernelILi4E", n_pool, len(cfg.selected_task_indices)),
                    4 * 2 + 10 * 4 * n_pool))
    ms_entry = time_ms(lambda: fr.fresh_packed_fused(cfg, sd[0], n_pool, seed2=sd[1]))
    print(f"{tag} fresh_packed_fused (entry point, assembly included) n={n_pool}: "
          f"{ms_entry:.4f} ms; agent-cell chi2 {chi2:.1f} (dof 440)")
    floor = results["pool"]["bound"][0]
    dv, discarded = device_ms(lambda: fr.pool_picks(cfg, sd, n_pool), "cw_pool_kernel", floor)
    print(f"{tag} pool kernel n={n_pool} 21x21: CUDA events {results['pool']['ms']:.4f} ms, "
          f"device time {dv:.5f} ms (torch.profiler, mean of 20 calls); bound {floor:.5f} ms, "
          f"device share {floor / dv:.1%}, event share {floor / results['pool']['ms']:.1%}; "
          f"profiler sessions discarded: " + ("; ".join(discarded) or "none"))

    # ---- 9. the product core, then the gradient kernels vs plain ----------------
    gemm_core_phase(dev, tag)
    results.update(gradient_phase(cw, dev, tag))

    # ---- 10. fast-PPO timings ----------------------------------------------------
    for preset, fppo in (("default", fp.FastPPOConfig()),
                         ("throughput", fp.FastPPOConfig.throughput())):
        state = {"ts": fp.init_fast_train_state(key(5), cfg, fppo),
                 "env": fr.fresh_packed_fused(cfg, 12, B, device=dev), "key": key(6)}

        def step(**kw):
            state["ts"], state["env"], state["key"], _ = fp.train_step_fast(
                cfg, fppo, state["ts"], state["env"], state["key"], **kw)

        ms_k = time_ms(step)
        ms_p = time_ms(lambda: step(fused_pool=False, fused_update=False))
        ms_k2 = time_ms(step)
        env0 = state["env"]
        k_pool, k_roll, k_perm = key(9), key(10), key(11)
        pool = fp._fresh_pool(cfg, k_pool, 2 * B)
        u = fp.gumbel_uniforms(k_roll, fppo.rollout_steps, B)
        with torch.no_grad():
            ms_collect = time_ms(lambda: fp._collect(cfg, fppo, state["ts"].params, env0, pool, u))
            _, traj = fp._collect(cfg, fppo, state["ts"].params, env0, pool, u)
            _, lv = fp.apply_policy(state["ts"].params, fp.features(cfg, env0))
            adv, ret = fp._gae(fppo, traj, lv)
        NBp = fppo.rollout_steps * B // fp.shuffle_block(fppo.rollout_steps, B, fppo.num_minibatches)
        perms = fp.epoch_perms(k_perm, fppo.update_epochs, NBp)
        ms_update = time_ms(lambda: fp._update_phase(fppo, state["ts"], traj, adv, ret, perms))
        ms_pool = time_ms(lambda: fp._fresh_pool(cfg, k_pool, 2 * B))
        ms_draws = time_ms(lambda: (fp.gumbel_uniforms(k_roll, fppo.rollout_steps, B),
                                    fp.epoch_perms(k_perm, fppo.update_epochs, NBp)))
        ms_gae = time_ms(lambda: fp._gae(fppo, traj, lv))
        env_steps = B * fppo.rollout_steps
        print(f"{tag} fast PPO {preset} B={B} hidden={fppo.hidden}: "
              f"{ms_k:.2f} / {ms_k2:.2f} ms per update through the kernels "
              f"({env_steps / (ms_k2 / 1e3):.4e} env-steps/s), {ms_p:.2f} ms with "
              f"fused_pool=False, fused_update=False (median of 5, CUDA events); stages: "
              f"pool {ms_pool:.3f} ms, collect {ms_collect:.2f} ms, GAE {ms_gae:.3f} ms, "
              f"update phase {ms_update:.2f} ms; the keyed draws (uniforms and permutations) "
              f"{ms_draws:.3f} ms")
        if preset == "default":
            torch.cuda.reset_peak_memory_stats(dev)
            step()
            torch.cuda.synchronize()
            print(f"{tag} fast PPO default: peak device memory of one update "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB "
                  f"(torch.cuda.max_memory_allocated)")
    gradient_breakdown(cw, dev, tag, results["ppo_grads_indexed"])
    for name, r in results.items():
        print(f"{tag} {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return [dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
                 launches=main_launches[name], max_abs_err=r["err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
                 library_ms=r["library_ms"])
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
    wrappers = kernel_wrappers("fused_rollout", "fused_rollout_actions", "fused_rollout_t",
                               "packed_bench", "action_stream")
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
    mark = keyed_mark()
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
    keyed_since(mark, f"{tag} phase 11, whose rungs step the Philox stream", keyed_counts(0, 0))
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
    mark = keyed_mark()
    gen = torch.Generator(device=dev)  # the script's own actions and synthetic states
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

    # the actions kernel where its ring of actions loaded ahead can go wrong:
    # fewer steps than the ring, one either side of its depth, and long
    ring_T = sorted({t for t in (1, fr.SLOT_AHEAD - 1, fr.SLOT_AHEAD + 1, 256) if t >= 1})
    big = cw.ray_config(height=181, width=181)
    for label, cfg_, B_, mix in (("21x21 ragged", cfg, B + 37, False),
                                 ("8x8 mix", cw.flat_config(reward_equal=False), B_SMALL, True),
                                 ("181x181 mix", big, B_SMALL, True)):
        sl = sm.from_env_state(cw.reset_from_seed(cfg_, 32, B_, device=dev))
        errs = {}
        for T in ring_T:
            gen.manual_seed(78 + T)
            actions = torch.randint(0, 6, (T, B_), generator=gen, device=dev, dtype=torch.int32)
            if mix:
                t = torch.arange(T, device=dev)[:, None]
                actions = torch.where(t % 7 == 6, 4, torch.where(t % 11 == 10, 5, actions % 4))
                actions = actions.to(torch.int32).contiguous()
            errs[T] = compare("fused_rollout_actions", fr.rollout_slots_actions(cfg_, sl, actions),
                              fr.rollout_slots_actions_plain(cfg_, sl, actions))
        check(all(e == 0 for e in errs.values()),
              f"actions kernel bit-exact at the ring's edges, tolerance 0 ({label}: {errs})")
        print(f"{tag} actions kernel == plain at the edges of its ring (SLOT_AHEAD "
              f"{fr.SLOT_AHEAD}): {label} {cfg_.height}x{cfg_.width} B={B_}; max |err| by T {errs}")

    keyed_since(mark, f"{tag} phase 12, six resets from keys", keyed_counts(6, 6))

    # ---- 13. ladder timings ----------------------------------------------------
    mark = keyed_mark()
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
    kernel_of = {k: kern for k, (kern, _) in results.items()}
    results = {k: dict(ms=time_ms(kern), plain_ms=time_ms(plain))
               for k, (kern, plain) in results.items()}
    for name, r in results.items():
        print(f"{tag} {name} B={B} T={T}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    # bounds at the timed B and T: instructions, or the state in and out, the
    # rewards and dones, and the given actions
    warps = -(-B // 32)
    state_bytes = 2 * sum(t.numel() * t.element_size() for t in sl)
    # each instantiation's name in the SASS (mangled) and in the profiler's
    # records (demangled)
    kern = {"fused_rollout": ("cw_slot_rollout_kernelI10RowsLayoutLb1E",
                              "cw_slot_rollout_kernel<RowsLayout, true>"),
            "fused_rollout_actions": ("cw_slot_rollout_kernelI10RowsLayoutLb0E",
                                      "cw_slot_rollout_kernel<RowsLayout, false>"),
            "fused_rollout_t": ("cw_slot_rollout_kernelI13ColumnsLayoutLb1E",
                                "cw_slot_rollout_kernel<ColumnsLayout, true>")}
    bounds = {"fused_rollout": bound(pipe_bound_ms(kern["fused_rollout"][0], warps, T // 4),
                                     state_bytes + 5 * T * B),
              "fused_rollout_actions": bound(pipe_bound_ms(kern["fused_rollout_actions"][0],
                                                           warps, T), state_bytes + 9 * T * B),
              "fused_rollout_t": bound(pipe_bound_ms(kern["fused_rollout_t"][0], warps, T // 4),
                                       state_bytes + 5 * T * B)}
    # device time (torch.profiler) beside the CUDA-event time; no main path
    # launches these kernels (rows 7-9)
    for name, r in results.items():
        dv, discarded = device_ms(kernel_of[name], kern[name][1], bounds[name][0])
        r["device_ms"] = dv
        print(f"{tag} {name} B={B} T={T}: CUDA events {r['ms']:.4f} ms, device time {dv:.4f} ms "
              f"(torch.profiler, mean of 20 calls); bound {bounds[name][0]:.5f} ms "
              f"({bounds[name][1]}), device share {bounds[name][0] / dv:.1%}, event share "
              f"{bounds[name][0] / r['ms']:.1%}; launches on a main path 0; profiler sessions "
              f"discarded: " + ("; ".join(discarded) or "none"))
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
    for name, kernel, fn, start in (
            ("fused_rollout (kernel 7)", kern["fused_rollout"][0],
             lambda s, i: fr.rollout_slots_seeded(cfg, s, i, T_CHUNK)[0], sl),
            ("fused_rollout_t (kernel 9)", kern["fused_rollout_t"][0],
             lambda s, i: frt.rollout_t_seeded(cfg, s, i, T_CHUNK)[0], ts)):
        probe = time_ms(chained(fn, start, 1), reps=3)
        n = max(1, math.ceil(250 / probe))
        ms = time_ms(chained(fn, start, n))
        rates[name] = B * T_CHUNK * n / (ms / 1e3)
        print(f"{tag} {name} B={B}: {n} launches x T={T_CHUNK}, {ms:.2f} ms/run, "
              f"{rates[name]:.4e} env-steps/s (median of 5), "
              f"{shares(kernel, -(-B // 32), T_CHUNK // 4, ms / n)}")
    p = pr.pack(cfg, ts)
    probe = time_ms(lambda: pf.rollout_packed_bench(cfg, p, 7, 4096), reps=3)
    T = min(4 * math.ceil(0.25 / (probe / 1e3 / 4096) / 4), 1 << 22)
    ms = time_ms(lambda: pf.rollout_packed_bench(cfg, p, 7, T))
    print(f"{tag} packed bench kernel (kernel 1) B={B} T={T}: {ms:.2f} ms/run, "
          f"{B * T / (ms / 1e3):.4e} env-steps/s (median of 5), "
          f"{shares('cw_bench_kernel', -(-B // 32), T // 4, ms)}")

    T = 32
    key = prng_key(4, device=dev)
    for name, fn in (("grid rollout_random", lambda: cw.rollout_random(cfg, state, key, T)),
                     ("rollout_slots_random", lambda: sm.rollout_slots_random(cfg, sl, key, T)),
                     ("rollout_t_random", lambda: tr.rollout_t_random(cfg, sl, key, T))):
        ms = time_ms(fn)
        print(f"{tag} {name} B={B} T={T}: {ms / T:.4f} ms per step (plain torch, median of 5)")
    keyed_since(mark, f"{tag} phase 13, a reset and the three engines' actions a run",
                keyed_counts(1, 1 + 3 * (1 + 5)))

    source = "gym_craftingworld_tpu_torch/csrc/fused_rollout.cu"
    replaces = {"fused_rollout": "gym_craftingworld_tpu/ops/fused_rollout.py:227",
                "fused_rollout_actions": "gym_craftingworld_tpu/ops/fused_rollout.py:242",
                "fused_rollout_t": "gym_craftingworld_tpu/ops/fused_rollout_t.py:165"}
    return [dict(name=name, route="cuda", source=source, replaces=replaces[name],
                 launches=launches[name], max_abs_err=worst[name], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=bounds[name][0], bound_by=bounds[name][1],
                 library_ms=None)
            for name, r in results.items()]


# ---------------------------------------------------------------------------
# the front end: renders, the observation rollout, the façade, the vector env
# (phases 14-16)
# ---------------------------------------------------------------------------


def on_host(state):
    """A CPU copy of an ``EnvState``."""
    return type(state)(**{f.name: getattr(state, f.name).cpu() for f in dataclasses.fields(state)})


def same(got, want, what: str) -> None:
    """Equal observations, rewards, dones and infos: dicts key by key, arrays
    in dtype, shape and every element."""
    import numpy as np

    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want), f"{what}: keys")
        for k in want:
            same(got[k], want[k], f"{what} {k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    check(g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w),
          f"{what}: equal ({g.dtype}{g.shape} vs {w.dtype}{w.shape})")


def front_end_phases(cw, dev, tag):
    """Phases 14-16: the renderers and the observation rollout at 16,384 envs
    on 21x21, the Gym façade on the card against the CPU, and the vector env."""
    import numpy as np

    from gym_craftingworld_tpu_torch import api
    from gym_craftingworld_tpu_torch.core import slots as sm
    from gym_craftingworld_tpu_torch.core import validate
    from gym_craftingworld_tpu_torch.ops import obs_rollout as obr
    from gym_craftingworld_tpu_torch.render import raster

    cfg, B = cw.ray_config(), B_MAIN
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    keyed = {k: w.launches for k, w in keyed_wrappers().items()}
    mark = keyed_mark()
    gen = torch.Generator(device=dev).manual_seed(14)  # the script's own actions (15-16)

    # ---- 14. renders -----------------------------------------------------------
    fresh = cw.reset_from_seed(cfg, 14, B, device=dev)
    stepped, _ = cw.rollout_random(cfg, fresh, prng_key(14), 40)  # held items, crafted objects
    renderers = {"render_ray": raster.render_ray, "render_altobs": raster.render_altobs,
                 "render_onehot": raster.render_onehot}
    for label, st in (("reset_from_seed", fresh), ("after 40 random steps", stepped)):
        host = on_host(st)
        for name, fn in renderers.items():
            got = fn(st.objects, st.agent, st.holding)
            want = fn(host.objects, host.agent, host.holding)
            check(got.device == st.objects.device and got.dtype == want.dtype
                  and torch.equal(got.cpu(), want), f"{name} on the card == on the CPU ({label})")
        for name in ("state_images_ray", "state_images_altobs", "state_obs_onehot"):
            got, want = getattr(raster, name)(st), getattr(raster, name)(host)
            check(set(got) == set(want), f"{name} keys")
            for k in want:
                check(got[k].dtype == want[k].dtype and torch.equal(got[k].cpu(), want[k]),
                      f"{name}[{k}] on the card == on the CPU ({label})")
            del got, want
        check(torch.equal(raster.state_images_altobs(st, stacked=True).cpu(),
                          raster.state_images_altobs(host, stacked=True)),
              f"stacked AltObs on the card == on the CPU ({label})")
        alt = raster.render_altobs(st.objects, st.agent, st.holding)
        print(f"{tag} renders on the card == on the CPU, byte for byte: {label}, B={B} 21x21, "
              f"the three renderers and the state_images_* dicts; envs holding an item "
              f"{int((st.holding > 0).sum())}, AltObs max {int(alt.max())}")
        del host, alt
    for name, fn in renderers.items():
        out = fn(stepped.objects, stepped.agent, stepped.holding)
        nbytes = out.numel() * out.element_size()
        ms = time_ms(lambda: fn(stepped.objects, stepped.agent, stepped.holding))
        print(f"{tag} {name} B={B} 21x21 -> {tuple(out.shape)} {out.dtype}: {ms:.4f} ms, "
              f"{B / (ms / 1e3):.4e} renders/s (median of 5, CUDA events); writes "
              f"{nbytes / 1e6:.1f} MB, {nbytes / (ms / 1e3) / 1e9:.1f} GB/s, "
              f"{nbytes / PEAK_BYTES * 1e3 / ms:.1%} of the HBM rate")
        del out

    slots = sm.from_env_state(cw.reset_from_seed(cfg, 15, B, device=dev))
    T = 64
    for mode, fn in (("ray", raster.render_ray), ("altobs", raster.render_altobs),
                     ("onehot", raster.render_onehot)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        key = prng_key(14, device=dev)
        ms = time_ms(lambda: obr.rollout_obs_random(cfg, slots, key, T, mode))
        peak = torch.cuda.max_memory_allocated(dev)
        steps_ms = time_ms(lambda: sm.rollout_slots_random(cfg, slots, key, T))
        print(f"{tag} rollout_obs_random {mode} B={B} T={T}: {ms:.2f} ms/run, "
              f"{B * T / (ms / 1e3):.4e} env-steps/s with a render every step (median of 5, "
              f"CUDA events), {ms / T:.4f} ms a step; rollout_slots_random without renders "
              f"{steps_ms / T:.4f} ms a step; peak device memory {peak / 2**30:.3f} GiB, "
              f"{(peak - held) / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB held before")
        # T=8: the checksum against a stepwise recompute, the final state
        # against the pure slot rollout from the same key
        key = prng_key(100, device=dev)
        final, checksum = obr.rollout_obs_random(cfg, slots, key, 8, mode)
        ref, _ = sm.rollout_slots_random(cfg, slots, key, 8)
        actions = sm.random_actions(slots, key, 8)
        expect, s = 0, slots
        for t in range(8):
            s, res = sm.step_slots(cfg, s, actions[t])
            objects, agent, holding = sm.to_grid(s, cfg)
            expect += int(fn(objects, agent, holding).sum(dtype=torch.int64))
            expect += int(res.reward.sum(dtype=torch.int64))
        check(int(checksum) == expect % 2**32,
              f"{mode} checksum {int(checksum)} == stepwise recompute {expect % 2**32}")
        for f in sm.SlotState._fields:
            check(torch.equal(getattr(final, f), getattr(ref, f)),
                  f"{mode} obs rollout and rollout_slots_random agree on {f}")
        print(f"{tag} rollout_obs_random {mode} B={B} T=8: checksum {int(checksum)} == stepwise "
              f"recompute (sum {expect}), final state == rollout_slots_random's")
    # two resets and 40 random steps; a mode: two timed rollouts of 6 runs, then 3
    # draws of the T=8 check
    keyed_since(mark, f"{tag} phase 14, the resets and the random rollouts' actions",
                keyed_counts(2, 2 + 1 + 3 * (2 * (1 + 5) + 3)))

    # ---- 15. the façade -----------------------------------------------------------
    acts = np.random.RandomState(15).randint(6, size=120)
    for env_id in ("craftingworld-v3", "craftingworldflat-v3", "craftingworldonehot-v3",
                   "craftingworldaltobs-v3"):
        flat = "flat" in env_id
        card = api.make(env_id, rng_mode="parity", seed=0, device=dev)
        host = api.make(env_id, rng_mode="parity", seed=0, device="cpu")
        same(card.reset(), host.reset(), f"{env_id} reset")
        n, resets, card_s = 0, 0, 0.0
        for i in range(100 if flat else 120):
            t0 = time.perf_counter()
            co, cr, cd, ci = card.step(int(acts[i]))
            card_s += time.perf_counter() - t0
            ho, hr, hd, hi = host.step(int(acts[i]))
            check((cr, cd) == (hr, hd), f"{env_id} step {i}: reward and done")
            same(co, ho, f"{env_id} step {i} obs")
            same(ci, hi, f"{env_id} step {i} info")
            n += 1
            if cd:
                if flat:
                    break
                same(card.reset(), host.reset(), f"{env_id} reset at step {i}")
                resets += 1
        check(not flat or cd, "the 8x8 Flat episode ended")
        print(f"{tag} façade {env_id} parity seed 0, {card.STATE_W}x{card.STATE_H}: {n} steps "
              f"({resets} resets) on the card == on the CPU (obs, reward, done, info); "
              f"{card_s / n * 1e3:.3f} ms a step on the card (host clock, obs copied to the host)")
    # the incremental render against the CPU env's full render
    for label, kw, host_kw in (("fixed_init_state=4", dict(fixed_init_state=4),
                                dict(fixed_init_state=4)),
                               ("incremental_render=True", dict(incremental_render=True), {})):
        card = api.make("craftingworld-v3", rng_mode="parity", seed=3, device=dev, **kw)
        host = api.make("craftingworld-v3", rng_mode="parity", seed=3, device="cpu", **host_kw)
        same(card.reset(), host.reset(), f"{label} reset")
        for i in range(60):
            co, cr, cd, ci = card.step(int(acts[i]))
            ho, hr, hd, hi = host.step(int(acts[i]))
            check((cr, cd) == (hr, hd), f"{label} step {i}: reward and done")
            same(co, ho, f"{label} step {i} obs")
        print(f"{tag} façade craftingworld-v3 {label}: 60 steps on the card == on the CPU "
              f"with {host_kw or 'its full render'}")
    env = api.make("craftingworld-v3", batch_size=B, seed=0, device=dev)
    t0 = time.perf_counter()
    obs = env.reset()
    t_reset = time.perf_counter() - t0
    validate.assert_valid_state(env.cfg, env.state)
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        obs, reward, done, info = env.step(np.arange(B) % 6)
        times.append(time.perf_counter() - t0)
    validate.assert_valid_state(env.cfg, env.state)
    check(isinstance(obs["observation"], np.ndarray) and obs["observation"].shape == (B, 84, 84, 3)
          and obs["observation"].dtype == np.uint8, "full-width façade obs shape and dtype")
    check(reward.shape == (B,) and done.dtype == bool and info["achieved_goal"].shape == (B, 9),
          "full-width façade reward, done and info")
    print(f"{tag} façade craftingworld-v3 batch_size={B}: reset {t_reset * 1e3:.1f} ms, "
          f"steps {', '.join(f'{t * 1e3:.1f}' for t in times)} ms (host clock, the obs dict "
          f"copied to the host: {sum({id(v): v.nbytes for v in obs.values()}.values()) / 1e6:.0f} MB "
          f"a step)")
    del env, obs

    # ---- 16. the vector env ----------------------------------------------------------
    expect = {"onehot": ((21, 21, 12), torch.uint8), "pixels": ((84, 84, 3), torch.uint8),
              "features": ((21 * 21 * 12 + 18,), torch.float32)}
    for mode, (shape, dtype) in expect.items():
        env = api.CraftingWorldVectorEnv(B, obs_mode=mode, seed=16, device=dev)
        obs, _ = env.reset()
        gen.manual_seed(16)
        ever = torch.zeros(B, dtype=torch.bool, device=dev)
        resets = torch.zeros((), dtype=torch.int64, device=dev)
        restarted_late = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(320):
            a = torch.randint(0, 6, (B,), generator=gen, device=dev, dtype=torch.int32)
            obs, reward, term, trunc, infos = env.step(a)
            done = term | trunc
            if i < 300:
                ever |= done
            resets += done.sum()
            restarted_late += (done & (env.state.step_num != 0)).sum()
            if i % 40 == 0 or i in (299, 300, 319):
                check(bool(validate.check_state(env.cfg, env.state).all()),
                      f"vector env {mode}: valid states at step {i}")
        check(bool(ever.all()), f"vector env {mode}: every env terminated or truncated by step 300")
        check(int(restarted_late) == 0, f"vector env {mode}: a done env restarts at step_num 0")
        check(obs.device == dev and tuple(obs.shape) == (B,) + shape and obs.dtype == dtype,
              f"vector env {mode}: obs on the card, {(B,) + shape} {dtype}")
        check(reward.dtype == torch.int32 and term.dtype == torch.bool and reward.device == dev,
              f"vector env {mode}: reward and flags on the card")
        steps = torch.randint(0, 6, (64, B), generator=gen, device=dev, dtype=torch.int32)

        def run():  # keeps no step's observations
            for a in steps:
                env.step(a)
        ms = time_ms(run, reps=3)
        print(f"{tag} vector env {mode} B={B} 21x21: 320 steps, {int(resets)} resets, every env "
              f"done by step 300, valid restarts; {B * 64 / (ms / 1e3):.4e} env-steps/s "
              f"({ms / 64:.4f} ms a step, 64 steps a run, median of 3, CUDA events), "
              f"obs {tuple(obs.shape)} {obs.dtype}")
        del env, obs
    launches = {k: w.launches for k, w in wrappers.items()}
    check(all(n == 0 for n in launches.values()),
          f"the front end runs plain PyTorch and none of the nine ported kernels: {launches}")
    keyed = {k: w.launches - keyed[k] for k, w in keyed_wrappers().items()}
    check(keyed["keyed_reset"] >= 3 * (320 + 64 * 4), f"the vector env's auto-reset launched "
          f"the keyed reset kernel every step: {keyed}")
    print(f"{tag} launch counters over phases 14-16: {launches}; keyed draws {keyed}")


# ---------------------------------------------------------------------------
# pixel PPO and the policy families (phases 17-18)
# ---------------------------------------------------------------------------

# envs of each family's train_step in phase 18: a vit minibatch of 4,096 rows
# already holds 6.4 GB of attention weights per block
FAMILY_B = {"mlp": 4096, "cnn": 4096, "vit": 256}
# timed updates after the cold one and greedy evaluation episodes of each
# family in phase 18: vit's update takes ~10.7 s and its 1,024-episode
# evaluation ~28 s on the H100, so it is timed once and evaluated over 256
FAMILY_REPS = {"mlp": 3, "cnn": 3, "vit": 1}
FAMILY_EVAL = {"mlp": 1024, "cnn": 1024, "vit": 256}
GRAD_ROWS = 4096  # rows of phase 17's card-vs-CPU gradient check


def plain_versions():
    """Every kernel's plain version, each counting its calls in ``calls``
    (``utils/profiling``)."""
    from gym_craftingworld_tpu_torch.utils import profiling

    return profiling.plain_versions()


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def width_dependence(p, grid, bits, stride1: int) -> dict:
    """{layer: whether rows 0:2048 of its output at 8,192 and at 4,096 rows
    equal those of one call on all of ``grid``'s rows}, each layer of
    ``fast_pixel_ppo.apply_pixel_policy`` fed the full call's input."""
    from gym_craftingworld_tpu_torch.models.layers import conv_nhwc

    bf16 = torch.bfloat16
    layers = (("conv1", lambda x: torch.relu(conv_nhwc(x, p.k1, (stride1, stride1)) + p.b1.to(bf16))),
              ("conv2", lambda x: torch.relu(conv_nhwc(x, p.k2, (2, 2)) + p.b2.to(bf16))),
              ("w1", lambda x: torch.relu(x.float() @ p.w1.to(bf16).float() + p.bd).to(bf16)),
              ("wl", lambda h: h @ p.wl.to(bf16)), ("wv", lambda h: h @ p.wv.to(bf16)))
    out, x = {}, grid
    with torch.no_grad():
        for name, f in layers:
            if name == "w1":
                x = torch.cat([x.reshape(x.shape[0], -1), bits], dim=-1)
            whole = f(x)
            out[name] = all(torch.equal(f(x[:w])[:2048], whole[:2048]) for w in (8192, 4096))
            x = whole if name in ("conv1", "conv2", "w1") else x  # the heads read h
    return out


def kernel_breakdown(fn, top: int = 8):
    """Device time of one ``fn()`` call by kernel (``torch.profiler``, after a
    warm-up call): (total ms, span ms by CUDA events, launches, [(name, ms,
    launches)] of the ``top`` kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if "CUDA" in str(e.device_type)), key=lambda r: -r[1])
    return sum(r[1] for r in rows), start.elapsed_time(end), sum(r[2] for r in rows), rows[:top]


def pixel_ppo_phases(cw, dev, tag):
    """Phase 17: ``train_many_pixel`` at 16,384 envs on 21x21 for both presets,
    counted; the card against the CPU; the stages' times."""
    from gym_craftingworld_tpu_torch import interop
    from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx

    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd

    cfg, B, U = cw.ray_config(), B_MAIN, PPO_UPDATES
    wrappers, keyed = kernel_wrappers(), keyed_wrappers()
    plains = plain_versions() + [kd.counter_draws_plain, kd.reset_draws_plain]
    gen = torch.Generator(device=dev)  # the synthetic minibatch of the card-vs-CPU check
    key = lambda seed: prng_key(seed).to(dev)
    for preset, ppo in (("default", fx.PixelPPOConfig()),
                        ("throughput", fx.PixelPPOConfig.throughput())):
        T = ppo.rollout_steps
        gen.manual_seed(17)
        ts = fx.init_pixel_train_state(key(17), cfg, ppo)
        env = fx.fresh_packed_batch(cfg, key(18), B)
        k_train = key(19)
        before = {k: v.detach().clone() for k, v in ts.params.tensors().items()}
        torch.cuda.synchronize()
        for w in (*wrappers.values(), *keyed.values()):
            w.launches = 0
        for f in plains:
            f.calls = 0
        t0 = time.perf_counter()
        ts, env, k_train, m = fx.train_many_pixel(cfg, ppo, ts, env, U, k_train)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        keyed_launches = {k: w.launches for k, w in keyed.items()}
        calls = {f.__name__: f.calls for f in plains}
        # an update: split(key, 4); the pool's split, scores, split of 2B keys
        # and tasks (the reset kernel); the uniforms; the permutations
        NB = T * B // fx.BLK
        want = {k: U * v for k, v in pixel_keyed_launches(ppo, B).items()}
        print(f"{tag} pixel PPO {preset}: the keyed-draw kernels launched {keyed_launches} "
              f"in {U} updates (want {want}): the pool of fresh_packed_batch, the uniforms and "
              f"permutations from the key chain on the card")
        check(keyed_launches == want, f"keyed draws {keyed_launches} == {want}")
        print(f"{tag} pixel PPO {preset}: B={B} conv {ppo.conv1}/{ppo.conv2} stride {ppo.stride1} "
              f"hidden {ppo.hidden} T={T} {ppo.update_epochs}x{ppo.num_minibatches} minibatches, "
              f"{U} updates in {t_train * 1e3:.1f} ms (cold, host clock); launches {launches}; "
              f"plain calls {calls}")
        check(launches["packed_actions"] == U * T,
              f"actions kernel once per collect step ({launches['packed_actions']})")
        check(all(n == 0 for k, n in launches.items() if k != "packed_actions"),
              f"no other of the nine kernels ran (the pixel path draws its pool from keys): "
              f"{launches}")
        check(all(c == 0 for c in calls.values()), f"no plain version ran: {calls}")
        metrics = {k: v.tolist() for k, v in m.items()}
        print(f"{tag} pixel PPO {preset} metrics: {json.dumps(metrics)}")
        check(all(math.isfinite(x) for v in metrics.values() for x in v), "finite metrics")
        check(all(len(v) == U for v in metrics.values()), "metrics stacked per update")
        check(ts.update_idx == U and int(ts.opt_state.count) == U * ppo.update_epochs
              * ppo.num_minibatches, "update and optimizer counts")
        check(all(not torch.equal(before[k], v) for k, v in ts.params.tensors().items()
                  if k in ("k1", "k2", "w1", "wl", "wv")), "the weights changed")
        check(abs(metrics["entropy"][0] - math.log(6)) < 0.05,
              f"first update's entropy within 0.05 of log 6 ({metrics['entropy'][0]:.4f})")
        check(bool(((env.slot_key >= 0) & (env.slot_key <= cfg.n_cells + 1)).all()),
              "env keys in range after training")

        # the card against the CPU on one state of B worlds
        host_env = type(env)(*(x.cpu() for x in env))
        host_params = interop.conv_params_from_numpy(interop.conv_params_to_numpy(ts.params),
                                                     device="cpu")
        card_obs, host_obs = fx.render_grid_obs(cfg, env), fx.render_grid_obs(cfg, host_env)
        for got, want in zip(card_obs, host_obs):
            check(got.dtype == want.dtype and torch.equal(got.cpu(), want),
                  f"render_grid_obs on the card == on the CPU, byte for byte ({preset})")
        with torch.no_grad():
            card_out = fx.apply_pixel_policy(ts.params, *card_obs, ppo.stride1)
            host_out = fx.apply_pixel_policy(host_params, *host_obs, ppo.stride1)
            card_tb = fx._policy_tb(ts.params, cfg, env, ppo.stride1)  # the collect's graph
            card_chunks = fx._policy_tb(ts.params, cfg, env, ppo.stride1, chunk=fx.POLICY_CHUNK)
        check(all(torch.equal(a, b) for a, b in zip(card_tb, card_chunks)),
              f"the collect's policy step replayed from its CUDA graph == the same chunks "
              f"called one by one, bit for bit ({preset})")
        err_fwd = max(float((a.cpu() - b).abs().max()) for a, b in zip(card_out, host_out))
        check(all(torch.allclose(a.cpu(), b, rtol=2e-2, atol=2e-2) for a, b in zip(card_out, host_out)),
              f"apply_pixel_policy card vs CPU within rtol 2e-2 / atol 2e-2 ({err_fwd:.3e})")
        host_tb = (host_out[0].T, host_out[1])
        err_chunk = max(float((a.cpu() - b).abs().max()) for a, b in zip(card_tb, host_tb))
        check(all(torch.allclose(a.cpu(), b, rtol=2e-2, atol=2e-2) for a, b in zip(card_tb, host_tb)),
              f"the collect's chunked policy ({fx.POLICY_CHUNK} rows a call) card vs CPU within "
              f"rtol 2e-2 / atol 2e-2 ({err_chunk:.3e})")
        print(f"{tag} pixel PPO {preset}: rows 0:2048 of each layer's output at B=8,192 / 4,096 "
              f"equal to those of one call at B={B} (layer by layer, on one call's inputs): "
              + ", ".join(f"{k} {v}" for k, v in width_dependence(ts.params, *card_obs,
                                                                  ppo.stride1).items()))
        n = GRAD_ROWS
        rows = type(env)(*(x[..., :n] for x in env))
        draws = (torch.randint(0, 6, (n,), generator=gen, device=dev, dtype=torch.int32),
                 -torch.rand((n,), generator=gen, device=dev) - 1.5,
                 *(torch.randn((n,), generator=gen, device=dev) for _ in range(3)))
        g_card, a_card = fx._pixel_grads(ppo, ts.params, cfg, (rows,) + draws)
        g_host, a_host = fx._pixel_grads(ppo, host_params, cfg, (type(rows)(*(x.cpu() for x in rows)),)
                                         + tuple(x.cpu() for x in draws))
        err_loss = max(abs(float(a_card[k]) - float(a_host[k])) for k in a_host)
        check(all(math.isclose(float(a_card[k]), float(a_host[k]), rel_tol=2e-3, abs_tol=2e-4)
                  for k in a_host), f"loss terms card vs CPU within rtol 2e-3 / atol 2e-4 "
                                    f"({err_loss:.3e})")
        err_grad = max(rel_l2(g_card[k].cpu(), g_host[k]) for k in g_host)
        check(err_grad <= 2e-2, f"each gradient card vs CPU within 2e-2 relative L2 ({err_grad:.3e})")
        print(f"{tag} pixel PPO {preset} card vs CPU: render_grid_obs byte for byte at B={B}; "
              f"apply_pixel_policy max abs {err_fwd:.3e}, in the collect's chunks "
              f"{err_chunk:.3e}; on {n} rows loss terms max abs "
              f"{err_loss:.3e}, gradients max relative L2 {err_grad:.3e}")
        del card_obs, host_obs, host_env

        # times
        state = {"ts": ts, "env": env, "key": k_train}

        def step():
            state["ts"], state["env"], state["key"], _ = fx.train_step_pixel(
                cfg, ppo, state["ts"], state["env"], state["key"])

        ms_update = time_ms(step)
        env0 = state["env"]
        k_pool, k_perm = key(20), key(21)
        pool = fx.fresh_packed_batch(cfg, k_pool, 2 * B)
        u = fx.gumbel_uniforms(key(22), T, B)
        with torch.no_grad():
            # the collect's policy step: replayed from its CUDA graph (as
            # training runs it), its chunks called one by one, one call of B
            params = state["ts"].params
            ms_collect, ms_collect_chunks, ms_collect_whole = (
                time_ms(lambda: fx._collect_pixel(cfg, ppo, params, env0, pool, u, chunk=c))
                for c in (None, fx.POLICY_CHUNK, B))
            steps = {c: kernel_breakdown(lambda: fx._policy_tb(params, cfg, env0, ppo.stride1, c))
                     for c in (None, fx.POLICY_CHUNK, B)}
            print(f"{tag} pixel PPO {preset} B={B}, one policy step of the collect (render and "
                  f"forward; torch.profiler device time in a CUDA-event span): " + "; ".join(
                      f"{what} {steps[c][0]:.3f} ms of device time in {steps[c][1]:.3f} ms, idle "
                      f"{1 - steps[c][0] / steps[c][1]:.1%}, {steps[c][2]} launches" for what, c in (
                          ("graph", None), (f"chunks of {fx.POLICY_CHUNK}", fx.POLICY_CHUNK),
                          (f"one call of {B}", B))))
            _, traj = fx._collect_pixel(cfg, ppo, state["ts"].params, env0, pool, u)
            _, lv = fx._policy_tb(params, cfg, env0, ppo.stride1)
            ms_gae = time_ms(lambda: fx._gae(ppo.as_fast, traj, lv))
            adv, ret = fx._gae(ppo.as_fast, traj, lv)
        perms = fx.epoch_perms(k_perm, ppo.update_epochs, NB)
        ms_upd = time_ms(lambda: fx._update_phase(cfg, ppo, state["ts"], traj, adv, ret, perms))
        ms_pool = time_ms(lambda: fx.fresh_packed_batch(cfg, k_pool, 2 * B))
        del traj, adv, ret
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        if preset == "default":
            total, span, _, rows = kernel_breakdown(step)
            print(f"{tag} pixel PPO default, one update by kernel (torch.profiler): device "
                  f"{total:.2f} ms in a {span:.2f} ms span (CUDA events), idle share "
                  f"{1 - total / span:.1%}; top kernels: " + "; ".join(
                      f"{name[:70]} {ms:.2f} ms x{n} ({ms / total:.1%})" for name, ms, n in rows))
        print(f"{tag} pixel PPO {preset} B={B}: {ms_update:.2f} ms per update "
              f"({B * T / (ms_update / 1e3):.4e} env-steps/s of the full loop; median of 5, CUDA "
              f"events); stages: pool {ms_pool:.3f} ms, collect {ms_collect:.2f} ms (policy in "
              f"chunks of {fx.POLICY_CHUNK} from a CUDA graph; {ms_collect_chunks:.2f} ms with the "
              f"chunks called one by one, {ms_collect_whole:.2f} ms in one call of {B}), GAE "
              f"{ms_gae:.3f} ms, update phase {ms_upd:.2f} ms; peak device memory of one update "
              f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
        del state, env, ts, env0, pool, params


def policy_families_phase(cw, dev, tag):
    """Phase 18: the four flax families on the card against the CPU, one
    ``train/ppo.py`` update per family at hidden 512 on 21x21, and greedy
    evaluation; no hand-written kernel."""
    from gym_craftingworld_tpu_torch import interop
    from gym_craftingworld_tpu_torch.models import actor_critic as ac
    from gym_craftingworld_tpu_torch.models import cnn
    from gym_craftingworld_tpu_torch.models import vit
    from gym_craftingworld_tpu_torch.train import evaluate as ev
    from gym_craftingworld_tpu_torch.train import ppo

    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd

    cfg = cw.ray_config()
    wrappers, plains, keyed = kernel_wrappers(), plain_versions(), keyed_wrappers()
    for w in (*wrappers.values(), *keyed.values()):
        w.launches = 0
    for f in (*plains, kd.counter_draws_plain, kd.reset_draws_plain):
        f.calls = 0
    st, _ = cw.rollout_random(cfg, cw.reset_from_seed(cfg, 18, 256, device=dev), prng_key(18), 40)
    host = on_host(st)
    k18 = prng_key(18, device=dev)  # flax's init on the card, carried to the CPU by interop
    images = lambda s: (cnn.student_images(cfg, s.objects, s.agent, s.holding, s.goal_objects,
                                           s.goal_agent, s.init_objects, s.init_agent),)
    models = {
        "ActorCritic": (ac.init_params(k18), interop.actor_critic_from_numpy,
                        lambda s: (ac.obs_features(s),)),
        "PixelActorCritic": (cnn.init_params(k18), interop.pixel_actor_critic_from_numpy,
                             cnn.pixel_obs),
        "PixelDistillStudent": (cnn.init_student(k18, cfg), interop.pixel_distill_student_from_numpy,
                                images),
        "GridActorCritic": (vit.init_params(k18), interop.grid_actor_critic_from_numpy,
                            vit.grid_tokens),
    }
    for name, (m_card, from_numpy, inputs) in models.items():
        m_host = from_numpy(interop.flax_params_to_numpy(m_card), device="cpu")
        with torch.no_grad():
            card, want = m_card(*inputs(st)), m_host(*inputs(host))
        err = max(float((a.cpu() - b).abs().max()) for a, b in zip(card, want))
        check(all(a.device == st.objects.device and torch.allclose(a.cpu(), b, rtol=2e-2, atol=2e-2)
                  for a, b in zip(card, want)),
              f"{name} on the card vs the CPU within rtol 2e-2 / atol 2e-2 ({err:.3e})")
        print(f"{tag} {name} forward at B=256 on 21x21, the card vs the CPU on the same "
              f"parameters: max abs {err:.3e}")
    del models

    for policy, B in FAMILY_B.items():
        p = ppo.PPOConfig(policy=policy)
        ts = ppo.init_train_state(k18, cfg, p)  # flax's init from PRNGKey(18), on the card
        before = {k: v.detach().clone() for k, v in ts.params.named_parameters()}
        env = cw.reset_from_seed(cfg, 18, B, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        ts, env, k_step, m = ppo.train_step(cfg, p, ts, env, prng_key(18).to(dev))
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        metrics = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(x) for x in metrics.values()), f"{policy}: finite metrics {metrics}")
        check(ts.update_idx == 1 and int(ts.opt_state.count) == p.update_epochs * p.num_minibatches,
              f"{policy}: one update of {p.update_epochs}x{p.num_minibatches} minibatches")
        after = dict(ts.params.named_parameters())
        check(all(not torch.equal(before[k], after[k]) for k in before if k.endswith("kernel")),
              f"{policy}: every kernel changed")
        state = {"ts": ts, "env": env, "key": k_step}

        def step():
            state["ts"], state["env"], state["key"], _ = ppo.train_step(
                cfg, p, state["ts"], state["env"], state["key"])

        reps, episodes = FAMILY_REPS[policy], FAMILY_EVAL[policy]
        ms = time_ms(step, reps=reps)
        t0 = time.perf_counter()
        summary = ev.evaluate_policy(cfg, p, state["ts"].params, episodes, seed=0)
        t_eval = time.perf_counter() - t0
        check(summary["episodes"] == episodes
              and 0 < summary["mean_episode_steps"] <= cfg.max_steps,
              f"{policy}: evaluate_policy summary {summary}")
        print(f"{tag} train/ppo.py {policy} hidden {p.hidden} B={B} T={p.rollout_steps} "
              f"{p.update_epochs}x{p.num_minibatches} minibatches of {p.rollout_steps * B // p.num_minibatches} "
              f"rows: {ms:.2f} ms per update (median of {reps}, CUDA events), "
              f"{B * p.rollout_steps / (ms / 1e3):.4e} env-steps/s; first update {t_cold * 1e3:.1f} ms "
              f"(cold, host clock), peak device memory {peak / 2**30:.3f} GiB; metrics "
              f"{json.dumps(metrics)}; evaluate_policy over {episodes} greedy episodes in "
              f"{t_eval:.2f} s (host clock): success {summary['success_rate']:.4f}, mean steps "
              f"{summary['mean_episode_steps']:.2f}")
        del state, ts, env, before, after
    launches = {k: w.launches for k, w in wrappers.items()}
    calls = {f.__name__: f.calls for f in plains}
    check(all(n == 0 for n in launches.values()) and all(c == 0 for c in calls.values()),
          f"the policy families launch none of the nine kernels: {launches}, plain calls {calls}")
    keyed_launches = {k: w.launches for k, w in keyed.items()}
    check(all(n > 0 for n in keyed_launches.values())
          and kd.counter_draws_plain.calls == kd.reset_draws_plain.calls == 0,
          f"the keyed draws ran on their kernels, no plain version: {keyed_launches}")
    print(f"{tag} launch counters over phase 18: {launches}; keyed draws {keyed_launches} "
          f"(the inits, the resets, the key chain, the noise, the permutations)")


# ---------------------------------------------------------------------------
# the imitation path, recurrent PPO and the flat families (phases 19-20)
# ---------------------------------------------------------------------------

# phase 19 at the canonical imitation settings (tools/collect_canonical_demos.py,
# tools/train_canonical.py): DAgger's states are cut from the tool's 300,000 to
# 20,000 because the host relabels them one by one
DEMO_EPISODES, DEMO_BATCH = 384, 192
BC_BATCH, BC_EPOCHS = 4096, 2
GRID_WIDTHS, CPV_WIDTHS = (96, 1536), (96, 1024, 32)  # the published canonical widths
GRID_EVAL_EPISODES = 4096
DAGGER_EPISODES, DAGGER_STATES = 768, 20_000
CHECK_B = 4096  # worlds of phase 19's on-card feature checks
RNN_B, RNN_UPDATES = 4096, 3
FLAT_EPISODES = 16  # bc.py's small-data path (phase 20)
SNAP_COLS = ("occ_key", "occ_code", "init_key", "init_agent_key", "agent_key", "holding",
             "desired", "achieved")


def keyed_mark():
    """The keyed-draw wrappers' launches and their plain versions' calls now,
    to read back with ``keyed_since``."""
    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd

    plains = [kd.counter_draws_plain, kd.reset_draws_plain]
    return ({k: w.launches for k, w in keyed_wrappers().items()},
            {f.__name__: f.calls for f in plains})


def keyed_counts(resets: int, counters: int) -> dict:
    """The keyed-draw kernels' launches as ``keyed_since`` reads them."""
    return {"keyed_reset": resets, "keyed_counter": counters}


def keyed_since(mark, what: str, want: dict) -> dict:
    """Since ``mark`` (``keyed_mark``) the keyed-draw kernels launched exactly
    ``want`` times and no plain version ran; prints and returns the launches."""
    now = keyed_mark()
    launches = {k: n - mark[0][k] for k, n in now[0].items()}
    calls = {k: n - mark[1][k] for k, n in now[1].items()}
    check(launches == want and not any(calls.values()),
          f"{what}: keyed launches {launches}, want {want}; plain calls {calls}")
    print(f"{what}: keyed draws {launches}, as counted; no plain version")
    return launches


def drawn_params(make) -> int:
    """The parameters a flax family's init draws (``Rngs``'s log of an init
    on the CPU): its init launches the counter kernel twice each (27d)."""
    from gym_craftingworld_tpu_torch.models.flax_rng import Rngs

    log = []
    make(Rngs(prng_key(0), log=log))
    return len(log)


def zero_counters():
    """Every kernel wrapper's launch counter and every plain version's call
    counter set to 0; returns (wrappers, plains) to read them back."""
    wrappers, plains = kernel_wrappers(), plain_versions()
    for w in wrappers.values():
        w.launches = 0
    for f in plains:
        f.calls = 0
    return wrappers, plains


def keyed_ran(keyed, plains, what: str) -> None:
    """Both keyed-draw kernels launched and neither plain version ran
    (``zero_keyed``'s wrappers and plain versions)."""
    launches = {k: w.launches for k, w in keyed.items()}
    calls = {f.__name__: f.calls for f in plains}
    check(all(n > 0 for n in launches.values()) and not any(calls.values()),
          f"{what}: the keyed draws ran on their kernels, no plain version: {launches}, {calls}")
    print(f"{what}: keyed draws {launches}")


def no_kernel_ran(wrappers, plains, what: str) -> None:
    launches = {k: w.launches for k, w in wrappers.items()}
    calls = {f.__name__: f.calls for f in plains}
    check(all(n == 0 for n in launches.values()) and all(c == 0 for c in calls.values()),
          f"{what} launch no hand-written kernel and no plain version: {launches}, {calls}")


def card_vs_cpu(name: str, card, host, rtol=2e-2, atol=2e-2) -> float:
    """Max |card - CPU| over pairs of float tensors, checked within rtol/atol."""
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(card, host))
    check(all(torch.allclose(a.cpu(), b, rtol=rtol, atol=atol) for a, b in zip(card, host)),
          f"{name} on the card vs the CPU within rtol {rtol:g} / atol {atol:g} ({err:.3e})")
    return err


def grads_vs_cpu(name: str, card: dict, host: dict) -> float:
    """Each gradient within 2e-2 relative L2 of the CPU's (bias vectors, which
    sum bf16 cotangents with cancellation, within 5e-2); gradients under 1e-4
    of the largest are roundoff and skipped, as in the CPU tests. Prints every
    tensor's error before it checks."""
    top = max(float(g.norm()) for g in host.values())
    errs = {k: rel_l2(card[k].cpu(), g) for k, g in host.items() if float(g.norm()) >= 1e-4 * top}
    print(f"{name} gradients card vs CPU, relative L2: "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    for k, err in errs.items():
        check(err <= (5e-2 if k.endswith("bias") else 2e-2), f"{name} gradient {k} ({err:.3e})")
    return max(errs.values())


def imitation_phase(cw, dev, tag):
    """Phase 19: the canonical imitation path on 21x21 stacked goals:
    snapshot demos, BC of GridPolicy(96, 1536) and CPVGridPolicy(96, 1024,
    32), greedy evaluation, one DAgger round; the features on the card
    against the host extraction and the CPU."""
    import numpy as np

    from gym_craftingworld_tpu_torch import interop
    from gym_craftingworld_tpu_torch.models import cpv
    from gym_craftingworld_tpu_torch.models import grid_policy as gp
    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
    from gym_craftingworld_tpu_torch.train import dagger, demos

    t_phase = time.perf_counter()
    cfg = cw.EnvConfig(height=21, width=21, max_steps=300, stacking=True)
    wrappers, plains = zero_counters()
    keyed, keyed_plains = zero_keyed()
    k19 = prng_key(19, device=dev)

    # ---- snapshot demos ----------------------------------------------------------
    t0 = time.perf_counter()
    snaps = demos.collect_expert_demos(cfg, DEMO_EPISODES, seed=0, noise_eps=0.05,
                                       batch=DEMO_BATCH, device=dev)
    t_demo = time.perf_counter() - t0
    check(snaps.num_episodes >= 0.9 * DEMO_EPISODES and set(np.unique(snaps.action)) <= set(range(6)),
          f"the expert solved {snaps.num_episodes} of {DEMO_EPISODES} episodes")
    print(f"{tag} collect_expert_demos 21x21 stacked, {DEMO_EPISODES} episodes in batches of "
          f"{DEMO_BATCH}, noise 0.05: {snaps.num_rows} rows, {snaps.num_episodes} episodes kept, "
          f"{t_demo:.2f} s ({snaps.num_episodes / t_demo * 60:.1f} episodes a minute, "
          f"{snaps.num_rows / t_demo:.0f} rows/s; host clock)")
    rows = np.random.RandomState(0).choice(snaps.num_rows, 256, replace=False)
    relabeled = dagger.expert_relabel(cfg, {k: getattr(snaps, k)[rows] for k in SNAP_COLS})
    check(np.array_equal(relabeled.action, snaps.action[rows]),
          "expert_relabel of 256 collected rows reproduces their labels")

    # ---- features on the card -----------------------------------------------------
    st, _ = cw.rollout_random(cfg, cw.reset_from_seed(cfg, 19, CHECK_B, device=dev), prng_key(19),
                              60)
    cols = gp.snap_columns_from_state(cfg, st)
    host = on_host(st)
    agent = host.agent.numpy()
    occ_key, occ_code = demos.occupancy_from_grids(host.objects.reshape(CHECK_B, -1).numpy(),
                                                   cfg.n_cells)
    init_key, init_agent_key = demos.init_keys_from_grids(
        host.init_objects.reshape(CHECK_B, -1).numpy())
    want = dict(occ_key=occ_key, occ_code=occ_code, init_key=init_key,
                init_agent_key=init_agent_key,
                agent_key=(agent[:, 0] * cfg.width + agent[:, 1]).astype(np.int16),
                holding=host.holding.numpy().astype(np.int8),
                desired=demos.bits_to_mask(host.desired.numpy()),
                achieved=demos.bits_to_mask(host.achieved.numpy()))
    for k in SNAP_COLS:
        got = cols[k]
        check(got.device == st.objects.device and got.cpu().numpy().dtype == want[k].dtype
              and np.array_equal(got.cpu().numpy(), want[k]),
              f"snap_columns_from_state {k} on the card == the host extraction")
    p_state, e_state = gp.planes_from_state(cfg, st)
    p_snap, e_snap = gp.planes_from_snaps(cfg, *(cols[k] for k in SNAP_COLS))
    p_host, e_host = gp.planes_from_state(cfg, host)
    bits = lambda x: x.view(torch.int16).cpu()
    for a, b, what in ((p_snap, p_state, "planes_from_snaps == planes_from_state on the card"),
                       (e_snap, e_state, "extras from snaps == from state on the card"),
                       (p_state, p_host, "planes on the card == on the CPU"),
                       (e_state, e_host, "extras on the card == on the CPU")):
        check(torch.equal(bits(a), bits(b)), f"{what}, byte for byte")
    print(f"{tag} features on the card, B={CHECK_B} 21x21 after 60 random steps: "
          f"snap_columns_from_state == the host extraction (occupancy_from_grids, "
          f"init_keys_from_grids, bits_to_mask), column for column; planes_from_state == "
          f"planes_from_snaps == the CPU's, byte for byte; objects off the grid "
          f"{int((cols['occ_key'] == cfg.n_cells + 1).sum())}")
    del st, host, cols, p_state, e_state, p_snap, e_snap, p_host, e_host

    # ---- BC of the two grid families ----------------------------------------------
    data = dagger.device_columns(snaps, dev)
    n_mb = snaps.num_rows // BC_BATCH
    states = {}
    for name, widths, make, from_numpy in (
            ("GridPolicy", GRID_WIDTHS, lambda k: gp.init_grid_policy(k, cfg, *GRID_WIDTHS),
             interop.grid_policy_from_numpy),
            ("CPVGridPolicy", CPV_WIDTHS, lambda k: cpv.init_cpv_grid(k, cfg, *CPV_WIDTHS),
             interop.cpv_grid_policy_from_numpy)):
        state = dagger.init_bc_state(make(k19))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        ts, hist = dagger.bc_train_snaps(cfg, snaps, k19, state=state, epochs=BC_EPOCHS,
                                         batch_size=BC_BATCH, lr=1e-3)
        torch.cuda.synchronize()
        t_bc = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        check(all(math.isfinite(h["loss"]) for h in hist) and hist[-1]["loss"] < hist[0]["loss"],
              f"{name}: the BC loss falls {hist}")
        perm1 = kd.permutation(k19, snaps.num_rows)[:BC_BATCH]
        ms_mb = time_ms(lambda: dagger._bc_epoch(cfg, 1e-3, ts, data, perm1, BC_BATCH), reps=3)
        # the card against the CPU on the same parameters
        host_model = from_numpy(interop.flax_params_to_numpy(ts.params), device="cpu")
        mb = {k: v[perm1[:512]] for k, v in data.items()}
        mb_host = {k: v.cpu() for k, v in mb.items()}
        with torch.no_grad():
            err_fwd = card_vs_cpu(f"{name} forward", ts.params(*dagger._batch_planes(cfg, mb)),
                                  host_model(*dagger._batch_planes(cfg, mb_host)))
        loss_c, acc_c, g_c = dagger._snap_grads(cfg, ts.params, mb)
        loss_h, acc_h, g_h = dagger._snap_grads(cfg, host_model, mb_host)
        err_loss = abs(float(loss_c) - float(loss_h))
        check(math.isclose(float(loss_c), float(loss_h), rel_tol=1e-3, abs_tol=1e-3),
              f"{name} BC loss card vs CPU within rtol 1e-3 / atol 1e-3 ({err_loss:.3e})")
        err_grad = grads_vs_cpu(name, g_c, g_h)
        print(f"{tag} bc_train_snaps {name}{widths}, 21x21: {snaps.num_rows} rows, {BC_EPOCHS} epochs "
              f"of {n_mb} minibatches of {BC_BATCH} in {t_bc:.2f} s (host clock, first epoch "
              f"cold); one minibatch {ms_mb:.2f} ms (median of 3, CUDA events); peak device memory "
              f"{peak / 2**30:.3f} GiB; history {json.dumps(hist)}; card vs CPU on 512 rows: "
              f"forward max abs {err_fwd:.3e}, loss {err_loss:.3e}, gradients max relative L2 "
              f"{err_grad:.3e}")
        states[name] = ts
        del host_model, g_c, g_h

    # ---- greedy evaluation ------------------------------------------------------
    model = states["GridPolicy"].params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = dagger.evaluate_grid_policy(cfg, model, GRID_EVAL_EPISODES, seed=0)
    t_eval = time.perf_counter() - t0
    check(summary["episodes"] == GRID_EVAL_EPISODES
          and 0 < summary["mean_episode_steps"] <= cfg.max_steps, f"evaluate summary {summary}")
    steps = summary["mean_episode_steps"] * GRID_EVAL_EPISODES
    print(f"{tag} evaluate_grid_policy GridPolicy{GRID_WIDTHS} over {GRID_EVAL_EPISODES} greedy episodes, "
          f"21x21 stacked: {t_eval:.2f} s (host clock), {steps / t_eval:.4e} env-steps/s of the "
          f"episodes' own steps; success {summary['success_rate']:.4f}, mean steps "
          f"{summary['mean_episode_steps']:.2f}")

    # ---- one DAgger round, its stages timed -------------------------------------
    stages = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[name] = time.perf_counter() - t
            return out
        return run

    names = ("collect_policy_states", "expert_relabel", "bc_train_snaps")
    saved = {k: getattr(dagger, k) for k in names}
    for k in names:
        setattr(dagger, k, timed(k, saved[k]))
    try:
        t0 = time.perf_counter()
        ts, dataset, info = dagger.dagger_round(cfg, states["GridPolicy"], snaps, 0, k19,
                                                num_episodes=DAGGER_EPISODES,
                                                max_states=DAGGER_STATES, epochs=1,
                                                batch_size=BC_BATCH, lr=3e-4)
        t_round = time.perf_counter() - t0
    finally:
        for k, f in saved.items():
            setattr(dagger, k, f)
    added = dataset.num_rows - snaps.num_rows
    check(0 < added <= DAGGER_STATES and math.isfinite(info["history"][0]["loss"]),
          f"the DAgger round added {added} rows: {info}")
    print(f"{tag} dagger_round {DAGGER_EPISODES} episodes, max_states {DAGGER_STATES} (cut from "
          f"the tool's 300,000: the host relabels one state at a time), 1 epoch: {t_round:.2f} s; "
          f"rollout {stages['collect_policy_states'] * 1e3:.1f} ms, relabel "
          f"{stages['expert_relabel'] * 1e3:.1f} ms ({stages['expert_relabel'] / added * 1e3:.3f} ms "
          f"a state), training {stages['bc_train_snaps'] * 1e3:.1f} ms (host clock); +{added} rows "
          f"-> {dataset.num_rows}; rollout success {info['rollout_success']:.4f}; history "
          f"{json.dumps(info['history'])}")
    no_kernel_ran(wrappers, plains, "phase 19: the imitation path")
    keyed_ran(keyed, keyed_plains,
              "phase 19: the inits, demos' resets, permutations, evaluation and DAgger")
    print(f"{tag} phase 19 took {time.perf_counter() - t_phase:.1f} s")


def recurrent_phase(cw, dev, tag):
    """Phase 20: recurrent PPO at 4,096 envs, the GRU and CPVPolicy on the card
    against the CPU, and bc.py's small-data path through the façade."""
    from gym_craftingworld_tpu_torch import interop
    from gym_craftingworld_tpu_torch.models import actor_critic as ac
    from gym_craftingworld_tpu_torch.models import cpv
    from gym_craftingworld_tpu_torch.train import bc, ppo, ppo_rnn

    t_phase = time.perf_counter()
    cfg = cw.ray_config()
    wrappers, plains = zero_counters()
    keyed, keyed_plains = zero_keyed()
    gen = torch.Generator(device=dev).manual_seed(20)  # the dones of the GRU's check

    # ---- recurrent PPO ------------------------------------------------------------
    p = ppo.PPOConfig()
    ts = ppo_rnn.init_rnn_train_state(prng_key(20, device=dev), cfg, p, RNN_B)
    before = {k: v.detach().clone() for k, v in ts.params.named_parameters()}
    env = cw.reset_from_seed(cfg, 20, RNN_B, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, metrics = [], []
    k_step = prng_key(20).to(dev)
    for _ in range(RNN_UPDATES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ts, env, k_step, m = ppo_rnn.train_step_rnn(cfg, p, ts, env, k_step)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for m in metrics for x in m.values()), f"finite metrics {metrics}")
    check(ts.update_idx == RNN_UPDATES and int(ts.opt_state.count) == RNN_UPDATES
          * p.update_epochs * p.num_minibatches, "update and optimizer counts")
    after = dict(ts.params.named_parameters())
    check(all(not torch.equal(before[k], after[k]) for k in before if k.endswith("kernel")),
          "every kernel of the GRU actor-critic changed")
    print(f"{tag} train_step_rnn hidden {p.hidden} B={RNN_B} 21x21 T={p.rollout_steps} "
          f"{p.update_epochs}x{p.num_minibatches} minibatches of {RNN_B // p.num_minibatches} "
          f"sequences: {', '.join(f'{t:.1f}' for t in times)} ms per update (CUDA events; the "
          f"first cold), {RNN_B * p.rollout_steps / (statistics.median(times) / 1e3):.4e} env-steps/s "
          f"at the median; peak device memory {peak / 2**30:.3f} GiB; metrics {json.dumps(metrics)}")

    # ---- the GRU and CPVPolicy on the card against the CPU ------------------------
    st, _ = cw.rollout_random(cfg, cw.reset_from_seed(cfg, 21, 256, device=dev), prng_key(21), 30)
    host = on_host(st)
    rnn_host = interop.recurrent_actor_critic_from_numpy(interop.flax_params_to_numpy(ts.params),
                                                         device="cpu")
    h, hh = ts.params.initial_state(256), rnn_host.initial_state(256)
    err = 0.0
    with torch.no_grad():
        for t in range(8):
            done = torch.rand(256, generator=gen, device=dev) < 0.25
            obs = ac.obs_features(st)
            h, lc, vc = ts.params(h, obs, done)
            hh, lh, vh = rnn_host(hh, obs.cpu(), done.cpu())
            err = max(err, card_vs_cpu(f"RecurrentActorCritic step {t}", (h, lc, vc), (hh, lh, vh)))
            st, _ = cw.rollout_random(cfg, st, prng_key(22 + t), 1)
    print(f"{tag} RecurrentActorCritic hidden {p.hidden}, 8 steps with dones at B=256 on 21x21, "
          f"the card vs the CPU on the same parameters (hidden state carried on each): max abs "
          f"{err:.3e}")
    for with_init in (False, True):  # flax's init on the card, carried to the CPU by interop
        m_card = cpv.init_cpv(prng_key(20, device=dev), 21, 21, with_init=with_init)
        m_host = interop.cpv_policy_from_numpy(interop.flax_params_to_numpy(m_card), 21, 21,
                                               with_init, device="cpu")
        feats = ac.obs_features_init if with_init else ac.obs_features
        with torch.no_grad():
            err = card_vs_cpu(f"CPVPolicy with_init={with_init}", m_card(feats(host).to(dev)),
                              m_host(feats(host)))
        print(f"{tag} CPVPolicy with_init={with_init} (embed 32, hidden 256) at B=256 on 21x21, "
              f"the card vs the CPU: max abs {err:.3e}")
    del st, host

    # ---- bc.py's small-data path through the façade --------------------------------
    t0 = time.perf_counter()
    flat = bc.collect_demos(FLAT_EPISODES, seed=0, device=dev)
    t_collect = time.perf_counter() - t0
    check(flat.num_episodes > 0 and flat.features.shape[1] == ac.feature_dim(21, 21),
          f"bc.collect_demos kept {flat.num_episodes} episodes")
    t0 = time.perf_counter()
    model, bm = bc.bc_train(flat, prng_key(20, device=dev), 21, 21, hidden=256, epochs=3)
    t_train = time.perf_counter() - t0
    check(all(math.isfinite(x) for x in bm["loss"]) and bm["loss"][-1] < bm["loss"][0],
          f"bc_train's loss falls {bm}")
    t0 = time.perf_counter()
    ev = bc.evaluate_bc(model, FLAT_EPISODES, seed=0, device=dev)
    t_eval = time.perf_counter() - t0
    check(ev["episodes"] == FLAT_EPISODES and 0.0 <= ev["success_rate"] <= 1.0, f"evaluate_bc {ev}")
    print(f"{tag} bc.py on 21x21 through the façade on the card: collect_demos {FLAT_EPISODES} "
          f"episodes, {flat.features.shape[0]} rows, {flat.num_episodes} kept, {t_collect:.2f} s; "
          f"bc_train hidden 256, 3 epochs {t_train:.2f} s, loss {bm['loss']}, accuracy "
          f"{bm['accuracy']:.4f}; evaluate_bc {FLAT_EPISODES} episodes {t_eval:.2f} s, {ev} "
          f"(host clock)")
    no_kernel_ran(wrappers, plains, "phase 20: recurrent PPO and the flat families")
    keyed_ran(keyed, keyed_plains,
              "phase 20: the inits, the key chain, the resets and bc_train's permutations")
    print(f"{tag} phase 20 took {time.perf_counter() - t_phase:.1f} s")



# ---------------------------------------------------------------------------
# multi-device (phase 21)
# ---------------------------------------------------------------------------

MD_SEED, MD_STREAM_SEED = 21, 22  # the bench's and the action slab's Philox seeds
MD_WORLD = 2  # ranks that share the one card under gloo
MD_PPO_B = 4096  # envs of phase 21's train/ppo.py update under a mesh
RUN_ENVS, RUN_UPDATES = 4096, 4  # run.py's check: 4 updates, a checkpoint at 2
# the sharded fast- and pixel-PPO updates against the unsharded ones (only the
# order of the sums over the ranks, and the update phase's per-rank widths,
# differ): each gradient's relative L2, the first minibatch's loss terms and the
# update's metrics (rtol, atol)
MD_GRAD_TOL = {"fast": 1e-4, "pixel": 1e-2}
MD_LOSS_TOL = (1e-4, 1e-6)
MD_METRIC_TOL = (1e-3, 1e-5)


def to_host(x):
    """A CPU copy of a tensor, or of the tensors of a state, tuple or dict."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: to_host(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, tuple):
        parts = [to_host(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def md_fast(cfg, fppo, ts0, env, key, mesh, fused_pool, timed: bool) -> dict:
    """Phase 21's fast-PPO update over ``mesh`` with ``fused_pool``, counted,
    its collect and first minibatch's gradient (``md_work``)."""
    import copy

    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
    from gym_craftingworld_tpu_torch.parallel import mesh as pm
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp

    dev = env.agent_r.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    elements = lambda: kd.counter_draws_kernel.elements + kd.counter_draws_plain.elements
    out = {}
    step = lambda ts, env_, k: fp.train_step_fast(cfg, fppo, ts, env_, k, fused_pool=fused_pool,
                                                  mesh=mesh)
    sync()
    wrappers, plains = zero_counters()
    keyed = keyed_wrappers()
    for w in keyed.values():
        w.launches = 0
    before = elements()
    ts1, env1, g1, m = step(copy.deepcopy(ts0), env, key(8))
    sync()
    out["fast_drawn"] = elements() - before
    out["fast_launches"] = {k: w.launches for k, w in (*wrappers.items(), *keyed.items())}
    out["fast_calls"] = {f.__name__: f.calls
                         for f in (*plains, kd.counter_draws_plain, kd.reset_draws_plain)}
    out["fast_metrics"] = {k: float(v) for k, v in m.items()}
    out["fast_env"] = to_host(env1)
    _, r, _ = fp.rollout_phase(cfg, fppo, copy.deepcopy(ts0), env, key(8),
                               fused_pool=fused_pool, mesh=mesh)
    out["fast_traj"] = to_host(r.traj)
    mb = next(fp.minibatches(fppo, r.traj, r.adv, r.ret, r.perms, mesh))
    out["fast_first"] = to_host(fp.minibatch_grads(fppo, ts0.params, mb, None, mesh))
    del r, mb
    if timed:
        state = {"ts": ts1, "env": env1, "key": g1}

        def update():
            state["ts"], state["env"], state["key"], _ = step(state["ts"], state["env"],
                                                              state["key"])

        out["fast_ms"] = pm.time_ms(update, 3, dev)
        # one more update with each all_reduce timed between syncs
        spent, real = [], torch.distributed.all_reduce

        def timed_all_reduce(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            real(*args, **kwargs)
            sync()
            spent.append(time.perf_counter() - t0)

        torch.distributed.all_reduce = timed_all_reduce
        try:
            sync()
            t0 = time.perf_counter()
            update()
            sync()
            total = time.perf_counter() - t0
        finally:
            torch.distributed.all_reduce = real
        out["all_reduce"] = dict(calls=len(spent), ms=1e3 * sum(spent), update_ms=1e3 * total)
        del state
    del ts1, env1
    return out


def md_work(cw, dev, mesh, timed: bool) -> dict:
    """Phase 21's work over ``mesh`` (None: the unsharded run): the bench
    kernel (T = 300), the actions kernel on row 3's stream (T = 300), one
    default fast-PPO update, counted, with its collect and first minibatch's
    gradient, and one default pixel-PPO update, at 16,384 envs on 21x21;
    then ``md_ppo_work``. Returns CPU copies of the results, and with
    ``timed`` the ms of an update and the share of it in ``all_reduce``
    calls. The ranks' fast PPO takes its default pool (``fused_pool`` None:
    the keyed ``fresh_packed_batch`` over several ranks, as JAX's sharded
    step, the pool kernel on one); the unsharded run takes the keyed pool,
    and again the pool kernel under ``kernel_pool``, to hold each world to;
    ``*_drawn`` counts the counter kernel's elements of an update (a rank's
    columns of the uniforms)."""
    import copy

    from gym_craftingworld_tpu_torch.core import slots as sm
    from gym_craftingworld_tpu_torch.ops import fused_reset as fr
    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
    from gym_craftingworld_tpu_torch.ops import packed_fused as pf
    from gym_craftingworld_tpu_torch.parallel import sharded_engine as se
    from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp

    cfg, B = cw.ray_config(), B_MAIN
    T = cfg.max_steps
    key = lambda seed: prng_key(seed).to(dev)
    elements = lambda: kd.counter_draws_kernel.elements + kd.counter_draws_plain.elements
    out = {}

    whole = sm.from_env_state(cw.reset_from_seed(cfg, 0, B, device=dev))
    if mesh is None:
        out["bench"] = pf.fused_rollout_packed_bench(cfg, whole, MD_SEED, T)
        stream = pf.fused_action_stream(B, MD_STREAM_SEED, T, device=dev)
        out["actions"] = pf.fused_rollout_packed(cfg, whole, stream, T)
    else:
        mine = se.shard_slots(whole, mesh)
        out["bench"] = se.fused_rollout_packed_bench_sharded(cfg, mine, MD_SEED, T, mesh=mesh)
        stream = pf.fused_action_stream(B, MD_STREAM_SEED, T, device=dev)
        out["actions"] = se.fused_rollout_packed_sharded(cfg, mine, stream, T, mesh=mesh)
    out = to_host(out)
    del whole, stream

    local = (lambda env: env) if mesh is None else (lambda env: se.shard_packed(env, mesh))
    fppo = fp.FastPPOConfig()
    env = local(fr.fresh_packed_fused(cfg, 11, B, device=dev))
    ts0 = fp.init_fast_train_state(key(7), cfg, fppo)
    out.update(md_fast(cfg, fppo, ts0, env, key, mesh, False if mesh is None else None, timed))
    if mesh is None:
        out["kernel_pool"] = md_fast(cfg, fppo, ts0, env, key, None, None, False)
    del env, ts0

    px = fx.PixelPPOConfig()
    envx = local(fr.fresh_packed_fused(cfg, 12, B, device=dev))
    xts0 = fx.init_pixel_train_state(key(9), cfg, px)
    _, (traj, adv, ret, perms), _ = fx.rollout_phase(cfg, px, copy.deepcopy(xts0), envx,
                                                     key(10), mesh)
    out["pixel_traj"] = to_host(traj)
    out["pixel_first"] = to_host(fx.minibatch_grads(
        px, xts0.params, cfg, *next(fx.minibatches(px, traj, adv, ret, perms, mesh)), mesh))
    del traj, adv, ret, perms
    before = elements()
    _, envx2, _, xm = fx.train_step_pixel(cfg, px, xts0, envx, key(10), mesh)
    out["pixel_drawn"] = elements() - before
    out["pixel_env"] = to_host(envx2)
    out["pixel_metrics"] = {k: float(v) for k, v in xm.items()}
    del envx, envx2, xts0
    out.update(md_ppo_work(cw, dev, mesh, timed))
    return out


def md_ppo_work(cw, dev, mesh, timed: bool) -> dict:
    """``train/ppo.py`` over ``mesh`` (None: unsharded) through
    ``ppo_train_step_sharded``, the counterpart of ``dryrun_multichip``'s path
    1: the default mlp at ``MD_PPO_B`` envs on 21x21; the start state, the
    envs and keys this rank drew at reset and in one update, the update's
    metrics and, with ``timed``, its ms. The update's counters drawn are its
    keys, the whole permutations and the rank's envs' noise."""
    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
    from gym_craftingworld_tpu_torch.parallel import mesh as pm
    from gym_craftingworld_tpu_torch.train import ppo as tppo

    cfg, out = cw.ray_config(), {}
    pp = tppo.PPOConfig()
    ts0 = tppo.init_train_state(prng_key(13, device=dev), cfg, pp)  # flax's init, every rank alike
    drawn = lambda: ((kd.reset_draws_kernel.envs + kd.reset_draws_plain.envs),
                     (kd.counter_draws_kernel.elements + kd.counter_draws_plain.elements))
    before = drawn()
    if mesh is None:
        env_p = cw.reset_from_seed(cfg, 0, MD_PPO_B, device=dev)
        pstep = lambda ts, env_, g: tppo.train_step(cfg, pp, ts, env_, g)
    else:
        env_p = pm.reset_sharded(cfg, 0, MD_PPO_B, mesh)
        pstep = pm.ppo_train_step_sharded(cfg, pp, mesh)
    out["ppo_start"] = to_host(env_p)
    after_reset = drawn()
    pts, env_p, gp, ppo_m = pstep(ts0, env_p, prng_key(14).to(dev))
    out["ppo_drawn"] = dict(reset=[a - b for a, b in zip(after_reset, before)],
                            update=[a - b for a, b in zip(drawn(), after_reset)])
    out["ppo_metrics"] = {k: float(v) for k, v in ppo_m.items()}
    if timed:
        pstate = {"ts": pts, "env": env_p, "key": gp}

        def ppo_update():
            pstate["ts"], pstate["env"], pstate["key"], _ = pstep(pstate["ts"], pstate["env"],
                                                                  pstate["key"])

        out["ppo_ms"] = pm.time_ms(ppo_update, 3, dev)
        del pstate
    return out


def rank_worker(out_dir: Path, device: str) -> int:
    """One rank of phase 21's world of ``MD_WORLD`` under torchrun: its share
    of ``md_work``, saved for the parent as ``rank<r>.pt``."""
    import gym_craftingworld_tpu_torch as cw
    from gym_craftingworld_tpu_torch.parallel.mesh import initialize_distributed, make_env_mesh

    import traceback

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(device=device)
    mesh = make_env_mesh(device=device)
    t0 = time.perf_counter()
    try:
        res = md_work(cw, mesh.device, mesh, timed=True)
    except Exception:  # the parent prints every rank's own failure, not only the last
        (out_dir / f"rank{mesh.rank}.err").write_text(traceback.format_exc())
        raise
    res["seconds"] = time.perf_counter() - t0
    res["backend"] = torch.distributed.get_backend()
    torch.save(res, out_dir / f"rank{mesh.rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def joined(parts, axis):
    """The ranks' results put side by side on the batch axis ``axis``."""
    x = parts[0]
    if isinstance(x, torch.Tensor):
        return torch.cat(parts, dim=axis)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: joined([getattr(p, f.name) for p in parts], axis)
                          for f in dataclasses.fields(x)})
    if hasattr(x, "_fields"):
        return type(x)(*(joined(list(f), axis) for f in zip(*parts)))
    return tuple(joined(list(f), axis) for f in zip(*parts))


def differing(got, want) -> list:
    """Where two results (tensors, states, tuples, dicts) differ in any bit,
    as dotted field names ("" for a tensor)."""
    if isinstance(want, torch.Tensor):
        return [] if got.dtype == want.dtype and torch.equal(got, want) else [""]
    if isinstance(want, dict):
        pairs = [(k, got.get(k), v) for k, v in want.items()]
        if set(got) != set(want):
            return ["(keys)"]
    elif dataclasses.is_dataclass(want) or hasattr(want, "_fields"):
        names = ([f.name for f in dataclasses.fields(want)] if dataclasses.is_dataclass(want)
                 else want._fields)
        pairs = [(k, getattr(got, k), getattr(want, k)) for k in names]
    else:
        pairs = list(zip(range(len(want)), got, want, strict=True))
    return [f"{k}{'.' + d if d else ''}" for k, g, w in pairs for d in differing(g, w)]


def md_equal(got, want, what: str) -> None:
    """Bit-for-bit equality of two results."""
    diff = differing(got, want)
    check(not diff, f"{what}: bit for bit" + (f" (differ in {diff})" if diff else ""))


def md_compare(name: str, got: dict, ref: dict, tag: str) -> None:
    """Hold one world's results (whole-batch columns) to the unsharded run's:
    rows 1-2 and both trainers' trajectories and final envs bit for bit, their
    first-minibatch gradients, loss terms and update metrics within
    ``MD_*_TOL``."""
    md_equal(got["bench"][0], ref["bench"][0], f"{name} bench final state")
    check(int(got["bench"][1]) == int(ref["bench"][1]),
          f"{name} bench checksum {int(got['bench'][1])} == {int(ref['bench'][1])}")
    md_equal(got["actions"], ref["actions"], f"{name} actions kernel (state, rewards, dones)")
    errs = {}
    for trainer in ("fast", "pixel"):
        md_equal(got[f"{trainer}_traj"], ref[f"{trainer}_traj"], f"{name} {trainer}-PPO trajectory")
        md_equal(got[f"{trainer}_env"], ref[f"{trainer}_env"], f"{name} {trainer}-PPO final env")
        (g, aux), (wg, waux) = got[f"{trainer}_first"], ref[f"{trainer}_first"]
        err_g = max(rel_l2(g[k], v) for k, v in wg.items())
        err_l = max(abs(float(aux[k]) - float(v)) for k, v in waux.items())
        check(err_g <= MD_GRAD_TOL[trainer], f"{name} {trainer} first-minibatch gradients within "
              f"{MD_GRAD_TOL[trainer]:g} relative L2 ({err_g:.3e})")
        check(all(math.isclose(float(aux[k]), float(v), rel_tol=MD_LOSS_TOL[0],
                               abs_tol=MD_LOSS_TOL[1]) for k, v in waux.items()),
              f"{name} {trainer} first-minibatch loss terms ({err_l:.3e})")
        m, wm = got[f"{trainer}_metrics"], ref[f"{trainer}_metrics"]
        err_m = max(abs(m[k] - v) for k, v in wm.items())
        check(all(math.isfinite(v) for v in m.values()), f"{name} {trainer} finite metrics")
        check(all(math.isclose(m[k], v, rel_tol=MD_METRIC_TOL[0], abs_tol=MD_METRIC_TOL[1])
                  for k, v in wm.items()), f"{name} {trainer} update metrics ({err_m:.3e})")
        errs[trainer] = (err_g, err_l, err_m)
    print(f"{tag} phase 21 {name}: bench (checksum {int(got['bench'][1])}, final state), "
          f"actions kernel (state, rewards, dones), and the fast- and pixel-PPO trajectories "
          f"(log_prob and value included) and final envs bit for bit; against the unsharded "
          f"update, max gradient relative L2, first-minibatch loss-term and update-metric abs "
          f"errors: " + "; ".join(f"{k} {a:.3e} {b:.3e} {c:.3e}" for k, (a, b, c) in errs.items()))


def md_ppo(name: str, ranks: list, ref: dict, tag: str) -> None:
    """``train/ppo.py`` under a mesh: each rank's start state is its columns
    of ``reset_from_seed``; its reset drew its B/W envs' keys and worlds and
    its update T x B/W worlds (its envs' auto-resets), no more; finite
    metrics; ms an update (slowest rank)."""
    from gym_craftingworld_tpu_torch.train import ppo as tppo

    n, world = MD_PPO_B // len(ranks), len(ranks)
    T = tppo.PPOConfig().rollout_steps
    for i, r in enumerate(ranks):
        cols = slice(i * n, (i + 1) * n)
        want = type(ref["ppo_start"])(**{f.name: getattr(ref["ppo_start"], f.name)[cols]
                                         for f in dataclasses.fields(ref["ppo_start"])})
        md_equal(r["ppo_start"], want, f"{name} rank {i}: ppo start state == its columns of "
                                       f"reset_from_seed(cfg, 0, {MD_PPO_B})")
        # the update's keys and permutations whole, the noise of the rank's envs only
        want = dict(reset=[n, n], update=[T * n, ref["ppo_drawn"]["update"][1]
                                          - T * 6 * (MD_PPO_B - n)])
        check(r["ppo_drawn"] == want, f"{name} rank {i} drew only its envs: {r['ppo_drawn']} "
                                      f"(want {want})")
        check(all(math.isfinite(v) for v in r["ppo_metrics"].values()),
              f"{name} rank {i}: finite train/ppo.py metrics")
    print(f"{tag} phase 21 {name}: train/ppo.py (mlp, hidden 512, T=64) at {MD_PPO_B} envs, "
          f"{n} a rank: start states are reset_from_seed's columns, each rank drew {n} keys and "
          f"envs at reset, {T * n} envs and its envs' {T * 6 * n} noise draws an update "
          f"(counters {r['ppo_drawn']['update'][1]}, unsharded {ref['ppo_drawn']['update'][1]}); "
          f"{max(r['ppo_ms'] for r in ranks):.2f} ms an update (slowest rank, CUDA events, "
          f"median of 3); loss {ranks[0]['ppo_metrics']['loss']:.5f} (unsharded "
          f"{ref['ppo_metrics']['loss']:.5f})")


def md_launches(name: str, per_rank: list, ref: dict, tag: str) -> None:
    """The counted fast-PPO update: per rank the actions and indexed gradient
    kernels ran 64 and at most 16 times; over several ranks the keyed pool's
    tasks once (the reset kernel) and the counter kernel 10 times (the key
    chain, the pool's keys and scores, the uniforms, the permutations), on
    one rank the pool kernel once and the counter kernel 8 times (its seeds
    for the pool); every minibatch ran on some rank, no plain version ran,
    and each rank drew of the counters the unsharded update's less the other
    ranks' columns of the uniforms (and likewise in the pixel-PPO update)."""
    from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp

    world = len(per_rank)
    fppo, T_pixel, B = fp.FastPPOConfig(), fx.PixelPPOConfig().rollout_steps, B_MAIN
    T, n_mb = fppo.rollout_steps, fppo.update_epochs * fppo.num_minibatches
    keyed_pool = world > 1  # the default pool (fast_ppo.pool_choice)
    # the keyed pool: split 2, scores, split 2B
    counter = keyed_update_launches(fppo, B) + (2 if keyed_pool else 0)
    # the other ranks' columns of the uniforms, in the fast and the pixel update
    others = tuple(t * 6 * (B - B // world) for t in (T, T_pixel))
    for r, (launches, calls, drawn) in enumerate(per_rank):
        check(launches["pool"] == int(not keyed_pool) and launches["packed_actions"] == T
              and launches["ppo_grads_indexed"] <= n_mb
              and launches["keyed_reset"] == int(keyed_pool)
              and launches["keyed_counter"] == counter,
              f"{name} rank {r}: pool {int(not keyed_pool)}, actions {T}, indexed gradient <= "
              f"{n_mb}, keyed reset {int(keyed_pool)}, counter {counter} launches ({launches})")
        check(all(c == 0 for c in calls.values()), f"{name} rank {r}: no plain version ({calls})")
        check(drawn == (ref["fast_drawn"] - others[0], ref["pixel_drawn"] - others[1]),
              f"{name} rank {r} drew its columns of the uniforms only: {drawn} (unsharded "
              f"{ref['fast_drawn']}, {ref['pixel_drawn']}; less {others})")
    total = sum(l["ppo_grads_indexed"] for l, _, _ in per_rank)
    check(total >= n_mb, f"{name}: the indexed gradient kernel ran for every minibatch ({total})")
    print(f"{tag} phase 21 {name} fast-PPO update launches per rank: "
          + "; ".join(f"rank {r} {l}" for r, (l, _, _) in enumerate(per_rank))
          + f"; counters drawn an update (fast, pixel) per rank "
          + ", ".join(str(d) for _, _, d in per_rank)
          + f", unsharded {(ref['fast_drawn'], ref['pixel_drawn'])}")


def run_group(cmd, timeout: float = 600):
    """Run ``cmd`` (torchrun and its ranks) in a process group of its own and
    return (code, stdout, stderr); past ``timeout`` s the whole group is
    killed, so that no rank outlives the script."""
    import signal

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=HERE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err += f"\nkilled after {timeout} s"
    return proc.returncode, out, err


def run_py(args):
    """``run.py`` under torchrun with one rank; its JSON records."""
    code, out, err = run_group([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                "--nproc_per_node", "1", "-m",
                                "gym_craftingworld_tpu_torch.train.run", *args])
    check(code == 0, f"run.py exited {code}: {err[-3000:]}")
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def run_py_phase(cw, dev, tag):
    """Phase 21c: ``train/run.py`` under torchrun, 4 updates with a checkpoint
    at 2, then a resume from it that must repeat updates 2-3 bit for bit."""
    import shutil

    work = HERE / "build" / "run_py"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    args = ["--envs", str(RUN_ENVS), "--size", "21", "--hidden", "512", "--policy", "mlp",
            "--log-every", "1", "--ckpt-every", "2", "--device", dev.type]
    t0 = time.perf_counter()
    full = run_py(args + ["--updates", str(RUN_UPDATES), "--ckpt-dir", str(work / "full")])
    t_full = time.perf_counter() - t0
    (work / "resume").mkdir()
    shutil.copytree(work / "full" / "step_2", work / "resume" / "step_2")
    resumed = run_py(args + ["--updates", str(RUN_UPDATES), "--ckpt-dir", str(work / "resume"),
                             "--resume"])
    volatile = ("env_steps_per_s", "wall_s")
    metrics = lambda recs: {r["update"]: {k: v for k, v in r.items() if k not in volatile}
                            for r in recs if "loss" in r}
    mf, mr = metrics(full), metrics(resumed)
    check(set(mf) == set(range(RUN_UPDATES)) and set(mr) == {2, 3}, f"run.py updates {mf}, {mr}")
    for u in (2, 3):
        check(mr[u] == mf[u], f"run.py update {u} after the resume equals the uninterrupted "
                              f"run's: {mr[u]} vs {mf[u]}")
    rates = [r["env_steps_per_s"] for r in full if "env_steps_per_s" in r]
    print(f"{tag} phase 21c run.py ({RUN_ENVS} envs, 21x21, mlp hidden 512, T=64; torchrun, one "
          f"rank, deterministic algorithms): {RUN_UPDATES} updates in {t_full:.1f} s of command; "
          f"env-steps/s {rates} (host clock between log lines); the resume from step_2 repeats "
          f"updates 2-3 bit for bit: {json.dumps(mr[3])}")
    shutil.rmtree(work, ignore_errors=True)


def multi_device_phase(cw, dev, tag):
    """Phase 21: the multi-device paths at 16,384 envs on 21x21."""
    import shutil

    from gym_craftingworld_tpu_torch.parallel import mesh as pm
    from gym_craftingworld_tpu_torch.parallel.dryrun import dryrun_multichip
    from gym_craftingworld_tpu_torch.train import ppo as tppo

    t_phase = time.perf_counter()
    work = HERE / "build" / "multi_device"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # the unsharded run, in this process
    t0 = time.perf_counter()
    ref = md_work(cw, dev, None, timed=False)
    print(f"{tag} phase 21 unsharded run in {time.perf_counter() - t0:.1f} s (host clock); "
          f"launches of its counted fast-PPO update {ref['fast_launches']}")

    # world 2 under gloo: two ranks on the one card, which this process's
    # cache of earlier phases' blocks must not crowd
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        print(f"{tag} phase 21 device memory before the ranks: {free / 2**30:.1f} GiB free of "
              f"{total / 2**30:.1f} GiB")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(MD_WORLD), str(HERE / "chip_smoke.py"), "--rank-worker", str(work),
           "--device", dev.type]
    t0 = time.perf_counter()
    code, out, err = run_group(cmd)
    t_ranks = time.perf_counter() - t0
    failures = "".join(f"\nrank {f.stem}: {f.read_text()}" for f in sorted(work.glob("*.err")))
    check(code == 0, f"{MD_WORLD} ranks exited {code}:{failures}\n{out[-2000:]}\n{err[-3000:]}")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(MD_WORLD)]
    check(all(r["backend"] == "gloo" for r in ranks), "two ranks on one card take gloo")
    whole = {k: joined([r[k] for r in ranks], -1) for k in
             ("fast_traj", "fast_env", "pixel_traj", "pixel_env")}
    whole["bench"] = (joined([r["bench"][0] for r in ranks], 0), ranks[0]["bench"][1])
    check(all(int(r["bench"][1]) == int(ranks[0]["bench"][1]) for r in ranks),
          "every rank holds the whole checksum")
    whole["actions"] = (joined([r["actions"][0] for r in ranks], 0),
                        *(joined([r["actions"][i] for r in ranks], -1) for i in (1, 2)))
    for k in ("fast_first", "pixel_first", "fast_metrics", "pixel_metrics"):
        whole[k] = ranks[0][k]  # summed over the ranks: the same on each
        for r in ranks[1:]:
            if k.endswith("first"):
                md_equal(r[k], ranks[0][k], f"world {MD_WORLD} {k} alike on every rank")
            else:
                check(r[k] == ranks[0][k], f"world {MD_WORLD} {k} alike on every rank")
    md_compare(f"world {MD_WORLD} (gloo, two ranks sharing one card)", whole, ref, tag)
    md_ppo(f"world {MD_WORLD}", ranks, ref, tag)
    md_launches(f"world {MD_WORLD}", [(r["fast_launches"], r["fast_calls"],
                                       (r["fast_drawn"], r["pixel_drawn"])) for r in ranks],
                ref, tag)
    w2 = ranks[0]
    print(f"{tag} phase 21 world {MD_WORLD} (gloo, two ranks sharing one card): {t_ranks:.1f} s "
          f"of command, a rank's work {max(r['seconds'] for r in ranks):.1f} s; sharded fast-PPO "
          f"update {max(r['fast_ms'] for r in ranks):.2f} ms (slowest rank, CUDA events, median "
          f"of 3); all_reduce {w2['all_reduce']['calls']} calls, {w2['all_reduce']['ms']:.2f} ms "
          f"of a {w2['all_reduce']['update_ms']:.2f} ms update timed between syncs "
          f"({w2['all_reduce']['ms'] / w2['all_reduce']['update_ms']:.1%}, rank 0)")

    # world 1 under NCCL, in this process
    backend = "nccl" if dev.type == "cuda" else "gloo"
    pm.initialize_distributed(init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                              device=dev.type, backend=backend)
    try:
        mesh = pm.make_env_mesh(device=dev)
        check(mesh.group is not None and torch.distributed.get_backend() == backend,
              f"world 1 under {backend}")
        w1 = md_work(cw, dev, mesh, timed=True)
    finally:
        torch.distributed.destroy_process_group()
    ref1 = {**ref, **ref["kernel_pool"]}  # one rank's default: the pool kernel
    md_compare(f"world 1 ({backend})", w1, ref1, tag)
    md_ppo("world 1", [w1], ref1, tag)
    md_launches("world 1", [(w1["fast_launches"], w1["fast_calls"],
                             (w1["fast_drawn"], w1["pixel_drawn"]))], ref1, tag)
    ar = w1["all_reduce"]
    print(f"{tag} phase 21 world 1 ({backend}): sharded fast-PPO update {w1['fast_ms']:.2f} ms "
          f"(CUDA events, median of 3); all_reduce {ar['calls']} calls, {ar['ms']:.2f} ms of a "
          f"{ar['update_ms']:.2f} ms update timed between syncs ({ar['ms'] / ar['update_ms']:.1%})")
    del ref, ref1, ranks, whole, w1

    # the cost of deterministic algorithms, on train/ppo.py's mlp update
    cfg = cw.ray_config(max_steps=100)
    ppo = tppo.PPOConfig()
    st = {"ts": tppo.init_train_state(prng_key(0, device=dev), cfg, ppo),
          "env": cw.reset_from_seed(cfg, 0, RUN_ENVS, device=dev), "key": prng_key(1).to(dev)}

    def update():
        st["ts"], st["env"], st["key"], _ = tppo.train_step(cfg, ppo, st["ts"], st["env"],
                                                            st["key"])

    ms = {}
    for mode in (False, True, True, False):
        torch.use_deterministic_algorithms(mode)
        ms.setdefault(mode, []).append(pm.time_ms(update, 2, dev))
    torch.use_deterministic_algorithms(False)
    print(f"{tag} phase 21 train/ppo.py mlp update at {RUN_ENVS} envs: {ms[False]} ms without, "
          f"{ms[True]} ms with deterministic algorithms (CUDA events, median of 2, in turns)")
    del st

    print(f"{tag} phase 21 {dryrun_multichip(1, dev.type)}")
    rep = pm.scaling_report(cw.ray_config(), B_MAIN, num_steps=64, engines=("grid", "packed_scan", "fused"),
                            device=dev)
    print(f"{tag} phase 21 scaling_report, one card (n1: env-steps/s at {B_MAIN} envs, 64 "
          f"steps, CUDA events, median of 3): "
          + "; ".join(f"{k} {v['n1']:.4e}" for k, v in rep.items()))
    shutil.rmtree(work, ignore_errors=True)
    print(f"{tag} phase 21 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# learning (phase 22)
# ---------------------------------------------------------------------------

# Bounds of the port's learning against the JAX record, fixed before the first
# run on the card: each run's mean success per step over updates 160-191
# (``TAIL_BAND``) and 32-63 (``EARLY_BAND``) as a multiple of the JAX record's
# mean over its two seeds. JAX's seeds differ by under 1% and 2% there; its
# 1ep_8mb setting, a different update, reads 16% lower at the tail.
TAIL_BAND = (0.90, 1.10)
EARLY_BAND = (0.70, 1.30)
LEARN_SEEDS = (0, 1)


LEARN_RESULT = "phase 22 run result "  # the line that carries one run's tail to the parent


def learning_run(cw, dev, tag, path: str, seed: int) -> None:
    """One run of phase 22: fast PPO's learning on the card, through the
    gradient kernel (``path`` "fused") or autograd, from JAX's keys of
    ``seed``; prints its windows and, on the last line, its tails and the
    bounds it missed (``learning_summary`` reads them)."""
    from gym_craftingworld_tpu_torch.tools import fast_ppo_sweep as sweep
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp

    fppo = fp.FastPPOConfig()
    n, B, W = sweep.LEARN_UPDATES, sweep.B_LEARN, sweep.WINDOW
    ref = sweep.jax_reference()["2ep_8mb (default)"]
    jax_tail, jax_early = ref["tail_seed_mean"], ref["early_seed_mean"]
    fused = path == "fused"
    wrappers, plains = zero_counters()
    keyed, keyed_plains = zero_keyed()
    t0 = time.perf_counter()
    curve = sweep.learning_curve(fppo, seed, n, B, dev, fused_update=fused)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in (*wrappers.items(), *keyed.items())}
    calls = {f.__name__: f.calls for f in (*plains, *keyed_plains)}
    want = {k: 0 for k in launches}
    # the key chain: the init (split 4 and 4 normals) and the first envs
    # (split 2, scores, split B, their tasks), then each update's draws
    want.update(pool=n, packed_actions=n * fppo.rollout_steps,
                ppo_grads_indexed=n * fppo.update_epochs * fppo.num_minibatches
                if fused else 0, keyed_counter=5 + 3 + n * keyed_update_launches(fppo, B),
                keyed_reset=1)
    check(launches == want, f"phase 22 {path} seed {seed}: launches {launches}, want {want}")
    check(all(c == 0 for c in calls.values()), f"phase 22: no plain version ran: {calls}")
    check(len(curve) == n and all(math.isfinite(x) for x in curve),
          f"phase 22 {path} seed {seed}: {n} finite success rates")
    windows = sweep.window_means(curve, n, W)
    tail, early = sweep.tail_mean(curve, n, W), windows[1]
    jax_w = ref["windows"][f"seed{seed}"]
    print(f"{tag} phase 22 {path} seed {seed}: {n} updates at {B} envs in {seconds:.1f} s "
          f"(host clock); success per step by window of {W} updates, port against JAX "
          f"seed {seed}: " + ", ".join(f"{a:.6f} / {b:.6f}" for a, b in zip(windows, jax_w))
          + f"; half the tail first at update {sweep.half_tail_update(curve, n, W)} "
          f"(JAX {ref['half_tail_update'][f'seed{seed}']}); launches {launches}")
    failed = []
    for what, got, jax, (lo, hi) in (("tail (updates 160-191)", tail, jax_tail, TAIL_BAND),
                                     ("early (updates 32-63)", early, jax_early, EARLY_BAND)):
        ratio = got / jax
        print(f"{tag} phase 22 {path} seed {seed} {what}: {got:.6f} = {ratio:.4f} x JAX's "
              f"seed mean {jax:.6f} (bound {lo}-{hi})")
        if not lo <= ratio <= hi:
            failed.append(f"{path} seed {seed} {what} {ratio:.4f} x JAX, outside {lo}-{hi}")
    print(LEARN_RESULT + json.dumps(dict(path=path, seed=seed, tail=tail, failed=failed)))


def learning_summary(tag, results: list) -> None:
    """Phase 22's verdict over its runs (``learning_run``'s last lines): every
    run within its bounds, and the two paths' tails within JAX's noise rule."""
    from gym_craftingworld_tpu_torch.tools.fused_update_e2e import cross_path_summary

    got = {(r["path"], r["seed"]) for r in results}
    check(got == {(p, s) for p in ("fused", "autograd") for s in LEARN_SEEDS},
          f"phase 22: one run a path and seed: {sorted(got)}")
    tails = {p: {f"seed{r['seed']}": r["tail"] for r in results if r["path"] == p}
             for p in ("fused", "autograd")}
    failed = [f for r in results for f in r["failed"]]
    summary = cross_path_summary(tails)
    print(f"{tag} phase 22 fused against autograd: tails {json.dumps(tails)}; cross-path gap "
          f"{summary['cross_path_gap']:.6f}, cross-seed noise {summary['cross_seed_noise']:.6f}, "
          f"within noise {summary['within_noise']} (JAX's rule)")
    if not summary["within_noise"]:
        failed.append(f"cross-path gap {summary['cross_path_gap']:.6f} beyond max(2 x noise "
                      f"{summary['cross_seed_noise']:.6f}, 0.1 x the largest tail)")
    check(not failed, "phase 22 learning bounds: " + "; ".join(failed))


LEARN_JOBS = tuple(f"22:{p}:{s}" for p in ("fused", "autograd") for s in LEARN_SEEDS)


# ---------------------------------------------------------------------------
# phases side by side (19, 20, 21c, 22, 23 and 25)
# ---------------------------------------------------------------------------

# Phases that time no kernel, have no time budget and are paced by the host:
# each runs as ``chip_smoke.py --worker JOB`` in a process of its own (phase
# 22 one a path and seed), all started together on the one card, so that the
# script waits for the longest of them and not for their sum. Each holds its
# own counters, as it did in this process.
SIDE_BY_SIDE = ("19", "20", "21c", *LEARN_JOBS, "23a", "23b", "25")
SIDE_TIMEOUT_S = 600
# Phases 24 and 26 keep their time budgets and run alone, each in a fresh
# process: at the end of this process host-paced work steps ~1.75x slower
# than in a fresh one (on the H100: phase 24 took 62.1 s with phase 1 alone,
# 102.4 s at the end of the script)


def phase_worker(cw, job: str, argv) -> int:
    """One job of ``side_by_side``, in this process: phase ``job``, or for
    "22:PATH:SEED" one learning run. ``--long-t-rate B=RATE`` gives phase 24
    phase 6's rate."""
    from gym_craftingworld_tpu_torch.ops import _build

    card = card_line().splitlines()[0].strip()
    tag = f"[{card}]"
    dev = torch.device(DEVICE, 0)
    _build.load()  # built by the parent: the library of these sources is loaded as it is
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--long-t-rate" in argv:
        envs, rate = argv[argv.index("--long-t-rate") + 1].split("=")
        LONG_T_RATE[int(envs)] = float(rate)
    phase, *rest = job.split(":")
    phases = {"19": imitation_phase, "20": recurrent_phase, "21c": run_py_phase,
              "23a": pixel_curve_phase, "23b": canonical_tools_phase, "24": cpv_phase,
              "25": distill_phase}
    if phase == "22":
        learning_run(cw, dev, tag, rest[0], int(rest[1]))
    elif phase == "26":
        tools_phase(cw, dev, tag, card)
    else:
        phases[phase](cw, dev, tag)
    torch.cuda.synchronize()
    print(f"{tag} phase {job}: peak device memory {torch.cuda.max_memory_reserved(dev) / 2**30:.2f} "
          f"GiB reserved")
    return 0


def side_by_side(tag, jobs, args=(), timeout: float = SIDE_TIMEOUT_S) -> None:
    """Run ``jobs`` (``phase_worker``'s names) each in a process of its own,
    all started together, with ``args`` after each job's name; print each
    one's output in order, fail if any failed, and give phase 22's verdict
    over its runs. A job still running after ``timeout`` s, and every job if
    this process is interrupted, is killed with its process group."""
    import shutil
    import signal

    out_dir = HERE / "build" / "side_by_side"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}  # a killed job keeps what it printed
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    try:
        for job in jobs:
            with open(out_dir / f"{job}.out", "w") as out, open(out_dir / f"{job}.err", "w") as err:
                procs[job] = subprocess.Popen(
                    [sys.executable, str(HERE / "chip_smoke.py"), "--worker", job, *args], stdout=out,
                    stderr=err, cwd=HERE, env=env, start_new_session=True)
        while len(seconds) < len(procs) and time.perf_counter() - t0 < timeout:
            time.sleep(0.25)
            for job, proc in procs.items():
                if job not in seconds and proc.poll() is not None:
                    seconds[job] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    failed, learned = [], []
    for job in jobs:
        out = (out_dir / f"{job}.out").read_text()
        err = (out_dir / f"{job}.err").read_text()
        sys.stdout.write(out)
        sys.stderr.write(err)
        code = procs[job].returncode
        took = f"{seconds[job]:.1f} s" if job in seconds else f"killed after {timeout} s"
        print(f"{tag} phase {job} (a process of its own): exit {code}, {took}")
        if code != 0:
            failed.append(f"phase {job} exited {code} ({took}): {err[-3000:]}")
        learned += [json.loads(line[len(LEARN_RESULT):]) for line in out.splitlines()
                    if line.startswith(LEARN_RESULT)]
    shutil.rmtree(out_dir, ignore_errors=True)
    check(not failed, "; ".join(failed))
    if any(job.startswith("22:") for job in jobs):
        learning_summary(tag, learned)
    print(f"{tag} phases {', '.join(jobs)}, each in a process of its own, took "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the canonical-training tools (phase 23)
# ---------------------------------------------------------------------------

# Bounds of 23a against the JAX record's throughput_preset curve, fixed before
# the first run on the card (PERF.md §6): the mean success per step over
# updates 0-49 as a multiple of JAX's 1.325e-4, and the ratio of updates 50-99
# to 0-49 (JAX: 0.494, its early dip). A 50-update window of 16,384 envs x 64
# steps holds about 3,000-7,000 successes: 1-2% counting noise.
PIXEL_UPDATES = 100
PIXEL_FIRST_BAND = (0.80, 1.25)
PIXEL_DIP_BAND = (0.35, 0.70)
# 23b's sizes: the tools' own code at the records' shapes, cut to a short run.
# DAgger's states are capped at 10,000 (the tool's default 300,000): the host
# relabels about 3,500 a second.
CANON_DEMOS = ["--episodes", "384", "--batch", "192"]
CANON_WIDTHS = (64, 1024)  # the tools' default GridPolicy
CANON_TRAIN = ["--bc-steps", "300", "--chunk", "100", "--dagger-rounds", "1",
               "--dagger-episodes", "256", "--dagger-max-states", "10000", "--dagger-steps", "100",
               "--eval-episodes", "256", "--final-eval-episodes", "512", "--capacity", "1000000"]
CANON_TARGETED = ["--rounds", "1", "--episodes", "512", "--steps", "100", "--eval-episodes", "512",
                  "--final-eval-episodes", "1024", "--capacity", "1000000"]


def pixel_curve_phase(cw, dev, tag):
    """Phase 23a: the pixel tool's curve against the JAX record."""
    from gym_craftingworld_tpu_torch.tools import fast_pixel_canonical as fpc

    _, preset = fpc.configs()
    jax_curve = fpc.jax_record()["throughput_preset"]["single_task_curve"]
    wrappers, plains = zero_counters()
    keyed, keyed_plains = zero_keyed()
    t0 = time.perf_counter()
    curve = fpc.run_curve(cw.ray_config(stacking=False), preset, 0, PIXEL_UPDATES, B_MAIN, dev,
                          tag)
    torch.cuda.synchronize()
    t_pixel = time.perf_counter() - t0
    launches = {k: w.launches for k, w in (*wrappers.items(), *keyed.items())}
    calls = {f.__name__: f.calls for f in (*plains, *keyed_plains)}
    want = {k: 0 for k in launches}
    want["packed_actions"] = PIXEL_UPDATES * preset.rollout_steps
    # the key chain: the init (split 5 and 5 normals), the first envs (split 2,
    # scores, split B; their tasks), then each update's draws
    per_update = pixel_keyed_launches(preset, B_MAIN)
    want["keyed_counter"] = 6 + 3 + PIXEL_UPDATES * per_update["keyed_counter"]
    want["keyed_reset"] = 1 + PIXEL_UPDATES * per_update["keyed_reset"]
    check(launches == want, f"phase 23a launches {launches}, want {want}")
    check(all(c == 0 for c in calls.values()), f"phase 23a: no plain version ran: {calls}")
    check(len(curve) == PIXEL_UPDATES and all(math.isfinite(x) for x in curve),
          f"phase 23a: {PIXEL_UPDATES} finite success rates")
    windows = fpc.compare_windows(curve, jax_curve)
    first = windows[0]["ratio"]
    dip, jax_dip = windows[1]["port"] / windows[0]["port"], windows[1]["jax"] / windows[0]["jax"]
    print(f"{tag} phase 23a pixel PPO throughput() preset, {B_MAIN} envs single-task 21x21, seed "
          f"0: {PIXEL_UPDATES} updates in {t_pixel:.1f} s (host clock); success per step by "
          f"window of {fpc.CHUNK} updates, port / JAX: "
          + ", ".join(f"{w['port']:.4e} / {w['jax']:.4e}" for w in windows)
          + f"; first window {first:.4f} x JAX's (bound {PIXEL_FIRST_BAND[0]}-"
          f"{PIXEL_FIRST_BAND[1]}); dip {dip:.4f} (JAX {jax_dip:.4f}, bound {PIXEL_DIP_BAND[0]}-"
          f"{PIXEL_DIP_BAND[1]}); launches {launches}")
    failed = []
    if not PIXEL_FIRST_BAND[0] <= first <= PIXEL_FIRST_BAND[1]:
        failed.append(f"first window {first:.4f} x JAX, outside {PIXEL_FIRST_BAND}")
    if not PIXEL_DIP_BAND[0] <= dip <= PIXEL_DIP_BAND[1]:
        failed.append(f"dip {dip:.4f}, outside {PIXEL_DIP_BAND}")
    check(not failed, "phase 23a pixel bounds: " + "; ".join(failed))


def canonical_tools_phase(cw, dev, tag):
    """Phase 23b: the three canonical tools end to end at a small size."""
    import tempfile

    import numpy as np

    from gym_craftingworld_tpu_torch.tools import _canonical
    from gym_craftingworld_tpu_torch.tools import collect_canonical_demos as demos_tool
    from gym_craftingworld_tpu_torch.tools import targeted_dagger as targeted_tool
    from gym_craftingworld_tpu_torch.tools import train_canonical as train_tool
    from gym_craftingworld_tpu_torch.models.grid_policy import init_grid_policy
    from gym_craftingworld_tpu_torch.train.demos import SnapDataset

    t_phase = time.perf_counter()
    wrappers, plains = zero_counters()
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        run, demos_path = tmp / "run", tmp / "demos.npz"
        widths = ["--channels", str(CANON_WIDTHS[0]), "--hidden", str(CANON_WIDTHS[1])]
        common = ["--device", dev.type]
        t0 = time.perf_counter()
        snaps = demos_tool.main(CANON_DEMOS + common + ["--out", str(demos_path)])
        seconds["collect_canonical_demos"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_tool.main(CANON_TRAIN + widths + common + ["--demos", str(demos_path), "--out", str(run)])
        seconds["train_canonical"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = targeted_tool.main(CANON_TARGETED + widths + common + [
            "--demos", str(demos_path), "--out", str(run), "--init-params",
            str(run / "params_final.pt"), "--policy-json", str(tmp / "canonical_policy.json")])
        seconds["targeted_dagger"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        no_kernel_ran(wrappers, plains, "phase 23b's tools")

        again = SnapDataset.load(str(demos_path))
        check(all(np.array_equal(a, b) for a, b in zip(again, snaps)),
              "phase 23b: the demos npz reloads equal")
        records = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
        targeted = [json.loads(l)
                    for l in (run / "targeted_metrics.jsonl").read_text().splitlines()]
        curve = json.loads((run / "canonical_curve.json").read_text())
        check([c["tag"] for c in curve] == [r["tag"] for r in records if r["phase"] == "eval"],
              f"phase 23b: the curve lists every evaluation: {curve}")
        bc = [r["loss"] for r in records if r["phase"] == "bc"]
        check(len(bc) == 3 and bc[-1] < bc[0], f"phase 23b: the BC loss falls: {bc}")
        (dg,) = [r for r in records if r["phase"] == "dagger_collect"]
        (tg,) = [r for r in targeted if r["phase"] == "collect"]
        dagger_rows = SnapDataset.load(str(run / "dagger0.npz")).num_rows
        targeted_rows = SnapDataset.load(str(run / "targeted0.npz")).num_rows
        check(dg["rows"] == dagger_rows and dg["n_valid"] == snaps.num_rows + dagger_rows,
              f"phase 23b: DAgger appended its relabelled rows: {dg}, {dagger_rows}")
        check(tg["rows"] == targeted_rows
              and tg["n_valid"] == snaps.num_rows + dagger_rows + targeted_rows,
              f"phase 23b: the targeted round appended its relabelled rows: {tg}, {targeted_rows}")
        for name in ("bc", "dagger0", "final", "targeted0", "targeted_final"):
            model = init_grid_policy(prng_key(0, device=dev), _canonical.CFG, *CANON_WIDTHS)
            _canonical.load_params(model, run / f"params_{name}.pt")
            check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
                  f"phase 23b: params_{name}.pt reloads finite")
        doc = json.loads(Path(result["path"]).read_text())
        jax_keys = set(json.loads((HERE / "docs" / "canonical_policy.json").read_text()))
        check(set(doc) == jax_keys | {"card"} and doc == result["artifact"],
              f"phase 23b: the artifact holds the JAX record's keys and the card: {sorted(doc)}")
        by_k = doc["success_by_num_tasks"]
        check(doc["episodes"] == 1024 == sum(v["episodes"] for v in by_k.values()),
              f"phase 23b: episodes by task count sum to the episodes: {by_k}")
        check(0.0 <= doc["success_rate"] <= 1.0, "phase 23b: a success rate")
    finals = {"train_canonical final": [r for r in records if r.get("tag") == "final"][0],
              "targeted_dagger final": doc}
    print(f"{tag} phase 23b: {snaps.num_rows} demo rows from {snaps.num_episodes} episodes; BC "
          f"loss by chunk {', '.join(f'{x:.4f}' for x in bc)}; DAgger round {dg['states']} "
          f"states, rollout success {dg['rollout_success']:.3f} (collect {dg['collect_s']:.1f} s, "
          f"relabel {dg['relabel_s']:.1f} s); targeted round {tg['states']} states (collect "
          f"{tg['collect_s']:.1f} s, relabel {tg['relabel_s']:.1f} s); success "
          + ", ".join(f"{k} {v['success_rate']:.4f} over {v['episodes']}"
                      for k, v in finals.items())
          + f"; seconds by tool (host clock) {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
          f"phase 23b took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the CPV matrix and the scaling artifact (phase 24)
# ---------------------------------------------------------------------------

LONG_T_RATE = {}  # envs -> phase 6's long-T env-steps/s of the bench kernel
SCALING_ITERS, SCALING_SCAN_STEPS = 3, 128
RATE_BAND = (0.95, 1.05)  # sharded over unsharded: the same kernel
# the untrained policy runs every cell's 300 steps, host-paced: ~3 ms a step
# with phases 1 and 24 alone, ~5 ms at the end of the whole script (after the
# profiler's sessions). With all 36 pairs 24b took 200.7 s, and with 4 pairs
# and 64-episode rounds, the matrix rerun whole, phase 24 took 102.4 s at the
# end of the script. As it is, it took 88.7 and 92.3 s there: its budget is
# 1.3 x the larger
CPV_BUDGET_S = 120.0
CPV_ARGS = ["--pool", "32", "--singles-per-task", "4", "--handoff-episodes", "32",
            "--bc-epochs", "1", "--dagger-rounds", "2", "--dagger-episodes", "32",
            "--dagger-epochs", "1", "--cell-episodes", "16", "--channels", "96",
            "--hidden", "1024", "--batch", "4096"]
CPV_TRIPLES = [(0, 1, 2)]  # the one triple, as the tool's --smoke takes it
CPV_PAIRS = [(0, 1), (5, 6), (5, 7), (5, 8)]  # JAX's weak families


def cpv_phase(cw, dev, tag):
    """Phase 24: the scaling artifact's card section, counted (24a), and the
    CPV protocol end to end at 21x21, small, then its matrix alone (24b)."""
    import tempfile

    import numpy as np

    from gym_craftingworld_tpu_torch.core import slots as sm
    from gym_craftingworld_tpu_torch.ops import packed_fused as pf
    from gym_craftingworld_tpu_torch.tools import cpv_canonical as cc
    from gym_craftingworld_tpu_torch.tools import scaling_artifact as sa

    t_phase = time.perf_counter()
    # ---- 24a. the scaling artifact's card section, counted ------------------------
    wrappers, plains = zero_counters()
    mark = keyed_mark()
    t0 = time.perf_counter()
    section = sa.run_gpu(None, iters=SCALING_ITERS, scan_steps=SCALING_SCAN_STEPS, device=dev)
    torch.cuda.synchronize()
    t_scaling = time.perf_counter() - t0
    # the envs' reset, and each plain-scan run (a warm-up and the timed runs,
    # at T and T/2) draws its actions: randint(PRNGKey(2), (T, B), 0, 6)
    keyed_since(mark, f"{tag} phase 24a", keyed_counts(1, 1 + (1 + SCALING_ITERS) * 2))
    launches = {k: w.launches for k, w in wrappers.items()}
    calls = {f.__name__: f.calls for f in plains}
    want = {k: 0 for k in launches}
    want["packed_bench"] = (1 + SCALING_ITERS) * 2
    check(launches == want, f"phase 24a launches {launches}, want {want}")
    check(all(c == 0 for c in calls.values()), f"phase 24a: no plain version ran: {calls}")
    sharded = section["fused_bench_env_steps_per_s"]
    B = section["config"]["envs"]
    if B in LONG_T_RATE:
        unsharded, how = LONG_T_RATE[B], "phase 6's long-T rate"
    else:
        cfg = cw.ray_config()
        slots = sm.from_env_state(cw.reset_from_seed(cfg, 0, B, device=dev))
        unsharded = sa._delta_rate(lambda T: pf.fused_rollout_packed_bench(cfg, slots, 3, T), B,
                                   section["config"]["fused_steps"], SCALING_ITERS, dev)
        how = "the unsharded entry point, delta-timed alike"
    ratio = sharded / unsharded
    print(f"{tag} phase 24a scaling_artifact gpu_single_chip, {B} envs on 21x21, 1-rank mesh: "
          f"bench kernel {sharded:.5e} env-steps/s (T = {section['config']['fused_steps']} "
          f"against half, median of {SCALING_ITERS}, CUDA events), {ratio:.4f} x {how} "
          f"{unsharded:.5e} (bound {RATE_BAND[0]}-{RATE_BAND[1]}); plain packed scan "
          f"{section['packed_scan_env_steps_per_s']:.5e} at T = {SCALING_SCAN_STEPS}; "
          f"launches {launches}; {t_scaling:.1f} s")
    check(RATE_BAND[0] <= ratio <= RATE_BAND[1],
          f"phase 24a: the sharded bench rate is {ratio:.4f} x the unsharded one")

    # ---- 24b. the CPV protocol end to end, small, then the matrix alone -----------
    wrappers, plains = zero_counters()
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        common = CPV_ARGS + ["--device", dev.type, "--save-params", str(tmp / "run")]
        t0 = time.perf_counter()
        full = cc.main(common + ["--out", str(tmp / "full.json")], CPV_PAIRS, CPV_TRIPLES)
        seconds["full"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone = cc.main(common + ["--matrix-only", "--out", str(tmp / "matrix.json")], [], [])
        seconds["matrix_only"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        no_kernel_ran(wrappers, plains, "phase 24b's tool")
        doc = json.loads((tmp / "full.json").read_text())
        jax_doc = json.loads((HERE / "docs" / "cpv_matrix.json").read_text())
        check(set(doc) == set(jax_doc) | {"card"} and set(doc["config"]) == set(jax_doc["config"])
              and doc == full["results"],
              f"phase 24b: the JSON holds the JAX record's keys and the card: {sorted(doc)}")
        data, tasks = full["phase1"]
        cached, cached_tasks = cc.load_phase1(tmp / "run" / "phase1.npz")
        check(all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(cached, data))
              and np.array_equal(cached_tasks, tasks), "phase 24b: phase1.npz reloads equal")
    rounds = full["rounds"]
    check([r["mode"] for r in rounds] == ["argmax_eps", "sample"], f"phase 24b rounds {rounds}")
    for r in rounds:
        check(r["rows_after"] == r["rows_before"] + r["relabelled"] + r["augmented"]
              and r["augmented"] <= r["relabelled"],
              f"phase 24b: round {r['round']} appended its relabelled rows and their copies: {r}")
    counts = {k: len(doc[k]) for k in ("singles", "pairs", "triples")}
    check(counts == {"singles": 9, "pairs": len(CPV_PAIRS), "triples": 1}, f"phase 24b cells {counts}")
    rates = [v for k in ("singles", "pairs", "triples") for s in ("", "_argmax")
             for v in doc[k + s].values()]
    check(all(0.0 <= v <= 1.0 for v in rates), "phase 24b: every cell a success rate")
    same = {k: doc[k] == alone["results"][k] for k in ("singles", "singles_argmax")}
    check(same["singles_argmax"],
          f"phase 24b: --matrix-only gives the full run's argmax singles: {same}")
    took = time.perf_counter() - t_phase
    print(f"{tag} phase 24b cpv_canonical {' '.join(CPV_ARGS)} on 21x21: {data.num_rows} expert "
          f"rows from {data.num_episodes} episodes; DAgger rounds "
          + "; ".join(f"{r['mode']} policy sr {r['policy_sr']:.3f}, +{r['relabelled']} relabelled "
                      f"+{r['augmented']} copies (collect {r['collect_s']:.1f} s, train "
                      f"{r['train_s']:.1f} s)" for r in rounds)
          + f"; cells {counts}, pair mean {doc['pair_mean']:.4f} sampled / "
          f"{doc['pair_mean_argmax']:.4f} argmax; --matrix-only (singles) equal {same}; seconds "
          f"(host clock) full run {json.dumps({k: round(v, 1) for k, v in full['seconds'].items()})}"
          f" in {seconds['full']:.1f}, matrix alone {seconds['matrix_only']:.1f}; phase 24 took "
          f"{took:.1f} s")
    check(took <= CPV_BUDGET_S, f"phase 24 took {took:.1f} s, budget {CPV_BUDGET_S} s")


# ---------------------------------------------------------------------------
# the last tools and entry points (phase 25)
# ---------------------------------------------------------------------------

FT_ARGS = ["--init-params", "", "--channels", "16", "--hidden", "64", "--envs", "256",
           "--updates", "3", "--warmup", "1", "--eval-every", "1", "--eval-episodes", "256",
           "--final-eval-episodes", "256"]
DISTILL_ARGS = ["--teacher", "", "--teacher-channels", "16", "--teacher-hidden", "64",
                "--stem", "8", "--channels", "16", "--hidden", "64", "--rounds", "2",
                "--episodes0", "256", "--episodes", "256", "--epochs0", "1", "--epochs", "1",
                "--eval-episodes", "256", "--final-eval-episodes", "256"]
GRAPH_STEPS = 12  # student minibatches of 25b's graph-against-eager check


def option(args: list, name: str, default) -> int:
    """The integer value of ``name`` in an argument list (its last), else ``default``."""
    at = [i for i, a in enumerate(args) if a == name]
    return int(args[at[-1] + 1]) if at else default


def finetune_keyed_launches(args: list, init: int) -> dict:
    """The keyed-draw kernels' launches of ``finetune_canonical.main(args)``
    (default ``FTConfig``): the init's ``init``; the envs' reset; each
    update's draws (``split(key, 4)``, the pool's 2B keys and their reset,
    the Gumbel uniforms of T planes, ``split(k_perm, E)`` and per epoch a
    split and a bits draw each round of ``permutation``); each evaluation's
    reset (the start, every ``--eval-every`` update past the warm-up, the
    final one)."""
    from gym_craftingworld_tpu_torch.ops import threefry as tf
    from gym_craftingworld_tpu_torch.tools.finetune_canonical import FTConfig

    ft, envs = FTConfig(), option(args, "--envs", 2048)
    updates, warmup = option(args, "--updates", 120), option(args, "--warmup", 15)
    every = option(args, "--eval-every", 15)
    evals = 2 + sum(1 for u in range(1, updates + 1) if u % every == 0 and u > warmup)
    update = 4 + 2 * ft.update_epochs * tf.shuffle_rounds(ft.rollout_steps * envs)
    return keyed_counts(1 + updates + evals, init + 1 + updates * update + evals)


def distill_keyed_launches(args: list, max_steps: int, init: int, chunk: int = 2048) -> dict:
    """The keyed-draw kernels' launches of ``pixel_distill.main(args)``: the
    two inits' ``init``; each round's collect, a chunk: its envs' split and
    reset and 4 counter launches of exploration (``dagger.explore_draws``);
    each epoch's flips, 4 (``flip_bits``); each evaluation (a round's and the
    final), a chunk: the argmax's split and reset, the sample's split, reset,
    ``max_steps`` splits of its chain and one draw of Gumbel uniforms."""
    rounds = option(args, "--rounds", 6)
    chunks = lambda n: -(-n // chunk)
    collects = chunks(option(args, "--episodes0", 24576)) + (rounds - 1) * chunks(
        option(args, "--episodes", 8192))
    epochs = option(args, "--epochs0", 10) + (rounds - 1) * option(args, "--epochs", 4)
    evals = rounds * chunks(option(args, "--eval-episodes", 2048)) + chunks(
        option(args, "--final-eval-episodes", 8192))
    return keyed_counts(collects + 2 * evals, init + 5 * collects + 4 * epochs
                 + evals * (1 + 1 + max_steps + 1))


def distill_phase(cw, dev, tag):
    """Phase 25: ``finetune_canonical`` (25a) and ``pixel_distill`` (25b)
    end to end at a small size, ``entry()`` on the card against the CPU (25c)
    and the ``record_episode`` example (25d)."""
    import copy
    import tempfile

    from gym_craftingworld_tpu_torch import entry as entry_mod
    from gym_craftingworld_tpu_torch.examples import record_episode
    from gym_craftingworld_tpu_torch.models.cnn import student_images
    from gym_craftingworld_tpu_torch.models.grid_policy import (init_grid_policy,
                                                                snap_columns_from_state)
    from gym_craftingworld_tpu_torch.tools import finetune_canonical as ftc
    from gym_craftingworld_tpu_torch.tools import pixel_distill as pd

    t_phase = time.perf_counter()
    seconds = {}
    cfg = cw.ray_config()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- 25a. the fine-tune, small ----------------------------------------------
        widths = (option(FT_ARGS, "--channels", 96), option(FT_ARGS, "--hidden", 1536))
        want = finetune_keyed_launches(FT_ARGS, 2 * drawn_params(
            lambda k: init_grid_policy(k, cfg, *widths)))
        wrappers, plains = zero_counters()
        mark = keyed_mark()
        t0 = time.perf_counter()
        ft = ftc.main(FT_ARGS + ["--device", dev.type, "--out", str(tmp / "ft.json"),
                                 "--save", str(tmp / "ft")])
        torch.cuda.synchronize()
        seconds["finetune_canonical"] = time.perf_counter() - t0
        no_kernel_ran(wrappers, plains, "phase 25a's fine-tune")
        keyed_since(mark, f"{tag} phase 25a's fine-tune", want)
        doc = json.loads((tmp / "ft.json").read_text())
        jax_keys = set(json.loads((HERE / "docs" / "canonical_finetune.json").read_text()))
        check(set(doc) == jax_keys | {"card"} and doc == ft["doc"],
              f"phase 25a: the JSON holds the JAX record's keys and the card: {sorted(doc)}")
        check(ft["policy_head_after_warmup"] is True,
              "phase 25a: the value-only update leaves the policy head bit-identical")
        curve = doc["curve"]
        beat = [c for c in curve[1:] if c["eval"] > max([curve[0]["eval"]] + [
            d["eval"] for d in curve[1:curve.index(c)]])]
        want = f"u{beat[-1]['update']}" if beat else "start"
        check(doc["best_checkpoint"] == want,
              f"phase 25a: the best checkpoint is {doc['best_checkpoint']}, want {want}: {curve}")
        if want == "start":
            start = init_grid_policy(prng_key(0, device=dev), cfg,
                                     int(FT_ARGS[3]), int(FT_ARGS[5]))
            got = ft["model"].state_dict()
            check(all(torch.equal(v, got[k]) for k, v in start.state_dict().items()),
                  "phase 25a: nothing beat the start, so the start's parameters ship")

        # ---- 25b. the distillation, small, and the frames from columns ------------------
        teacher = (option(DISTILL_ARGS, "--teacher-channels", 96),
                   option(DISTILL_ARGS, "--teacher-hidden", 1536))
        student = dict(channels=option(DISTILL_ARGS, "--channels", 96),
                       hidden=option(DISTILL_ARGS, "--hidden", 1536),
                       stem=option(DISTILL_ARGS, "--stem", 64))
        want = distill_keyed_launches(DISTILL_ARGS, cfg.max_steps, 2 * (
            drawn_params(lambda k: init_grid_policy(k, cfg, *teacher))
            + drawn_params(lambda k: pd.init_student(k, cfg, **student))))
        wrappers, plains = zero_counters()
        mark = keyed_mark()
        t0 = time.perf_counter()
        dist = pd.main(DISTILL_ARGS + ["--device", dev.type, "--out", str(tmp / "px.json"),
                                       "--save", str(tmp / "px")])
        torch.cuda.synchronize()
        seconds["pixel_distill"] = time.perf_counter() - t0
        keyed_since(mark, f"{tag} phase 25b's distillation", want)
        section = json.loads((tmp / "px.json").read_text())["distilled_student"]
        jax_section = json.loads((HERE / "docs" / "pixel_canonical.json").read_text())[
            "distilled_student"]
        check(set(section) == set(jax_section) | {"card"} and section == dist["section"],
              f"phase 25b: the section holds the JAX record's keys and the card: "
              f"{sorted(section)}")
        r0, r1 = dist["rounds"]
        check(r0["core_rows"] == r0["collected"] > 0
              and r1["appended"] == r1["relabelled"] == r1["collected"] == r1["student_rows"]
              and r1["mixture_rows"] == r1["core_rows"] * max(1, round(
                  r1["student_rows"] / r1["core_rows"])) + r1["student_rows"],
              f"phase 25b: round 1 appended its relabelled rows: {dist['rounds']}")
        gen = torch.Generator(device=dev).manual_seed(5)
        state = cw.reset_from_seed(cfg, 5, 256, device=dev)
        for _ in range(48):
            state, _ = cw.step(cfg, state, torch.randint(0, 6, (256,), generator=gen,
                                                         device=dev))
        cols = {**snap_columns_from_state(cfg, state), **pd.goal_columns_from_state(cfg, state)}
        init = torch.where(state.init_objects == 9, 0, state.init_objects)
        want_img = student_images(cfg, state.objects, state.agent, state.holding,
                                  state.goal_objects, state.goal_agent, init, state.init_agent)
        got_img = pd.images_from_cols(cfg, cols)
        check(got_img.dtype == torch.uint8 and torch.equal(got_img, want_img),
              "phase 25b: images_from_cols equals student_images on a live batch, byte for byte")
        holding = int((state.holding > 0).sum())
        # the student's epoch from its CUDA graph against the same epoch launched
        # minibatch by minibatch: the same kernels, so the same bits
        data = {k: v for k, v in cols.items() if k in pd._IMG_COLS}
        data["label"] = torch.randint(0, 6, (256,), generator=gen, device=dev).to(torch.int8)
        data["tlogits"] = torch.randn((256, 6), generator=gen, device=dev).to(torch.float16)
        data["soft"] = (torch.rand(256, generator=gen, device=dev) < 0.5).to(torch.float16)
        perm = torch.randint(0, 256, (GRAPH_STEPS * 64,), generator=gen, device=dev)
        fh, fw = pd.flip_bits(prng_key(5, device=dev), GRAPH_STEPS, 64)
        runs = []
        for graph in (False, True):
            student = pd.init_student(prng_key(9, device=dev), cfg, 16, 64, 8)
            opt, loss, acc = pd.student_epoch(cfg, student, pd.init_opt(student), data, perm, 64,
                                              fh, fw, graph=graph)
            runs.append((student, opt, float(loss), float(acc)))
        (s0, o0, l0, a0), (s1, o1, l1, a1) = runs
        check((l0, a0) == (l1, a1) and int(o0.count) == int(o1.count) == GRAPH_STEPS
              and all(torch.equal(p, q) for p, q in zip(s0.parameters(), s1.parameters()))
              and all(torch.equal(p, q) for p, q in zip(o0.mu + o0.nu, o1.mu + o1.nu)),
              f"phase 25b: {GRAPH_STEPS} student minibatches from the CUDA graph equal them "
              f"launched one by one, bit for bit (loss {l1:.6f} / {l0:.6f})")
        no_kernel_ran(wrappers, plains, "phase 25b's distillation")

        # ---- 25c. entry() on the card against the CPU --------------------------------------
        wrappers, plains = zero_counters()
        fn, (model, st) = entry_mod.entry(dev.type)
        with torch.no_grad():
            card = fn(model, st)
            host = fn(copy.deepcopy(model).cpu(), dataclasses.replace(
                st, **{f.name: getattr(st, f.name).cpu() for f in dataclasses.fields(st)}))
        check([tuple(x.shape) for x in card] == [(64, 6), (64,)],
              f"phase 25c: entry() gives logits [64, 6] and values [64]")
        entry_err = card_vs_cpu("phase 25c entry() forward", card, host)
        no_kernel_ran(wrappers, plains, "phase 25c's entry()")

        # ---- 25d. the record_episode example ---------------------------------------------------
        wrappers, plains = zero_counters()
        here = os.getcwd()
        t0 = time.perf_counter()
        try:
            os.chdir(tmp)
            where = Path(record_episode.main(["--device", dev.type]))
            gifs = sorted((tmp / where).glob("*.gif"))
        finally:
            os.chdir(here)
        seconds["record_episode"] = time.perf_counter() - t0
        check(len(gifs) == 1 and gifs[0].stat().st_size > 0,
              f"phase 25d: record_episode wrote one GIF: {gifs}")
        gif = f"{gifs[0].name} ({gifs[0].stat().st_size} bytes)"
        no_kernel_ran(wrappers, plains, "phase 25d's example")
    ft_first = [c for c in curve if c["update"] > 1]
    print(f"{tag} phase 25a finetune_canonical {' '.join(FT_ARGS)} on 21x21: updates "
          + "; ".join(f"{u['update']}{' (value-only)' if u['value_only'] else ''} loss "
                      f"{u['loss']:.4f} v_loss {u['v_loss']:.4f} entropy {u['entropy']:.4f} "
                      f"train sr {u['success_rate']:.4f}" for u in ft["updates"])
          + f"; evals {[c['eval'] for c in curve]}, shipped {doc['best_checkpoint']}; policy "
          f"head kept through the value-only update: {ft['policy_head_after_warmup']}; "
          f"joint evals {len(ft_first)}")
    print(f"{tag} phase 25b pixel_distill {' '.join(DISTILL_ARGS)} on 21x21: rounds "
          + "; ".join(json.dumps({k: (round(v, 1) if isinstance(v, float) else v)
                                  for k, v in r.items()}) for r in dist["rounds"])
          + f"; final {section['final_eval']['success_rate']:.4f} argmax / "
          f"{section['final_eval_sampled']['success_rate']:.4f} sampled; images_from_cols = "
          f"student_images over 256 live worlds ({holding} holding); {GRAPH_STEPS} student "
          f"minibatches from the CUDA graph = launched one by one, bit for bit")
    print(f"{tag} phase 25c entry() forward on the card vs the CPU: max |diff| {entry_err:.3e}; "
          f"phase 25d record_episode wrote {gif}; "
          f"seconds (host clock) {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
          f"phase 25 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the last entry points (phase 26)
# ---------------------------------------------------------------------------

BENCH_BAND = (0.95, 1.05)  # bench's value over the direct median of the same entry point
# the parts of one fast-PPO update over the whole (train_step_fast also draws
# the uniforms and permutations and takes the last value and the metrics)
FAST_PROF_BAND = (0.80, 1.15)
# policyonly + steponly over the whole collect (host-paced: their ops a step,
# 47 + 35 of 147, without the features and the stores)
COLLECT_PROF_BAND = (0.35, 0.85)
PROF_K = 3
OBS_STEPS = 256  # 26b's T: a render every step
TOOLS_BUDGET_S = 60.0
CPV_DEBUG_ARGS = ["--episodes-per-task", "2", "--epochs", "1", "--hidden", "16", "--episodes",
                  "2", "--verbose", "0", "--pairs", "MakeBread+ChopTree", "GoToHouse+MoveAxe"]
PROBE_ARGS = ["all", "--seeds", "1"]


def ppo_prof_keyed_launches(ppo, B: int, runs: int, steps: int, init: int) -> dict:
    """The keyed-draw kernels' launches of ``ppo_prof.main`` (``runs`` runs a
    stage): the init's ``init`` and three resets; the collect's noise (T
    splits and the uniforms); a ``train_step`` (``split(key, 3)``, the
    chain's T splits and uniforms, a reset kernel a collect step,
    ``split(k_perm, E)`` and per epoch a split and a bits draw each round of
    ``permutation``); a collect (a reset kernel a step); the resets stage (a
    split and a reset a step), the grid steps (a split and a ``randint`` a
    step) and the update epoch (one ``permutation``)."""
    from gym_craftingworld_tpu_torch.ops import threefry as tf

    T, perm = ppo.rollout_steps, 2 * tf.shuffle_rounds(ppo.rollout_steps * B)
    train = (1 + T + 1 + 1 + ppo.update_epochs * perm, T)
    return keyed_counts(3 + runs * (train[1] + T + steps),
                 init + 3 + (T + 1) + runs * (train[0] + steps + 2 * steps + perm))


def tool_lines(what: str, fn, card: str):
    """``fn()``'s result and its printed JSON lines: its standard output is
    captured, printed again, and every line that opens a JSON object must
    parse and carry ``card``."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    text = buf.getvalue()
    print(text, end="")
    lines = [json.loads(l) for l in text.splitlines() if l.startswith("{")]
    check(lines, f"phase 26 {what} printed a JSON line")
    for line in lines:
        check(card in (line.get("card"), line.get("device")),
              f"phase 26 {what}: every JSON line carries the card's name: {line}")
    return out, lines


def tools_phase(cw, dev, tag, card):
    """Phase 26: the six last entry points through their ``main`` on the card."""
    import tempfile

    from gym_craftingworld_tpu_torch.core import slots as sm
    from gym_craftingworld_tpu_torch.ops import packed_fused as pf
    from gym_craftingworld_tpu_torch.tools import (bench, collect_prof, cpv_debug, expert_probe,
                                                   fast_ppo_prof, ppo_prof)

    t_phase = time.perf_counter()
    seconds = {}

    def bench_env(**env):
        for k in ("BENCH_LAYOUT", "BENCH_ENVS", "BENCH_STEPS", "BENCH_ITERS"):
            os.environ.pop(k, None)
        os.environ.update({k: str(v) for k, v in env.items()})

    # ---- 26a. bench at packed_fused, against the entry point timed directly -----------
    B, iters = B_MAIN, 5
    T = bench.default_steps("packed_fused")
    wrappers, plains = zero_counters()
    mark = keyed_mark()
    t0 = time.perf_counter()
    try:
        bench_env(BENCH_LAYOUT="packed_fused", BENCH_ENVS=B, BENCH_ITERS=iters)
        line, _ = tool_lines("bench packed_fused", lambda: bench.main(["--device", dev.type]), card)
    finally:
        bench_env()
    seconds["bench packed_fused"] = time.perf_counter() - t0
    # the envs' reset; the warm-up's seed randint(PRNGKey(0)), each run's
    # fold_in(PRNGKey(0), i) and its seed
    keyed_since(mark, f"{tag} phase 26a", keyed_counts(1, 1 + 1 + 2 * iters))
    launches = {k: w.launches for k, w in wrappers.items()}
    calls = {f.__name__: f.calls for f in plains}
    want = {k: 0 for k in launches}
    want["packed_bench"] = 1 + iters
    check(launches == want and not any(calls.values()),
          f"phase 26a: bench launched the bench kernel warm-up + runs times and nothing else: "
          f"{launches}, plain {calls}")
    check(line["metric"] == f"env_steps_per_s_per_chip_{B // 1024}k_envs" and line["runs"] == iters
          and line["timing"] == ("cuda_events" if dev.type == "cuda" else "host_clock"),
          f"phase 26a: bench.py's metric and keys: {line}")
    cfg = cw.ray_config()
    slots = sm.from_env_state(cw.reset_from_seed(cfg, 0, B, device=dev))
    direct = B * T / (time_ms(lambda: pf.fused_rollout_packed_bench(cfg, slots, 7, T)) / 1e3)
    ratio = line["value"] / direct
    print(f"{tag} phase 26a bench packed_fused B={B} T={T}: {line['value']:.5e} env-steps/s "
          f"(median of {iters}, spread {line['spread_pct']}%), direct median of the entry point "
          f"{direct:.5e}: ratio {ratio:.4f} (band {BENCH_BAND[0]}-{BENCH_BAND[1]}); launches "
          f"{launches}")
    check(BENCH_BAND[0] <= ratio <= BENCH_BAND[1],
          f"phase 26a: bench's value is {ratio:.4f} x the direct median")

    # ---- 26b. bench at obs_ray ------------------------------------------------------
    wrappers, plains = zero_counters()
    mark = keyed_mark()
    t0 = time.perf_counter()
    try:
        bench_env(BENCH_LAYOUT="obs_ray", BENCH_ENVS=B, BENCH_STEPS=OBS_STEPS, BENCH_ITERS=3)
        obs, _ = tool_lines("bench obs_ray", lambda: bench.main(["--device", dev.type]), card)
    finally:
        bench_env()
    seconds["bench obs_ray"] = time.perf_counter() - t0
    no_kernel_ran(wrappers, plains, "phase 26b's bench at obs_ray")
    # the envs' reset; the warm-up's actions, each run's fold_in and actions
    keyed_since(mark, f"{tag} phase 26b", keyed_counts(1, 1 + 1 + 2 * 3))
    check(obs["metric"] == f"env_steps_with_ray_obs_per_s_per_chip_{B // 1024}k_envs",
          f"phase 26b: bench.py's metric: {obs['metric']}")
    print(f"{tag} phase 26b bench obs_ray B={B} T={OBS_STEPS}: {obs['value']:.5e} env-steps/s "
          f"(median of 3, spread {obs['spread_pct']}%)")

    # ---- 26c. the fast-PPO profilers, counted by phase -----------------------------
    def fast_counts(line):  # rows 4, 2 and 6: a pool, T steps, epochs x minibatches
        T, grads = line["rollout_steps"], line.get("epochs", 0) * line.get("minibatches", 0)
        row = {"pool": {"pool": 1.0}, "collect": {"packed_actions": float(T)}, "gae": {},
               "update": {"ppo_grads_indexed": float(grads)}}
        return {**row, "full": {**row["pool"], **row["collect"], **row["update"]}}

    def collect_counts(line):
        return {k: ({} if k == "policyonly" else {"packed_actions": float(line["rollout_steps"])})
                for k in ("full", "nostore", "noreset", "nosample", "policyonly", "steponly")}

    ms = lambda x: "n/a" if x is None else f"{x:.2f}"
    for name, tool, counts, band in (("fast_ppo_prof", fast_ppo_prof, fast_counts, FAST_PROF_BAND),
                                     ("collect_prof", collect_prof, collect_counts,
                                      COLLECT_PROF_BAND)):
        wrappers, plains = zero_counters()
        t0 = time.perf_counter()
        lines, _ = tool_lines(name, lambda: tool.main([str(B), str(PROF_K), "--device", dev.type]),
                              card)
        seconds[name] = time.perf_counter() - t0
        phases = {l["phase"]: l for l in lines}
        want = counts(lines[0])
        for k, n in want.items():
            check(phases[k]["launches"] == n and phases[k]["plain_calls"] == {},
                  f"phase 26c {name} {k}: launches a run {phases[k]['launches']}, want {n}; "
                  f"plain {phases[k]['plain_calls']}")
        calls = {f.__name__: f.calls for f in plains}
        check(not any(calls.values()), f"phase 26c {name}: no plain version ran: {calls}")
        ratio = phases["sum"]["sum_over_full"]
        print(f"{tag} phase 26c {name} B={B} K={PROF_K}: " + ", ".join(
            f"{k} {phases[k]['ms']:.2f} ms (device {ms(phases[k]['device_ms'])} ms, "
            f"{phases[k]['device_records_lost']} records lost)" for k in want)
              + f"; {'+'.join(phases['sum']['parts'])} = {ratio:.4f} x full (band "
              f"{band[0]}-{band[1]}); launches "
              f"{ {k: w.launches for k, w in wrappers.items() if w.launches} }")
        check(band[0] <= ratio <= band[1], f"phase 26c {name}: the parts are {ratio:.4f} x full")

    # ---- 26d. ppo_prof at its default B ---------------------------------------------
    ppo = ppo_prof.P.PPOConfig()
    want = ppo_prof_keyed_launches(ppo, int(os.environ.get("B", 4096)), 1 + 3, ppo_prof.STAGE_STEPS,
                                   2 * drawn_params(lambda k: ppo_prof.P.init_train_state(
                                       k, cw.flat_config(), ppo)))
    wrappers, plains = zero_counters()
    mark = keyed_mark()
    t0 = time.perf_counter()
    stages, _ = tool_lines("ppo_prof", lambda: ppo_prof.main(["--device", dev.type,
                                                               "--reps", "3"]), card)
    seconds["ppo_prof"] = time.perf_counter() - t0
    no_kernel_ran(wrappers, plains, "phase 26d's ppo_prof")
    keyed_since(mark, f"{tag} phase 26d", want)
    check([l["stage"] for l in stages] == ["train_step", "collect", "reset", "grid_step",
                                           "policy_forward", "update_epoch"],
          f"phase 26d: ppo_prof's stages {[l['stage'] for l in stages]}")
    print(f"{tag} phase 26d ppo_prof B={stages[0]['envs']}: " + ", ".join(
        f"{l['stage']} {l['ms']:.1f} ms" for l in stages)
          + f"; {stages[0]['env_steps_per_s']:.4e} env-steps/s")

    # ---- 26e. cpv_debug and expert_probe, smallest -------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        argv = CPV_DEBUG_ARGS + ["--device", dev.type, "--params", str(Path(tmp) / "p.pt")]
        wrappers, plains = zero_counters()
        t0 = time.perf_counter()
        first, _ = tool_lines("cpv_debug", lambda: cpv_debug.main(argv), card)
        again, _ = tool_lines("cpv_debug reloaded", lambda: cpv_debug.main(argv), card)
        seconds["cpv_debug"] = time.perf_counter() - t0
    no_kernel_ran(wrappers, plains, "phase 26e's cpv_debug")
    check(first == again and all(sum(v.values()) == 2 for v in first["pairs"].values()),
          f"phase 26e: cpv_debug classifies every episode, the same after a reload: {first}")
    wrappers, plains = zero_counters()
    t0 = time.perf_counter()
    fails, probe = tool_lines("expert_probe", lambda: expert_probe.main(PROBE_ARGS + [
        "--device", dev.type]), card)
    seconds["expert_probe"] = time.perf_counter() - t0
    no_kernel_ran(wrappers, plains, "phase 26e's expert_probe")
    check(probe[-1]["episodes"] == 11 and probe[-1]["failures"] == [list(f) for f in fails],
          f"phase 26e: expert_probe ran 11 episodes: {probe[-1]}")
    took = time.perf_counter() - t_phase
    print(f"{tag} phase 26e cpv_debug pairs {json.dumps(first['pairs'])}; expert_probe "
          f"{' '.join(PROBE_ARGS)}: {len(fails)} failures of 11; seconds (host clock) "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}; phase 26 took {took:.1f} s")
    check(took <= TOOLS_BUDGET_S, f"phase 26 took {took:.1f} s, budget {TOOLS_BUDGET_S} s")


# ---------------------------------------------------------------------------
# the keyed draws (phase 27)
# ---------------------------------------------------------------------------

KEYED_SOURCE = "gym_craftingworld_tpu_torch/csrc/keyed_draws.cu"
KEYED_DIGESTS = "gym_craftingworld_tpu_torch/tools/records/keyed_digests.json"
# phase 27d: the card's erfinv (the normal's bound, tests/test_torch_threefry.py)
# and cuSOLVER's QR of the GRU's 512 x 512 recurrent kernels against the CPU's
# on the same uniforms; measured on an H100: max 4 ulps, 3.8e-6
INIT_ULPS = 128
INIT_ORTHO_ABS = 2e-5
CW_KEYED_CELLS = 128  # keyed_draws.cu: a reset block's cells
KEYED_POOL = 256  # pool size of 27a's pool-mode check
# The keyed kernels' bounds are the two-rate issue bound of the SASS each warp
# issues (``warps_bound_ms``) at the launches that 27c times. Source lines
# whose branches those launches decide, for ``sass_under``: the counter
# kernel's columns in range, 4 a thread (c < width, j < n), and the plane
# key's derivation when the planes are split from a parent; the reset
# kernel's mode (a fresh reset) and cells, in a block's first warp the env's
# subkeys (lanes 0-3) and goal keys (lanes 0-6, lane 6 one more), and in the
# last thread of an env's first block its task draws (stacked tasks; one
# trip of each loop, the least there is).
COUNTER_LINES, DERIVE_LINE = r"c >= a\.width|j < n\)", r"a\.derive"
CELL_LINES = (r"mode == CW_KEYED_(WORLD|TASKS)\)|j < n && mode"
              r"|mode != CW_KEYED_(POOL|WORLD)\)")
KEY_LINES = r"t < 4\)|t < CW_GOAL_ROWS\)|t < 6 \?"
TASK_LINES = r"t != blockDim\.x - 1\) return|stacking \?|round < rounds|i < n_sel"
NO_LINE = r"(?!)"
# SASS instructions of one Threefry-2x32 at the least (20 rounds of an add,
# a rotate and an xor): a path that counts fewer for its draws missed them
THREEFRY_FLOOR = 60


def counter_bound(mode: int, warps: int, threefry: int, derive: bool, nbytes: float):
    """(bound_ms, bound_by, path) of a counter-kernel launch of ``mode``
    (``CW_COUNTER_*``) whose ``warps`` warps each make one trip of its loop,
    each thread ``threefry`` Threefry calls, moving ``nbytes``."""
    p = sass_under(f"cw_keyed_counter_kernelILi{mode}E",
                   COUNTER_LINES + (f"|{DERIVE_LINE}" if derive else ""))
    check(p.pro + p.body + p.epi >= THREEFRY_FLOOR * threefry,
          f"the counter kernel's path ({p.pro}, {p.body}, {p.epi}) holds its {threefry} "
          f"Threefry calls of at least {THREEFRY_FLOOR} instructions")
    return (*bound(warps_bound_ms([(warps, p, 1)]), nbytes), p)


def reset_bound(B: int, n: int, nbytes: float):
    """(bound_ms, bound_by, {kind: (warps, path)}) of a fresh reset of B envs
    of n cells by the reset kernel: blocks of 128 cells (an env's chunk) of
    four kinds of warp, the first of a block, the last of an env's first
    block, the others with cells, and those past the env's last cell."""
    threads = CW_KEYED_CELLS if n >= CW_KEYED_CELLS else -(-n // 32) * 32
    chunks, per_block = -(-n // threads), threads // 32
    check(per_block >= 2, f"a block of {threads} threads holds a first and a last warp")
    with_cells = sum(y * threads + w * 32 < n for y in range(chunks) for w in range(per_block))
    name = "cw_keyed_reset_kernel"
    cells = sass_under(name, CELL_LINES, loop=False)
    kinds = {"first": (chunks, sass_under(name, f"{CELL_LINES}|{KEY_LINES}", loop=False)),
             "tasks": (1, sass_under(name, f"{CELL_LINES}|{TASK_LINES}", loop=False)),
             "cells": (with_cells - chunks - 1, cells),
             "idle": (chunks * per_block - with_cells, sass_under(name, NO_LINE, loop=False))}
    issued = lambda k: kinds[k][1].pro
    check(issued("cells") >= 8 * THREEFRY_FLOOR and issued("first") - issued("cells")
          >= 3 * THREEFRY_FLOOR and issued("tasks") - issued("cells") >= 2 * THREEFRY_FLOOR,
          f"the reset kernel's paths hold a cell's 8 Threefry calls, a block's 3 key "
          f"derivations and the task draws' 2: {({k: issued(k) for k in kinds})}")
    ms = warps_bound_ms([(B * w, p, 0) for w, p in kinds.values()])
    return (*bound(ms, nbytes), kinds)


def path_line(p) -> str:
    return ", ".join(f"{k} {p.on_pipe(k, 1)}" for k in PIPES)


def counter_cases(B, key, planes, half):
    """(label, args, kwargs) of ``counter_draws`` over every mode: one key,
    P plane keys given ([P, 2]) or split from a parent (``derive``), whole
    rows and a rank's column box, widths a multiple of 4 and ragged."""
    from gym_craftingworld_tpu_torch.ops import threefry as tf

    T, n_pool = 64, 2 * B
    c0, w = half.start, half.stop - half.start
    return [
        ("split of B keys", (key, "split", 1, B, 0, B), {}),
        ("split, rank 1 of 2's keys", (key, "split", 1, B, c0, w), {}),
        ("split of 4 from 64 derived planes", (key, "split", 1, 4, 0, 4), {"derive": T}),
        ("randint (64, B)", (key, "randint", T, B, 0, B, 0, 6), {}),
        ("randint (64, B) rank 1 of 2", (key, "randint", T, B, c0, w, 0, 6), {}),
        ("randint (2,) in [0, 2**31 - 1)", (key, "randint", 1, 2, 0, 2, 0, 2**31 - 1), {}),
        ("randint (7, 1001) in [-3, 70000)", (key, "randint", 7, 1001, 0, 1001, -3, 70000), {}),
        ("randint of 64 given planes (6, B)", (planes, "randint", 6, B, 0, B, 0, 6), {}),
        ("bits of 512 (an epoch permutation's keys)", (key, "bits", 1, 512, 0, 512), {}),
        ("bits of 262,144", (key, "bits", 1, 262144, 0, 262144), {}),
        ("uniform [1e-7, 1) of 64 derived planes (6, B)",
         (key, "uniform", 6, B, 0, B, 1e-7, 1.0), {"derive": T}),
        ("uniform [1e-7, 1) of 64 derived planes (6, B), rank 1 of 2",
         (key, "uniform", 6, B, c0, w, 1e-7, 1.0), {"derive": T}),
        ("uniform [tiny, 1) of 64 given planes (1, 6B), rank 1 of 2's envs",
         (planes, "uniform", 1, 6 * B, 6 * c0, 6 * w, tf.TINY, 1.0), {}),
        ("uniform [0, 1) (2B, 441): fresh_packed_batch's scores, ragged rows",
         (key, "uniform", n_pool, 441, 0, 441), {}),
        ("uniform [nextafter(-1, 0), 1) (1, 196,608): normal's",
         (key, "uniform", 1, 196608, 0, 196608, tf.NORMAL_LOW, 1.0), {}),
        ("uniform [-2.5, 3.7) (3, 1003) ragged", (key, "uniform", 3, 1003, 5, 998, -2.5, 3.7), {}),
    ]


def keys_phase(cw, dev, tag):
    """Phase 27: the keyed draws. (a) both kernels against their plain
    versions bit for bit; (b) the keyed main path, counted, against the JAX
    package's digests, then (d) the inits, (e) the imitation draws and (f)
    the ladder's random rollouts and the tools' draws against theirs; (c)
    times by CUDA events. Returns the two kernels' rows of the
    ``{"kernels": ...}`` line."""
    import hashlib

    import numpy as np

    from gym_craftingworld_tpu_torch import api, interop
    from gym_craftingworld_tpu_torch.core.rollout import rollout
    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
    from gym_craftingworld_tpu_torch.train import fast_ppo as fp
    from gym_craftingworld_tpu_torch.utils.profiling import graph_ms

    t_phase = time.perf_counter()
    ray, flat = cw.ray_config(), cw.flat_config()
    sel = cw.flat_config(selected_task_indices=(1, 4, 7), number_of_tasks=2)
    big = cw.ray_config(height=181, width=181)

    # ---- 27a. kernels against plain, bit for bit -----------------------------------
    worst = 0.0

    def same_draws(got, want, what):
        nonlocal worst
        for f, g, w in zip(kd.ResetDraws._fields, got, want):
            check((g is None) == (w is None), f"{what}: {f} drawn by both or neither")
            if g is None:
                continue
            check(g.dtype == w.dtype and g.shape == w.shape, f"{what}: {f} dtype and shape")
            worst = max(worst, float((g.double() - w.double()).abs().max()))
            check(torch.equal(g, w), f"{what}: {f} bit for bit, tolerance 0")

    for label, cfg, B, mode, pool in (("21x21 fresh", ray, B_MAIN, "fresh", 0),
                                      ("21x21 pool", ray, B_MAIN, "pool", KEYED_POOL),
                                      ("8x8 fresh", flat, B_SMALL, "fresh", 0),
                                      ("8x8 tasks (1, 4, 7) of 2, pool", sel, B_SMALL, "pool", 5),
                                      ("181x181 fresh", big, 256, "fresh", 0),
                                      ("21x21 world (generate_pool)", ray, 2 * B_MAIN, "world", 0)):
        key = prng_key(27 + B).to(dev)
        keys = kd.counter_draws_kernel(key, "split", 1, B, 0, B)[0]
        check(torch.equal(keys, kd.counter_draws_plain(key, "split", 1, B, 0, B)[0]),
              f"counter kernel split of {B} keys == plain, tolerance 0")
        same_draws(kd.reset_draws_kernel(cfg, keys, mode, pool),
                   kd.reset_draws_plain(cfg, keys, mode, pool), f"reset kernel {label} B={B}")
        print(f"{tag} keyed reset kernel == plain: {label} B={B} n={cfg.n_cells}, every draw "
              f"bit for bit; split kernel == plain")
    for cfg, B in ((ray, 2 * B_MAIN), (sel, B_SMALL)):  # fresh_packed_batch's task draws
        keys = kd.split_keys(prng_key(28).to(dev), B)
        same_draws(kd.reset_draws_kernel(cfg, keys, "tasks"),
                   kd.reset_draws_plain(cfg, keys, "tasks"), f"reset kernel tasks B={B}")
    print(f"{tag} keyed reset kernel == plain: tasks mode (sample_desired of each key) at "
          f"{2 * B_MAIN} keys on 21x21 and {B_SMALL} of tasks (1, 4, 7), bit for bit")
    key = prng_key(3).to(dev)
    planes = kd.split_keys(prng_key(4).to(dev), 64)  # 64 given plane keys, as train/ppo.py's chain
    half = slice(B_MAIN // 2, B_MAIN)
    for label, args, kw in counter_cases(B_MAIN, key, planes, half):
        got = kd.counter_draws_kernel(*args, **kw)
        want = kd.counter_draws_plain(*args, **kw)
        check(got.dtype == want.dtype and got.shape == want.shape, f"counter {label}: dtype, shape")
        bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
        worst = max(worst, float((got.double() - want.double()).abs().max()))
        check(torch.equal(bits(got), bits(want)), f"counter kernel {label} == plain, tolerance 0")
        print(f"{tag} keyed counter kernel == plain, bit for bit: {label} "
              f"{list(got.shape)} {got.dtype}")
    got = kd.randint_cols(key, (64, B_MAIN), 0, 6, device=dev)
    freq = torch.bincount(got.reshape(-1).to(torch.int64), minlength=6).double() / got.numel()
    u = kd.uniform_cols(key, (6, B_MAIN), minval=1e-7, planes=64)
    print(f"{tag} randint (64, {B_MAIN}) in [0, 6): max |freq - 1/6| "
          f"{float((freq - 1 / 6).abs().max()):.2e}; uniform [1e-7, 1) of 64 planes: min "
          f"{float(u.min()):.3e}, max {float(u.max()):.7f}, mean {float(u.double().mean()):.5f}")
    check(float(u.min()) >= 1e-7 and float(u.max()) < 1.0, "uniforms on [1e-7, 1)")

    # ---- 27b. the keyed main path, counted, against JAX's digests ------------------
    digests = json.loads((HERE / KEYED_DIGESTS).read_text())
    keyed = keyed_wrappers()
    for w in keyed.values():
        w.launches = 0
    plain_calls = kd.reset_draws_plain.calls, kd.counter_draws_plain.calls
    state = cw.reset_from_seed(ray, 0, 16384, device=dev)  # the digests' sizes
    cfg10 = cw.flat_config(max_steps=10)
    start = cw.reset_from_seed(cfg10, 0, 4096, device=dev)
    actions = kd.randint_cols(prng_key(3), (64, 4096), 0, 6, device=dev)
    rolled, out = rollout(cfg10, start, actions, auto_reset=True)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in keyed.items()}
    check(launches == {"keyed_reset": 2 + 64, "keyed_counter": 3},
          f"the keyed path launched the reset kernel 66 times and the counter kernel 3: {launches}")
    check((kd.reset_draws_plain.calls, kd.counter_draws_plain.calls) == plain_calls,
          "the keyed path ran no plain version")
    world_invariants(state, ray)
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    (reset_name, want_reset), (roll_name, want_roll) = list(digests.items())[:2]
    got_reset = {k: sha(v) for k, v in interop.env_state_to_numpy(state).items()}
    got_roll = {k: sha(v) for k, v in interop.env_state_to_numpy(rolled).items()}
    got_roll.update(reward=sha(out.reward.cpu().numpy()), done=sha(out.done.cpu().numpy()))
    for name, got, want in ((reset_name, got_reset, want_reset), (roll_name, got_roll, want_roll)):
        bad = sorted(k for k in want if got.get(k) != want[k])
        check(not bad and set(got) == set(want), f"{name} on the card == JAX's digests "
              f"({KEYED_DIGESTS}); fields that differ: {bad}")
    print(f"{tag} keyed main path: reset_from_seed(ray_config(), 0, 16384) and a T=64 "
          f"auto-reset rollout at 4,096 envs on 8x8 (max_steps 10, {int(out.done.sum())} "
          f"restarts) hash to JAX's digests, every field incl. rng; launches {launches}")
    del state, start, rolled, out
    keyed_init_phase(cw, dev, tag, digests["init"])
    keyed_imitation_phase(cw, dev, tag, digests["imitation"])
    keyed_ladder_phase(cw, dev, tag, digests["ladder"])

    # ---- 27c. times: one call, and a CUDA graph of 20 ------------------------------
    B, n = B_MAIN, ray.n_cells
    keys = kd.split_keys(prng_key(5), B, device=dev)
    reset_ms = dict(ms=time_ms(lambda: kd.reset_draws_kernel(ray, keys)),
                    device_ms=graph_ms(lambda: kd.reset_draws_kernel(ray, keys)),
                    plain_ms=time_ms(lambda: kd.reset_draws_plain(ray, keys)))
    n_sel = len(ray.selected_task_indices)
    *reset_b, kinds = reset_bound(B, n, B * (16 + 8 * n * 4 + 4 + 4 * n_sel + 16))
    print(f"{tag} keyed_reset B={B} on 21x21, SASS a warp issues by kind (warps an env: "
          f"path by pipe): " + "; ".join(f"{k} ({w}: {path_line(p)})"
                                         for k, (w, p) in kinds.items()))
    T = 64
    counter_ms = dict(ms=time_ms(lambda: kd.randint_cols(key, (T, B), 0, 6, device=dev)),
                      device_ms=graph_ms(lambda: kd.randint_cols(key, (T, B), 0, 6, device=dev)),
                      plain_ms=time_ms(lambda: kd.counter_draws_plain(key, "randint", T, B, 0, B,
                                                                      0, 6)))
    # a warp a 128 columns of a row; a thread's 4 columns of 2 draws and its
    # warp's subkey, and 4 bytes out an element
    warps = lambda rows: rows * -(-B // 1024) * 8
    *counter_b, counter_path = counter_bound(1, warps(T), 9, False, 16 + 4 * T * B)
    uniforms = lambda: kd.uniform_cols(key, (6, B), minval=1e-7, planes=T)
    uniform_ms = dict(ms=time_ms(uniforms), device_ms=graph_ms(uniforms),
                      plain_ms=time_ms(lambda: kd.counter_draws_plain(
                          key, "uniform", 6, B, 0, B, 1e-7, 1.0, derive=T)))
    # a thread's 4 draws and its plane's key
    *uniform_b, uniform_path = counter_bound(3, warps(6 * T), 5, True, 16 + 4 * T * 6 * B)
    split_ms = graph_ms(lambda: kd.split_keys(key, B, device=dev))
    for name, r, (b_ms, b_by), shape, path in (
            ("keyed_reset", reset_ms, reset_b, f"B={B} on 21x21", None),
            ("keyed_counter", counter_ms, counter_b, f"randint (T={T}, B={B})", counter_path),
            ("keyed_counter", uniform_ms, uniform_b,
             f"uniform [1e-7, 1) of {T} planes split from a key x (6, B={B}), fast PPO's",
             uniform_path)):
        print(f"{tag} {name} {shape}: kernel {r['ms']:.4f} ms (CUDA events, one call, median "
              f"of 5), device {r['device_ms']:.5f} ms (a CUDA graph of 20 launches, the "
              f"median of 5 replays), plain {r['plain_ms']:.4f} ms; bound {b_ms:.5f} ms "
              f"({b_by}; two-rate issue of the SASS path"
              + (f" a warp: {path_line(path)}" if path else "") + "), share "
              f"{b_ms / r['device_ms']:.1%} of the device time, {b_ms / r['ms']:.1%} of one call")
        check(b_ms <= 1.02 * r["device_ms"], f"{name} {shape} beat its bound: the SASS path "
              f"or the pipe classes are wrong")
    print(f"{tag} keyed_counter split of {B} keys: device {split_ms:.4f} ms")
    k_pool = prng_key(29).to(dev)  # fast PPO's pool of 2B worlds, as a step draws it
    pools = {"keyed fresh_packed_batch (a step over several ranks)":
             time_ms(lambda: fp._fresh_pool(ray, k_pool, 2 * B, fused=False)),
             "randint seeds and the pool kernel (one rank)":
             time_ms(lambda: fp._fresh_pool(ray, k_pool, 2 * B))}
    print(f"{tag} fast PPO's pool of {2 * B} worlds on 21x21, one call (CUDA events, median of "
          f"5): " + "; ".join(f"{k} {v:.4f} ms" for k, v in pools.items()))
    ms = time_ms(lambda: cw.reset_from_seed(ray, 6, B, device=dev))
    print(f"{tag} reset_from_seed B={B} 21x21: {ms:.4f} ms (CUDA events, median of 5; the "
          f"generator reset read 3.7172 ms in PR 7's phase 6)")
    env = api.CraftingWorldVectorEnv(B, obs_mode="onehot", seed=27, device=dev)
    env.reset()
    steps = kd.randint_cols(prng_key(27), (64, B), 0, 6, device=dev)

    def run():  # keeps no step's observations
        for a in steps:
            env.step(a)
    ms = time_ms(run, reps=3)
    print(f"{tag} vector env onehot B={B}: {B * 64 / (ms / 1e3):.4e} env-steps/s "
          f"({ms / 64:.4f} ms a step, 64 steps a run, median of 3, CUDA events)")
    del env
    env = api.make("craftingworld-v3", batch_size=B, seed=0, device=dev)
    env.reset()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        env.step(np.arange(B) % 6)
        times.append(time.perf_counter() - t0)
    print(f"{tag} façade craftingworld-v3 batch_size={B}: steps "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms (host clock, obs copied to the host)")
    del env
    print(f"{tag} phase 27 took {time.perf_counter() - t_phase:.1f} s")
    replaces = {"keyed_reset": "gym_craftingworld_tpu/core/reset.py:75",
                "keyed_counter": "gym_craftingworld_tpu/train/fast_ppo.py:300"}
    return [dict(name=name, route="cuda", source=KEYED_SOURCE, replaces=replaces[name],
                 launches=launches[name], max_abs_err=worst, ms=r["ms"], plain_ms=r["plain_ms"],
                 bound_ms=b[0], bound_by=b[1], library_ms=None)
            for name, r, b in (("keyed_reset", reset_ms, reset_b),
                               ("keyed_counter", uniform_ms, uniform_b))]


def init_families(cw) -> dict:
    """{digest name: init of a key} of the flax families at the main path's
    widths: phase 19's grid families, the distillation student, phase 18's
    three and the GRU of phase 20."""
    from gym_craftingworld_tpu_torch.models import actor_critic as ac
    from gym_craftingworld_tpu_torch.models import cnn, cpv, rnn, vit
    from gym_craftingworld_tpu_torch.models import grid_policy as gp

    canon = cw.EnvConfig(height=21, width=21, max_steps=300, stacking=True)
    return {
        "GridPolicy(96, 1536)": lambda k: gp.init_grid_policy(k, canon, 96, 1536),
        "CPVGridPolicy(96, 1024, 32)": lambda k: cpv.init_cpv_grid(k, canon, 96, 1024, 32),
        "PixelDistillStudent(64, 96, 1536)": lambda k: cnn.init_student(k, canon, 96, 1536, 64),
        "ActorCritic(512)": lambda k: ac.init_params(k, 21, 21, 512),
        "PixelActorCritic(256)": lambda k: cnn.init_params(k, 21, 21, 256),
        "RecurrentActorCritic(512)": lambda k: rnn.init_params(k, ac.feature_dim(21, 21), 512),
        "GridActorCritic(512)": lambda k: vit.init_params(k, 21, 21, 512),
    }


def keyed_init_phase(cw, dev, tag, want: dict) -> None:
    """Phase 27d: each flax family inits on the card at the main path's widths
    from ``PRNGKey(want["seed"])``: every drawn parameter's key and
    uniforms hash to JAX's digests (``KEYED_DIGESTS``), its values are the
    plain version's (the same uniforms through ``from_uniforms`` on the CPU)
    within ``INIT_ULPS`` (orthogonal kernels within ``INIT_ORTHO_ABS``), and
    the init launched the counter kernel twice a drawn parameter (its
    fold-in and its uniforms) and no plain version."""
    import hashlib

    import numpy as np

    from gym_craftingworld_tpu_torch.models import layers
    from gym_craftingworld_tpu_torch.models.flax_rng import Rngs

    t_phase = time.perf_counter()
    families = init_families(cw)
    check(set(families) == set(want) - {"seed"}, f"27d: the families are the digests' {list(want)}")
    sha = lambda t: hashlib.sha256(np.ascontiguousarray(t.cpu().numpy()).tobytes()).hexdigest()
    keyed, plains = zero_keyed()
    worst_ulps, worst_ortho, total = 0.0, 0.0, {}
    for name, make in families.items():
        for w in keyed.values():
            w.launches = 0
        log = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = make(Rngs(prng_key(want["seed"], device=dev), log=log))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: w.launches for k, w in keyed.items()}
        check(launches == {"keyed_reset": 0, "keyed_counter": 2 * len(log)}
              and not any(f.calls for f in plains),
              f"27d {name}: the init launched the counter kernel twice a drawn parameter "
              f"({len(log)}) and no plain version: {launches}")
        rows = want[name]
        check(sorted(d.path for d in log) == sorted(rows), f"27d {name}: the drawn parameters "
              f"are flax's: {sorted(d.path for d in log)}")
        params = dict(model.named_parameters())
        n = 0
        for d in log:
            row = rows[d.path]
            check(d.key.device == params[d.path.replace("/", ".")].device
                  and [int(x) for x in d.key.cpu()] == row["key"]
                  and d.init == row["init"] and list(d.shape) == row["shape"],
                  f"27d {name} {d.path}: the key on the card is flax's ({row['key']})")
            u = layers.init_uniforms(d.key, d.init, d.shape)
            check(sha(u) == row["uniforms"], f"27d {name} {d.path}: the uniforms on the card "
                  f"hash to JAX's, bit for bit")
            got = params[d.path.replace("/", ".")].detach().cpu()
            plain = layers.from_uniforms(d.init, u.cpu(), d.shape, d.arg)
            if d.init == "orthogonal":
                err = float((got - plain).abs().max())
                worst_ortho = max(worst_ortho, err)
                check(err <= INIT_ORTHO_ABS, f"27d {name} {d.path}: the card's QR within "
                      f"{INIT_ORTHO_ABS:g} of the CPU's ({err:.3e})")
            else:
                unit = float(np.float32(d.arg)) if d.init == "normal" else float(
                    np.sqrt(np.float32(1.0 / d.arg)) / np.float32(0.87962566103423978))
                step = torch.from_numpy(np.spacing(np.maximum(plain.abs().numpy(), unit)
                                                   .astype(np.float32)))
                ulps = float(((got.double() - plain.double()).abs() / step).max())
                worst_ulps = max(worst_ulps, ulps)
                check(ulps <= INIT_ULPS, f"27d {name} {d.path}: the card's values within "
                      f"{INIT_ULPS} ulps of the plain version's ({ulps:.0f})")
            n += got.numel()
        total[name] = n
        print(f"{tag} 27d {name}: {len(log)} drawn parameters, {n:,} values, init on the card "
              f"{ms:.1f} ms (host clock, synced); keys and uniforms == JAX's digests; counter "
              f"kernel {launches['keyed_counter']} launches")
        del model, params
    print(f"{tag} 27d the flax families' init from PRNGKey({want['seed']}): {sum(total.values()):,} "
          f"values; card vs plain: max {worst_ulps:.0f} ulps (bound {INIT_ULPS}), orthogonal "
          f"max abs {worst_ortho:.3e} (bound {INIT_ORTHO_ABS:g})")
    print(f"{tag} phase 27d took {time.perf_counter() - t_phase:.1f} s")


def keyed_imitation_phase(cw, dev, tag, want: dict) -> None:
    """Phase 27e: ``collect_expert_demos`` on the card from JAX's keys hashes
    to JAX's demos, column for column, and ``collect_policy_states(
    explore_eps=0.05)``'s exploration draws to JAX's; each launches the
    keyed kernels as counted and no plain version."""
    import hashlib

    import numpy as np

    from gym_craftingworld_tpu_torch.models import grid_policy as gp
    from gym_craftingworld_tpu_torch.train import dagger, demos

    t_phase = time.perf_counter()
    canon = cw.EnvConfig(height=21, width=21, max_steps=300, stacking=True)
    sizes = want["sizes"]
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    keyed, plains = zero_keyed()
    t0 = time.perf_counter()
    snaps = demos.collect_expert_demos(canon, sizes["demo_episodes"], seed=0, noise_eps=0.05,
                                       batch=sizes["demo_batch"], device=dev)
    t_demo = time.perf_counter() - t0
    n_batches = -(-sizes["demo_episodes"] // sizes["demo_batch"])
    launches = {k: w.launches for k, w in keyed.items()}
    check(launches == {"keyed_reset": n_batches, "keyed_counter": n_batches}
          and not any(f.calls for f in plains),
          f"27e: the demos' resets launched both keyed kernels once a batch: {launches}")
    bad = [k for k in demos.SnapDataset._fields
           if sha(getattr(snaps, k)) != want["demos"][k]]
    check(not bad, f"27e: collect_expert_demos on the card == JAX's demos; columns that "
          f"differ: {bad}")
    print(f"{tag} 27e collect_expert_demos 21x21 stacked, {sizes['demo_episodes']} episodes in "
          f"batches of {sizes['demo_batch']}: {snaps.num_rows} rows, {snaps.num_episodes} kept, "
          f"hash to JAX's, column for column; {t_demo:.2f} s (host clock); launches {launches}")
    model = gp.init_grid_policy(prng_key(0, device=dev), canon, *GRID_WIDTHS)
    drawn, explore_draws = [], dagger.explore_draws

    def recorded(*args, **kw):
        out = explore_draws(*args, **kw)
        drawn.append(out)
        return out

    keyed, plains = zero_keyed()
    dagger.explore_draws = recorded
    try:
        t0 = time.perf_counter()
        cols, sr = dagger.collect_policy_states(canon, model, sizes["explore_episodes"],
                                                seed=sizes["explore_seed"], explore_eps=0.05)
        t_collect = time.perf_counter() - t0
    finally:
        dagger.explore_draws = explore_draws
    launches = {k: w.launches for k, w in keyed.items()}
    check(launches == {"keyed_reset": 1, "keyed_counter": 5} and not any(f.calls for f in plains),
          f"27e: collect_policy_states launched the reset kernel once and the counter kernel 5 "
          f"times (the resets' keys, then 4 for T={canon.max_steps} steps of exploration), no "
          f"plain version: {launches}")
    (u, a), = drawn
    got = {"uniform": sha(u.cpu().numpy()), "moves": sha(a.cpu().numpy())}
    check(got == want["explore"], f"27e: the exploration draws on the card == JAX's: {got}")
    print(f"{tag} 27e collect_policy_states(explore_eps=0.05) GridPolicy{GRID_WIDTHS} untrained, "
          f"{sizes['explore_episodes']} episodes from seed {sizes['explore_seed']}: exploration "
          f"draws [{canon.max_steps}, {sizes['explore_episodes']}] hash to JAX's; "
          f"{len(cols['agent_key'])} states, success {sr:.4f}, {t_collect:.2f} s (host clock); "
          f"launches {launches}")
    print(f"{tag} phase 27e took {time.perf_counter() - t_phase:.1f} s")


LADDER_ULPS = 2  # Gumbel noise of the tools' draws: the card's log against the plain one


def keyed_ladder_phase(cw, dev, tag, want: dict) -> None:
    """Phase 27f: the engine ladder's five random rollouts, each from
    ``PRNGKey(5)`` at 16,384 envs on 21x21 over T = 64 with the counters set
    to 0 just before, launch the counter kernel once (their actions) and no
    plain version, and their final slot states and outputs hash to JAX's
    digests; ``finetune_canonical.draw`` and ``pixel_distill``'s draws of one
    round (a collect chunk's reset and exploration, an epoch's flips, the
    sampled evaluation's reset and chain) launch the keyed kernels as counted
    and hash to JAX's digests, the Gumbel noise by its uniforms, the noise
    itself within ``LADDER_ULPS`` of ``-log(-log u)`` on the CPU."""
    import hashlib

    import numpy as np

    from gym_craftingworld_tpu_torch import interop
    from gym_craftingworld_tpu_torch.core import slots as sm
    from gym_craftingworld_tpu_torch.models.cnn import init_student
    from gym_craftingworld_tpu_torch.models.grid_policy import init_grid_policy
    from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
    from gym_craftingworld_tpu_torch.ops import obs_rollout as obr
    from gym_craftingworld_tpu_torch.ops import packed_rollout as pr
    from gym_craftingworld_tpu_torch.ops import threefry as tf
    from gym_craftingworld_tpu_torch.ops import transposed_rollout as tr
    from gym_craftingworld_tpu_torch.tools import finetune_canonical as ftc
    from gym_craftingworld_tpu_torch.tools import pixel_distill as pd

    t_phase = time.perf_counter()
    cfg, sizes = cw.ray_config(), want["sizes"]
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    shas = lambda d: {k: sha(v) for k, v in d.items()}

    def same(name, got: dict, digests: dict) -> None:
        bad = sorted(k for k in digests if got.get(k) != digests[k])
        check(not bad and set(got) == set(digests), f"27f {name} on the card == JAX's digests "
              f"({KEYED_DIGESTS}); entries that differ: {bad}")

    # ---- the five random rollouts -------------------------------------------------
    lad = sizes["ladder"]
    engines = {
        "rollout_slots_random": sm.rollout_slots_random,
        "rollout_t_random": tr.rollout_t_random,
        "rollout_p_random": pr.rollout_p_random,
        "rollout_p_bench": pr.rollout_p_bench,
        "rollout_obs_random(ray)": lambda c, s, k, n: obr.rollout_obs_random(c, s, k, n, "ray"),
    }
    check(set(engines) == set(want["rollouts"]), f"27f: the rollouts are the digests' "
          f"{sorted(want['rollouts'])}")
    times = {}
    for name, fn in engines.items():
        slots = sm.from_env_state(cw.reset_from_seed(cfg, lad["reset_seed"], lad["envs"],
                                                     device=dev))
        key = prng_key(lad["key"], device=dev)
        torch.cuda.synchronize()
        wrappers, plains = zero_counters()
        mark = keyed_mark()
        t0 = time.perf_counter()
        final, out = fn(cfg, slots, key, lad["steps"])
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        no_kernel_ran(wrappers, plains, f"27f {name}")
        keyed_since(mark, f"{tag} 27f {name}, its actions", keyed_counts(0, 1))
        got = shas(interop.slot_state_to_numpy(final))
        if torch.is_tensor(out):
            got["total"] = int(out)
        else:
            got.update({f"out.{k}": sha(v.cpu().numpy()) for k, v in out._asdict().items()})
        same(name, got, want["rollouts"][name])
    print(f"{tag} 27f the ladder's random rollouts from PRNGKey({lad['key']}), "
          f"{lad['envs']} envs on 21x21, T={lad['steps']}: final states and outputs hash to "
          f"JAX's; seconds (host clock, synced) "
          f"{json.dumps({k: round(v, 2) for k, v in times.items()})}")

    def noise_check(what, noise, u) -> float:
        """The card's Gumbel noise against ``-log(-log u)`` of its uniforms on the CPU, in ulps."""
        plain = tf.gumbel_from_uniform(u.cpu())
        step = torch.from_numpy(np.spacing(np.maximum(plain.abs().numpy(), 1).astype(np.float32)))
        ulps = float(((noise.cpu().double() - plain.double()).abs() / step).max())
        check(ulps <= LADDER_ULPS, f"27f {what}: the noise within {LADDER_ULPS} ulps of its "
              f"uniforms' on the CPU ({ulps:.1f})")
        return ulps

    # ---- finetune_canonical's first update's draws ----------------------------------
    ftz = sizes["finetune"]
    ft, B = ftc.FTConfig(), ftz["envs"]
    key = prng_key(ftz["key"], device=dev)
    mark = keyed_mark()
    nxt, draws = ftc.draw(cfg, ft, B, key)
    torch.cuda.synchronize()
    rounds = tf.shuffle_rounds(ft.rollout_steps * B)
    keyed_since(mark, f"{tag} 27f finetune_canonical.draw",
                keyed_counts(1, 4 + 2 * ft.update_epochs * rounds))
    k_roll = kd.split_keys(key, 4)[2]
    u = kd.uniform_cols(k_roll, (1, B * 6), minval=tf.TINY, planes=ft.rollout_steps)
    ft_ulps = noise_check("finetune noise", draws.noise, u.reshape(draws.noise.shape))
    same("finetune_canonical.draw", {
        "next_key": [int(x) for x in nxt.cpu()],
        "pool": shas(interop.env_state_to_numpy(draws.pool)),
        "noise_uniforms": sha(u.reshape(draws.noise.shape).cpu().numpy()),
        "perms": sha(draws.perms.cpu().numpy())}, want["finetune_draw"])

    # ---- pixel_distill's draws of a round, through the tool -------------------------
    dz = sizes["distill"]
    D, T = dz["chunk"], cfg.max_steps
    teacher = init_grid_policy(prng_key(0, device=dev), cfg, 16, 64)
    student = init_student(prng_key(dz["flip_seed"], device=dev), cfg, channels=16, hidden=64,
                           stem=8)
    seen = {}
    collect, evaluate = pd._rollout_collect, pd._eval_student

    def collect_rec(cfg_, kind, model, state, u_, a_, eps):
        seen["collect"] = (state, u_, a_)
        return collect(cfg_, kind, model, state, u_, a_, eps)

    def eval_rec(cfg_, model, state, noise=None):
        seen["eval"] = (state, noise)
        return evaluate(cfg_, model, state, noise)

    pd._rollout_collect, pd._eval_student = collect_rec, eval_rec
    try:
        mark = keyed_mark()
        t0 = time.perf_counter()
        pd.collect_round(cfg, "grid", teacher, D, dz["collect_seed"], 0.02)
        keyed_since(mark, f"{tag} 27f pixel_distill.collect_round", keyed_counts(1, 1 + 4))
        mark = keyed_mark()
        fh, fw = pd.flip_bits(prng_key(dz["flip_seed"], device=dev), dz["flip_steps"],
                              dz["batch"])
        keyed_since(mark, f"{tag} 27f pixel_distill.flip_bits", keyed_counts(0, 4))
        mark = keyed_mark()
        res = pd.eval_student(cfg, student, D, dz["eval_seed"], chunk=D, mode="sample")
        keyed_since(mark, f"{tag} 27f pixel_distill.eval_student(sample)",
                    keyed_counts(1, 1 + T + 1))
        t_distill = time.perf_counter() - t0
    finally:
        pd._rollout_collect, pd._eval_student = collect, evaluate
    state, eu, ea = seen["collect"]
    estate, noise = seen["eval"]
    chain = kd.chain_keys(kd.split_keys(prng_key(dz["eval_seed"], device=dev), D)[0], T)[1]
    u = kd.uniform_cols(chain, (1, D * 6), minval=tf.TINY).reshape(noise.shape)
    pd_ulps = noise_check("pixel_distill eval noise", noise, u)
    same("pixel_distill's round", {
        "collect_reset": shas(interop.env_state_to_numpy(state)),
        "explore_uniform": sha(eu.cpu().numpy()), "explore_moves": sha(ea.cpu().numpy()),
        "flip_h": sha(fh.cpu().numpy()), "flip_w": sha(fw.cpu().numpy()),
        "eval_reset": shas(interop.env_state_to_numpy(estate)),
        "eval_noise_uniforms": sha(u.cpu().numpy())}, want["distill_round"])
    print(f"{tag} 27f finetune_canonical.draw ({B} envs, T={ft.rollout_steps}, key "
          f"{ftz['key']}) and pixel_distill's draws of a round (a collect chunk of {D} from seed "
          f"{dz['collect_seed']}, {dz['flip_steps']} minibatches' flips, the sampled "
          f"evaluation's chain of {T} from seed {dz['eval_seed']}; {t_distill:.1f} s with the "
          f"collect's and the evaluation's episodes) hash to JAX's; Gumbel noise within "
          f"{max(ft_ulps, pd_ulps):.1f} ulps of its uniforms' on the CPU; sampled success "
          f"{res['success_rate']:.4f}")
    print(f"{tag} phase 27f took {time.perf_counter() - t_phase:.1f} s")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


if __name__ == "__main__":
    sys.exit(main())
