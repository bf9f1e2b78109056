"""Command-line tools that drive the port's trainers and kernels on the card.

Each runs as ``python -m gym_craftingworld_tpu_torch.tools.<name>``, on
``cuda`` unless given ``--device cpu`` (for the tests), and imports torch,
numpy and the port only. Every JSON it writes and every line of numbers it
prints carries the card's name and power limit
(``utils/profiling.card_identity``); times come from CUDA events
(``utils/profiling.timed_runs``). JSON goes to ``--out``, by default under
``runs/torch/``. The JAX package's records under ``docs/`` are read as JSON
data, never imported.

Tools and their counterparts in the JAX package's ``tools/``:

* ``fast_ppo_sweep`` <- ``tools/fast_ppo_sweep.py``: five update settings,
  full-loop throughput at 16,384 envs on 21x21 and learning curves on
  single-task 8x8 at 4,096 envs; ``learning_curve`` is also
  ``chip_smoke.py``'s phase 22.
* ``fused_update_e2e`` <- ``tools/fused_update_e2e.py``: the same training
  through the gradient kernel and through autograd, 384 updates, two seeds.
* ``fast_ppo_bench`` <- ``tools/fast_ppo_bench.py``: fast-PPO ms/update,
  env-steps/s and stages.
* ``fast_pixel_bench`` <- ``tools/fast_pixel_bench.py``: the same for pixel
  PPO.
* ``fused_update_bench`` <- ``tools/fused_update_bench.py``: the indexed
  gradient kernel at one minibatch's shape, beside five cuBLAS products.
* ``fused_bench`` <- ``tools/fused_bench.py``: the plain packed rollout and
  the fused bench kernel, env-steps/s.
* ``fast_pixel_canonical`` <- ``tools/fast_pixel_canonical.py``: pixel
  PPO at 16,384 envs on 21x21, its full-loop rate at both presets and
  single-task learning curves at matched wall clock, by ``--part``
  (``rate``, ``default``, ``preset``) merged into one JSON; its
  ``run_curve`` and ``compare_windows`` are ``chip_smoke.py``'s phase 23a.
* ``collect_canonical_demos`` <- ``tools/collect_canonical_demos.py``: the
  expert's snapshot demos at the canonical setting (a ``SnapDataset`` npz).
* ``train_canonical`` <- ``tools/train_canonical.py``: BC and DAgger rounds
  of a GridPolicy, resumable (``--init-params``, ``--round-base``).
* ``targeted_dagger`` <- ``tools/targeted_dagger.py``: failure-targeted
  DAgger rounds and the ``docs/canonical_policy.json`` artifact.
* ``_canonical``: what the three canonical tools share (the setting, the
  device dataset of fixed capacity, row sampling, parameter files, the
  metrics file and the evaluation curve).
* ``cpv_canonical`` <- ``tools/cpv_canonical.py``: the CPV compositional
  matrix at 21x21 (``docs/cpv_matrix.json``'s schema), with resume points
  (``--resume``, ``--matrix-only``); ``chip_smoke.py``'s phase 24b.
* ``cpv_matrix`` <- ``tools/cpv_matrix.py``: the round-4 CPV protocol on
  8x8 through the Gym façade.
* ``_cpv``: what the two CPV tools share (the expert's task order and the
  handoff world edit).
* ``scaling_artifact`` <- ``tools/scaling_artifact.py``: the sharded
  engines' env-steps/s over the host's gloo ranks (``--cpu``, under
  ``torchrun``) and on one card (``--gpu``, the bench kernel and the packed
  scan, delta-timed); ``chip_smoke.py``'s phase 24a.
* ``finetune_canonical`` <- ``tools/finetune_canonical.py`` and
  ``pixel_distill`` <- ``tools/pixel_distill.py``: PPO of the canonical
  GridPolicy under the exact-match reward, and its distillation into a pixel
  student; ``relabel`` in ``_canonical`` labels their rows in host processes.
* ``bench`` <- the root ``bench.py``: the headline env-steps/s, its
  environment variables, layouts and JSON keys, timed with CUDA events.
* ``fast_ppo_prof`` <- ``tools/fast_ppo_prof.py`` and ``collect_prof`` <-
  ``tools/collect_prof.py``: one fast-PPO update by phase, and its collect
  with pieces knocked out (CUDA-event and device ms, kernels launched).
* ``ppo_prof`` <- ``tools/ppo_prof.py``: ``train/ppo.py`` by stage.
* ``cpv_debug`` <- ``tools/cpv_debug.py``: the 8x8 CPV model's failures on
  chosen pairs, classed by ``_cpv.failure_kind``.
* ``expert_probe`` <- ``tools/expert_probe.py``: the scripted expert's
  failures over the JAX tool's seeds and modes.

The canonical tools run ``docs/training.md``'s recipe in steps that resume
from their files (README, "Tools"); phase 23b drives them end to end at a
small size, and phase 26 runs the last six small. ``records/`` holds the
runs made on an H100 with these tools.
"""
