"""The scaling artifact: env-steps/s of the sharded engines, on the host's
ranks and on one card.

Counterpart of the JAX package's ``tools/scaling_artifact.py``, which writes
``docs/scaling.json``. Two sections, each merged into ``--out`` (by default
``runs/torch/scaling.json``):

* ``cpu_virtual8``: ``parallel/mesh.scaling_report`` of the grid and packed
  scan engines on 21x21 at 512 envs a rank, 64 steps, one rank against all.
  JAX runs eight virtual XLA devices in one process; the port runs eight
  gloo ranks on the host, one process each::

      torchrun --standalone --nproc_per_node 8 \\
          -m gym_craftingworld_tpu_torch.tools.scaling_artifact --cpu

* ``gpu_single_chip`` (JAX's ``tpu_single_chip``): 16,384 envs on 21x21 over
  a 1-rank mesh: the bench kernel through
  ``fused_rollout_packed_bench_sharded`` at T = 131,072, and the plain packed
  scan (``rollout_p_sharded``) at ``--scan-steps`` (512: the scan is plain
  torch, paced by the host at ~2 ms a step, where JAX's 32,768 would take a
  quarter of an hour and tell nothing new), each run drawing its actions
  ``randint(PRNGKey(2), (T, B), 0, 6)`` as JAX's does (the counter kernel
  on the card). Both delta-timed as JAX's are:
  the extra T/2 steps over the extra time, median of 7 runs after a
  warm-up, so that pack and unpack cancel; timed with CUDA events::

      python -m gym_craftingworld_tpu_torch.tools.scaling_artifact --gpu

Each section carries the card (``utils/profiling.card_identity``) or the
host's core count.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from gym_craftingworld_tpu_torch.config import EnvConfig, ray_config
from gym_craftingworld_tpu_torch.tools._canonical import RUNS
from gym_craftingworld_tpu_torch.utils.profiling import card_identity, timed_runs

OUT = RUNS / "scaling.json"


def merge(section: str, payload: dict, out=OUT) -> None:
    """Write ``payload`` as ``section`` of the JSON at ``out``, keeping the others."""
    out = Path(out)
    doc = json.loads(out.read_text()) if out.exists() else {}
    doc[section] = payload
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    print(f"wrote {section} -> {out}")


def run_cpu(out=OUT, batch_per_device: int = 512, num_steps: int = 64, iters: int = 5) -> dict:
    """The ``cpu_virtual8`` section over every rank of the process group
    (torchrun's environment), gloo on the host; rank 0 writes it. Returns it."""
    import torch.distributed as dist

    from gym_craftingworld_tpu_torch.parallel.mesh import initialize_distributed, scaling_report

    initialize_distributed(device="cpu")
    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg = EnvConfig(height=21, width=21, max_steps=300)
    rep = scaling_report(cfg, batch_per_device=batch_per_device, num_steps=num_steps,
                         engines=("grid", "packed_scan"), iters=iters, device="cpu")
    payload = {
        "config": {"batch_per_device": batch_per_device, "num_steps": num_steps,
                   "grid": "21x21", "devices": world, "physical_cores": os.cpu_count()},
        "note": (
            f"{world} gloo ranks, one process each, share this host's cores, so "
            "perfect per-rank scaling is impossible by construction; the "
            "measurement validates that the sharded programs run and scale "
            "to the core limit. Stepping is communication-free (no "
            "collectives in the rollout), so across cards efficiency is "
            "linear by construction — see gpu_single_chip for one card's "
            "absolutes."
        ),
        "engines": rep,
    }
    if not dist.is_initialized() or dist.get_rank() == 0:
        merge("cpu_virtual8", payload, out)
        for k, v in rep.items():
            n = v["devices"]
            print(f"  {k}: eff {v['efficiency']:.3f} (1 rank {v['n1']:.4g} -> {n} ranks "
                  f"{v[f'n{n}']:.4g} env-steps/s)")
    return payload


def _delta_rate(run, B: int, T: int, iters: int = 7, device="cuda") -> float:
    """Delta-timed env-steps/s: the extra ``T - T // 2`` steps of ``run(T)``
    over ``run(T // 2)``, each the median of ``iters`` runs after a warm-up."""
    def med(T):
        return timed_runs(lambda: run(T), device, reps=iters, warmup=1)["median_ms"]

    t_full, t_half = med(T), med(T // 2)
    return B * (T - T // 2) / max((t_full - t_half) / 1e3, 1e-9)


def run_gpu(out=OUT, iters: int = 7, scan_steps: int = 512, device="cuda", envs: int = 16384,
            fused_steps: int = 131072) -> dict:
    """The ``gpu_single_chip`` section (one rank, the card unless asked for
    the CPU); merged into ``out`` when it is not None. Returns it."""
    from gym_craftingworld_tpu_torch.core import slots as sm
    from gym_craftingworld_tpu_torch.core.reset import reset_from_seed
    from gym_craftingworld_tpu_torch.ops.keyed_draws import randint_cols
    from gym_craftingworld_tpu_torch.ops.threefry import prng_key
    from gym_craftingworld_tpu_torch.parallel import sharded_engine as se
    from gym_craftingworld_tpu_torch.parallel.mesh import make_env_mesh

    cfg = ray_config()
    mesh = make_env_mesh(1, device)
    dev = mesh.device
    slots = se.shard_slots(sm.from_env_state(reset_from_seed(cfg, 0, envs, device=dev)), mesh)

    def run_fused(T):
        se.fused_rollout_packed_bench_sharded(cfg, slots, 3, T, mesh=mesh)

    fused_rate = _delta_rate(run_fused, envs, fused_steps, iters, dev)

    def run_scan(T):  # the JAX tool's draw, inside each timed run as there
        actions = randint_cols(prng_key(2, device=dev), (T, envs), 0, 6)
        se.rollout_p_sharded(cfg, slots, actions, T, mesh)

    scan_rate = _delta_rate(run_scan, envs, scan_steps, iters, dev)
    payload = {
        "card": card_identity(dev),
        "config": {"envs": envs, "grid": "21x21", "mesh": "1-rank EnvMesh",
                   "timing": f"delta (T vs T/2, median of {iters}, "
                             + ("CUDA events)" if dev.type == "cuda" else "host clock)"),
                   "fused_steps": fused_steps, "scan_steps": scan_steps},
        "packed_scan_env_steps_per_s": scan_rate,
        "fused_bench_env_steps_per_s": fused_rate,
    }
    if out is not None:
        merge("gpu_single_chip", payload, out)
    print(f"  [{payload['card']}] packed_scan {scan_rate:.5g}  fused {fused_rate:.5g} "
          f"env-steps/s")
    return payload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="the cpu_virtual8 section (under torchrun)")
    ap.add_argument("--gpu", action="store_true", help="the gpu_single_chip section")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--scan-steps", type=int, default=512, help="the packed scan's T of --gpu")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where --gpu runs")
    args = ap.parse_args(argv)
    done = {}
    if args.cpu:
        done["cpu_virtual8"] = run_cpu(args.out)
    if args.gpu:
        done["gpu_single_chip"] = run_gpu(args.out, scan_steps=args.scan_steps, device=args.device)
    if not done:
        print("pass --cpu and/or --gpu")
    return done


if __name__ == "__main__":
    main()
