"""The simulator alone: bench-kernel launches over the packed worlds, one a unit.

The worlds are packed once in set-up and carried from launch to launch;
launch ``i``'s Philox seed is ``randint(fold_in(k_run, i), (), 0, 2**31 -
1)``, drawn on the card and read back, as the port's ``tools/bench.py``
draws its runs' seeds.
"""

from __future__ import annotations

import sys

import torch

from benchmark.drivers._train import replaced
from benchmark.drivers.fastppo_train import env_config
from benchmark.reference.world import FIELDS
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.fused_reset import fresh_packed_fused
from gym_craftingworld_tpu_torch.ops.packed_fused import rollout_packed_bench


class Cell:
    def __init__(self, conf: dict, traffic: dict, inp: dict, device):
        self.cfg = env_config(conf)
        self.B, self.T = traffic["envs"], traffic["steps_per_launch"]
        self.work_per_unit = self.B * self.T
        self.sample = inp["sample"]
        s0, s1 = inp["pool_seeds"]
        self.state = fresh_packed_fused(self.cfg, s0, self.B, seed2=s1, device=device)
        self.key = inp["key"].clone()
        self.i = 0
        self.unit()
        self.first = self._host(self.state), self.sums[self.sample].cpu().numpy()

    def _host(self, state) -> dict:
        return {k: getattr(state, k)[..., self.sample].cpu().numpy() for k in FIELDS}

    def unit(self):
        seed = int(kd.randint(kd.fold_in(self.key, self.i), (), 0, 2**31 - 1))
        self.before = self.state
        self.state, self.sums = rollout_packed_bench(self.cfg, self.state, seed, self.T)
        self.i += 1

    def finish(self) -> dict:
        record = {"first_end": self.first[0], "first_sums": self.first[1],
                  "last_index": self.i - 1, "last_start": self._host(self.before),
                  "last_end": self._host(self.state),
                  "last_sums": self.sums[self.sample].cpu().numpy()}
        del self.state, self.before, self.sums
        return record


def plant(fault: str):
    """A fault under the timed path, for the check's tests: ``stale`` (the
    worlds come back as they went in), ``token`` (every seventh world's sum
    altered), ``half`` (half of the worlds left unstepped)."""
    bench = rollout_packed_bench

    def broken(cfg, p, seed, steps, env0=0):
        out, sums = bench(cfg, p, seed, steps, env0)
        if fault == "stale":
            return p, sums
        if fault == "token":
            sums = sums.clone()
            sums[::7] += 1
            return out, sums
        keep = torch.arange(p.agent_r.shape[0], device=p.agent_r.device) < p.agent_r.shape[0] // 2
        return type(p)(*(torch.where(keep, o, x) for o, x in zip(out, p))), sums

    return replaced(sys.modules[__name__], "rollout_packed_bench", broken)
