"""Fast-PPO training: ``train_step_fast`` repeated, one update a unit."""

from __future__ import annotations

import torch

from benchmark.drivers._train import altered_token, check_steps, replaced, stale
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.ops import fused_update as fu
from gym_craftingworld_tpu_torch.ops.fused_reset import fresh_packed_fused
from gym_craftingworld_tpu_torch.train import fast_ppo as fp


def env_config(conf: dict) -> EnvConfig:
    e = conf["env"]
    return EnvConfig(height=e["height"], width=e["width"], max_steps=e["max_steps"],
                     stacking=e["stacking"], number_of_tasks=e["number_of_tasks"],
                     reward_equal=e["reward_equal"])


class Cell:
    def __init__(self, conf: dict, traffic: dict, inp: dict, device):
        self.cfg = env_config(conf)
        self.fppo = fp.FastPPOConfig(**{k: conf[k] for k in fp.FastPPOConfig._fields})
        self.B = traffic["envs"]
        self.work_per_unit = self.fppo.rollout_steps * self.B
        p = fp.MLPParams(conf["features"], conf["hidden"], device=device)
        with torch.no_grad():
            for k, v in inp["weights"].items():
                getattr(p, k).copy_(v)
        self.ts = fp.FastTrainState(p, fp.make_optimizer(self.fppo).init(p.tensors()), 0)
        s0, s1 = inp["pool_seeds"]
        self.env = fresh_packed_fused(self.cfg, s0, self.B, seed2=s1, device=device)
        self.key = inp["key"].clone()
        self.record = check_steps(self, fp, traffic["check_steps"])

    def params(self) -> dict:
        return self.ts.params.tensors()

    def unit(self):
        self.ts, self.env, self.key, metrics = fp.train_step_fast(
            self.cfg, self.fppo, self.ts, self.env, self.key)
        return metrics

    def finish(self):
        record = self.record
        del self.ts, self.env, self.record
        return record


def plant(fault: str):
    """A fault under the timed path, for the check's tests
    (``benchmark/control.py``): ``stale``, ``token``, or ``half`` (half of
    each minibatch's blocks left out, the mean taken over the rest)."""
    if fault == "stale":
        return stale(fp)
    if fault == "token":
        return altered_token(fp)
    grads = fu.fused_minibatch_grads_indexed

    def half(fppo, params, featb, ids, rest, **kw):
        k = len(ids) // 2
        rows = k * featb.shape[1]
        kw["n_total"] = None
        return grads(fppo, params, featb, ids[:k], tuple(r[:rows] for r in rest), **kw)

    half.launches = grads.launches  # the wrapper counts its launches under its own name
    return replaced(fu, "fused_minibatch_grads_indexed", half)
