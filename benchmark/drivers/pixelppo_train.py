"""Pixel-PPO training: ``train_step_pixel`` repeated, one update a unit."""

from __future__ import annotations

import torch

from benchmark.drivers._train import altered_token, check_steps, replaced, stale
from benchmark.drivers.fastppo_train import env_config
from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fpp
from gym_craftingworld_tpu_torch.train import fast_ppo as fp


class Cell:
    def __init__(self, conf: dict, traffic: dict, inp: dict, device):
        self.cfg = env_config(conf)
        self.ppo = fpp.PixelPPOConfig(**{k: conf[k] for k in fpp.PixelPPOConfig._fields})
        self.B = traffic["envs"]
        self.work_per_unit = self.ppo.rollout_steps * self.B
        w = inp["weights"]
        p = fpp.ConvParams(self.ppo.conv1, self.ppo.conv2, w["w1"].shape[0] - 22,
                           self.ppo.hidden, device=device)
        with torch.no_grad():
            for k, v in w.items():
                getattr(p, k).copy_(v)
        opt = fp.make_optimizer(self.ppo.as_fast).init(p.tensors())
        self.ts = fpp.PixelTrainState(p, opt, 0)
        self.env = fp.fresh_packed_batch(self.cfg, inp["env_key"], self.B)
        self.key = inp["key"].clone()
        self.record = check_steps(self, fpp, traffic["check_steps"])

    def params(self) -> dict:
        return self.ts.params.tensors()

    def unit(self):
        self.ts, self.env, self.key, metrics = fpp.train_step_pixel(
            self.cfg, self.ppo, self.ts, self.env, self.key)
        return metrics

    def finish(self):
        record = self.record
        self.ts.params.policy_graph = None
        del self.ts, self.env, self.record
        return record


def plant(fault: str):
    """A fault under the timed path, for the check's tests: ``stale``,
    ``token``, or ``half`` (half of each minibatch's rows left out, the mean
    taken over the rest)."""
    if fault == "stale":
        return stale(fpp)
    if fault == "token":
        return altered_token(fpp)
    grads = fpp._pixel_grads

    def half(ppo, params, cfg, batch, normalized=False, n_total=None):
        st, *rest = batch
        n = rest[0].shape[0] // 2
        st = type(st)(*(x[..., :n] for x in st))
        return grads(ppo, params, cfg, (st, *(r[:n] for r in rest)), normalized, None)

    return replaced(fpp, "_pixel_grads", half)
