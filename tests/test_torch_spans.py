"""The trainers' profiler spans (``utils/profiling.trace``), on the CPU.

Under ``torch.profiler`` an iteration of ``train_step_fast`` and of
``train_step_pixel`` holds one ``ppo.collect`` with T ``ppo.policy`` inside
it and one ``ppo.update`` with epochs x minibatches ``ppo.grads`` inside it,
and no other ``ppo.*`` span. The spans change nothing a step computes, and
with no profiler recording ``trace`` never enters ``record_function``. Sizes
are the benchmark's tiny cells (256 envs, T = 16) with narrow policies.
"""

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fx
from gym_craftingworld_tpu_torch.train import fast_ppo as fp
from gym_craftingworld_tpu_torch.utils import profiling

torch.set_num_threads(1)

B, T = 256, 16
SPANS = ("ppo.collect", "ppo.policy", "ppo.update", "ppo.grads")


def fast_case():
    cfg = cw.flat_config(stacking=False)
    fppo = fp.FastPPOConfig(rollout_steps=T, hidden=64)
    ts = fp.init_fast_train_state(prng_key(0), cfg, fppo)
    env = fp.fresh_packed_batch(cfg, prng_key(1), B)
    step = lambda ts, env, key: fp.train_step_fast(cfg, fppo, ts, env, key)
    return step, ts, env, fppo


def pixel_case():
    cfg = cw.flat_config(stacking=False)
    ppo = fx.PixelPPOConfig(rollout_steps=T, conv1=8, conv2=16, hidden=32)
    ts = fx.init_pixel_train_state(prng_key(0), cfg, ppo)
    env = fx.fresh_packed_batch(cfg, prng_key(1), B)
    step = lambda ts, env, key: fx.train_step_pixel(cfg, ppo, ts, env, key)
    return step, ts, env, ppo


CASES = {"fast": fast_case, "pixel": pixel_case}


def span_tree(prof) -> dict:
    """{name: [(start, end), ...]} of the trace's ``ppo.*`` spans."""
    out = {}
    for e in prof.events():
        if e.name.startswith("ppo."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def inside(iv, outer) -> bool:
    return any(o0 <= iv[0] and iv[1] <= o1 for o0, o1 in outer)


@pytest.mark.parametrize("case", list(CASES))
def test_an_iteration_holds_the_span_tree(case):
    step, ts, env, conf = CASES[case]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(ts, env, prng_key(2))
    tree = span_tree(prof)
    assert sorted(tree) == sorted(SPANS)
    (collect,), (update,) = tree["ppo.collect"], tree["ppo.update"]
    assert len(tree["ppo.policy"]) == conf.rollout_steps
    assert len(tree["ppo.grads"]) == conf.update_epochs * conf.num_minibatches
    assert all(inside(iv, [collect]) for iv in tree["ppo.policy"])
    assert all(inside(iv, [update]) for iv in tree["ppo.grads"])
    assert collect[1] <= update[0]


def state_of(ts, env, key, metrics) -> dict:
    out = {f"param.{k}": v for k, v in ts.params.tensors().items()}
    out.update({f"mu.{k}": v for k, v in ts.opt_state.mu.items()})
    out.update({f"nu.{k}": v for k, v in ts.opt_state.nu.items()})
    out["count"] = ts.opt_state.count
    out.update({f"env.{k}": v for k, v in env._asdict().items()})
    out["key"] = key
    out.update({f"metric.{k}": v for k, v in metrics.items()})
    return {k: v.detach().clone() for k, v in out.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_spans_change_nothing_a_step_computes(case):
    step, ts, env, _ = CASES[case]()
    runs = []
    for traced in (False, True):
        ts_i, env_i = copy.deepcopy(ts), type(env)(*(x.clone() for x in env))
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                out = step(ts_i, env_i, prng_key(2))
        else:
            out = step(ts_i, env_i, prng_key(2))
        runs.append(state_of(*out))
    off, on = runs
    assert sorted(off) == sorted(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_without_a_profiler_no_span_is_entered(case, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    step, ts, env, _ = CASES[case]()
    assert not torch._C._autograd._profiler_enabled()
    ts, env, key, metrics = step(ts, env, prng_key(2))
    assert torch.isfinite(metrics["loss"])
    with profiling.trace("ppo.collect"):
        pass
