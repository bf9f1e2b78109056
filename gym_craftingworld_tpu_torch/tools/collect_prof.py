"""The fast-PPO collect on the card with pieces knocked out, timed.

Counterpart of the JAX package's ``tools/collect_prof.py``: 21x21 stacked,
the default ``FastPPOConfig`` (hidden 512, T = 64) at ``[ENVS]`` envs
(16,384). Six variants of one T-step collect, each built from
``train/fast_ppo.py``'s pieces (``features``, ``apply_policy``,
``_sample_action``, ``_window``, ``_autoreset``, the actions kernel through
``ops/packed_fused.rollout_packed_actions``), which stay as they are:

* ``full``: ``_collect`` itself (policy, sample, step, auto-reset, storage);
* ``nostore``: the same steps, each step's outputs reduced to scalars
  instead of stored as the [T, ...] trajectory;
* ``noreset``: no pool window and no auto-reset;
* ``nosample``: the policy's argmax, no Gumbel uniforms;
* ``policyonly``: the policy and the sample on one fixed feature matrix, no
  env step;
* ``steponly``: the packed step and the auto-reset with constant actions
  (``(agent_r + t) % 6``), no policy.

Each variant runs from the same env, pool and uniforms once to warm up and
then in ``[K]`` rounds (12), as ``fast_ppo_prof`` times its phases; it
reports the median CUDA-event ms, env-steps/s, the device ms of one more
run and the kernels it launched a run, one JSON line a variant, then one
with ``policyonly`` + ``steponly`` beside ``full``. The JAX tool's
K-against-K/2 delta timing is gone.

    python -m gym_craftingworld_tpu_torch.tools.collect_prof [ENVS] [K]
    python -m gym_craftingworld_tpu_torch.tools.collect_prof 128 2 --device cpu
"""

from __future__ import annotations

import functools

import torch

import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.ops.packed_fused import rollout_packed_actions
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools.fast_ppo_prof import arguments, profile_phases, sum_line
from gym_craftingworld_tpu_torch.train import fast_ppo as fp
from gym_craftingworld_tpu_torch.utils.profiling import card_identity


def _step(cfg, st, action):
    """One packed step of every env through the actions kernel; (state, raw reward, done)."""
    st, raw, done = rollout_packed_actions(cfg, st, action[None])
    return st, raw[0], done[0]


def variants(cfg, fppo: fp.FastPPOConfig, params, pool, u) -> dict:
    """{name: collect(env) -> (env, accumulated output)} of the six variants."""
    T = fppo.rollout_steps

    def full(env):
        return fp._collect(cfg, fppo, params, env, pool, u)

    def nostore(env):
        st, acc = env, 0.0
        for t in range(T):
            logits, value = fp.apply_policy(params, fp.features(cfg, st))
            action, log_prob = fp._sample_action(u[t], logits)
            st, _, done = _step(cfg, st, action)
            st = fp._autoreset(st, fp._window(pool, t, st.agent_r.shape[-1]), done)
            acc = acc + log_prob.sum() + value.sum()
        return st, acc

    def noreset(env):
        st, acc = env, 0.0
        for t in range(T):
            logits, _ = fp.apply_policy(params, fp.features(cfg, st))
            action, log_prob = fp._sample_action(u[t], logits)
            st, raw, _ = _step(cfg, st, action)
            acc = acc + log_prob.sum() + raw.sum()
        return st, acc

    def nosample(env):
        st, acc = env, 0.0
        for t in range(T):
            logits, value = fp.apply_policy(params, fp.features(cfg, st))
            action = torch.argmax(logits, dim=0).to(torch.int32)
            st, _, done = _step(cfg, st, action)
            st = fp._autoreset(st, fp._window(pool, t, st.agent_r.shape[-1]), done)
            acc = acc + value.sum()
        return st, acc

    def policyonly(env):
        feat0, acc = fp.features(cfg, env), 0.0
        for t in range(T):
            logits, value = fp.apply_policy(params, feat0)
            _, log_prob = fp._sample_action(u[t], logits)
            acc = acc + log_prob.sum() + value.sum()
        return env, acc

    def steponly(env):
        st, acc = env, 0
        for t in range(T):
            action = ((st.agent_r.to(torch.int32) + t) % C.N_ACTIONS).to(torch.int32)
            st, raw, done = _step(cfg, st, action)
            st = fp._autoreset(st, fp._window(pool, t, st.agent_r.shape[-1]), done)
            acc = acc + raw.sum()
        return st, acc

    return {"full": full, "nostore": nostore, "noreset": noreset, "nosample": nosample,
            "policyonly": policyonly, "steponly": steponly}


@torch.no_grad()
def main(argv=None) -> list:
    args = arguments(__doc__.split("\n")[0], argv)
    dev = torch.device(args.device)
    card = card_identity(dev)
    cfg = cw.ray_config()
    fppo = fp.FastPPOConfig()
    B, T, K = args.envs, fppo.rollout_steps, args.K
    key = lambda seed: prng_key(seed, device=dev)
    ts = fp.init_fast_train_state(key(0), cfg, fppo)
    env = fp.fresh_packed_batch(cfg, key(1), B)
    pool = fp._fresh_pool(cfg, key(2), 2 * B)
    u = fp.gumbel_uniforms(key(3), T, B)
    setting = {"envs": B, "rollout_steps": T, "hidden": fppo.hidden, "device": args.device}
    print(f"[{card}] collect_prof " + " ".join(f"{k}={v}" for k, v in setting.items())
          + f" K={K}", flush=True)
    phases = {name: functools.partial(collect, env)
              for name, collect in variants(cfg, fppo, ts.params, pool, u).items()}
    lines = profile_phases("collect_prof", phases, setting, K, dev, card,
                           dict.fromkeys(phases, B * T))
    return lines + [sum_line("collect_prof", lines, ("policyonly", "steponly"), setting, K, card)]


if __name__ == "__main__":
    main()
