"""Reference of the simulator's rollout: the bench kernel's launches replayed.

Launch ``i`` steps every world ``steps`` times with the bench kernel's
Philox actions under the seed ``randint(fold_in(k_run, i), (), 0, 2**31 -
1)`` and returns the final worlds and each world's int32 reward sum. The
reference replays two launches for a sample of worlds drawn from the run's
seed: the first launch of set-up, from the first worlds it draws itself
from the pool's seed words, and the last launch of the window, from the
program's worlds before it (only the program holds them: the launches
between are not replayed). It compares the final worlds and the sums, all
integers, exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import keys as K
from benchmark.reference import world as W


def inputs(conf: dict, traffic: dict, seed: int, device) -> dict:
    k_env, k_run = K.split(K.key_data(seed, device), 2)
    words = K.randint(k_env, (2,), 0, 2**31 - 1)
    rng = np.random.default_rng(seed & (2**63 - 1))
    sample = np.sort(rng.choice(traffic["envs"], traffic["check_envs"], replace=False))
    return {"pool_seeds": [int(w) for w in words], "key": k_run, "sample": sample}


def launch_seed(key: torch.Tensor, i: int) -> int:
    return int(K.randint(K.fold_in(key, i), (), 0, 2**31 - 1))


def replay(env: dict, seeds: np.ndarray, envs: np.ndarray, steps: int, conf: dict,
           dtype=np.int16):
    """Worlds ``env`` (numpy fields, one column a world) stepped ``steps``
    times, column ``j`` with env ``envs[j]``'s actions under ``seeds[j]``;
    (final worlds, int32 reward sums). ``dtype`` as ``world.step`` takes it."""
    e = conf["env"]
    kw = dict(height=e["height"], width=e["width"], max_steps=e["max_steps"])
    acts = np.concatenate([W.bench_actions(int(s), envs[seeds == s], steps)
                           for s in np.unique(seeds)], axis=1)
    order = np.concatenate([np.flatnonzero(seeds == s) for s in np.unique(seeds)])
    actions = np.empty_like(acts)
    actions[:, order] = acts
    total = np.zeros(len(envs), np.int32)
    if dtype == np.int16:  # int32 steps equal int16 steps: no conversion a step
        s = {k: v.astype(np.int32) for k, v in env.items()}
        for t in range(steps):
            s, r, _ = W.step32(s, actions[t], **kw)
            total += r
        return {k: v.astype(np.int16) for k, v in s.items()}, total
    for t in range(steps):
        env, r, _ = W.step(env, actions[t], dtype=dtype, **kw)
        total += r
    return env, total


def check(conf: dict, traffic: dict, inp: dict, record, device, dtype=np.int16) -> dict:
    """(numbers, details). ``record``: the program's first launch (its seed index 0, final worlds
    and sums of the sample) and last launch (index, the worlds before it,
    final worlds and sums), all numpy over the sample."""
    e, sample, T = conf["env"], inp["sample"], traffic["steps_per_launch"]
    first = W.take(W.pool(*inp["pool_seeds"], traffic["envs"], e["height"], e["width"],
                          e["number_of_tasks"], device), sample)
    n = len(sample)
    start = {k: np.concatenate([first[k], record["last_start"][k]], axis=-1) for k in W.FIELDS}
    seeds = np.array([launch_seed(inp["key"], 0)] * n
                     + [launch_seed(inp["key"], record["last_index"])] * n)
    env, total = replay(start, seeds, np.concatenate([sample, sample]), T, conf, dtype)
    prog = {k: np.concatenate([record["first_end"][k], record["last_end"][k]], axis=-1)
            for k in W.FIELDS}
    sums = np.concatenate([record["first_sums"], record["last_sums"]])
    bad = W.mismatched(prog, env)
    return ({"state_mismatch": int(bad.sum()), "sum_mismatch": int((sums != total).sum())},
            {"first_launch_mismatch": int(bad[:n].sum()), "last_launch_mismatch": int(bad[n:].sum()),
             "last_index": int(record["last_index"])})


def control(conf: dict, traffic: dict, inp: dict, device, dtype=np.int8) -> dict:
    """The program's record as the reference gives it with worlds held one
    precision below the program's int16: the first launch from the first
    worlds, and launch 1 after it."""
    e, sample, T = conf["env"], inp["sample"], traffic["steps_per_launch"]
    start = W.take(W.pool(*inp["pool_seeds"], traffic["envs"], e["height"], e["width"],
                          e["number_of_tasks"], device), sample)
    start = {k: v.astype(dtype) for k, v in start.items()}
    n = len(sample)
    first, first_sums = replay(start, np.array([launch_seed(inp["key"], 0)] * n), sample, T,
                               conf, dtype)
    last, last_sums = replay(first, np.array([launch_seed(inp["key"], 1)] * n), sample, T,
                             conf, dtype)
    return {"first_end": first, "first_sums": first_sums, "last_index": 1,
            "last_start": first, "last_end": last, "last_sums": last_sums}
