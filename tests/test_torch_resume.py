"""The port's training command line, its checkpoints and resume, on the CPU.

Counterpart of ``tests/test_resume.py``: ``python -m
gym_craftingworld_tpu_torch.train.run --device cpu`` is SIGKILLed right
after it writes its update-2 checkpoint, resumed in a fresh process, and
every metric of updates 2-3 must equal the uninterrupted run's bit for bit.
Also: a checkpoint round trip with the key data, a JAX
``TrainState`` carried across by ``interop.ppo_train_state_from_numpy``
giving JAX's first-update loss, and two ranks of ``torch.distributed.run``
giving the one-rank run's metrics within the tolerance stated below.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import gym_craftingworld_tpu as jcw
from gym_craftingworld_tpu.train import ppo as jppo
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.ops.keyed_draws import split_keys
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import checkpoint
from gym_craftingworld_tpu_torch.train import fast_ppo as fp
from gym_craftingworld_tpu_torch.train import ppo as tppo

from test_torch_packed_rollout import np_tree, tcfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ARGS = [
    "--envs", "32", "--size", "6", "--max-steps", "16",
    "--rollout-steps", "8", "--hidden", "16", "--seed", "3",
    "--log-every", "1", "--ckpt-every", "2", "--device", "cpu",
]
_VOLATILE = {"env_steps_per_s", "wall_s"}  # timing fields differ between runs
# each run takes 5-10 s with six test workers on 8 cores: one that runs past
# this has stalled
RUN_TIMEOUT_S = 120
RUN = [sys.executable, "-m", "gym_craftingworld_tpu_torch.train.run"]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1")


def _metrics(lines):
    out = {}
    for line in lines:
        line = line.strip()
        if line.startswith("{"):
            rec = json.loads(line)
            if "update" in rec and "loss" in rec:
                out[rec["update"]] = {k: v for k, v in rec.items() if k not in _VOLATILE}
    return out


def _run(cmd):
    res = subprocess.run(cmd, env=_env(), capture_output=True, text=True, timeout=RUN_TIMEOUT_S,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return _metrics(res.stdout.splitlines())


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """The uninterrupted 4-update run (checkpoints at 2 and 4)."""
    ckpt = tmp_path_factory.mktemp("uninterrupted")
    got = _run(RUN + _ARGS + ["--updates", "4", "--ckpt-dir", str(ckpt)])
    assert set(got) == {0, 1, 2, 3}
    return got


def test_killed_run_resumes_bit_identically(full, tmp_path):
    cmd = RUN + _ARGS + ["--updates", "4", "--ckpt-dir", str(tmp_path)]
    proc = subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE, text=True, cwd=ROOT)
    pre_kill = []
    # a run that stalls without a line is killed, which ends the read below
    watchdog = threading.Timer(RUN_TIMEOUT_S, proc.kill)
    watchdog.start()
    try:
        for line in proc.stdout:
            pre_kill.append(line)
            if '"checkpoint"' in line and "step_2" in line:
                os.kill(proc.pid, signal.SIGKILL)
                break
        else:
            pytest.fail(f"run ended without checkpointing within {RUN_TIMEOUT_S} s: {pre_kill}")
    finally:
        watchdog.cancel()
        proc.wait(timeout=60)
    pre = _metrics(pre_kill)
    assert set(pre) >= {0, 1}
    for u in (0, 1):
        assert pre[u] == full[u]
    resumed = _run(RUN + _ARGS + ["--updates", "4", "--ckpt-dir", str(tmp_path), "--resume"])
    assert set(resumed) == {2, 3}, resumed.keys()
    for u in (2, 3):
        assert resumed[u] == full[u], f"update {u} diverged after resume:\n{resumed[u]}\nvs\n{full[u]}"


def test_two_ranks_give_the_one_rank_metrics(full, tmp_path):
    """Two gloo ranks of ``torch.distributed.run`` over the same 32 envs.
    The trajectory is the one-rank run's, so the rates agree exactly; the
    loss terms see weight gradients that each rank rounds to bf16 before the
    ranks sum them (measured max abs difference 5.8e-6, on update 1's
    pg_loss): within rtol 1e-3 / atol 2e-5."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "gym_craftingworld_tpu_torch.train.run", *_ARGS, "--updates", "2",
           "--ckpt-dir", str(tmp_path)]
    two = _run(cmd)
    assert set(two) == {0, 1}
    for u in (0, 1):
        assert set(two[u]) == set(full[u])
        for k in ("reward_mean", "episode_done_frac", "success_rate", "update"):
            assert two[u][k] == full[u][k], (u, k)
        for k in ("loss", "pg_loss", "v_loss", "entropy"):
            np.testing.assert_allclose(two[u][k], full[u][k], rtol=1e-3, atol=2e-5, err_msg=k)
    # the 2-rank checkpoint resumes in one process: its two env shards are one batch
    ts = tppo.init_train_state(prng_key(0), tcfg(jcw.EnvConfig(6, 6, 16)),
                               tppo.PPOConfig(rollout_steps=8, hidden=16))
    ts, env, key, step = checkpoint.restore(str(tmp_path / "step_2"), ts, "cpu")
    assert step == 2 and ts.update_idx == 2 and tuple(env.objects.shape) == (32, 6, 6)
    assert key.dtype == torch.int64 and tuple(key.shape) == (2,)


def test_checkpoint_round_trip(tmp_path):
    cfg = tcfg(jcw.flat_config())
    ppo = tppo.PPOConfig(rollout_steps=4, num_minibatches=2, hidden=16)
    ts = tppo.init_train_state(prng_key(1), cfg, ppo)
    env = tppo.reset(cfg, split_keys(prng_key(1), 8))
    ts, env, key, _ = tppo.train_step(cfg, ppo, ts, env, prng_key(2))
    checkpoint.save(str(tmp_path / "step_1"), ts, env, key, step=1)

    ts2 = tppo.init_train_state(prng_key(9), cfg, ppo)
    ts2, env2, key2, step = checkpoint.restore(str(tmp_path / "step_1"), ts2, "cpu")
    assert step == 1 and ts2.update_idx == 1
    assert torch.equal(key2, key)  # the key data the run goes on from
    for k, v in ts.params.state_dict().items():
        assert torch.equal(ts2.params.state_dict()[k], v), k
    assert int(ts2.opt_state.count) == int(ts.opt_state.count)
    for m in ("mu", "nu"):
        for k, v in getattr(ts.opt_state, m).items():
            assert torch.equal(getattr(ts2.opt_state, m)[k], v), (m, k)
    for k, v in interop.env_state_to_numpy(env).items():
        np.testing.assert_array_equal(interop.env_state_to_numpy(env2)[k], v, err_msg=k)
    # packed batches (the fast trainers') round-trip too
    pk = fp.fresh_packed_batch(cfg, key, 16)
    checkpoint.save(str(tmp_path / "packed"), ts, pk, key, step=3)
    _, pk2, _, _ = checkpoint.restore(str(tmp_path / "packed"), ts2, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(pk, pk2))
    # no temporary file is left beside the checkpoint
    assert sorted(os.listdir(tmp_path / "step_1")) == ["env.rank0.pt", "state.pt"]


def test_jax_train_state_gives_jax_first_update_loss():
    """``init_train_state`` of the JAX package, carried across, and JAX's
    draws of its first ``train_step`` (its collect, then each epoch's
    permutation) give the port's update phase JAX's losses, within the mlp
    tolerance of ``test_torch_policy_families.py`` (rtol 2e-3 / atol 2e-4)."""
    cfg = jcw.EnvConfig(height=6, width=6, max_steps=16)
    ppo = jppo.PPOConfig(rollout_steps=8, num_minibatches=4, hidden=16)
    jts = jppo.init_train_state(jax.random.PRNGKey(3), cfg, ppo)
    host = jax.tree.map(np.asarray, jts)
    ts = interop.ppo_train_state_from_numpy(host.params, host.opt_state, host.update_idx,
                                            device="cpu")
    env = jcw.reset_from_seed(cfg, 3, 32)
    key = jax.random.PRNGKey(4)

    _, k_roll, k_perm = jax.random.split(key, 3)
    _, apply_j = jppo.make_policy(ppo)
    jenv_end, jtraj = jppo._collect(cfg, ppo, apply_j, jts.params, env, k_roll)
    last_env = interop.env_state_from_numpy(np_tree(jenv_end), device="cpu")
    perms = torch.stack([torch.as_tensor(np.array(jax.random.permutation(k, 8 * 32)))
                         for k in jax.random.split(k_perm, ppo.update_epochs)])
    # train_step donates its train state and env: it runs last, on a fresh reset
    _, _, _, jmetrics = jppo.train_step(cfg, ppo, jts, jcw.reset_from_seed(cfg, 3, 32), key)

    tp = tppo.PPOConfig(**ppo._asdict())
    _, apply_t = tppo.make_policy(tp)
    traj = tppo.Transition(
        tppo.Snapshot(*(torch.as_tensor(np.array(x)) for x in jtraj.obs)),
        *(torch.as_tensor(np.array(getattr(jtraj, f))) for f in
          ("action", "log_prob", "value", "reward", "done")))
    with torch.no_grad():
        _, last_value = apply_t(ts.params, tppo.snapshot(last_env))
        adv, ret = tppo._gae(tp, traj, last_value)
        _, opt_state, losses, aux = tppo._update_phase(tp, apply_t, ts, traj, adv, ret, perms)
    assert int(opt_state.count) == ppo.update_epochs * ppo.num_minibatches
    np.testing.assert_allclose(float(losses.mean()), float(jmetrics["loss"]), rtol=2e-3, atol=2e-4)
    for k in ("pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(aux[k].mean()), float(jmetrics[k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
