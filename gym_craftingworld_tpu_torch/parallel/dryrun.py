"""The multi-device dry run: six sharded paths at tiny shapes, each checked.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``. Every rank of the process group calls
``dryrun_multichip(world)``; each path runs sharded over the ranks and is
held to what the JAX dry run checks it against:

1. the ``train/ppo.py`` step sharded: the env batch still split, a finite loss;
2. the packed scan sharded: bit-exact to the unsharded run;
3. fast PPO sharded: a finite loss, the batch still split on the lane axis;
4. the actions kernel sharded: bit-exact to the unsharded run;
5. pixel PPO sharded: a finite loss, the batch still split;
6. the gradient kernel per shard, summed over the ranks and divided by the
   ranks, against the per-shard average within ``rtol = atol = 2e-5``.

Shapes are the JAX dry run's where the port's blocks allow (its shuffle
blocks are 128 rows, so a rank holds 128 envs in paths 3 and 5), and so
are the keys: ``PRNGKey(n)`` of the JAX dry run for the resets, the
actions, the trainers' envs, parameters (the flax family's of path 1 as
flax's ``model.init`` draws them) and step keys (paths 1-5), and path 6's
random minibatch (``ops/fused_update.random_minibatch`` of ``PRNGKey(12)``).

    torchrun --standalone --nproc_per_node 2 -m gym_craftingworld_tpu_torch.parallel.dryrun
    python -m gym_craftingworld_tpu_torch.parallel.dryrun --device cpu   # one rank
"""

from __future__ import annotations

import argparse
import math

import torch

from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core import slots as sm
from gym_craftingworld_tpu_torch.core.reset import reset_from_seed
from gym_craftingworld_tpu_torch.ops import fused_update as fu
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops.keyed_draws import randint_cols
from gym_craftingworld_tpu_torch.ops.packed_rollout import rollout_p
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.parallel import sharded_engine as se
from gym_craftingworld_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_env_mesh,
    ppo_train_step_sharded,
    reset_sharded,
)
from gym_craftingworld_tpu_torch.train import fast_pixel_ppo as fpx
from gym_craftingworld_tpu_torch.train import fast_ppo as fp
from gym_craftingworld_tpu_torch.train.ppo import PPOConfig, init_train_state


def _check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Run and check the six sharded paths over ``n_devices`` ranks (the
    process group's size, or 1 without a group); returns the summary line."""
    mesh = make_env_mesh(device=device)
    _check(mesh.size == n_devices, f"need {n_devices} ranks, have {mesh.size}")
    dev = mesh.device
    # 1) the train/ppo.py step: 2 envs a rank, 5x5, 4-step rollouts
    cfg = EnvConfig(height=5, width=5, max_steps=10)
    ppo = PPOConfig(rollout_steps=4, num_minibatches=2, update_epochs=1, hidden=32)
    B = 2 * n_devices
    env_state = reset_sharded(cfg, 0, B, mesh)
    key = lambda seed: prng_key(seed, device=dev)
    ts = init_train_state(key(1), cfg, ppo)
    ts, env_state, _, metrics = ppo_train_step_sharded(cfg, ppo, mesh)(ts, env_state, key(2))
    _check(env_state.objects.shape[0] == B // n_devices, "the env batch lost its split")
    _check(math.isfinite(float(metrics["loss"])), "train/ppo.py loss is finite")

    # 2) the packed scan, against the unsharded run
    cfg_r = EnvConfig(height=7, width=7, max_steps=20)
    T = 24
    whole = sm.from_env_state(reset_from_seed(cfg_r, 0, B, device=dev))
    actions = randint_cols(prng_key(3), (T, B), 0, 6, device=dev)
    sl_ref, out_ref = rollout_p(cfg_r, whole, actions, T)
    sl_sh, out_sh = se.rollout_p_sharded(cfg_r, se.shard_slots(whole, mesh), actions, T, mesh)
    cols = mesh.cols(B)
    _check(torch.equal(out_sh.reward, out_ref.reward[:, cols]), "sharded packed scan rewards")
    _check(torch.equal(sl_sh.agent, sl_ref.agent[cols]), "sharded packed scan agents")

    # 3) fast PPO with the batch split on the lane axis
    fppo = fp.FastPPOConfig(rollout_steps=4, num_minibatches=2, update_epochs=1, hidden=32)
    Bp = 128 * n_devices
    envp = se.shard_packed(fp.fresh_packed_batch(cfg_r, key(4), Bp), mesh)
    fts = fp.init_fast_train_state(key(5), cfg_r, fppo)
    fts, envp, _, fmetrics = se.fast_train_step_sharded(cfg_r, fppo, mesh)(fts, envp, key(6))
    _check(math.isfinite(float(fmetrics["loss"])), "fast-PPO loss is finite")
    _check(envp.slot_key.shape[-1] == Bp // n_devices and envp.agent_r.shape[-1] == Bp // n_devices,
           "the packed batch lost its lane split")

    # 4) the actions kernel, against the unsharded run
    Bf, Tf = 128 * n_devices, 16
    slf = sm.from_env_state(reset_from_seed(cfg_r, 6, Bf, device=dev))
    f_actions = randint_cols(prng_key(7), (Tf, Bf), 0, 6, device=dev)
    sl_f_ref, rew_f_ref, _ = pf.fused_rollout_packed(cfg_r, slf, f_actions, Tf)
    sl_f, rew_f, _ = se.fused_rollout_packed_sharded(cfg_r, se.shard_slots(slf, mesh), f_actions,
                                                     Tf, mesh=mesh)
    cols = mesh.cols(Bf)
    _check(torch.equal(rew_f, rew_f_ref[:, cols]), "sharded actions kernel rewards")
    _check(torch.equal(sl_f.agent, sl_f_ref.agent[cols]), "sharded actions kernel agents")

    # 5) pixel PPO with the batch split on the lane axis
    pppo = fpx.PixelPPOConfig(rollout_steps=4, num_minibatches=2, update_epochs=1,
                              conv1=8, conv2=8, hidden=32)
    Bx = 128 * n_devices
    envx = se.shard_packed(fp.fresh_packed_batch(cfg_r, key(8), Bx), mesh)
    xts = fpx.init_pixel_train_state(key(9), cfg_r, pppo)
    xts, envx, _, xmetrics = se.pixel_train_step_sharded(cfg_r, pppo, mesh)(xts, envx, key(10))
    _check(math.isfinite(float(xmetrics["loss"])), "pixel-PPO loss is finite")
    _check(envx.slot_key.shape[-1] == Bx // n_devices, "the pixel batch lost its lane split")

    # 6) the gradient kernel per shard, summed over the ranks / ranks
    fppo_k = fp.FastPPOConfig(hidden=32)
    params_k = fp.init_params(key(11), cfg_r, fppo_k)
    n_shard = 256
    Nk, Fk = n_shard * n_devices, fp.feature_rows(cfg_r)
    _, batch_k = fu.random_minibatch(key(12), Nk, Fk)
    shard = lambda i: tuple(x[i * n_shard:(i + 1) * n_shard] for x in batch_k)
    grads, _ = fu.fused_minibatch_grads(fppo_k, params_k, shard(mesh.rank))
    grads = {k: mesh.all_reduce(v.clone()) / n_devices for k, v in grads.items()}
    ref = {k: torch.zeros_like(v) for k, v in grads.items()}
    for i in range(n_devices):
        g_i, _ = fu.fused_minibatch_grads(fppo_k, params_k, shard(i))
        ref = {k: ref[k] + g_i[k] for k in ref}
    for k in grads:
        _check(torch.allclose(grads[k], ref[k] / n_devices, rtol=2e-5, atol=2e-5),
               f"gradient {k} summed over ranks against the per-shard average")

    line = (f"dryrun_multichip({n_devices}): ok on {dev} — PPO loss={float(metrics['loss']):.4f} "
            f"(B={B}, {B // n_devices} a rank); sharded packed rollout bit-exact over "
            f"{n_devices} ranks; fast-PPO loss={float(fmetrics['loss']):.4f} with lane-sharded "
            f"batch (B={Bp}); sharded actions kernel bit-exact (B={Bf}); pixel-PPO "
            f"loss={float(xmetrics['loss']):.4f} (B={Bx}); gradient kernel per shard, summed "
            f"over {n_devices} ranks, matches the per-shard average (N={Nk}) — "
            f"6 sharded paths validated")
    return line


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    initialize_distributed(device=args.device)
    mesh = make_env_mesh(device=args.device)
    line = dryrun_multichip(mesh.size, args.device)
    if mesh.rank == 0:
        print(line, flush=True)
    if mesh.group is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
