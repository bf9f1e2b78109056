"""The snapshot trainer, greedy evaluation and DAgger (``train/dagger``)
against the JAX package's, on the CPU.

Datasets come from JAX's lockstep expert collection, parameters and optimizer
states through ``interop``, resets and exploration draws from JAX's keys.
Evaluation, visited states and relabels are integers and must match bit for
bit; one epoch of training from JAX's carried state within the tolerance
stated at its test, beside the error measured when it was written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_craftingworld_tpu import constants as C
from gym_craftingworld_tpu.config import EnvConfig
from gym_craftingworld_tpu.core.reset import reset as jreset
from gym_craftingworld_tpu.models import grid_policy as jgp
from gym_craftingworld_tpu.train import dagger as jdagger
from gym_craftingworld_tpu.train import demos as jdemos
from gym_craftingworld_tpu.train import evaluate as jev
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.models import cpv as tcpv
from gym_craftingworld_tpu_torch.models import grid_policy as tgp
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.train import dagger as tdagger
from gym_craftingworld_tpu_torch.train import evaluate as tev

from test_torch_packed_rollout import np_tree, tcfg

torch.set_num_threads(1)

# one walk-onto task an episode, so that a policy cloned from a few dozen
# demos already wins some of its greedy episodes
CFG = EnvConfig(height=8, width=8, max_steps=100, stacking=False,
                selected_task_indices=(C.T_CHOP_TREE, C.T_EAT_BREAD))
COLS = ("occ_key", "occ_code", "init_key", "init_agent_key", "agent_key", "holding", "desired",
        "achieved")


def host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained():
    """JAX's expert demos on 8x8 and a GridPolicy JAX trained on them for 16
    epochs (its greedy episodes are neither all won nor all lost), its state
    as numpy: JAX's epoch donates the state it is given."""
    snaps = jdemos.collect_expert_demos(CFG, num_episodes=48, seed=0, noise_eps=0.1, batch=24)
    model = jgp.GridPolicy(channels=16, hidden=64)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, jgp.N_PLANES), jnp.bfloat16),
                            jnp.zeros((1, jgp.N_EXTRAS), jnp.bfloat16))  # eager init compiles op by op
    ts = jdagger.BCTrainState(v, jdagger._make_tx(3e-3).init(v))
    model, ts, hist = jdagger.bc_train_snaps(CFG, snaps, key=0, model_and_state=(model, ts),
                                             epochs=16, batch_size=128, lr=3e-3)
    return snaps, model, host(ts)


def on_jax(ts):
    return jax.tree.map(jnp.asarray, ts)


def port_state(ts):
    return interop.bc_train_state_from_numpy(ts.params, ts.opt_state, device="cpu")


def agreeing_envs(model, ts, cols, live) -> np.ndarray:
    """bool[B]: the envs on whose every live visited state (JAX's snapshot
    columns [T, B]) the port's forward picks JAX's greedy action. The bf16
    forwards agree within 2e-2, not bit for bit, so two near-tied logits can
    order differently; an env past such a state follows another path."""
    T, B = live.shape
    rows = [np.asarray(cols[k]).reshape((T * B,) + np.shape(cols[k])[2:]) for k in COLS]
    jl, _ = jax.jit(model.apply)(on_jax(ts).params, *jgp.planes_from_snaps(CFG, *rows))
    port = interop.grid_policy_from_numpy(ts.params, device="cpu")
    with torch.no_grad():
        tl, _ = port(*tgp.planes_from_snaps(tcfg(CFG), *(torch.from_numpy(r) for r in rows)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-2)
    same = (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).reshape(T, B)
    return (same | ~np.asarray(live)).all(axis=0)


def test_bc_train_snaps_one_epoch_matches_jax(trained):
    """One epoch of ``bc_train_snaps`` continued from JAX's carried
    ``BCTrainState`` with JAX's permutation: clip 1.0 + Adam, the remainder
    rows dropped. The loss within rtol 1e-3 / atol 1e-3 (measured 8.5e-5);
    the accuracy, a mean of argmaxes over bf16 logits, within 2 rows a
    minibatch, atol 2/256 (measured 2.0e-3); every parameter within 2e-3
    relative L2 (measured max 1.9e-4) and the Adam count exact."""
    snaps, model, ts = trained
    key = jax.random.PRNGKey(7)
    _, jts, jh = jdagger.bc_train_snaps(CFG, snaps, key, model_and_state=(model, on_jax(ts)), epochs=1,
                                        batch_size=256, lr=3e-4)
    # the permutation bc_train_snaps draws from ``key``
    key, _ = jax.random.split(key)
    _, k_perm = jax.random.split(key)
    perm = np.array(jax.random.permutation(k_perm, snaps.num_rows))
    calls = pf.rollout_packed_actions_plain.calls
    tts, th = tdagger.bc_train_snaps(tcfg(CFG), snaps, prng_key(7), state=port_state(ts),
                                     epochs=1, batch_size=256, lr=3e-4, perms=[perm])
    assert pf.rollout_packed_actions_plain.calls == calls
    np.testing.assert_allclose(th[0]["loss"], jh[0]["loss"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(th[0]["accuracy"], jh[0]["accuracy"], rtol=0, atol=2 / 256)
    want = interop._flat_tree(host(jts.params["params"]))
    got = {k: v.detach().numpy() for k, v in tts.params.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():  # (the value head takes no gradient: zeros both)
        assert np.linalg.norm(got[k] - w) <= 2e-3 * np.linalg.norm(w), k
    assert int(tts.opt_state.count) == int(host(jts.opt_state)[1][0].count)


def test_eval_batch_grid_matches_jax(trained):
    """Greedy episodes of the trained policy from JAX's reset states: on every
    env whose visited states the two forwards order alike (all 24 here, 5
    of them won; asserted to be at least 22), the port's success, steps, desired and
    achieved bits equal JAX's. The visited states are JAX's greedy
    ``_rollout_states`` (eps 0), the same episodes."""
    snaps, model, ts = trained
    B = 24
    keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(0), B))
    want = host(jdagger._eval_batch_grid(CFG, model, on_jax(ts).params, keys))
    cols, live, _ = jdagger._rollout_states(CFG, model, on_jax(ts).params, keys,
                                            jax.random.PRNGKey(0), 0.0)
    ok = agreeing_envs(model, ts, cols, live)
    assert ok.sum() >= B - 2
    port = interop.grid_policy_from_numpy(ts.params, device="cpu")
    got = tdagger._eval_batch_grid(tcfg(CFG), port,
                                   interop.env_state_from_numpy(np_tree(jreset(CFG, keys)), "cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy()[ok], want[k][ok], err_msg=k)
    assert 0 < want["success"].sum() < B  # some won, some lost
    if ok.all():
        assert tev.summarize(got) == jev.summarize(want)
    out = tdagger.evaluate_grid_policy(tcfg(CFG), port, num_episodes=8, seed=1)
    assert out["episodes"] == 8 and 0 < out["mean_episode_steps"] <= CFG.max_steps


def jax_explore(seed, T, B):
    """The exploration draws JAX's ``_rollout_states`` takes from its key."""
    us, acts = [], []
    for k in jax.random.split(jax.random.PRNGKey(seed ^ 0xDA66E4), T):
        k_u, k_a = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(k_u, (B,))))
        acts.append(np.asarray(jax.random.randint(k_a, (B,), 0, 4)))
    return torch.as_tensor(np.stack(us)), torch.as_tensor(np.stack(acts))


@pytest.mark.parametrize("mode", ["all", "failures_only", "max_states"])
def test_collect_policy_states_matches_jax(trained, mode):
    """Visited states of eps-greedy rollouts (eps 0.3) from JAX's resets and
    exploration draws: the port's snapshot columns and success rate equal
    JAX's, in each collection mode. The two forwards order every visited
    state's logits alike here (asserted; ``agreeing_envs``), so the episodes
    are the same."""
    snaps, model, ts = trained
    B, seed = 12, 4
    cols, live, _ = jdagger._rollout_states(CFG, model, on_jax(ts).params, jax.random.key_data(
        jax.random.split(jax.random.PRNGKey(seed), B)), jax.random.PRNGKey(seed ^ 0xDA66E4), 0.3)
    assert agreeing_envs(model, ts, cols, live).all()
    kw = dict(explore_eps=0.3, failures_only=mode == "failures_only",
              max_states=50 if mode == "max_states" else None)
    want, wsr = jdagger.collect_policy_states(CFG, model, on_jax(ts).params, B, seed=seed, **kw)
    keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed), B))
    state = interop.env_state_from_numpy(np_tree(jreset(CFG, keys)), "cpu")
    port = interop.grid_policy_from_numpy(ts.params, device="cpu")
    got, sr = tdagger.collect_policy_states(tcfg(CFG), port, B, seed=seed, state=state,
                                            explore=jax_explore(seed, CFG.max_steps, B), **kw)
    assert sr == wsr and set(got) == set(want)
    assert len(want["agent_key"]) > (0 if mode == "failures_only" else 49)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_expert_relabel_matches_jax_and_the_collected_labels(trained):
    """The expert is a deterministic function of the snapshot row: the port's
    relabel of collected rows equals JAX's and the recorded labels."""
    snaps = trained[0]
    rows = np.random.RandomState(0).choice(snaps.num_rows, 64, replace=False)
    cols = {k: getattr(snaps, k)[rows] for k in tdagger._COL_FIELDS}
    got = tdagger.expert_relabel(tcfg(CFG), cols)
    np.testing.assert_array_equal(got.action, jdagger.expert_relabel(CFG, cols).action)
    np.testing.assert_array_equal(got.action, snaps.action[rows])


def test_bc_train_snaps_and_dagger_round_smoke(trained):
    """The port on its own draws: a fresh GridPolicy learns, a CPVGridPolicy
    trains through ``state``, and one DAgger round grows the dataset."""
    snaps = trained[0]
    cfg = tcfg(CFG)
    ts, hist = tdagger.bc_train_snaps(cfg, snaps, prng_key(0), epochs=3, batch_size=256,
                                      channels=16, hidden=64)
    assert hist[-1]["loss"] < hist[0]["loss"]
    cpv = tdagger.init_bc_state(tcpv.init_cpv_grid(prng_key(1), cfg, channels=8, hidden=32,
                                                   embed_dim=8))
    cts, chist = tdagger.bc_train_snaps(cfg, snaps, 2, state=cpv, epochs=2, batch_size=256)
    assert chist[-1]["loss"] < chist[0]["loss"] and int(cts.opt_state.count) > 0
    ts, dataset, info = tdagger.dagger_round(cfg, ts, snaps, round_idx=0, key=prng_key(3),
                                             num_episodes=8, max_states=200, epochs=1,
                                             batch_size=256)
    assert snaps.num_rows < dataset.num_rows <= snaps.num_rows + 200
    assert 0.0 <= info["rollout_success"] <= 1.0 and len(info["history"]) == 1
