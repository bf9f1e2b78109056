"""The port's last entry points (``gym_craftingworld_tpu_torch/tools/``:
``bench``, ``fast_ppo_prof``, ``collect_prof``, ``ppo_prof``, ``cpv_debug``,
``expert_probe``) on the CPU, against the JAX package's tools where the
streams allow.

``bench`` names its metric by the root ``bench.py``'s formula (read from its
source) and its checksum is the engine's own; the profilers count the
kernels (here, on the CPU, their plain versions) each phase ran; the
expert's episodes and the CPV failure classes equal the JAX tools' through
the JAX façade in parity mode, where both draw the reference's worlds. The
host clock times these runs: no number here is a device number.
"""

import ast
import dataclasses
import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_craftingworld_tpu import constants as JC
from gym_craftingworld_tpu.agents.expert import ExpertPolicy as JExpert
from gym_craftingworld_tpu.api import gym_env as jge
import gym_craftingworld_tpu_torch as cw
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core import slots as sm
from gym_craftingworld_tpu_torch.core.rollout import rollout_random
from gym_craftingworld_tpu_torch.ops import obs_rollout as obr
from gym_craftingworld_tpu_torch.ops import packed_fused as pf
from gym_craftingworld_tpu_torch.ops import packed_rollout as pr
from gym_craftingworld_tpu_torch.ops import transposed_rollout as tr
from gym_craftingworld_tpu_torch.ops import threefry as tf
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools import (bench, collect_prof, cpv_debug, cpv_matrix,
                                               expert_probe, fast_ppo_prof, ppo_prof)
from gym_craftingworld_tpu_torch.train import fast_ppo as fp
from gym_craftingworld_tpu_torch.train import ppo as tppo

import test_torch_tools
from test_torch_canonical_tools import REPO, jax_tool
from test_torch_cpv import cpv_init

torch.set_num_threads(1)

NEW_TOOLS = ("bench", "fast_ppo_prof", "collect_prof", "ppo_prof", "cpv_debug", "expert_probe")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "runs", "min", "max", "spread_pct"}
RELAY_KEYS = {"pairs", "outliers_dropped", "stall_retries", "measurement_takes",
              "timing_fallback"}


def jax_bench_metric(layout: str, B: int) -> str:
    """The root ``bench.py``'s metric name, by evaluating the expression its
    ``main`` prints under ``"metric"``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    (expr,) = [v for node in ast.walk(tree) if isinstance(node, ast.Dict)
               for k, v in zip(node.keys, node.values)
               if isinstance(k, ast.Constant) and k.value == "metric"]
    return eval(compile(ast.Expression(expr), "bench.py", "eval"), {"layout": layout, "B": B})


def jax_bench_keys() -> set:
    """Every key the root ``bench.py`` prints (its JSON dict and the spread
    dicts it merges in)."""
    keys = set()
    for node in ast.walk(ast.parse((REPO / "bench.py").read_text())):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant) \
                and getattr(node.value, "id", None) == "spread":
            keys.add(node.slice.value)
    return keys


@pytest.mark.parametrize("layout", bench.LAYOUTS)
def test_bench_prints_bench_py_s_line(layout, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_LAYOUT", layout)
    monkeypatch.setenv("BENCH_ENVS", "64")
    monkeypatch.setenv("BENCH_STEPS", "8")
    monkeypatch.setenv("BENCH_ITERS", "2")
    pf.rollout_packed_bench_plain.calls = 0
    line = bench.main(["--device", "cpu"])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert printed == [line]
    assert line["metric"] == jax_bench_metric(layout, 64) == bench.metric_name(layout, 64)
    assert BENCH_KEYS <= jax_bench_keys() and not RELAY_KEYS & set(line)
    assert set(line) == BENCH_KEYS | {"device", "timing"}
    assert line["device"] == "cpu" and line["timing"] == "host_clock" and line["runs"] == 2
    assert line["unit"] == "env-steps/s" and line["min"] <= line["value"] <= line["max"]
    base = json.loads((REPO / "BASELINE_MEASURED.json").read_text())
    assert line["vs_baseline"] == round(line["value"] / base["reference_single_env_steps_per_s"], 1)
    # the bench kernel's plain version ran once for the warm-up and once a run
    assert pf.rollout_packed_bench_plain.calls == (3 if layout == "packed_fused" else 0)


def direct(layout, cfg, state, key, T):
    """The engine ``layout`` names, called on its own from its own layout's
    ``state`` (an EnvState for ``grid``, else a SlotState) with key data
    ``key``: (final state, checksum). ``packed_fused``'s seed is JAX's
    ``randint(key, (), 0, 2**31 - 1)``, drawn here by ``ops/threefry``."""
    if layout == "grid":
        st, out = rollout_random(cfg, state, key, T)
        return st, out.reward.sum(dtype=torch.int64)
    if layout == "packed_fused":
        return pf.fused_rollout_packed_bench(cfg, state, int(tf.randint(key, (), 0, 2**31 - 1)), T)
    if layout == "packed":
        return pr.rollout_p_bench(cfg, state, key, T)
    if layout.startswith("obs_"):
        return obr.rollout_obs_random(cfg, state, key, T, layout[4:])
    engine = tr.rollout_t_random if layout == "transposed" else sm.rollout_slots_random
    st, out = engine(cfg, state, key, T)
    return st, out.reward.sum(dtype=torch.int64)


@pytest.mark.parametrize("layout", bench.LAYOUTS)
def test_bench_checksum_is_the_named_engine_s(layout):
    """``bench``'s engine from a state and key gives the checksum and final
    state of a direct call of the engine it names; its warm-up (``PRNGKey(0)``)
    and timed runs (``fold_in(PRNGKey(0), i)``) continue from each run's
    state, so their checksums are those of the direct calls chained the same
    way with those keys."""
    cfg = cw.ray_config()
    start = lambda seed: (lambda s: s if layout == "grid" else sm.from_env_state(s))(
        cw.reset_from_seed(cfg, seed, 48, device="cpu"))
    roll, st0 = bench.make_engine(layout, cfg, cw.reset_from_seed(cfg, 4, 48, device="cpu"))
    got_st, got = roll(st0, prng_key(5), 12)
    want_st, want = direct(layout, cfg, start(4), prng_key(5), 12)
    assert got.dtype == want.dtype == torch.int64 and int(got) == int(want)
    fields = lambda st: ([getattr(st, f.name) for f in dataclasses.fields(st)]
                         if dataclasses.is_dataclass(st) else list(st))
    assert all(torch.equal(a, b) for a, b in zip(fields(got_st), fields(want_st)))
    measured = bench.measure(layout, 48, 12, 2, "cpu")["checksums"]
    st, chained = start(0), []
    for key in (prng_key(0), tf.fold_in(prng_key(0), 0), tf.fold_in(prng_key(0), 1)):
        st, c = direct(layout, cfg, st, key, 12)
        chained.append(int(c))
    assert measured == chained and any(measured)


def small_fast_ppo(monkeypatch, *modules):
    """The default FastPPOConfig cut to hidden 32 and T = 8 in the tools."""
    small = functools.partial(fp.FastPPOConfig, hidden=32, rollout_steps=8)
    for m in modules:
        monkeypatch.setattr(m.fp, "FastPPOConfig", small)


def by_phase(lines):
    return {l["phase"]: l for l in lines}


def test_fast_ppo_prof_counts_each_phase_s_kernels(monkeypatch, capsys):
    small_fast_ppo(monkeypatch, fast_ppo_prof)
    lines = fast_ppo_prof.main(["256", "1", "--device", "cpu"])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert printed == lines and all(l["card"] == "cpu" for l in lines)
    ph = by_phase(lines)
    assert list(ph) == ["pool", "collect", "gae", "update", "full", "sum"]
    T, E, M = 8, 2, 8
    want = {"pool": {"fresh_packed_plain": 1.0}, "collect": {"rollout_packed_actions_plain": T},
            "gae": {}, "update": {"ppo_grads_plain": E * M},
            "full": {"fresh_packed_plain": 1.0, "rollout_packed_actions_plain": T,
                     "ppo_grads_plain": E * M}}
    for k, calls in want.items():
        assert ph[k]["plain_calls"] == calls and ph[k]["launches"] == {}, k
        assert ph[k]["device_ms"] is None and ph[k]["timing"] == "host_clock"
    s = ph["sum"]
    assert s["sum_ms"] == pytest.approx(sum(ph[k]["ms"] for k in s["parts"]))
    assert s["sum_over_full"] == pytest.approx(s["sum_ms"] / ph["full"]["ms"])


def test_collect_prof_variants_from_fast_ppo_s_pieces(monkeypatch):
    """``full`` is ``_collect``; ``nostore`` takes the same actions from the
    same uniforms, so it reaches the same env; ``policyonly`` steps nothing;
    each variant but ``policyonly`` steps every env T times."""
    cfg, fppo = cw.ray_config(), fp.FastPPOConfig(hidden=32, rollout_steps=8)
    ts = fp.init_fast_train_state(prng_key(0), cfg, fppo)
    env = fp.fresh_packed_batch(cfg, prng_key(1), 64)
    pool = fp._fresh_pool(cfg, prng_key(2), 128)
    u = fp.gumbel_uniforms(prng_key(3), 8, 64)
    v = collect_prof.variants(cfg, fppo, ts.params, pool, u)
    assert list(v) == ["full", "nostore", "noreset", "nosample", "policyonly", "steponly"]
    with torch.no_grad():
        want_env, traj = fp._collect(cfg, fppo, ts.params, env, pool, u)
        outs = {}
        for name, collect in v.items():
            calls = pf.rollout_packed_actions_plain.calls
            outs[name] = collect(env)
            assert pf.rollout_packed_actions_plain.calls - calls == (0 if name == "policyonly" else 8)
    for a, b in zip(outs["full"][0], want_env):
        assert torch.equal(a, b)
    for a, b in zip(outs["nostore"][0], want_env):
        assert torch.equal(a, b)
    want = traj.log_prob.sum() + traj.value.sum()
    assert float(outs["nostore"][1]) == pytest.approx(float(want), rel=1e-5)
    assert outs["policyonly"][0] is env


def test_collect_prof_prints_a_line_a_variant(monkeypatch, capsys):
    small_fast_ppo(monkeypatch, collect_prof)
    lines = collect_prof.main(["128", "1", "--device", "cpu"])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert printed == lines and all(l["card"] == "cpu" for l in lines)
    ph = by_phase(lines)
    assert ph["full"]["plain_calls"] == {"rollout_packed_actions_plain": 8.0}
    assert ph["policyonly"]["plain_calls"] == {}
    assert all(ph[k]["env_steps_per_s"] > 0 for k in ph if k != "sum")
    assert ph["sum"]["parts"] == ["policyonly", "steponly"]


def test_ppo_prof_times_the_jax_tool_s_stages(monkeypatch, capsys):
    monkeypatch.setenv("B", "16")
    monkeypatch.setattr(ppo_prof.P, "PPOConfig",
                        functools.partial(tppo.PPOConfig, hidden=32, rollout_steps=8))
    monkeypatch.setattr(ppo_prof, "STAGE_STEPS", 4)
    lines = ppo_prof.main(["--device", "cpu", "--reps", "1"])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert printed == lines
    assert [l["stage"] for l in lines] == ["train_step", "collect", "reset", "grid_step",
                                           "policy_forward", "update_epoch"]
    assert all(l["card"] == "cpu" and l["launches"] == {} and l["plain_calls"] == {}
               for l in lines)
    assert lines[0]["env_steps_per_s"] == pytest.approx(16 * 8 / (lines[0]["ms"] / 1e3))


def jax_env(kind: str, task, seed: int, rng_mode: str):
    """The JAX tool's env of an episode (``tools/expert_probe.py``)."""
    if kind == "single":
        return jge.CraftingWorldEnvRay(seed=seed, selected_tasks=[task], stacking=False,
                                       max_steps=300, rng_mode=rng_mode)
    if kind == "stacked":
        return jge.CraftingWorldEnvRay(seed=seed, stacking=True, max_steps=300,
                                       rng_mode=rng_mode)
    return jge.CraftingWorldEnvFlat(seed=seed, stacking=True, rng_mode=rng_mode)


def jax_probe(mode: str, seeds: int, rng_mode: str = "parity") -> list:
    """The JAX tool's loop (``tools/expert_probe.py``) through the JAX façade
    (in parity mode unless asked): every episode's (kind, task, seed, reward,
    desired, achieved, success)."""
    out = []
    for kind, task, seed, _ in expert_probe.episodes(mode, seeds):
        env = jax_env(kind, task, seed, rng_mode)
        env.reset()
        r = JExpert(env).run_episode()
        d = np.asarray(env.desired_goal_vector).reshape(-1).tolist()
        a = np.asarray(env.achieved_goal_vector).reshape(-1).tolist()
        out.append((kind, task, seed, int(r), d, a, bool(r == env.MAX_STEPS)))
    return out


def test_expert_probe_equals_the_jax_tool_in_parity_mode(capsys):
    """The first two seeds of every mode (22 episodes): every episode's
    reward, desired and achieved bits, and so the failure list, equal the
    JAX tool's loop through the JAX façade; the seeds and modes are the JAX
    tool's."""
    assert expert_probe.SEEDS["single"] == [7, 20, 33, 46, 59, 72, 85, 98, 111, 124]
    got = expert_probe.probe("all", 2, "cpu", "parity")
    want = jax_probe("all", 2)
    assert len(got) == 9 * 2 + 2 + 2 and got == want
    assert expert_probe.failures(got) == [r[:3] + r[4:6] for r in want if not r[6]]
    fails = expert_probe.main(["flat", "--seeds", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    line = json.loads(out[-1])
    assert line["card"] == "cpu" and line["failures"] == fails and line["episodes"] == 1
    assert out[-2] == f"total failures: {len(fails)}"


def test_expert_probe_in_fast_mode_sees_the_jax_tool_s_worlds():
    """The port's fast-mode façade (the tools' default) resets to the JAX
    façade's fast-mode worlds on the first seed of each of the tool's modes
    (every observation array, the goal vectors), since both draw them from
    JAX's key chain; and ``probe`` in fast mode on ``flat`` seeds 0-1
    reports the JAX tool's episodes and failures."""
    seen = set()
    for kind, task, seed, make_env in expert_probe.episodes("all", 1):
        if kind in seen:
            continue
        seen.add(kind)
        je, te = jax_env(kind, task, seed, "fast"), make_env(device="cpu", rng_mode="fast")
        jo, to = je.reset(), te.reset()
        if not isinstance(jo, dict):  # the flat env observes one array
            jo, to = {"obs": jo}, {"obs": to}
        for k in jo:
            np.testing.assert_array_equal(to[k], jo[k], err_msg=f"{kind}: {k}")
        for v in ("desired_goal_vector", "achieved_goal_vector"):
            np.testing.assert_array_equal(np.asarray(getattr(te, v)), np.asarray(getattr(je, v)))
    assert seen == {"single", "stacked", "flat"}
    got = expert_probe.probe("flat", 2, "cpu", verbose=False)
    want = jax_probe("flat", 2, "fast")
    assert got == want and len(got) == 2
    assert expert_probe.failures(got) == [r[:3] + r[4:6] for r in want if not r[6]]


def test_expert_probe_prints_failures_in_the_jax_format(monkeypatch, capsys):
    """An expert that never finishes fails every episode, each printed as the
    JAX tool prints it."""
    monkeypatch.setattr(expert_probe, "ExpertPolicy",
                        lambda env: SimpleNamespace(run_episode=lambda: -1))
    recs = expert_probe.probe("all", 1, "cpu")
    lines = capsys.readouterr().out.splitlines()
    names = list(JC.TASK_LIST)
    want = []
    for k, t, s, _, d, a, ok in recs:
        assert not ok
        if k == "single":
            want.append(" ".join(map(str, ["FAIL single", t, "seed", s, "desired",
                                           np.flatnonzero(d), "achieved", np.flatnonzero(a)])))
        else:
            want.append(" ".join(map(str, [f"FAIL {k} seed", s, "desired",
                                           [names[i] for i in np.flatnonzero(d)], "achieved",
                                           [names[i] for i in np.flatnonzero(a)]])))
    assert lines == want and len(expert_probe.failures(recs)) == 11


@pytest.fixture(scope="module")
def cpv_8x8():
    """A CPVPolicy with the init view JAX trained (the ``cpv_matrix`` tool's
    ``scan_bc_train``) on the port's tool data before DAgger, its variables
    as numpy, and the port's module holding them."""
    jcm = jax_tool("cpv_matrix")
    demos = cpv_matrix.training_demos(8, 5, 16, "cpu")
    model, v = cpv_init(6, embed_dim=32, hidden=64, with_init=True)
    params = jcm.scan_bc_train(demos, jax.random.PRNGKey(7), model, v, epochs=30, batch=128,
                               lr=2e-3)
    params = jax.tree.map(np.asarray, params)
    return model, params, interop.cpv_policy_from_numpy(params, 8, 8, with_init=True,
                                                        device="cpu")


def test_cpv_debug_classifies_a_pair_as_the_jax_tool(cpv_8x8, monkeypatch):
    """``trace_pair`` on parameters JAX trained, carried across by
    ``interop``, gives the JAX tool's counts on the same pairs and worlds
    (both façades in parity mode): successes, and failures by class."""
    model, params, port = cpv_8x8
    jcd = jax_tool("cpv_debug")
    monkeypatch.setattr(jge, "CraftingWorldEnvRay",
                        functools.partial(jge.CraftingWorldEnvRay, rng_mode="parity"))
    args = SimpleNamespace(seed=5, pool=16)
    seen = {}
    # the model is trained on the tool's data, JAX's worlds since the keyed
    # resets: MakeBread+ChopTree gives a second failure class beside the stalls
    for spec in ("GoToHouse+MoveAxe", "MakeBread+ChopTree"):
        pair = tuple(spec.split("+"))
        want = jcd.trace_pair(model, jax.tree.map(jnp.asarray, params), pair, args, episodes=6,
                              verbose=0)
        got = cpv_debug.trace_pair(port, pair, 5, 16, episodes=6, verbose=0, rng_mode="parity")
        assert got == want, spec
        for k, n in got.items():
            seen[k] = seen.get(k, 0) + n
    assert sum(seen.values()) == 12 and sum(1 for n in seen.values() if n) >= 2


def test_cpv_debug_main_trains_saves_and_reloads(tmp_path, capsys):
    argv = ["--device", "cpu", "--episodes-per-task", "1", "--epochs", "1", "--hidden", "16",
            "--episodes", "1", "--verbose", "0", "--params", str(tmp_path / "p.pt"),
            "--pairs", "MakeBread+ChopTree"]
    first = cpv_debug.main(argv)
    assert (tmp_path / "p.pt").exists()
    again = cpv_debug.main(argv)
    out = capsys.readouterr().out
    assert "loaded" in out and first == again and first["card"] == "cpu"
    assert sum(first["pairs"]["MakeBread+ChopTree"].values()) == 1


def test_failure_kind_names_jax_s_classes():
    """``tools/cpv_debug.py``'s rule: an undesired latch first, then a tail
    of 12 states with at most 4 values, else a timeout."""
    from gym_craftingworld_tpu_torch.tools._cpv import failure_kind

    cycle = [1, 2, 3, 4] * 5
    assert failure_kind(True, cycle) == "wrong_latch"
    assert failure_kind(False, cycle) == "stall"
    assert failure_kind(False, list(range(40)) + cycle[:12]) == "stall"
    assert failure_kind(False, cycle[:11] + [9]) == "timeout"
    assert failure_kind(False, list(range(5))) == "timeout"


@pytest.mark.parametrize("name", NEW_TOOLS)
def test_new_tools_import_no_jax(name):
    path = test_torch_tools.TOOLS / f"{name}.py"
    assert path.exists()
    test_torch_tools.test_tools_import_no_jax(path)
