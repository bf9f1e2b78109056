"""The canonical-training tools (``gym_craftingworld_tpu_torch/tools/``:
``collect_canonical_demos``, ``train_canonical``, ``targeted_dagger``,
``fast_pixel_canonical`` and their shared ``_canonical``) against the JAX
package's ``tools/`` on the CPU.

The JAX tools are loaded from their files (``tools/`` is not a package);
loading one sets a persistent compilation cache in JAX's config, which
``jax_tool`` puts back. Datasets, parameters and reset states cross as numpy
(``interop``). Each tool's ``main`` also runs tiny with ``--device cpu``, where
its timer reads the host clock: no number here is a device number.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_craftingworld_tpu import constants as JC
from gym_craftingworld_tpu.core.reset import reset as jreset
from gym_craftingworld_tpu.train import dagger as jdagger
from gym_craftingworld_tpu.train import demos as jdemos
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.core.state import EnvState
from gym_craftingworld_tpu_torch.models.grid_policy import GridPolicy, init_grid_policy
from gym_craftingworld_tpu_torch.ops import keyed_draws as kd
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools import _canonical as cn
from gym_craftingworld_tpu_torch.tools import (collect_canonical_demos, fast_pixel_canonical,
                                               targeted_dagger, train_canonical)
from gym_craftingworld_tpu_torch.train import dagger as tdagger
from gym_craftingworld_tpu_torch.train import demos as tdemos
from gym_craftingworld_tpu_torch.train.demos import SnapDataset

from test_torch_dagger import CFG, agreeing_envs, trained  # noqa: F401 (a fixture)
from test_torch_packed_rollout import np_tree, tcfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module, JAX's config as it was."""
    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                  "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def snaps():
    """Expert demos on 8x8 (the port's collector; its rows equal JAX's,
    ``tests/test_torch_demos.py``)."""
    return tdemos.collect_expert_demos(tcfg(CFG), 16, seed=3, noise_eps=0.1, batch=8,
                                       device="cpu")


def split(s: SnapDataset, n: int):
    return SnapDataset(*[a[:n] for a in s]), SnapDataset(*[a[n:] for a in s])


def test_pad_and_append_columns_match_jax(snaps):
    """The buffer after two rounds, the second cut at the capacity as the JAX
    tool cuts it (``tools/train_canonical.py:190-192``), equals JAX's column
    by column; an append past the capacity without ``fit`` raises (JAX's
    ``dynamic_update_slice`` would move it back over valid rows)."""
    jtc = jax_tool("train_canonical")
    base, rest = split(snaps, snaps.num_rows // 2)
    first, second = split(rest, rest.num_rows // 3)
    capacity = base.num_rows + first.num_rows + second.num_rows // 2
    want = jtc.pad_columns(base, capacity)
    got = cn.pad_columns(base, capacity, "cpu")
    n_j = n_t = base.num_rows
    for labeled in (first, second):
        cut = labeled
        if n_j + labeled.num_rows > capacity:  # the JAX tool's truncation
            cut = SnapDataset(*[a[: capacity - n_j] for a in labeled])
        n_j = jtc.append_columns(want, cut, n_j)
        n_t = cn.append_columns(got, cn.fit(labeled, capacity, n_t), n_t)
    assert n_t == n_j == capacity < snaps.num_rows
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.array(want[k])).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="overflow"):
        cn.append_columns(got, first, n_t)
    assert cn.fit(first, capacity, capacity).num_rows == 0


def test_full_eval_artifact_matches_jax(trained):  # noqa: F811
    """``full_eval_artifact`` against the JAX tool's on the same reset states
    (JAX's keys of ``PRNGKey(seed)``, carried by ``interop``) and the same
    GridPolicy, over the episodes whose every visited state the two forwards
    order alike (``agreeing_envs``; asserted to be at least 22 of 24)."""
    snaps_, model, ts = trained
    jtd = jax_tool("targeted_dagger")
    jtd.CFG = CFG
    B, seed = 24, 0
    keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed), B))
    params = jax.tree.map(jnp.asarray, ts).params
    cols, live, _ = jdagger._rollout_states(CFG, model, params, keys, jax.random.PRNGKey(0), 0.0)
    ok = agreeing_envs(model, ts, cols, live)
    assert ok.sum() >= B - 2
    inner = jdagger._eval_batch_grid
    jtd.dagger = type("D", (), {"_eval_batch_grid": staticmethod(
        lambda cfg, m, p, k: {n: np.asarray(v)[ok] for n, v in inner(cfg, m, p, k).items()})})
    want = jtd.full_eval_artifact(model, params, B, seed)
    state = interop.env_state_from_numpy(np_tree(jreset(CFG, keys)), "cpu")
    keep = torch.from_numpy(ok)
    state = EnvState(**{f.name: getattr(state, f.name)[keep] for f in dataclasses.fields(EnvState)})
    port = interop.grid_policy_from_numpy(ts.params, device="cpu")
    got = targeted_dagger.full_eval_artifact(tcfg(CFG), port, B, seed, state=state)
    assert 0 < want["success_rate"] < 1  # some won, some lost
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)  # NaN == NaN


def test_artifact_summary_bit_for_bit():
    """The per-skill and per-task-count summary of one evaluation's terminal
    stats (every task count 1-9, every skill desired) equals the JAX tool's,
    float for float."""
    jtd = jax_tool("targeted_dagger")
    rng = np.random.default_rng(0)
    n = 300
    desired = np.zeros((n, JC.N_TASKS), np.int8)
    for i, k in enumerate(rng.integers(1, JC.N_TASKS + 1, n)):
        desired[i, rng.choice(JC.N_TASKS, k, replace=False)] = 1
    out = {"success": rng.random(n) < 0.7, "steps": rng.integers(10, 301, n).astype(np.int32),
           "desired": desired, "achieved": (rng.random((n, JC.N_TASKS)) < 0.8).astype(np.int8)}
    jtd.dagger = type("D", (), {"_eval_batch_grid": staticmethod(lambda *a: out)})
    want = jtd.full_eval_artifact(None, None, n, 424242)
    got = targeted_dagger.artifact_summary({k: torch.from_numpy(v) for k, v in out.items()}, n,
                                           424242)
    assert got == want
    assert sorted(got["success_by_num_tasks"]) == [str(k) for k in range(1, 10)]
    assert sum(v["episodes"] for v in got["success_by_num_tasks"].values()) == n


@pytest.mark.parametrize("frac_fail", [0.5, 0.2, 0.0])
def test_mixed_rows_distribution(frac_fail):
    """``mixed_rows``: the share drawn at ``fail_lo`` or later is ``frac_fail
    + (1 - frac_fail) x`` the uniform share, within 4 sigma; with
    ``frac_fail`` 0 every tenth of the rows holds a tenth of the draws, within
    4 sigma; every id lies below ``n_valid``."""
    n, n_valid, fail_lo = 400_000, 1000, 800
    idx = cn.mixed_rows(n, n_valid, fail_lo, frac_fail, prng_key(11)).numpy()
    assert idx.shape == (n,) and idx.min() >= 0 and idx.max() < n_valid
    p = frac_fail + (1 - frac_fail) * (n_valid - fail_lo) / n_valid
    share = float((idx >= fail_lo).mean())
    assert abs(share - p) <= 4 * np.sqrt(p * (1 - p) / n), (share, p)
    if frac_fail == 0:
        counts = np.bincount(idx // (n_valid // 10), minlength=10)
        assert np.all(np.abs(counts - n / 10) <= 4 * np.sqrt(n * 0.1 * 0.9)), counts
        again = cn.mixed_rows(n, n_valid, n_valid, 0.5, prng_key(11))
        assert torch.equal(again, torch.from_numpy(idx))  # no row past fail_lo: uniform


def test_train_chunk_is_an_epoch_over_uniform_rows(snaps):
    """``train_chunk`` is ``_bc_epoch`` over the ``steps x batch`` ids
    ``randint(key, ..., 0, n_valid)``; one Adam state runs on across a change
    of learning rate (BC to DAgger), as in JAX."""
    cfg = tcfg(CFG)
    data = cn.pad_columns(snaps, snaps.num_rows + 100, "cpu")
    runs = []
    for manual in (False, True):
        ts = tdagger.init_bc_state(init_grid_policy(prng_key(4), cfg, 8, 32))
        for i, lr in enumerate((1e-3, 3e-4)):
            k = prng_key(40 + i)
            if manual:
                idx = kd.randint(k, (3 * 64,), 0, snaps.num_rows)
                ts, stats = tdagger._bc_epoch(cfg, lr, ts, data, idx, 64)
                stats = {k: float(v) for k, v in stats.items()}
            else:
                ts, stats = cn.train_chunk(cfg, ts, data, snaps.num_rows, 3, 64, lr, k)
        runs.append((ts, stats))
    (a, sa), (b, sb) = runs
    assert sa == sb and int(a.opt_state.count) == 6
    for (k, x), (_, y) in zip(a.params.named_parameters(), b.params.named_parameters()):
        assert torch.equal(x, y), k


def test_params_round_trip(tmp_path):
    cfg = tcfg(CFG)
    model = init_grid_policy(prng_key(0), cfg, 8, 32)
    path = cn.save_params(model, tmp_path, "x")
    assert path.name == "params_x.pt"
    other = cn.load_params(init_grid_policy(prng_key(1), cfg, 8, 32), path)
    for (k, x), (_, y) in zip(model.named_parameters(), other.named_parameters()):
        assert torch.equal(x, y), k


def test_demos_npz_reads_back_in_jax(tmp_path):
    """``collect_canonical_demos`` on 21x21 stacked writes a ``SnapDataset``
    npz that JAX's ``SnapDataset.load`` reads back equal, dtypes and all."""
    out = tmp_path / "demos.npz"
    got = collect_canonical_demos.main(["--device", "cpu", "--episodes", "4", "--batch", "2",
                                        "--out", str(out)])
    want = jdemos.SnapDataset.load(str(out))
    assert got.num_episodes == want.num_episodes > 0
    assert jdemos.SnapDataset._fields == SnapDataset._fields
    for k in SnapDataset._fields:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


TINY = ["--device", "cpu", "--capacity", "40000", "--channels", "8", "--hidden", "32",
        "--batch", "64"]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The three canonical tools' ``main`` end to end, tiny, on the CPU."""
    d = tmp_path_factory.mktemp("canonical")
    demos = d / "demos.npz"
    collect_canonical_demos.main(["--device", "cpu", "--episodes", "6", "--batch", "3",
                                  "--out", str(demos)])
    run = d / "run"
    res = train_canonical.main(TINY + [
        "--demos", str(demos), "--out", str(run), "--bc-steps", "8", "--chunk", "2",
        "--dagger-rounds", "1", "--dagger-episodes", "4", "--dagger-max-states", "300",
        "--dagger-steps", "2", "--eval-episodes", "4", "--final-eval-episodes", "4"])
    targeted = targeted_dagger.main(TINY + [
        "--demos", str(demos), "--out", str(run), "--init-params", str(run / "params_final.pt"),
        "--rounds", "1", "--episodes", "4", "--steps", "2", "--eval-episodes", "4",
        "--final-eval-episodes", "6", "--policy-json", str(d / "canonical_policy.json")])
    return d, demos, run, res, targeted


def records(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


EVAL_KEYS = {"success_rate", "mean_episode_steps", "episodes", "skill_completion"}  # summarize's


def test_train_canonical_main_writes_the_jax_records(tiny_run):
    """``metrics.jsonl`` holds JAX's records in JAX's order with their keys,
    plus the card and the stages' host seconds; BC evaluates every 4 chunks;
    the round's appended rows are its relabelled rows."""
    d, demos, run, res, _ = tiny_run
    recs = records(run / "metrics.jsonl")
    extra = {"t", "card"}
    want = {"bc": {"phase", "steps", "loss", "accuracy", "train_s"},
            "eval": {"phase", "tag", "s"} | EVAL_KEYS,
            "dagger_collect": {"phase", "round", "rollout_success", "rows", "n_valid", "states",
                               "collect_s", "relabel_s"},
            "dagger_train": {"phase", "round", "steps", "loss", "accuracy", "train_s"},
            "done": {"phase", "success_rate"}}
    for r in recs:
        assert set(r) == want[r["phase"]] | extra, r
        assert r["card"] == "cpu"
    assert [r.get("tag", r["phase"]) for r in recs] == [
        "bc", "bc", "bc", "bc", "bc8", "bc_final", "dagger_collect", "dagger_train", "dagger0",
        "final", "done"]
    (dg,) = [r for r in recs if r["phase"] == "dagger_collect"]
    n_demos = SnapDataset.load(str(demos)).num_rows
    assert dg["rows"] == SnapDataset.load(str(run / "dagger0.npz")).num_rows == 300
    assert dg["n_valid"] == n_demos + dg["rows"]
    assert res == {k: v for k, v in recs[-2].items() if k in EVAL_KEYS}
    assert {p.name for p in run.glob("params_*.pt")} >= {
        "params_bc.pt", "params_dagger0.pt", "params_final.pt"}
    curve = json.loads((run / "canonical_curve.json").read_text())
    jax_curve = json.loads((REPO / "docs" / "canonical_curve.json").read_text())
    assert [set(c) for c in curve] == [set(jax_curve[0]) | {"card"}] * 4
    assert [c["tag"] for c in curve] == ["bc8", "bc_final", "dagger0", "final"]


def test_train_canonical_resumes_with_prior_rounds(tiny_run, tmp_path):
    """A resumed run (``--init-params``, ``--round-base``) folds the
    ``dagger*.npz`` already in ``--out`` into its dataset, starts from the
    saved parameters and numbers its rounds from the base."""
    d, demos, run, _, _ = tiny_run
    out = tmp_path / "resumed"
    out.mkdir()
    (out / "dagger0.npz").write_bytes((run / "dagger0.npz").read_bytes())
    train_canonical.main(TINY + [
        "--demos", str(demos), "--out", str(out), "--init-params", str(run / "params_final.pt"),
        "--round-base", "1", "--bc-steps", "0", "--dagger-rounds", "1", "--dagger-episodes", "4",
        "--dagger-max-states", "100", "--dagger-steps", "2", "--eval-episodes", "4",
        "--final-eval-episodes", "4"])
    recs = records(out / "metrics.jsonl")
    (dg,) = [r for r in recs if r["phase"] == "dagger_collect"]
    n_demos = SnapDataset.load(str(demos)).num_rows
    assert dg["n_valid"] == n_demos + 300 + dg["rows"] and dg["rows"] == 100
    assert (out / "dagger1.npz").exists() and not (out / "dagger2.npz").exists()
    assert [r.get("tag") for r in recs if r["phase"] == "eval"] == ["bc_final", "dagger0", "final"]
    bc = torch.load(out / "params_bc.pt", weights_only=True)  # the resumed params, untrained
    saved = torch.load(run / "params_final.pt", weights_only=True)
    assert all(torch.equal(bc[k], saved[k]) for k in saved)


def test_targeted_dagger_main_writes_the_jax_artifact(tiny_run):
    """The artifact holds ``docs/canonical_policy.json``'s keys and the card,
    below 0.97 beside ``--policy-json`` as a candidate (as JAX writes it); its
    episodes by task count sum to its episodes; the round appended the rows
    its relabel returned, after the demos and the DAgger round's."""
    d, demos, run, _, targeted = tiny_run
    jax_doc = json.loads((REPO / "docs" / "canonical_policy.json").read_text())
    path = Path(targeted["path"])
    assert path == d / "canonical_policy_candidate.json"
    doc = json.loads(path.read_text())
    assert set(doc) == set(jax_doc) | {"card"} and doc["card"] == "cpu"
    assert set(doc["skill_completion_when_desired"]) == set(jax_doc["skill_completion_when_desired"])
    assert doc["episodes"] == 6 == sum(v["episodes"] for v in doc["success_by_num_tasks"].values())
    assert doc["eval_seed"] == 424242 and doc["policy"] == "GridPolicy(channels=8, hidden=32), greedy argmax"
    recs = records(run / "targeted_metrics.jsonl")
    assert [r["phase"] for r in recs] == ["collect", "train", "eval", "final"]
    (tg,) = [r for r in recs if r["phase"] == "collect"]
    n_prior = SnapDataset.load(str(demos)).num_rows + 300
    assert tg["rows"] == SnapDataset.load(str(run / "targeted0.npz")).num_rows == tg["states"]
    assert tg["n_valid"] == n_prior + tg["rows"]
    model = GridPolicy(21, 21, 8, 32)
    cn.load_params(model, run / "params_targeted_final.pt")
    best = torch.load(run / "params_targeted0.pt", weights_only=True)
    assert all(torch.equal(v, best[k]) for k, v in model.state_dict().items())


def test_pixel_tool_main_writes_the_jax_schema(tmp_path):
    """``fast_pixel_canonical`` by parts into one JSON: the JAX record's keys
    (``config``, ``default``, ``throughput_preset``, the ``stacked`` note),
    the card, the spreads of the timed runs, and the reference block; the
    preset's updates match the default's wall clock."""
    out = tmp_path / "pixel.json"
    small = ["--device", "cpu", "--envs", "256", "--updates", "2", "--rate-updates", "1",
             "--rollout-steps", "8", "--out", str(out)]
    with pytest.raises(SystemExit, match="rate first"):
        fast_pixel_canonical.main(small + ["--part", "preset"])
    fast_pixel_canonical.main(small + ["--part", "rate", "default"])
    doc = fast_pixel_canonical.main(small + ["--part", "preset"])
    assert json.loads(out.read_text()) == doc
    jax_doc = fast_pixel_canonical.jax_record()
    assert set(doc) == {"card", "config", "default", "throughput_preset", "stacked", "reference",
                        "seconds"}
    assert set(jax_doc["config"]) <= set(doc["config"])
    spreads = {"full_loop_env_steps_per_s_spread", "ms_per_update_spread", "runs_ms"}
    assert set(doc["default"]) == set(jax_doc["default"]) | spreads
    assert set(doc["throughput_preset"]) == set(jax_doc["throughput_preset"]) | spreads
    pre = doc["throughput_preset"]
    assert pre["updates_at_matched_wall_clock"] == round(
        2 * doc["default"]["ms_per_update"] / pre["ms_per_update"])
    assert len(pre["single_task_curve"]) == pre["updates_at_matched_wall_clock"]
    assert len(doc["default"]["single_task_curve"]) == 2
    assert doc["stacked"] == {"note": fast_pixel_canonical.STACKED_NOTE}
    assert doc["default"]["policy"] == jax_doc["default"]["policy"]
    assert pre["policy"] == jax_doc["throughput_preset"]["policy"]


def test_compare_windows_on_the_jax_record():
    """The window comparison phase 23 and the records use, on the JAX record
    itself: the default's eight windows (first 1.192e-4, last 6.807e-4, its
    ``single_task_tail_mean``), the preset's dip (1.325e-4 then 6.552e-5), and
    the preset against the default over the 400 updates both have; the
    default's bounds hold on JAX's own curve and fail on a curve that stalls
    or sits 0.7x under it."""
    rec = fast_pixel_canonical.jax_record()
    d, p = rec["default"]["single_task_curve"], rec["throughput_preset"]["single_task_curve"]
    self_cmp = fast_pixel_canonical.compare_windows(d, d)
    assert [w["updates"] for w in self_cmp] == [[i, i + 49] for i in range(0, 400, 50)]
    assert all(w["ratio"] == 1.0 for w in self_cmp)
    assert self_cmp[0]["port"] == pytest.approx(1.192e-4, abs=1e-7)
    assert self_cmp[-1]["port"] == pytest.approx(rec["default"]["single_task_tail_mean"], rel=1e-12)
    pre = fast_pixel_canonical.compare_windows(p, d)
    assert len(pre) == 8
    assert pre[0]["port"] == pytest.approx(1.325e-4, abs=1e-7)
    assert pre[1]["port"] == pytest.approx(6.552e-5, abs=1e-8)
    assert pre[1]["port"] / pre[0]["port"] == pytest.approx(0.494, abs=1e-3)
    assert fast_pixel_canonical.compare_windows(p[:120], d)[-1]["updates"] == [50, 99]
    held = fast_pixel_canonical.default_bounds(self_cmp)
    assert held["held"] and held["rising"] and held["last_window_ratio"] == 1.0
    flat = fast_pixel_canonical.compare_windows(d[:200] + d[150:200] * 4, d)  # stalls at 200
    assert not fast_pixel_canonical.default_bounds(flat)["rising"]
    low = fast_pixel_canonical.compare_windows([0.7 * x for x in d], d)
    assert fast_pixel_canonical.default_bounds(low)["held"] is False
