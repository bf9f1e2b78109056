"""The last canonical tools (``gym_craftingworld_tpu_torch/tools/``:
``finetune_canonical``, ``pixel_distill``) and the CPV tool's carried pool
against the JAX package's ``tools/`` on the CPU.

The JAX tools are loaded from their files (``jax_tool``). Parameters, reset
states and pools cross as numpy (``interop``); the port draws from the same
key data as the JAX tools (``tests/test_torch_keyed_tools.py`` holds the
draws themselves), and the tests of one piece take JAX's draws, recovered
from its keys, explicitly. Integer results must match bit for bit; bf16
forwards within the tolerances stated at each test. ``main`` runs tiny with ``--device cpu``,
where its timers read the host clock: no number here is a device number.
"""

import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_craftingworld_tpu.core.reset import reset as jreset
from gym_craftingworld_tpu.core.step import _step_one
from gym_craftingworld_tpu.models import cnn as jcnn
from gym_craftingworld_tpu.models import grid_policy as jgp
from gym_craftingworld_tpu.train import dagger as jdagger
from gym_craftingworld_tpu_torch import interop
from gym_craftingworld_tpu_torch.models.grid_policy import planes_from_snaps, snap_columns_from_state
from gym_craftingworld_tpu_torch.ops.threefry import prng_key
from gym_craftingworld_tpu_torch.tools import _canonical
from gym_craftingworld_tpu_torch.tools import cpv_canonical as cc
from gym_craftingworld_tpu_torch.tools import finetune_canonical as ftc
from gym_craftingworld_tpu_torch.tools import pixel_distill as pd
from gym_craftingworld_tpu_torch.train import dagger as tdagger

from test_torch_canonical_tools import REPO, jax_tool
from test_torch_dagger import CFG, agreeing_envs, host, on_jax, trained  # noqa: F401 (a fixture)
from test_torch_keyed_trainers import NOISE_ULPS, noise_ulps
from test_torch_learning import GUMBEL_SLACK
from test_torch_packed_rollout import assert_tree_equal, np_tree, tcfg

torch.set_num_threads(1)

# bf16 forwards of the two packages (test_torch_dagger.agreeing_envs)
LOGIT_TOL = dict(rtol=2e-2, atol=2e-2)
# one minibatch's loss and the parameters per optimizer step
# (tests/test_torch_fast_pixel_ppo.py:189-193)
LOSS_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def jpd():
    return jax_tool("pixel_distill")


@pytest.fixture(scope="module")
def jft():
    return jax_tool("finetune_canonical")


@functools.lru_cache(maxsize=4)
def live_states(seed: int, B: int, steps: int):
    """JAX's reset of ``B`` worlds on 8x8 after ``steps`` random actions (some
    agents holding), as numpy."""
    st = jreset(CFG, jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed), B)))
    step = jax.jit(jax.vmap(functools.partial(_step_one, CFG)))
    acts = jax.random.randint(jax.random.PRNGKey(seed + 1), (steps, B), 0, 6, jnp.int32)
    for a in acts:
        st, _ = step(st, a)
    return np_tree(st)


def jax_cols(jpd, st: dict) -> dict:
    """JAX's snapshot and goal columns of a numpy state, as numpy."""
    from gym_craftingworld_tpu.core.state import EnvState as JEnvState

    js = JEnvState(**{k: jnp.asarray(v) for k, v in st.items()})
    cols = {**jgp.snap_columns_from_state(CFG, js), **jpd.goal_columns_from_state(CFG, js)}
    return {k: np.asarray(v) for k, v in cols.items()}


def port_cols(st: dict) -> dict:
    ts = interop.env_state_from_numpy(st, "cpu")
    return {**snap_columns_from_state(tcfg(CFG), ts), **pd.goal_columns_from_state(tcfg(CFG), ts)}


def tensors(cols: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in cols.items()}


def assert_same(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# pixel_distill: the column helpers
# ---------------------------------------------------------------------------


def test_goal_columns_and_grids_bit_for_bit(jpd):
    """``goal_columns_from_state``, ``grids_from_occ`` (current and goal) and
    ``init_grids_from_keys`` of 64 live 8x8 worlds equal the JAX tool's, dtype
    and value; the rebuilt grids are the states' own (init: the mark stripped)."""
    st = live_states(0, 64, 60)
    want, got = jax_cols(jpd, st), port_cols(st)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_same(got[k], want[k], k)
    c = tensors(want)
    cur = pd.grids_from_occ(tcfg(CFG), c["occ_key"], c["occ_code"])
    goal = pd.grids_from_occ(tcfg(CFG), c["goal_occ_key"], c["goal_occ_code"])
    init = pd.init_grids_from_keys(tcfg(CFG), c["init_key"])
    assert_same(cur, jpd.grids_from_occ(CFG, want["occ_key"], want["occ_code"]), "current")
    assert_same(goal, jpd.grids_from_occ(CFG, want["goal_occ_key"], want["goal_occ_code"]), "goal")
    assert_same(init, jpd.init_grids_from_keys(CFG, want["init_key"]), "init")
    assert_same(cur, st["objects"], "current = objects")
    assert_same(goal, st["goal_objects"], "goal = goal_objects")
    assert_same(init, np.where(st["init_objects"] == 9, 0, st["init_objects"]).astype(np.int8))
    assert (st["holding"] > 0).any()


def test_images_from_cols_bit_for_bit(jpd):
    """The stacked (current, goal, init) frames of the columns equal the JAX
    tool's, byte for byte, and ``models/cnn.student_images`` of the states."""
    from gym_craftingworld_tpu_torch.models.cnn import student_images

    st = live_states(0, 64, 60)
    want = jax_cols(jpd, st)
    img = pd.images_from_cols(tcfg(CFG), tensors(want))
    assert_same(img, jpd.images_from_cols(CFG, {k: jnp.asarray(v) for k, v in want.items()}))
    t = interop.env_state_from_numpy(st, "cpu")
    init = torch.where(t.init_objects == 9, 0, t.init_objects)
    assert torch.equal(img, student_images(tcfg(CFG), t.objects, t.agent, t.holding,
                                           t.goal_objects, t.goal_agent, init, t.init_agent))


def jax_flips(key, B):
    """The flip bits JAX's ``augment_flips`` draws from ``key``."""
    kh, kw = jax.random.split(key)
    return (np.array(jax.random.bernoulli(kh, 0.5, (B,))),
            np.array(jax.random.bernoulli(kw, 0.5, (B,))))


def test_flip_key_and_augment_flips_bit_for_bit(jpd):
    """Given JAX's flip bits, ``_flip_key`` (pad keys pass through) and
    ``augment_flips`` (keys, labels and logits) equal the JAX tool's, and
    flipping twice is the identity."""
    st = live_states(1, 64, 40)
    cols = jax_cols(jpd, st)
    rng = np.random.RandomState(0)
    cols["label"] = rng.randint(0, 6, 64).astype(np.int8)
    cols["tlogits"] = rng.randn(64, 6).astype(np.float16)
    key = jax.random.PRNGKey(5)
    fh, fw = jax_flips(key, 64)
    assert fh.any() and (~fh).any() and fw.any() and (~fw).any()
    want = jpd.augment_flips(CFG, {k: jnp.asarray(v) for k, v in cols.items()}, key)
    got = pd.augment_flips(tcfg(CFG), tensors(cols), torch.from_numpy(fh), torch.from_numpy(fw))
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "label":  # JAX's labels come back int32
            assert_same(got[k], np.asarray(want[k]), k)
        else:
            assert_same(got[k], want[k], k)
    pad = torch.tensor([[-1, CFG.height * CFG.width + 1, 0, 63]], dtype=torch.int16)
    assert_same(pd._flip_key(tcfg(CFG), pad, torch.tensor([True]), torch.tensor([True])),
                jpd._flip_key(CFG, jnp.asarray(pad.numpy()), jnp.array([True]), jnp.array([True])))
    back = pd.augment_flips(tcfg(CFG), got, torch.from_numpy(fh), torch.from_numpy(fw))
    for k in pd._FLIP_COLS + ("tlogits",):
        assert torch.equal(back[k], tensors(cols)[k]), k


# ---------------------------------------------------------------------------
# pixel_distill: the rows a round keeps, and main's host bookkeeping
# ---------------------------------------------------------------------------


def synthetic_rollout(seed: int, T: int, B: int):
    """Columns of a rollout chunk [T, B] with live prefixes, won and lost
    episodes, and latched undesired bits on some frames."""
    rng = np.random.RandomState(seed)
    st = live_states(2, B, 3)
    cols = {k: np.broadcast_to(v.numpy()[None], (T,) + tuple(v.shape)).copy()
            for k, v in port_cols(st).items() if not k.startswith("goal")}
    cols["agent_key"] = rng.randint(0, 64, (T, B)).astype(np.int16)
    cols["desired"] = rng.randint(0, 512, (T, B)).astype(np.int16)
    cols["achieved"] = rng.randint(0, 512, (T, B)).astype(np.int16)
    ends = rng.randint(1, T + 1, B)
    live = np.arange(T)[:, None] < ends[None, :]
    success = rng.rand(B) < 0.4
    goal = {k: v.numpy() for k, v in port_cols(st).items() if k.startswith("goal")}
    return cols, goal, live, success


def test_collect_round_keeps_jax_rows(jpd, monkeypatch):
    """``collect_round``'s salvage and ``fail_cap`` filter, with its
    ``RandomState(seed + 13 i)`` drops, on the same rollout columns (two
    chunks, the rollout replaced by the given columns in both tools) keeps
    the JAX tool's rows, in its order, and the same success rate; without
    ``fail_cap`` every live row."""
    T, B, seed = 30, 24, 7
    chunks = [synthetic_rollout(s, T, B) for s in (0, 1)]
    calls = iter(chunks + chunks)
    monkeypatch.setattr(jpd, "_rollout_collect", lambda *a: tuple(
        {k: jnp.asarray(v) for k, v in x.items()} if isinstance(x, dict) else jnp.asarray(x)
        for x in next(calls)))
    pcalls = iter(chunks + chunks)
    monkeypatch.setattr(pd, "_rollout_collect", lambda *a: tuple(
        tensors(x) if isinstance(x, dict) else torch.from_numpy(x) for x in next(pcalls)))
    model = torch.nn.Linear(1, 1)
    for fail_cap in (5, None):
        want, wsr = jpd.collect_round(CFG, "grid", None, None, 2 * B, seed, 0.02, chunk=B,
                                      fail_cap=fail_cap)
        got, sr = pd.collect_round(tcfg(CFG), "grid", model, 2 * B, seed, 0.02, chunk=B,
                                   fail_cap=fail_cap)
        assert sr == wsr and sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], k)
        kept = len(want["agent_key"])
        assert 0 < kept < (sum(c[2].sum() for c in chunks) if fail_cap else kept + 1)


def fake_rows(seed: int, n: int, soft: bool) -> dict:
    rng = np.random.RandomState(seed)
    cols = {"occ_key": rng.randint(0, 66, (n, 8)).astype(np.int16),
            "occ_code": rng.randint(0, 9, (n, 8)).astype(np.int8),
            "init_key": rng.randint(0, 64, (n, 8)).astype(np.int16),
            "init_agent_key": rng.randint(0, 64, n).astype(np.int16),
            "agent_key": rng.randint(0, 64, n).astype(np.int16),
            "holding": rng.randint(0, 4, n).astype(np.int8),
            "desired": rng.randint(0, 512, n).astype(np.int16),
            "achieved": rng.randint(0, 512, n).astype(np.int16),
            "goal_occ_key": rng.randint(0, 66, (n, 8)).astype(np.int16),
            "goal_occ_code": rng.randint(0, 9, (n, 8)).astype(np.int8),
            "goal_agent_key": rng.randint(0, 64, n).astype(np.int16)}
    return cols


def test_main_trains_on_jax_rows(jpd, monkeypatch, tmp_path):
    """Both tools' ``main`` over 4 rounds with the rollouts, labels,
    epochs and evaluations replaced by the same stand-ins: every epoch trains
    on the same device columns and the same row order, so the ``--max-rows``
    subsample (``RandomState(seed + r)``), the epoch permutations
    (``RandomState(seed + 17 r + ep)``) and the 50/50 mixture by upsampling
    the core equal JAX's; the history matches."""
    sizes = {0: 300, 1: 250, 2: 700, 3: 400}  # round 2 upsamples the core 3x; max-rows 900 cuts
    rows = {r: fake_rows(r, n, r == 0) for r, n in sizes.items()}
    labels = {r: np.random.RandomState(50 + r).randint(0, 6, n).astype(np.int8)
              for r, n in sizes.items()}
    logits = np.random.RandomState(9).randn(sizes[0], 6).astype(np.float16)
    summary = {"success_rate": 0.25, "mean_episode_steps": 10.0, "episodes": 8,
               "skill_completion": {}}
    seen, calls = {"jax": [], "port": []}, {"jax": 0, "port": 0}

    def collect(side):
        def fn(cfg, kind, *a, **kw):
            r = calls[side]
            assert (kind == "grid") == (r == 0)
            calls[side] += 1
            return {k: v.copy() for k, v in rows[r].items()}, 0.5 + r / 10
        return fn

    relabelled = lambda n: labels[[r for r, s in sizes.items() if s == n and r > 0][0]]
    monkeypatch.setattr(jpd, "collect_round", lambda cfg, kind, model, params, *a, **kw:
                        collect("jax")(cfg, kind))
    monkeypatch.setattr(jpd, "teacher_label", lambda *a: (labels[0], logits))
    monkeypatch.setattr(jpd.dagger_mod, "expert_relabel", lambda cfg, c: type(
        "S", (), {"action": relabelled(len(c["agent_key"]))})())
    monkeypatch.setattr(jpd, "eval_student", lambda *a, **kw: dict(summary))

    def jax_epoch(cfg, model, batch, ts, dev, perm, key):
        seen["jax"].append(({k: np.asarray(v) for k, v in dev.items()}, np.asarray(perm)))
        return ts, jnp.float32(0), jnp.float32(0)

    monkeypatch.setattr(jpd, "_student_epoch", jax_epoch)
    common = ["--rounds", "4", "--epochs0", "2", "--epochs", "2", "--batch", "16",
              "--max-rows", "900", "--channels", "8", "--hidden", "32", "--stem", "8",
              "--teacher-channels", "8", "--teacher-hidden", "32", "--teacher", "",
              "--seed", "5"]
    monkeypatch.setattr(sys, "argv", ["pixel_distill"] + common + [
        "--out", str(tmp_path / "jax.json"), "--save", str(tmp_path / "jax")])
    jpd.main()

    monkeypatch.setattr(pd, "collect_round", lambda cfg, kind, *a, **kw: collect("port")(cfg, kind))
    monkeypatch.setattr(pd, "teacher_label", lambda *a: (labels[0], logits))
    monkeypatch.setattr(pd, "relabel", lambda cfg, c: type(
        "S", (), {"action": relabelled(len(c["agent_key"])),
                  "num_rows": len(c["agent_key"])})())
    monkeypatch.setattr(pd, "eval_student", lambda *a, **kw: dict(summary))

    def port_epoch(cfg, model, opt, data, perm, batch, fh, fw, graph=True):
        assert fh.shape == fw.shape == (len(perm) // batch, batch)
        seen["port"].append(({k: v.numpy() for k, v in data.items()}, perm.numpy()))
        return opt, torch.tensor(0.0), torch.tensor(0.0)

    monkeypatch.setattr(pd, "student_epoch", port_epoch)
    out = pd.main(common + ["--device", "cpu", "--out", str(tmp_path / "port.json"),
                            "--save", str(tmp_path / "port")])
    assert len(seen["port"]) == len(seen["jax"]) == 8
    for (got, gperm), (want, wperm) in zip(seen["port"], seen["jax"]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], k)
        assert_same(gperm, wperm, "perm")
    jdoc = json.loads((tmp_path / "jax.json").read_text())["distilled_student"]
    assert out["section"]["history"] == jdoc["history"]
    r = out["rounds"]
    assert [x["student_rows"] for x in r[1:]] == [250, 900, 900]  # the cut at --max-rows
    assert all(x["appended"] == x["relabelled"] == x["collected"] for x in r[1:])


# ---------------------------------------------------------------------------
# pixel_distill: teacher labels, one student minibatch, the evaluation
# ---------------------------------------------------------------------------


def test_teacher_label_matches_jax(jpd, trained):  # noqa: F811
    """``teacher_label`` of a trained GridPolicy carried by ``interop``
    (chunks of 100 rows): logits within rtol / atol 2e-2 (bf16 forwards) and
    f16; labels equal JAX's on every row whose two best logits JAX separates
    by more than twice the largest logit difference (asserted: at least 95%
    of the rows)."""
    snaps, model, ts = trained
    cols = {k: getattr(snaps, k)[:600] for k in tdagger._COL_FIELDS}
    want_l, want_g = jpd.teacher_label(CFG, model, on_jax(ts).params, cols, chunk=256)
    port = interop.grid_policy_from_numpy(ts.params, device="cpu")
    got_l, got_g = pd.teacher_label(tcfg(CFG), port, cols, chunk=100)
    assert got_l.dtype == want_l.dtype == np.int8 and got_g.dtype == want_g.dtype == np.float16
    np.testing.assert_allclose(got_g.astype(np.float32), want_g.astype(np.float32), **LOGIT_TOL)
    top = np.sort(want_g.astype(np.float32), axis=1)
    drift = np.abs(got_g.astype(np.float32) - want_g.astype(np.float32)).max()
    clear = top[:, -1] - top[:, -2] > 2 * drift
    assert clear.mean() >= 0.95
    np.testing.assert_array_equal(got_l[clear], want_l[clear])


def student_batch(jpd, n: int):
    st = live_states(3, n, 40)
    cols = jax_cols(jpd, st)
    rng = np.random.RandomState(1)
    cols["label"] = rng.randint(0, 6, n).astype(np.int8)
    cols["tlogits"] = (3 * rng.randn(n, 6)).astype(np.float16)
    cols["soft"] = (rng.rand(n) < 0.5).astype(np.float16)
    return cols


def test_student_epoch_one_minibatch_matches_jax(jpd):
    """One minibatch of ``_student_epoch`` (64 rows, half soft) from JAX's
    params and batch, flipped by JAX's bits of ``fold_in(key, 0)``: the loss
    within rtol 2e-3 / atol 2e-4 and every parameter within 2 lr of JAX's
    after clip 1.0 + AdamW (the value head takes no gradient: only the
    weight decay moves it, on both sides)."""
    data = student_batch(jpd, 64)
    model, params = jcnn.init_student(jax.random.PRNGKey(0), CFG, channels=8, hidden=32, stem=8)
    start = host(params)
    ts = (params, jpd.make_tx().init(params))
    key = jax.random.PRNGKey(11)
    perm = np.random.RandomState(2).permutation(64).astype(np.int32)
    (jparams, _), loss, _ = jpd._student_epoch(CFG, model, 64, ts, {k: jnp.asarray(v) for k, v
                                                                     in data.items()},
                                               jnp.asarray(perm), key)
    fh, fw = jax_flips(jax.random.fold_in(key, 0), 64)
    student = interop.pixel_distill_student_from_numpy(start, device="cpu")
    opt, tloss, _ = pd.student_epoch(tcfg(CFG), student, pd.init_opt(student), tensors(data),
                                     torch.from_numpy(perm), 64, torch.from_numpy(fh)[None],
                                     torch.from_numpy(fw)[None])
    np.testing.assert_allclose(float(tloss), float(loss), **LOSS_TOL)
    want = interop._flat_tree(host(jparams)["params"])
    got = {k: v.detach().numpy() for k, v in student.named_parameters()}
    assert sorted(got) == sorted(want) and int(opt.count) == 1
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2 * pd.LR, err_msg=k)
    moved = interop._flat_tree(start["params"])
    # every leaf stepped but the value head's (no gradient; a decay of 3e-8 of
    # its value rounds away in f32), on both sides
    stuck = [k for k in want if np.array_equal(want[k], moved[k])]
    assert set(stuck) <= {"value.bias", "value.kernel"}
    assert stuck == [k for k in want if np.array_equal(got[k], moved[k])]


def test_eval_student_matches_jax_on_agreeing_envs(jpd):
    """Greedy episodes of a student JAX trained for 30 minibatches, from
    JAX's reset states: on every env whose visited states the two forwards
    order alike (JAX's own greedy rollout, eps 0; asserted at least 20 of
    24), the port's success, steps, desired and achieved equal JAX's; the
    sampled mode gives success rates of a softmax policy."""
    data = student_batch(jpd, 512)
    model, params = jcnn.init_student(jax.random.PRNGKey(1), CFG, channels=8, hidden=32, stem=8)
    ts = (params, jpd.make_tx().init(params))
    perm = np.tile(np.arange(512, dtype=np.int32), 4)[:30 * 64]
    (params, _), _, _ = jpd._student_epoch(CFG, model, 64, ts, {k: jnp.asarray(v) for k, v
                                                                in data.items()},
                                           jnp.asarray(perm), jax.random.PRNGKey(2))
    B = 24
    keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(4), B))
    want = host(jpd._eval_student(CFG, model, params, keys, "argmax"))
    cols, _, live, _ = jpd._rollout_collect(CFG, "pixel", model, params, keys,
                                            jax.random.PRNGKey(0), 0.0)
    state = jreset(CFG, keys)
    goal = {k: np.asarray(v) for k, v in jpd.goal_columns_from_state(CFG, state).items()}
    T = CFG.max_steps
    flat = {k: np.asarray(v).reshape((T * B,) + np.shape(v)[2:]) for k, v in cols.items()}
    flat.update({k: np.broadcast_to(v[None], (T,) + v.shape).reshape((T * B,) + v.shape[1:])
                 for k, v in goal.items()})
    jl, _ = jax.jit(model.apply)(params, jpd.images_from_cols(CFG, {k: jnp.asarray(v) for k, v
                                                                    in flat.items()}))
    student = interop.pixel_distill_student_from_numpy(host(params), device="cpu")
    with torch.no_grad():
        tl, _ = student(pd.images_from_cols(tcfg(CFG), tensors(flat)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    same = (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).reshape(T, B)
    ok = (same | ~np.asarray(live)).all(axis=0)
    assert ok.sum() >= B - 4
    got = pd._eval_student(tcfg(CFG), student, interop.env_state_from_numpy(np_tree(state), "cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy()[ok], want[k][ok], err_msg=k)
    res = pd.eval_student(tcfg(CFG), student, 16, 3, chunk=8, mode="sample")
    assert res["episodes"] == 16 and 0 <= res["success_rate"] <= 1
    with pytest.raises(ValueError, match="mode"):
        pd.eval_student(tcfg(CFG), student, 4, 3, mode="greedy")


# ---------------------------------------------------------------------------
# finetune_canonical: the fine-tune's evaluation and train_step from JAX's draws
# ---------------------------------------------------------------------------


def test_finetune_evaluation_matches_jax_on_agreeing_envs(trained):  # noqa: F811
    """The fine-tune's evaluations (``dagger.evaluate_grid_policy``, greedy
    over reset states) on JAX's reset states of the trained policy: per-env
    success, steps and bits equal on the envs whose visited states the two
    forwards order alike (asserted at least 30 of 32; some won, some lost)."""
    snaps, model, ts = trained
    B = 32
    keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(900), B))
    want = host(jdagger._eval_batch_grid(CFG, model, on_jax(ts).params, keys))
    cols, live, _ = jdagger._rollout_states(CFG, model, on_jax(ts).params, keys,
                                            jax.random.PRNGKey(0), 0.0)
    ok = agreeing_envs(model, ts, cols, live)
    assert ok.sum() >= B - 2 and 0 < want["success"].sum() < B
    port = interop.grid_policy_from_numpy(ts.params, device="cpu")
    got = tdagger._eval_batch_grid(tcfg(CFG), port,
                                   interop.env_state_from_numpy(np_tree(jreset(CFG, keys)), "cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy()[ok], want[k][ok], err_msg=k)


FT_B, FT_SEED = 32, 3
FT_KW = dict(rollout_steps=16, num_minibatches=2, lr=1e-4)
FT_VALUE_ONLY = (True, False, False)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _jax_collect(cfg, T, model, params, env, pool, noise):
    """JAX's collect as ``tools/finetune_canonical.py:108-141`` runs it (the
    Gumbel noise of ``categorical`` passed in), with each step's logits."""
    B = env.objects.shape[0]

    def body(st, inp):
        t, g = inp
        logits, _ = model.apply(params, *jgp.planes_from_state(cfg, st))
        action = jnp.argmax(g + logits, axis=-1).astype(jnp.int32)
        st2, res = jax.vmap(functools.partial(_step_one, cfg))(st, action)
        off = (t * jnp.int32(12007)) % jnp.int32(B)
        fresh = jax.tree.map(lambda f: jax.lax.dynamic_slice_in_dim(f, off, B, axis=0), pool)
        st2 = jax.tree.map(lambda f, s: jnp.where(
            res.done.reshape((-1,) + (1,) * (s.ndim - 1)), f, s), fresh, st2)
        return st2, dict(action=action, done=res.done, raw=res.reward, logits=logits)

    return jax.lax.scan(body, env, (jnp.arange(T, dtype=jnp.int32), noise))


@pytest.fixture(scope="module")
def jax_finetune(jft):
    """Three updates of JAX's own ``train_step`` (value-only, then joint PPO)
    from a fresh GridPolicy(16, 64), with per update the draws recovered from
    its key (the pool of ``k_pool``, the Gumbel noise of ``k_roll``'s step
    keys, the permutations of ``k_perm``), the trajectory and logits of
    ``_jax_collect`` on them, the metrics, the env and the parameters after
    it. The envs start 1-48 steps before ``max_steps``, so that each update
    restarts some from the pool. A fresh policy, because the two packages' forwards of it agree to
    ~1e-8 (a trained one's bf16 logits, ~10 large, differ by up to 2.6e-2,
    and 768 sampled draws then always meet a near-tie); random play on this
    8x8 setting wins often enough that the success metrics are not zero."""
    model = jgp.GridPolicy(channels=16, hidden=64)
    params = jax.jit(model.init)(jax.random.PRNGKey(FT_SEED), jnp.zeros((1, 8, 8, jgp.N_PLANES),
                                                                          jnp.bfloat16),
                                 jnp.zeros((1, jgp.N_EXTRAS), jnp.bfloat16))
    ft = jft.FTConfig(**FT_KW)
    T, B, N = ft.rollout_steps, FT_B, ft.rollout_steps * FT_B
    state = jft.FTState(params, jft._tx(ft).init(params))
    env = jreset(CFG, jax.random.key_data(jax.random.split(jax.random.PRNGKey(FT_SEED), B)))
    late = jax.random.randint(jax.random.PRNGKey(FT_SEED + 2), (B,), 1, 3 * T + 1)
    env = dataclasses.replace(env, step_num=(CFG.max_steps - late).astype(jnp.int32))
    key = jax.random.PRNGKey(FT_SEED + 1)
    start = (host(params), np_tree(env))
    updates = []
    for value_only in FT_VALUE_ONLY:
        _, k_pool, k_roll, k_perm = jax.random.split(key, 4)  # as train_step splits it
        pool = jreset(CFG, jax.random.key_data(jax.random.split(k_pool, 2 * B)))
        noise = jnp.stack([jax.random.gumbel(k, (B, 6), jnp.float32)
                           for k in jax.random.split(k_roll, T)])
        perms = np.stack([np.asarray(jax.random.permutation(k, N))
                          for k in jax.random.split(k_perm, ft.update_epochs)])
        after, traj = _jax_collect(CFG, T, model, state.params, env, pool, noise)
        after = np_tree(after)
        state, env, key, metrics = jft.train_step(CFG, ft, model, state, env, key, value_only)
        updates.append(dict(pool=np_tree(pool), noise=np.array(noise), perms=perms,
                            traj={k: np.asarray(v) for k, v in traj.items()}, collect_env=after,
                            env=np_tree(env), params=host(state.params),
                            metrics={k: float(v) for k, v in metrics.items()}))
    return start, updates


def test_finetune_train_step_in_lockstep_with_jax(jax_finetune):
    """Three updates of ``train_step`` (the first value-only) from JAX's key
    alone (``PRNGKey(FT_SEED + 1)``, carried from update to update as both
    tools return it) and JAX's fresh parameters: the draws the port makes
    from it (``draw``) are JAX's (the noise within 2 ulps); the actions,
    rewards, dones, raw rewards, the auto-reset env after
    the collect and the success metrics equal JAX's; the loss terms within
    rtol 2e-3 / atol 2e-4 and the parameters within 2 lr per optimizer step
    so far; the value-only update leaves the policy head bit-identical on
    both sides. Every Gumbel argmax is decided by a margin the two forwards'
    logits cannot flip (twice their largest difference plus
    ``GUMBEL_SLACK``), so a near-tie fails here and cannot pass by luck. The
    collect JAX's update ran is the test's ``_jax_collect``: its env equals
    the one ``train_step`` returned, asserted."""
    (jparams, jenv), updates = jax_finetune
    cfg, ft = tcfg(CFG), ftc.FTConfig(**FT_KW)
    model = interop.grid_policy_from_numpy(jparams, device="cpu")
    ts = ftc.init_state(model, ft)
    env = interop.env_state_from_numpy(jenv, "cpu")
    key = prng_key(FT_SEED + 1)
    assert all(u["traj"]["done"].any() for u in updates)  # the auto-reset fires in each
    assert sum(u["metrics"]["success_rate"] for u in updates) > 0  # some episode won
    steps = 0
    for i, (value_only, want) in enumerate(zip(FT_VALUE_ONLY, updates)):
        assert_tree_equal(want["collect_env"], want["env"])  # _jax_collect is the tool's
        _, (pool, noise, perms) = ftc.draw(cfg, ft, FT_B, key)
        assert_tree_equal(interop.env_state_to_numpy(pool), want["pool"])
        assert noise_ulps(noise, want["noise"]) <= NOISE_ULPS
        assert_same(perms, want["perms"], "perms")
        with torch.no_grad():
            _, traj, _ = ftc.collect(cfg, ft, model, env, pool, noise)
            logits = torch.stack([model(*planes_from_snaps(
                cfg, *(traj["cols"][k][t] for k in tdagger._COL_FIELDS)))[0]
                for t in range(ft.rollout_steps)])
        g = (logits + noise).sort(dim=-1, descending=True).values
        margin = g[..., 0] - g[..., 1]
        drift = (logits - torch.from_numpy(want["traj"]["logits"])).abs().amax(dim=-1)
        assert bool((margin > 2 * drift + GUMBEL_SLACK).all()), f"update {i}: a Gumbel near-tie"
        assert_same(traj["action"], want["traj"]["action"], f"update {i}: action")
        assert_same(traj["done"], want["traj"]["done"], f"update {i}: done")
        assert_same(traj["raw"], want["traj"]["raw"], f"update {i}: raw")
        win = want["traj"]["raw"] == CFG.max_steps
        assert_same(traj["reward"], np.where(win, np.float32(1.0),
                                             np.float32(-1.0 / CFG.max_steps)), "reward")
        head = {k: v.clone() for k, v in model.policy.state_dict().items()}
        ts, env, key, metrics = ftc.train_step(cfg, ft, ts, env, key, value_only)
        steps += ft.update_epochs * ft.num_minibatches
        assert_tree_equal(interop.env_state_to_numpy(env), want["env"])
        for k in ("success_rate", "done_frac"):
            assert float(metrics[k]) == pytest.approx(want["metrics"][k], rel=1e-6, abs=0), k
        for k in ("loss", "pg", "v_loss", "entropy"):
            np.testing.assert_allclose(float(metrics[k]), want["metrics"][k], **LOSS_TOL,
                                       err_msg=f"update {i}: {k}")
        got = {k: v.detach().numpy() for k, v in model.named_parameters()}
        jp = interop._flat_tree(want["params"]["params"])
        for k, w in jp.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=2 * ft.lr * steps,
                                       err_msg=f"update {i}: {k}")
        if value_only:
            assert all(torch.equal(v, head[k]) for k, v in model.policy.state_dict().items())
            prev = interop._flat_tree(jparams["params"] if i == 0 else
                                      updates[i - 1]["params"]["params"])
            assert all(np.array_equal(jp[k], prev[k]) for k in jp if k.startswith("policy"))
    assert int(ts.opt_state.count) == steps


# ---------------------------------------------------------------------------
# each tool's main, tiny, on the CPU; the CPV tool's carried pool
# ---------------------------------------------------------------------------


def test_finetune_main_writes_the_jax_record_keys(tmp_path):
    """``--smoke`` (JAX's tiny settings, on the CPU): the JSON has the keys of
    ``docs/canonical_finetune.json`` and the card; the value-only update
    kept the policy head; a fresh policy that nothing beat ships the start's
    parameters, and no ``params_rl_finetuned.pt`` is written."""
    out = ftc.main(["--smoke", "--out", str(tmp_path / "ft.json"), "--save", str(tmp_path / "s")])
    doc = json.loads((tmp_path / "ft.json").read_text())
    jax_doc = json.loads((REPO / "docs" / "canonical_finetune.json").read_text())
    assert set(doc) == set(jax_doc) | {"card"} and doc["card"] == "cpu" and doc == out["doc"]
    assert set(doc["config"]) == set(jax_doc["config"])
    assert set(doc["config"]["ppo"]) == set(jax_doc["config"]["ppo"])
    assert set(doc["baseline_eval"]) == set(jax_doc["baseline_eval"])
    assert [c["update"] for c in doc["curve"]] == [0, 2] and len(out["updates"]) == 2
    assert out["policy_head_after_warmup"] is True
    if doc["best_checkpoint"] == "start":
        fresh = ftc.init_grid_policy(prng_key(0), ftc.EnvConfig(
            height=8, width=8, max_steps=40), 8, 32)
        got = out["model"].state_dict()
        assert all(torch.equal(v, got[k]) for k, v in fresh.state_dict().items())
    assert not (tmp_path / "s").exists()


def test_pixel_distill_main_writes_the_jax_record_keys(tmp_path):
    """``--smoke`` (JAX's tiny settings, round 0 cut to 8 episodes, on the
    CPU): the ``distilled_student`` section has the JAX record's keys and the
    card, merged into the JSON at ``--out`` beside what it held; round 1
    appended exactly its relabelled rows; ``student.pt`` reloads."""
    out_path = tmp_path / "pixel.json"
    out_path.write_text(json.dumps({"default": {"kept": 1}}))
    out = pd.main(["--smoke", "--out", str(out_path), "--save", str(tmp_path / "s")])
    doc = json.loads(out_path.read_text())
    jax_doc = json.loads((REPO / "docs" / "pixel_canonical.json").read_text())
    assert doc["default"] == {"kept": 1}
    sec = doc["distilled_student"]
    assert set(sec) == set(jax_doc["distilled_student"]) | {"card"} and sec == out["section"]
    assert [set(h) for h in sec["history"]] == [set(h) for h in
                                                jax_doc["distilled_student"]["history"][:2]]
    r0, r1 = out["rounds"]
    assert r0["core_rows"] == r0["collected"] > 0
    assert r1["appended"] == r1["relabelled"] == r1["collected"] == r1["student_rows"]
    state = torch.load(tmp_path / "s" / "student.pt", weights_only=True)
    assert "dense0.kernel" in state or any(k.startswith("dense0") for k in state)


def test_relabel_is_shared_by_the_canonical_tools():
    """``relabel`` lives in ``tools/_canonical.py``; the CPV tool and the
    distillation use that one."""
    assert cc.relabel is _canonical.relabel is pd.relabel


def test_jax_pool_npz_equals_jax_make_pool(tmp_path):
    """``tools/records/cpv_pool_jax_seed7.npz`` is the JAX tool's
    ``make_pool(ray_config(), 7, 256)`` bit for bit, and ``load_pool`` reads
    it back (at the wrong size it raises)."""
    from gym_craftingworld_tpu import ray_config as jray_config

    jcc = jax_tool("cpv_canonical")
    objects, agent = jcc.make_pool(jray_config(), 7, 256)
    path = REPO / "gym_craftingworld_tpu_torch" / "tools" / "records" / "cpv_pool_jax_seed7.npz"
    got_o, got_a = cc.load_pool(path, 256)
    assert_same(got_o, np.asarray(objects), "objects")
    assert_same(got_a, np.asarray(agent).astype(np.int32), "agent")
    with pytest.raises(ValueError, match="worlds"):
        cc.load_pool(path, 128)
