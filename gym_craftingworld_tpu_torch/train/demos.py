"""Scalable expert demonstrations in a compact slot-snapshot format.

Counterpart of ``gym_craftingworld_tpu/train/demos.py``, the scale path of
imitation (``train/bc.py`` stores full flat feature rows):

  * **SnapDataset** stores each transition as ~40 bytes of integers (object
    occupancy as (cell, code) pairs, init layout, agent cell, holding, goal
    masks, expert action); policy features are rebuilt from these on the
    device at train time (``models/grid_policy.py``).
  * **collect_expert_demos** drives a lockstep batch of envs through the
    port's grid step on the device while per-env host experts
    (``agents/expert.py``) plan actions from numpy views; each state field
    crosses to the host once a step for the whole batch.
  * **NumpyExpert** re-targets the scripted expert at bare numpy arrays, which
    DAgger relabelling uses too (``train/dagger.py``).

Noise injection (``noise_eps``): with probability eps the executed action is a
random move into an adjacent empty cell while the recorded label stays the
expert's (DART-style coverage); moves into empty cells never latch a task bit,
so the expert always recovers.

The dataset, the host extraction, the array expert and ``label_snapshot`` are
pure numpy, copied from the JAX module (which imports JAX) and pinned to it
by ``tests/test_torch_api_copies.py``. Batch ``bi`` resets from JAX's keys,
``split(PRNGKey(seed + 7919 * bi), B)`` (``core/reset.reset``, the reset
kernel on the card), so the demonstrations equal JAX's bit for bit; pass
``resets`` to collect from given reset states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.agents.expert import ExpertPolicy
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.reset import reset
from gym_craftingworld_tpu_torch.core.step import step as core_step
from gym_craftingworld_tpu_torch.ops.keyed_draws import split_keys
from gym_craftingworld_tpu_torch.ops.threefry import prng_key

_BITS9 = (1 << np.arange(C.N_TASKS, dtype=np.int64)).astype(np.int64)
_DELTAS = C.ACTION_DELTAS[:4]


class SnapDataset(NamedTuple):
    """Columnar transition store; every row is one (state, expert action).

    ``occ_key/occ_code``: up to 8 on-grid objects as (flat cell, code) pairs,
    padded with (H*W+1, 0). ``init_key[s]`` is the reset cell of object code
    ``s+1`` (reset places exactly one of each, craftingworld_ray.py:599-628);
    ``init_agent_key`` the agent's reset cell. ``desired/achieved`` are 9-bit
    masks in task-bit order.
    """

    occ_key: np.ndarray  # int16[N, 8]
    occ_code: np.ndarray  # int8[N, 8]
    init_key: np.ndarray  # int16[N, 8]
    init_agent_key: np.ndarray  # int16[N]
    agent_key: np.ndarray  # int16[N]
    holding: np.ndarray  # int8[N]
    desired: np.ndarray  # int16[N] (9-bit mask)
    achieved: np.ndarray  # int16[N] (9-bit mask)
    action: np.ndarray  # int8[N] — expert label
    episode: np.ndarray  # int32[N]

    # NB: deliberately no __len__ — namedtuple._make length-checks via len(),
    # so overriding it breaks _replace.
    @property
    def num_rows(self) -> int:
        return self.action.shape[0]

    @property
    def num_episodes(self) -> int:
        return int(self.episode.max()) + 1 if self.num_rows else 0

    def save(self, path: str) -> None:
        np.savez_compressed(path, **self._asdict())

    @classmethod
    def load(cls, path: str) -> "SnapDataset":
        with np.load(path) as z:
            return cls(**{k: z[k] for k in cls._fields})

    @classmethod
    def concat(cls, *parts: "SnapDataset") -> "SnapDataset":
        base, eps = 0, []
        for p in parts:
            eps.append(p.episode + base)
            base += p.num_episodes
        cols = {
            k: np.concatenate([getattr(p, k) for p in parts])
            for k in cls._fields
            if k != "episode"
        }
        return cls(episode=np.concatenate(eps), **cols)


# ---------------------------------------------------------------------------
# snapshot extraction (vectorised host numpy)
# ---------------------------------------------------------------------------


def occupancy_from_grids(objects_flat: np.ndarray, n_cells: int):
    """[B, H*W] object grids → ((cell, code) pairs int16[B,8], int8[B,8]).

    At most 8 objects ever sit on the grid (reset places 8; every effect
    removes or transforms in place, pickup moves one to the hand —
    craftingworld_ray.py:314-341,416-438), so 8 slots always suffice.
    """
    mask = objects_flat > 0
    order = np.argsort(~mask, axis=1, kind="stable")[:, : C.N_OBJECTS]
    code = np.take_along_axis(objects_flat, order, axis=1).astype(np.int8)
    key = np.where(code > 0, order, n_cells + 1).astype(np.int16)
    return key, code


def init_keys_from_grids(init_flat: np.ndarray):
    """[B, H*W] init grids → (init_key int16[B,8], init_agent_key int16[B])."""
    keys = np.stack(
        [np.argmax(init_flat == c, axis=1) for c in range(1, C.N_OBJECTS + 1)],
        axis=1,
    ).astype(np.int16)
    agent = np.argmax(init_flat == C.AGENT_INIT_MARK, axis=1).astype(np.int16)
    return keys, agent


def bits_to_mask(bits: np.ndarray) -> np.ndarray:
    """[..., 9] 0/1 bit rows → int16 masks."""
    return (np.asarray(bits, np.int64) @ _BITS9).astype(np.int16)


def mask_to_bits(mask: np.ndarray) -> np.ndarray:
    """int16 masks → [..., 9] 0/1 rows."""
    return ((np.asarray(mask, np.int64)[..., None] >> np.arange(9)) & 1).astype(
        np.int8
    )


def grids_from_snaps(cfg: EnvConfig, snaps: SnapDataset, rows: np.ndarray):
    """Selected snapshot rows → (objects, init_objects) int8[K, H, W] grids."""
    K = len(rows)
    n = cfg.n_cells
    flat = np.zeros((K, n + 2), np.int8)
    np.put_along_axis(
        flat, snaps.occ_key[rows].astype(np.int64), snaps.occ_code[rows], axis=1
    )
    init = np.zeros((K, n), np.int8)
    np.put_along_axis(
        init,
        snaps.init_key[rows].astype(np.int64),
        np.arange(1, C.N_OBJECTS + 1, dtype=np.int8)[None],
        axis=1,
    )
    np.put_along_axis(
        init,
        snaps.init_agent_key[rows].astype(np.int64)[:, None],
        np.full((K, 1), C.AGENT_INIT_MARK, np.int8),
        axis=1,
    )
    H, W = cfg.height, cfg.width
    return flat[:, :n].reshape(K, H, W), init.reshape(K, H, W)


# ---------------------------------------------------------------------------
# the scripted expert over bare arrays
# ---------------------------------------------------------------------------


class _ArrayView:
    """The attribute surface ExpertPolicy reads, backed by plain arrays."""

    __slots__ = (
        "objects", "agent", "holding", "init_objects",
        "desired_goal_vector", "achieved_goal_vector",
    )

    def __init__(self):
        self.objects = None
        self.agent = (0, 0)
        self.holding = 0
        self.init_objects = None
        self.desired_goal_vector = None
        self.achieved_goal_vector = None


class NumpyExpert(ExpertPolicy):
    """ExpertPolicy re-targeted at numpy arrays (no env shim required)."""

    def __init__(self, view: _ArrayView | None = None):
        self.env = view or _ArrayView()
        self._plan: list[int] = []

    def set_state(self, objects, agent, holding, init_objects, desired,
                  achieved):
        v = self.env
        v.objects = objects
        v.agent = (int(agent[0]), int(agent[1]))
        v.holding = int(holding)
        v.init_objects = init_objects
        v.desired_goal_vector = desired
        v.achieved_goal_vector = achieved

    def _world(self):
        v = self.env
        return v.objects, v.agent, v.holding

    def _tool_origin(self, tool_code):
        hits = np.argwhere(self.env.init_objects == tool_code)
        return tuple(hits[0]) if len(hits) else None


def label_snapshot(expert: NumpyExpert, objects, agent, holding, init_objects,
                   desired_bits, achieved_bits) -> int:
    """The expert's action for one bare-array state (UP on stall, mirroring
    ExpertPolicy.run_episode)."""
    expert.set_state(objects, agent, holding, init_objects, desired_bits,
                     achieved_bits)
    a = expert.action()
    return int(a) if a is not None else C.ACTION_UP


# ---------------------------------------------------------------------------
# lockstep batched collection
# ---------------------------------------------------------------------------


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def collect_batch(cfg: EnvConfig, state, wrng: np.random.RandomState, experts: list,
                  noise_eps: float = 0.05, only_successful: bool = True):
    """One lockstep batch of expert episodes from ``state`` (B envs) on its
    device; each state field crosses to the host once a step, and the
    ``experts`` (one ``NumpyExpert`` an env, at least B) label on the host.
    The noise draws come from ``wrng``. Returns ``(SnapDataset, env of each
    row int[N], success bool[B])``; the dataset's episodes count from 0."""
    B = state.objects.shape[0]
    init_objects_np = _host(state.init_objects)
    init_key, init_agent_key = init_keys_from_grids(init_objects_np.reshape(B, -1))
    desired_bits = _host(state.desired)
    desired_mask = bits_to_mask(desired_bits)

    done = np.zeros(B, bool)
    success = np.zeros(B, bool)
    rec = {k: [] for k in ("occ_key", "occ_code", "agent_key", "holding",
                           "achieved", "action", "live")}

    for _t in range(cfg.max_steps):
        objects = _host(state.objects)
        agent = _host(state.agent)
        holding = _host(state.holding)
        achieved_bits = _host(state.achieved)
        flat = objects.reshape(B, -1)
        occ_key, occ_code = occupancy_from_grids(flat, cfg.n_cells)
        agent_key = (agent[:, 0] * cfg.width + agent[:, 1]).astype(np.int16)

        actions = np.zeros(B, np.int32)
        labels = np.zeros(B, np.int8)
        for b in np.nonzero(~done)[0]:
            lab = label_snapshot(
                experts[b], objects[b], agent[b], holding[b],
                init_objects_np[b], desired_bits[b], achieved_bits[b],
            )
            labels[b] = lab
            actions[b] = lab
            if noise_eps and wrng.rand() < noise_eps:
                d = wrng.randint(4)
                nr = min(max(agent[b, 0] + _DELTAS[d, 0], 0), cfg.height - 1)
                nc = min(max(agent[b, 1] + _DELTAS[d, 1], 0), cfg.width - 1)
                if (nr, nc) != (agent[b, 0], agent[b, 1]) and objects[
                    b, nr, nc
                ] == C.EMPTY:
                    actions[b] = d

        rec["occ_key"].append(occ_key)
        rec["occ_code"].append(occ_code)
        rec["agent_key"].append(agent_key)
        rec["holding"].append(holding.astype(np.int8))
        rec["achieved"].append(bits_to_mask(achieved_bits))
        rec["action"].append(labels)
        rec["live"].append(~done)

        state, res = core_step(cfg, state, torch.from_numpy(actions).to(state.objects.device))
        res_done = _host(res.done)
        res_rew = _host(res.reward)
        newly = res_done & ~done
        success |= newly & (res_rew == cfg.max_steps)
        done |= res_done
        if done.all():
            break

    live = np.stack(rec["live"])  # [T, B]
    keep_env = success if only_successful else np.ones(B, bool)
    sel = live & keep_env[None, :]
    ep_ids = np.cumsum(keep_env) - 1  # [B]; SnapDataset.concat re-bases
    take = lambda k: np.concatenate(
        [rec[k][t][sel[t]] for t in range(sel.shape[0])]
    )
    t_idx, b_idx = np.nonzero(sel)
    snaps = SnapDataset(
        occ_key=take("occ_key"),
        occ_code=take("occ_code"),
        init_key=init_key[b_idx],
        init_agent_key=init_agent_key[b_idx],
        agent_key=take("agent_key"),
        holding=take("holding"),
        desired=desired_mask[b_idx],
        achieved=take("achieved"),
        action=take("action"),
        episode=ep_ids[b_idx].astype(np.int32),
    )
    return snaps, b_idx, success


def collect_expert_demos(
    cfg: EnvConfig,
    num_episodes: int,
    seed: int = 0,
    noise_eps: float = 0.05,
    batch: int = 192,
    only_successful: bool = True,
    progress=None,
    device="cuda",
    resets=None,
) -> SnapDataset:
    """Expert demonstrations over lockstep batches of the grid step on ``device``.

    Resets draw the canonical distribution (stacked task sets per
    craftingworld_ray.py:169-176; worlds per :599-628) from the keys
    ``split(PRNGKey(seed + 7919 * bi), B)`` for batch ``bi``, as JAX does;
    ``resets``, a sequence of one ``EnvState`` per batch, replaces those
    draws. Episodes where the
    expert did not reach the exact-match reward are dropped when
    ``only_successful``.
    """
    parts = []
    wrng = np.random.RandomState(seed ^ 0x5EED)
    experts = [NumpyExpert() for _ in range(batch)]
    base_ep = 0
    n_batches = (num_episodes + batch - 1) // batch
    for bi in range(n_batches):
        B = min(batch, num_episodes - bi * batch)
        if resets is None:
            state = reset(cfg, split_keys(prng_key(seed + 7919 * bi, device=device), B))
        else:
            state = resets[bi]
        snaps, _, success = collect_batch(cfg, state, wrng, experts, noise_eps, only_successful)
        parts.append(snaps)
        base_ep += int(success.sum()) if only_successful else B
        if progress is not None:
            progress(bi + 1, n_batches, base_ep)
    out = SnapDataset.concat(*parts) if len(parts) > 1 else parts[0]
    if not out.num_rows:
        raise ValueError("expert produced no successful demonstrations")
    return out
