"""Host-side bit-exact mirror of the reference's reset-time RNG draws.

The reference funnels all randomness through one legacy-gym RandomState with a
fixed call order per reset (SURVEY §2.6; craftingworld_ray.py:169-176,
599-628, 220-299):

  (a) ``randint(number_of_tasks)``            — task-count draw
  (b) ``shuffle(task_idx)``                   — task selection order
  (c) ``shuffle(perm)`` over H*W entries      — world placement
      (or ``randint(fixed_init_state)`` when drawing from the fixed pool)
  (d) in imagine_obs: one ``randint`` per desired task among
      {EatBread, MoveSticks(x2), BuildHouse, GoToHouse, MoveAxe, MoveHammer}
      in application order 0,1,3,8,2,4,5,6,7

``jax.random`` cannot reproduce MT19937 draws, so parity-mode resets run here
on the host with a NumPy RandomState (resets are rare; stepping is
deterministic and stays on the device). The result converts losslessly into a
packed :class:`EnvState` on any device, after which stepping is bit-exact.

Counterpart of ``gym_craftingworld_tpu/parity/host_rng.py``: the draw code is
a copy of it, and ``reset_state`` builds the port's ``EnvState``.
``tests/test_torch_gym_env.py`` replays whole episodes against the JAX
package's parity mode.

This module is written against the reference's *observable draw sequence*, not
its code: it produces identical worlds/goals for identical seeds, verified in
test_host_rng_parity.py.
"""

from __future__ import annotations

import numpy as np

import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.state import EnvState


class ParityReset:
    """Replays the reference reset pipeline draw-for-draw on the host."""

    def __init__(self, cfg: EnvConfig, seed: int, scheme: str | None = None):
        # the RandomState comes from the shared seeding module so both sides
        # of a parity comparison use one scheme: "direct" (RandomState(seed))
        # or "legacy_hash" (historical gym<=0.19 SHA-512 seed hashing);
        # default follows CW_GYMSHIM_SEEDING.
        from gym_craftingworld_tpu_torch.parity.seeding import np_random as _np_random

        self.cfg = cfg
        self.rs, _ = _np_random(seed, scheme=scheme)
        self.fixed_pool: list[tuple[np.ndarray, np.ndarray]] | None = None

    # -- draw (a)+(b): task sampling (craftingworld_ray.py:169-176) --------

    def _sample_desired(self) -> np.ndarray:
        cfg = self.cfg
        if cfg.stacking:
            k = self.rs.randint(cfg.number_of_tasks) + 1
        else:
            k = 1
        sel = list(cfg.selected_task_indices)
        task_idx = np.arange(len(sel))
        self.rs.shuffle(task_idx)
        desired = np.zeros(C.N_TASKS, np.int8)
        for idx in task_idx[:k]:
            desired[sel[idx]] = 1
        return desired

    # -- draw (c): world placement (craftingworld_ray.py:599-628) ----------

    def _sample_world(self):
        """The exact diag-scatter + permutation-shuffle of the reference."""
        cfg = self.cfg
        n = cfg.n_cells
        diag = np.diag([1] * 9 + [0, 0, 0])
        state = np.zeros((n, 1, C.N_CHANNELS), int)
        state[:12, 0, :] = diag
        perm = np.arange(n)
        self.rs.shuffle(perm)
        state = state[perm].reshape(cfg.height, cfg.width, C.N_CHANNELS)

        obj_ch = state[:, :, : C.N_OBJECTS]
        objects = np.where(obj_ch.any(axis=2), obj_ch.argmax(axis=2) + 1, 0).astype(
            np.int8
        )
        rr, cc = np.nonzero(state[:, :, C.N_OBJECTS])
        agent = np.array([rr[0], cc[0]], np.int32)
        return objects, agent

    def generate_fixed_pool(self, num_states: int):
        """Reference generate_fixed_states: N placement shuffles up front."""
        self.fixed_pool = [self._sample_world() for _ in range(num_states)]

    def _draw_world(self):
        if self.fixed_pool is not None:
            i = self.rs.randint(len(self.fixed_pool))
            objects, agent = self.fixed_pool[i]
            return objects.copy(), agent.copy()
        return self._sample_world()

    # -- draw (d): goal imagination (craftingworld_ray.py:220-299) ---------

    def _imagine(self, objects: np.ndarray, agent: np.ndarray, desired):
        g = objects.astype(np.int64).copy()
        a = agent.copy()

        def first(code):
            rr, cc = np.nonzero(g == code)
            return rr[0], cc[0]

        def rand_among(mask):
            rr, cc = np.nonzero(mask)
            i = self.rs.randint(len(rr))
            return rr[i], cc[i]

        if desired[C.T_MAKE_BREAD]:
            r, c = first(C.WHEAT)
            g[r, c] = C.BREAD
        if desired[C.T_EAT_BREAD]:
            r, c = rand_among(g == C.BREAD)
            g[r, c] = C.EMPTY
        if desired[C.T_CHOP_TREE]:
            r, c = first(C.TREE)
            g[r, c] = C.STICKS
        if desired[C.T_MOVE_STICKS]:
            # empty over channels [:9] — excludes the agent's cell (:252)
            r, c = rand_among(g == C.STICKS)
            not_agent = np.ones_like(g, bool)
            not_agent[a[0], a[1]] = False
            r2, c2 = rand_among((g == C.EMPTY) & not_agent)
            g[r, c] = C.EMPTY
            g[r2, c2] = C.STICKS
        if desired[C.T_BUILD_HOUSE]:
            r, c = rand_among(g == C.STICKS)
            g[r, c] = C.HOUSE
        if desired[C.T_CHOP_ROCK]:
            r, c = first(C.ROCK)
            g[r, c] = C.EMPTY
        if desired[C.T_GO_TO_HOUSE]:
            r, c = rand_among(g == C.HOUSE)
            a = np.array([r, c], np.int32)
        if desired[C.T_MOVE_AXE]:
            # empty over channels [:8] — the agent's cell is eligible (:282)
            r, c = first(C.AXE)
            r2, c2 = rand_among(g == C.EMPTY)
            g[r, c] = C.EMPTY
            g[r2, c2] = C.AXE
        if desired[C.T_MOVE_HAMMER]:
            r, c = first(C.HAMMER)
            r2, c2 = rand_among(g == C.EMPTY)
            g[r, c] = C.EMPTY
            g[r2, c2] = C.HAMMER

        return g.astype(np.int8), a

    # -- public API --------------------------------------------------------

    def burn_gif_env_id(self) -> int:
        """Reference allow_gif_storage draws one extra randint (:778)."""
        return int(self.rs.randint(0, 1_000_000))

    def reset_arrays(self):
        """One reference reset worth of draws → packed numpy arrays."""
        desired = self._sample_desired()
        objects, agent = self._draw_world()
        goal_objects, goal_agent = self._imagine(objects, agent, desired)
        init_objects = objects.copy()
        if init_objects[agent[0], agent[1]] == C.EMPTY:
            init_objects[agent[0], agent[1]] = C.AGENT_INIT_MARK
        return dict(
            objects=objects,
            agent=agent,
            desired=desired,
            init_objects=init_objects,
            goal_objects=goal_objects,
            goal_agent=goal_agent,
        )

    def reset_state(self, device="cuda") -> EnvState:
        """One reference-parity reset as a B=1 EnvState on ``device`` (the
        card unless asked for the CPU); ``rng`` is the port's zeros int64[1, 2]."""
        a = self.reset_arrays()
        t = lambda x, dtype=None: torch.tensor(np.asarray(x, dtype), device=device)[None]
        return EnvState(
            objects=t(a["objects"]),
            agent=t(a["agent"]),
            holding=torch.zeros((1,), dtype=torch.int32, device=device),
            desired=t(a["desired"]),
            achieved=torch.zeros((1, C.N_TASKS), dtype=torch.int8, device=device),
            init_objects=t(a["init_objects"]),
            init_agent=t(a["agent"]),
            goal_objects=t(a["goal_objects"]),
            goal_agent=t(a["goal_agent"], np.int32),
            step_num=torch.zeros((1,), dtype=torch.int32, device=device),
            rng=torch.zeros((1, 2), dtype=torch.int64, device=device),
        )
