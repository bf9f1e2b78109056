"""Classic-Gym-compatible env façades over the batched core.

Counterpart of ``gym_craftingworld_tpu/api/gym_env.py``, with its four
variants and every public method:

  * :class:`CraftingWorldEnvRay`    — dict of 4 RGB images, 4x4-px tiles
    (craftingworld_ray.py:53-799)
  * :class:`CraftingWorldEnvFlat`   — 8x8 grid, raw image observation
    (craftingworld_flat.py:46-295)
  * :class:`CraftingWorldEnvOneHot` — dict of 12-channel one-hot states; the
    desired goal is the imagined final *state* (carftingworld_onehot.py:53-810)
  * :class:`CraftingWorldEnvAltObs` — 3x3-px tiles + status strip, optional
    ``stacked_obs`` (craftingworld_altobs.py:85-886)

API surface matches the reference: ``reset() -> obs``,
``step(a) -> (obs, reward, done, info)``, ``render()``, ``seed()``,
``compute_reward()``, ``imagine_obs()``, ``allow_gif_storage()``, plus the
live attributes RL code reads (``obs_one_hot``, ``agent_pos``,
``desired_goal_vector``, ``achieved_goal_vector``, ``observation_vector``...).

The state lives on ``device`` (the card unless the caller asks for the CPU)
and observations come back as numpy arrays, as from the JAX façade.
``rng_mode="fast"`` draws resets from a ``torch.Generator`` on that device
seeded with ``seed``: the JAX package's distributions, from another stream.
``rng_mode="parity"`` draws them on the host with the reference's
RandomState sequence (``parity/host_rng.py``), so an episode equals the JAX
façade's parity-mode episode under the same seed and actions, step for step.

Differences by design (recorded deviations, as in the JAX package):
  * pure-functional core — observations are fresh arrays each step, never
    aliased views of mutable state (reference §2.7 hazard removed);
  * ``batch_size > 1`` steps many envs in lockstep through the same API
    (arrays gain a leading batch axis);
  * images are uint8 (AltObs int16 — see render/raster.py), not int64;
  * a custom ``task_list`` ordering is not supported: the reference's own task
    evaluation hard-codes canonical bit indices (craftingworld_ray.py:646-703),
    so reordering breaks it there too;
  * ``allow_gif_storage`` takes its env id from the env's generator in both
    modes and never from the parity RandomState, as the JAX façade does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_craftingworld_tpu_torch import constants as C
from gym_craftingworld_tpu_torch.api import spaces
from gym_craftingworld_tpu_torch.config import EnvConfig
from gym_craftingworld_tpu_torch.core.reset import (
    generate_pool as _generate_pool,
    reset as _core_reset,
    reset_from_pool as _reset_from_pool,
    sample_world as _sample_world,
)
from gym_craftingworld_tpu_torch.core.state import onehot_from_packed, packed_from_onehot
from gym_craftingworld_tpu_torch.core.step import step as core_step
from gym_craftingworld_tpu_torch.render import raster
from gym_craftingworld_tpu_torch.utils.coordinates import Coord
from gym_craftingworld_tpu_torch.utils.gif import GifRecorder

TASK_LIST = list(C.TASK_LIST)


def _numpy(x):
    """A numpy array that shares no memory with the state: ``.numpy()`` of a
    CPU tensor is a view of it, so that one is copied."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    return x.cpu().numpy() if x.is_cuda else x.numpy().copy()


class CraftingWorldEnvRay:
    """Goal-conditioned pixel-observation CraftingWorld (primary variant)."""

    metadata = {"render.modes": ["human", "Non"]}

    _DEFAULT_SIZE = C.DEFAULT_SIZE
    _DEFAULT_MAX_STEPS = C.DEFAULT_MAX_STEPS

    def __init__(
        self,
        size=None,
        fixed_init_state=0,
        max_steps=None,
        store_gif=False,
        render_save_rate=1,
        task_list=None,
        selected_tasks=None,
        number_of_tasks=None,
        stacking=True,
        reward_style=None,
        seed=None,
        batch_size=1,
        rng_mode="fast",
        incremental_render=False,
        device="cuda",
    ):
        """``rng_mode='fast'`` (default) draws resets from a
        ``torch.Generator`` on ``device`` — same distributions as the
        reference, different bitstream. ``rng_mode='parity'`` (batch_size 1
        only) replays the reference's RandomState draw sequence on the host
        (parity/host_rng.py), making whole episodes bit-exact with a
        reference env under the same seed. ``incremental_render=True`` (pixel
        variants, batch_size 1 only) maintains the observation image on the
        host and repaints only the cells a step changed — the reference's
        ``render_edit`` fast path (craftingworld_ray.py:522-557) for
        interactive single-env use; byte-exact with the full render.
        ``device`` holds the state and runs the steps and renders."""
        if rng_mode not in ("fast", "parity"):
            raise ValueError(f"unknown rng_mode {rng_mode!r}")
        if rng_mode == "parity" and batch_size != 1:
            raise ValueError("rng_mode='parity' requires batch_size=1")
        self.rng_mode = rng_mode
        if incremental_render and (
            batch_size != 1 or not self._supports_incremental
        ):
            raise ValueError(
                "incremental_render requires batch_size=1 and a 4x4-px pixel "
                "variant (Ray/Flat)"
            )
        self.incremental_render = bool(incremental_render)
        self._inc = None
        self.device = torch.device(device)
        size = size or self._DEFAULT_SIZE
        max_steps = max_steps or self._DEFAULT_MAX_STEPS
        task_list = list(task_list) if task_list is not None else TASK_LIST
        if task_list != TASK_LIST:
            raise NotImplementedError(
                "custom task_list ordering is unsupported: the reference's "
                "eval_task_edit hard-codes canonical task indices "
                "(craftingworld_ray.py:646-703)"
            )
        selected_tasks = (
            list(selected_tasks) if selected_tasks is not None else task_list
        )
        n_tasks = (
            number_of_tasks if number_of_tasks is not None else len(selected_tasks)
        )
        self.task_list = task_list
        self.selected_tasks = selected_tasks
        self.cfg = EnvConfig(
            height=size[0],
            width=size[1],
            max_steps=max_steps,
            stacking=stacking,
            selected_task_indices=tuple(
                task_list.index(t) for t in selected_tasks
            ),
            number_of_tasks=min(n_tasks, len(selected_tasks)),
            reward_equal=(reward_style is None),
        )
        self.batch_size = int(batch_size)
        self.MAX_STEPS = max_steps
        self.STATE_W, self.STATE_H = size

        self.seed(seed)

        self.fixed_init_state = int(fixed_init_state)
        self._pool = None
        if self.fixed_init_state:
            if self.rng_mode == "parity":
                self._parity.generate_fixed_pool(self.fixed_init_state)
            else:
                self._pool = _generate_pool(self.cfg, self._gen, self.fixed_init_state)

        self.action_space = spaces.Discrete(C.N_ACTIONS)
        self.observation_space = self._build_observation_space()
        self.observation_vector_space = self._build_vector_space()

        self._state = None
        self._cached = {}
        self.ep_no = 0
        self.step_num = 0

        self.store_gif = False
        self.render_save_rate = render_save_rate
        self._recorder = None
        self.env_id = None
        if store_gif:
            self.allow_gif_storage()

    # -- spaces ------------------------------------------------------------

    def _pixel_shape(self):
        return (self.STATE_W * 4, self.STATE_H * 4, 3)

    def _build_observation_space(self):
        box = spaces.Box(0, 255, self._pixel_shape(), dtype=np.uint8)
        return spaces.Dict(
            dict(
                observation=box,
                desired_goal=box,
                achieved_goal=box,
                init_observation=box,
            )
        )

    def _build_vector_space(self):
        state_box = spaces.Box(
            0, 1, (self.STATE_W, self.STATE_H, C.N_CHANNELS), dtype=np.uint8
        )
        goal_box = spaces.Box(0, 1, (1, C.N_TASKS), dtype=np.uint8)
        return spaces.Dict(
            dict(
                observation=state_box,
                desired_goal=goal_box,
                achieved_goal=goal_box,
                init_observation=state_box,
            )
        )

    # -- seeding -----------------------------------------------------------

    def seed(self, seed=None):
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2**31))
        self._seed = seed
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        if getattr(self, "rng_mode", "fast") == "parity":
            from gym_craftingworld_tpu_torch.parity.host_rng import ParityReset

            self._parity = ParityReset(self.cfg, seed)
            if getattr(self, "fixed_init_state", 0):
                self._parity.generate_fixed_pool(self.fixed_init_state)
        return [seed]

    # -- core plumbing -----------------------------------------------------

    def _do_reset(self):
        if self.rng_mode == "parity":
            return self._parity.reset_state(self.device)
        if self._pool is not None:
            return _reset_from_pool(self.cfg, self.batch_size, self._gen, *self._pool)
        return _core_reset(self.cfg, self.batch_size, self._gen, self.device)

    def _unbatch(self, arr):
        """Return numpy; drop the leading batch axis when batch_size == 1."""
        arr = _numpy(arr)
        return arr[0] if self.batch_size == 1 else arr

    # -- reference-compatible live attributes ------------------------------

    @property
    def obs_one_hot(self):
        return self._unbatch(
            raster.render_onehot(
                self._state.objects, self._state.agent, self._state.holding
            )
        )

    @property
    def agent_pos(self):
        a = _numpy(self._state.agent)
        return tuple(a[0]) if self.batch_size == 1 else a

    @property
    def desired_goal_vector(self):
        d = _numpy(self._state.desired)
        return d[0][None] if self.batch_size == 1 else d

    @property
    def achieved_goal_vector(self):
        a = _numpy(self._state.achieved)
        return a[0][None] if self.batch_size == 1 else a

    @property
    def INIT_OBS_VECTOR(self):
        init_obj, init_agent = raster._init_views(self._state)
        return self._unbatch(
            raster.render_onehot(
                init_obj, init_agent, torch.zeros_like(self._state.holding)
            )
        )

    @property
    def observation_vector(self):
        return {
            "observation": self.obs_one_hot,
            "desired_goal": self.desired_goal_vector,
            "achieved_goal": self.achieved_goal_vector,
            "init_observation": self.INIT_OBS_VECTOR,
        }

    @property
    def state(self):
        """The packed device state (power-user access)."""
        return self._state

    # -- observations per variant ------------------------------------------

    _supports_incremental = True

    def _images(self):
        return raster.state_images_ray(self._state)

    def _observation(self):
        if self.incremental_render and self._inc is not None:
            return self._observation_incremental()
        imgs = self._images()
        # one host copy per image: observation and achieved_goal are one
        # array, as np.asarray of one JAX array is
        host = {}
        for v in imgs.values():
            if id(v) not in host:
                host[id(v)] = self._unbatch(v)
        obs = {k: host[id(v)] for k, v in imgs.items()}
        self._cached["observation"] = obs
        if self.incremental_render:
            # Seed the host-side image + state mirror for render_edit steps;
            # desired/init are static for the episode so the full path's
            # per-step re-render of them is skipped entirely from here on.
            self._inc = {
                "img": np.array(obs["observation"]),
                "desired": obs["desired_goal"],
                "init": obs["init_observation"],
                "objects": _numpy(self._state.objects[0]),
                "agent": tuple(int(x) for x in _numpy(self._state.agent[0])),
            }
        return obs

    def _observation_incremental(self):
        """render_edit fast path: pull only the tiny packed state (≤½ KB) and
        repaint the ≤2 tiles a step can change, instead of rendering and
        transferring four full frames."""
        inc = self._inc
        new_obj = _numpy(self._state.objects[0])
        new_agent = tuple(int(x) for x in _numpy(self._state.agent[0]))
        new_hold = int(self._state.holding[0])
        changed = {new_agent, inc["agent"]}
        changed.update(map(tuple, np.argwhere(new_obj != inc["objects"]).tolist()))
        raster.render_edit(inc["img"], new_obj, new_agent, new_hold, changed)
        inc["objects"], inc["agent"] = new_obj, new_agent
        img = inc["img"].copy()  # observations stay unaliased (module header)
        obs = {
            "observation": img,
            "achieved_goal": img,
            "desired_goal": inc["desired"].copy(),
            "init_observation": inc["init"].copy(),
        }
        self._cached["observation"] = obs
        return obs

    @property
    def observation(self):
        return self._cached.get("observation") or self._observation()

    def imagine_obs(self):
        """The rendered imagined goal (reference imagine_obs return value)."""
        return self.observation["desired_goal"]

    # -- gym API -----------------------------------------------------------

    def _should_save_episode(self):
        """Hook for variant-specific episode-save rules (Flat overrides)."""
        return True

    def reset(self, render_next=False):
        if (
            self._recorder is not None
            and self.step_num != 0
            and self._recorder.should_record(self.ep_no)
            and self._should_save_episode()
        ):
            self._recorder.save_episode(
                self.ep_no,
                self.step_num,
                self.desired_goal_vector[..., 0, :]
                if self.batch_size > 1
                else self.desired_goal_vector[0],
                self.achieved_goal_vector[..., 0, :]
                if self.batch_size > 1
                else self.achieved_goal_vector[0],
            )

        self._state = self._do_reset()
        self._cached = {}
        self._inc = None  # next _observation() re-seeds the render_edit mirror
        if self.step_num != 0:
            self.ep_no += 1
        self.step_num = 0

        obs = self._observation()
        if self._recorder is not None and self._recorder.should_record(self.ep_no):
            self._recorder.reset_episode()
            self._record_frame(action_label=None, reward=0)
        return obs

    def step(self, action):
        if np.isscalar(action) or np.ndim(action) == 0:
            actions = torch.full((self.batch_size,), int(action), dtype=torch.int32,
                                 device=self.device)
        else:
            actions = torch.as_tensor(_numpy(action), dtype=torch.int32, device=self.device)
        self._state, res = core_step(self.cfg, self._state, actions)
        self._cached = {}
        self.step_num += 1

        reward = self._unbatch(res.reward)
        done = self._unbatch(res.done)
        if self.batch_size == 1:
            reward, done = int(reward), bool(done)
        obs = self._observation()
        info = {
            "task_success": self.achieved_goal_vector,
            "desired_goal": self.desired_goal_vector,
            "achieved_goal": self.achieved_goal_vector,
        }
        if self._recorder is not None and self._recorder.should_record(self.ep_no):
            label = C.ACTION_NAMES[int(actions[0])]
            self._record_frame(action_label=label, reward=np.max(reward))
        return obs, reward, done, info

    def render(self, state=None, mode="Non", tile_size=4):
        """Render the current observation, or a reference-style one-hot state."""
        if state is None:
            img = self.observation["observation"]
            img = img if self.batch_size == 1 else img[0]
        else:
            objects, agent, holding = packed_from_onehot(np.asarray(state))
            t = lambda x, dtype=None: torch.tensor(np.asarray(x, dtype), device=self.device)[None]
            img = _numpy(self._render_fn(t(objects), t(agent), t(holding, np.int32)))[0]
        if mode == "human":
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(1)
            ax.imshow(img)
            fig.show()
        return img

    _render_fn = staticmethod(raster.render_ray)

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        achieved = np.asarray(achieved_goal).reshape(-1)
        desired = np.asarray(desired_goal).reshape(-1)
        if self.cfg.reward_equal:
            ok = np.array_equal(achieved, desired)
        else:
            ok = np.all(desired <= achieved)
        return self.MAX_STEPS if ok else -1

    def close(self):
        pass

    # -- reference helper functions (craftingworld_ray.py:784-799) ---------

    def one_hot(self, obj=None, agent=False, holding=None):
        """Build a 12-wide one-hot cell row (reference ``one_hot``)."""
        row = [0] * C.N_CHANNELS
        if obj is not None:
            row[obj] = 1
        if agent:
            row[C.N_OBJECTS] = 1
        if holding is not None:
            row[holding + C.N_OBJECTS + 1] = 1
        return row

    @staticmethod
    def translate_one_hot(one_hot_row):
        """Decode a 12-wide cell row → (object_channel|None, agent, holding|None)."""
        row = np.asarray(one_hot_row)
        obj_ch = row[: C.N_OBJECTS]
        object_at_location = int(obj_ch.argmax()) if obj_ch.any() else None
        hold_ch = row[C.N_OBJECTS + 1 :]
        holding = int(hold_ch.argmax()) if hold_ch.any() else None
        agent = int(row[C.N_OBJECTS])
        return object_at_location, agent, holding

    # -- reference diagnostic methods ---------------------------------------
    # The reference exposes these as public methods on the env instance; they
    # are thin delegates to the functional core so reference-notebook code
    # runs unmodified against this shim.

    def sample_state(self):
        """Sample a one-of-each-object observation + agent position.

        Mirrors ``sample_state`` (craftingworld_ray.py:599-628): returns
        ``(state (H, W, 12) int one-hot, agent_position Coord)``. In parity
        mode the placement consumes the reference's RandomState shuffle, so
        successive calls match a reference env under the same seed draw for
        draw; fast mode draws placement scores from the env's generator (same
        distribution — see core/reset.sample_world).
        """
        if self.rng_mode == "parity":
            objects, agent = self._parity._sample_world()
        else:
            scores = torch.rand((1, self.cfg.n_cells), generator=self._gen,
                                device=self.device)
            obj, agent, _ = _sample_world(self.cfg, scores)
            objects, agent = _numpy(obj[0]), _numpy(agent[0])
        state = onehot_from_packed(np.asarray(objects), agent, C.HOLD_NONE)
        agent_position = Coord(
            int(agent[0]), int(agent[1]), self.STATE_W - 1, self.STATE_H - 1
        )
        return state, agent_position

    def generate_fixed_states(self, num_states: int = 1) -> list:
        """N placement draws up front (craftingworld_ray.py:149-154)."""
        return [self.sample_state()[0] for _ in range(num_states)]

    def eval_task_edit(self, old_contents_new_loc):
        """Re-evaluate the achieved-goal vector from the agent's cell only.

        Mirrors ``eval_task_edit`` (craftingworld_ray.py:646-703):
        ``old_contents_new_loc`` is the destination cell's 12-wide one-hot
        row *after* the agent bit transferred but *before* object effects
        (the :411 snapshot), or ``None``. Updates the live achieved vector
        in place (the shim's state is functional, so the packed state is
        replaced) exactly per the reference rules, including the
        chopped-tree exemption for MoveSticks (:680-682).
        """
        if self.batch_size != 1:
            raise ValueError("eval_task_edit is a single-env diagnostic")
        achieved = _numpy(self._state.achieved[0]).copy()
        cell = self.obs_one_hot[self.agent_pos]
        new_objects = np.nonzero(cell)[0]
        old_object = (
            int(np.nonzero(np.asarray(old_contents_new_loc))[0][0])
            if old_contents_new_loc is not None
            else 100
        )
        if old_object == 5:
            achieved[C.T_EAT_BREAD] = 1
        elif old_object == 3:
            achieved[C.T_CHOP_ROCK] = 1
        elif old_object == 4:
            achieved[C.T_CHOP_TREE] = 1
        achieved[C.T_GO_TO_HOUSE] = 1 if new_objects[0] == 6 else 0
        init_cell = np.nonzero(self.INIT_OBS_VECTOR[self.agent_pos])[0]
        if new_objects[-1] == 8:
            pass  # not holding anything
        elif new_objects[-1] == 9:  # holding sticks
            if len(init_cell) == 0:
                achieved[C.T_MOVE_STICKS] = 1
            elif init_cell[0] == 0:
                achieved[C.T_MOVE_STICKS] = 0
            elif init_cell[0] == 4 and achieved[C.T_CHOP_TREE] == 1:
                achieved[C.T_MOVE_STICKS] = 0
            else:
                achieved[C.T_MOVE_STICKS] = 1
        elif new_objects[-1] == 10:  # holding axe
            if old_object == 7:
                achieved[C.T_MAKE_BREAD] = 1
            if len(init_cell) == 0:
                achieved[C.T_MOVE_AXE] = 1
            else:
                achieved[C.T_MOVE_AXE] = 0 if init_cell[0] == 1 else 1
        else:  # holding hammer
            if old_object == 0:
                achieved[C.T_BUILD_HOUSE] = 1
            if len(init_cell) == 0:
                achieved[C.T_MOVE_HAMMER] = 1
            else:
                achieved[C.T_MOVE_HAMMER] = 0 if init_cell[0] == 2 else 1
        self._state = dataclasses.replace(
            self._state,
            achieved=torch.tensor(achieved, dtype=torch.int8, device=self.device)[None],
        )

    def short_circuit_check(self, a, b, n):
        """Chunked early-exit array equality (craftingworld_ray.py:747-755)."""
        a, b = np.asarray(a), np.asarray(b)
        L = len(a) // n
        j = 0
        for i in range(n):
            j = i * L
            if not np.all(a[j : j + L] == b[j : j + L]):
                return False
        return bool(np.all(a[j + L :] == b[j + L :]))

    # -- gif recording -----------------------------------------------------

    def allow_gif_storage(self, store_gif=True):
        self.store_gif = store_gif
        if store_gif:
            env_id = int(torch.randint(0, 1_000_000, (), generator=self._gen,
                                       device=self.device))
            self._recorder = GifRecorder(
                env_id=env_id, save_rate=self.render_save_rate
            )
            self.env_id = env_id

    def _frame_images(self):
        obs = self.observation
        img = obs["observation"]
        goal = obs["desired_goal"]
        if self.batch_size > 1:
            img, goal = img[0], goal[0]
        return img, goal

    def _record_frame(self, action_label, reward):
        img, goal = self._frame_images()
        d = self.desired_goal_vector
        a = self.achieved_goal_vector
        if self.batch_size > 1:
            d, a = d[0], a[0]
        else:
            d, a = d[0], a[0]
        self._recorder.add_frame(
            img, goal, self.ep_no, self.step_num, action_label, reward, d, a
        )


class CraftingWorldEnvFlat(CraftingWorldEnvRay):
    """8x8 variant whose observation is the raw image (craftingworld_flat.py:57,119,185)."""

    _DEFAULT_SIZE = C.FLAT_SIZE
    _DEFAULT_MAX_STEPS = C.FLAT_MAX_STEPS

    def __init__(self, *args, **kwargs):
        kwargs.pop("fixed_init_state", None)  # Flat has no fixed-init path
        super().__init__(*args, **kwargs)

    def _build_observation_space(self):
        return spaces.Box(0, 255, self._pixel_shape(), dtype=np.uint8)

    def _should_save_episode(self):
        # Flat saves a recorded episode only when a task was completed or
        # every 30th episode (craftingworld_flat.py:68).
        completed = np.asarray(self.achieved_goal_vector).any()
        return bool(completed) or self.ep_no % 30 == 0

    def reset(self, render_next=False):
        obs = super().reset(render_next)
        return obs["observation"]

    def step(self, action):
        obs, reward, done, info = super().step(action)
        return obs["observation"], reward, done, info


class CraftingWorldEnvOneHot(CraftingWorldEnvRay):
    """One-hot observation variant: the obs dict carries raw (H, W, 12) states;
    desired_goal is the imagined final one-hot state (carftingworld_onehot.py:202-207)."""

    _supports_incremental = False  # obs is the raw state, nothing to repaint

    def _build_observation_space(self):
        box = spaces.Box(
            0, 1, (self.STATE_W, self.STATE_H, C.N_CHANNELS), dtype=np.uint8
        )
        return spaces.Dict(
            dict(
                observation=box,
                desired_goal=box,
                achieved_goal=box,
                init_observation=box,
            )
        )

    def _images(self):
        return raster.state_obs_onehot(self._state)

    def _frame_images(self):
        # GIFs still picture the world: fall back to pixel renders.
        imgs = raster.state_images_ray(self._state)
        img, goal = _numpy(imgs["observation"]), _numpy(imgs["desired_goal"])
        return img[0], goal[0]


class CraftingWorldEnvAltObs(CraftingWorldEnvRay):
    """3x3-px tile observation with a bottom status strip; optional stacked obs
    (craftingworld_altobs.py:115-119,258-259,408-411)."""

    _supports_incremental = False  # 3x3 tile layout; fast path is Ray/Flat only

    def __init__(self, *args, stacked_obs=False, **kwargs):
        self.stacked_obs = stacked_obs
        super().__init__(*args, **kwargs)

    def _pixel_shape(self):
        return ((self.STATE_W + 1) * 3, self.STATE_H * 3, 3)

    def _build_observation_space(self):
        box = spaces.Box(0, 510, self._pixel_shape(), dtype=np.int16)
        if self.stacked_obs:
            return spaces.Box(0, 510, (4,) + self._pixel_shape(), dtype=np.int16)
        return spaces.Dict(
            dict(
                observation=box,
                desired_goal=box,
                achieved_goal=box,
                init_observation=box,
            )
        )

    _render_fn = staticmethod(raster.render_altobs)

    def _images(self):
        return raster.state_images_altobs(self._state)

    def _stack(self, obs):
        return np.stack(
            [
                obs["observation"],
                obs["desired_goal"],
                obs["achieved_goal"],
                obs["init_observation"],
            ]
        )

    def reset(self, render_next=False):
        obs = super().reset(render_next)
        return self._stack(obs) if self.stacked_obs else obs

    def step(self, action):
        obs, reward, done, info = super().step(action)
        if self.stacked_obs:
            obs = self._stack(obs)
        return obs, reward, done, info
