"""Minimal classic-`gym` compatibility shim.

Only `gymnasium` is commonly installed today, but the reference package
(``gym_craftingworld``) imports the legacy ``gym`` API
(``gym.GoalEnv``, ``gym.spaces``, ``gym.utils.seeding.np_random`` returning a
``numpy.random.RandomState``, ``gym.envs.registration.register``). This shim
provides exactly the surface the reference uses so it can be imported and
driven as the bit-exactness oracle in the parity tests.

It deliberately implements the *old* (pre-0.21) gym behaviours the reference
relies on, most importantly RandomState-style seeding with ``randint`` and
``shuffle`` (gym.utils.seeding in gym<=0.19).
"""

from gym import spaces  # noqa: F401  (submodule)
from gym import utils  # noqa: F401
from gym import envs  # noqa: F401
from gym.envs.registration import make, register  # noqa: F401


class Env:
    metadata = {"render.modes": []}
    reward_range = (-float("inf"), float("inf"))
    spec = None

    def step(self, action):
        raise NotImplementedError

    def reset(self, **kwargs):
        raise NotImplementedError

    def render(self, mode="human"):
        raise NotImplementedError

    def close(self):
        pass

    def seed(self, seed=None):
        return []


class GoalEnv(Env):
    """Legacy gym.GoalEnv: goal-conditioned env with a compute_reward hook."""

    def compute_reward(self, achieved_goal, desired_goal, info):
        raise NotImplementedError


class Wrapper(Env):
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)
