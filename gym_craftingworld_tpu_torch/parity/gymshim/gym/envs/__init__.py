from gym.envs import registration  # noqa: F401
