from gym.utils import seeding  # noqa: F401
