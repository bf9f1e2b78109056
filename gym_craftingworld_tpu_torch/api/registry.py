"""Env registry: the three reference ids plus the AltObs variant.

Counterpart of ``gym_craftingworld_tpu/api/registry.py``, whose ids, default
kwargs and adapters it keeps; the entry points name this package's classes.
Mirrors `gym_craftingworld/__init__.py:5-18` (ids + default kwargs
``{'stacking': True, 'render_save_rate': 10}``). The reference leaves AltObs
importable but unregistered; here it also gets an id for convenience.

``register_gymnasium()`` optionally exposes the envs through the installed
gymnasium registry behind an adapter with the 5-tuple step API.
"""

from __future__ import annotations

from gym_craftingworld_tpu_torch.api.gym_env import (
    CraftingWorldEnvAltObs,
    CraftingWorldEnvFlat,
    CraftingWorldEnvOneHot,
    CraftingWorldEnvRay,
)

_DEFAULT_KWARGS = {"stacking": True, "render_save_rate": 10}

REGISTRY = {
    "craftingworld-v3": (CraftingWorldEnvRay, dict(_DEFAULT_KWARGS)),
    "craftingworldflat-v3": (CraftingWorldEnvFlat, dict(_DEFAULT_KWARGS)),
    "craftingworldonehot-v3": (CraftingWorldEnvOneHot, dict(_DEFAULT_KWARGS)),
    "craftingworldaltobs-v3": (CraftingWorldEnvAltObs, dict(_DEFAULT_KWARGS)),
}


def make(env_id: str, **overrides):
    """Instantiate a registered env id with reference default kwargs."""
    cls, kwargs = REGISTRY[env_id]
    merged = dict(kwargs)
    merged.update(overrides)
    return cls(**merged)


def register(env_id: str, cls, kwargs=None):
    REGISTRY[env_id] = (cls, dict(kwargs or {}))


_adapter_cls = None


def _gymnasium_adapter_cls():
    """Build (once) an adapter class inheriting gymnasium.Env: classic 4-tuple
    step API → gymnasium 5-tuple."""
    global _adapter_cls
    if _adapter_cls is not None:
        return _adapter_cls
    import gymnasium

    class GymnasiumAdapter(gymnasium.Env):
        metadata = {"render_modes": ["human", "rgb_array"]}
        render_mode = "rgb_array"

        def __init__(self, inner):
            self._env = inner
            try:
                self.observation_space = inner.observation_space.to_gymnasium()
                self.action_space = inner.action_space.to_gymnasium()
            except Exception:
                pass

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._env.seed(seed)
            return self._env.reset(), {}

        def step(self, action):
            obs, reward, done, info = self._env.step(action)
            truncated = done and reward != self._env.MAX_STEPS
            terminated = done and not truncated
            return obs, reward, terminated, truncated, info

        def render(self):
            return self._env.render()

        def close(self):
            self._env.close()

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)
            return getattr(self._env, name)

    _adapter_cls = GymnasiumAdapter
    return _adapter_cls


def register_legacy_gym(use_bundled_shim: bool = False):
    """Register all ids with the legacy ``gym`` registry (``gym.make``).

    Reproduces the reference's import-time registration
    (gym_craftingworld/__init__.py:5-18): code written against classic gym's
    ``gym.make('craftingworld-v3')`` then constructs these envs with the
    reference default kwargs. Legacy gym is long dead and usually not
    installed; ``use_bundled_shim=True`` puts the parity shim
    (parity/gymshim) on ``sys.path`` so ``import gym`` works regardless.
    Returns True if a ``gym`` module was found and registration ran.
    """
    if use_bundled_shim:
        import sys

        from gym_craftingworld_tpu_torch.parity.oracle import _SHIM_PATH

        if _SHIM_PATH not in sys.path:
            sys.path.insert(0, _SHIM_PATH)
    try:
        from gym.envs.registration import register as gym_register
    except ImportError:  # pragma: no cover - no gym, no shim requested
        return False
    for env_id, (cls, kwargs) in REGISTRY.items():
        entry = f"gym_craftingworld_tpu_torch.api.gym_env:{cls.__name__}"
        try:
            gym_register(id=env_id, entry_point=entry, kwargs=dict(kwargs))
        except Exception:
            pass  # real legacy gym raises on re-registration; keep the first
    return True


def register_gymnasium(prefix: str = ""):
    """Register all ids with gymnasium (no-op if gymnasium is unavailable)."""
    try:
        import gymnasium
    except ImportError:  # pragma: no cover
        return False
    adapter = _gymnasium_adapter_cls()
    for env_id, (cls, kwargs) in REGISTRY.items():
        gid = prefix + env_id
        if gid in gymnasium.registry:
            continue
        gymnasium.register(
            id=gid,
            entry_point=lambda cls=cls, kwargs=kwargs, **ov: adapter(
                cls(**{**kwargs, **ov})
            ),
            disable_env_checker=True,
        )
    return True
