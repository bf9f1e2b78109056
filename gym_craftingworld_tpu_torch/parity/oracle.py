"""Load and drive the reference implementation as a bit-exactness oracle.

The reference (``gym_craftingworld``) is pure Python (numpy + matplotlib +
legacy gym). It is imported here through the bundled ``gym`` shim
(:mod:`gym_craftingworld_tpu_torch.parity.gymshim`) and driven directly in
parity tests: fixed seed → recorded action sequence → per-step comparison of
one-hot state, achieved/desired vectors, rewards, and rendered frames.

A copy of ``gym_craftingworld_tpu/parity/oracle.py`` but for where it looks
for the reference by default: ``$CRAFTINGWORLD_REFERENCE``, else the
``reference`` directory at the root of this repository's checkout.
"""

from __future__ import annotations

import importlib
import os
import sys

_REFERENCE_PATH = os.environ.get("CRAFTINGWORLD_REFERENCE", os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "reference"))
_SHIM_PATH = os.path.join(os.path.dirname(__file__), "gymshim")


def reference_available() -> bool:
    return os.path.isdir(os.path.join(_REFERENCE_PATH, "gym_craftingworld"))


def load_reference():
    """Import the reference package (idempotent). Returns the module."""
    if "gym" not in sys.modules or not getattr(
        sys.modules.get("gym"), "__craftingworld_shim__", False
    ):
        # Force our shim over any other `gym` that may be importable.
        for mod in [m for m in list(sys.modules) if m == "gym" or m.startswith("gym.")]:
            del sys.modules[mod]
        sys.path.insert(0, _SHIM_PATH)
        import gym  # noqa: F401

        sys.modules["gym"].__craftingworld_shim__ = True
    if _REFERENCE_PATH not in sys.path:
        sys.path.insert(0, _REFERENCE_PATH)
    # matplotlib without display.
    os.environ.setdefault("MPLBACKEND", "Agg")
    return importlib.import_module("gym_craftingworld")


def make_reference_env(variant: str = "ray", seed: int | None = 0, **kwargs):
    """Construct a reference env of the given variant with a fixed seed.

    variant: 'ray' | 'flat' | 'onehot' | 'altobs'.
    The env is seeded *after* construction (the constructor's unseeded RNG is
    replaced), then you should call ``reset()`` yourself so every RNG draw from
    the fixed seed onward is accounted for.
    """
    load_reference()
    envs = importlib.import_module("gym_craftingworld.envs")
    cls = {
        "ray": envs.CraftingWorldEnvRay,
        "flat": envs.CraftingWorldEnvFlat,
        "onehot": envs.CraftingWorldEnvOneHot,
        "altobs": envs.CraftingWorldEnvAltObs,
    }[variant]
    env = cls(**kwargs)
    if seed is not None:
        env.seed(seed)
    return env
