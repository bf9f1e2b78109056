"""Tiny registry supporting the reference's ``register``/``gym.make`` usage."""

from __future__ import annotations

import importlib

_REGISTRY: dict[str, tuple[str, dict]] = {}


def register(id, entry_point, kwargs=None, **extra):
    _REGISTRY[id] = (entry_point, dict(kwargs or {}))


def make(id, **overrides):
    entry_point, kwargs = _REGISTRY[id]
    module_name, cls_name = entry_point.split(":")
    cls = getattr(importlib.import_module(module_name), cls_name)
    merged = dict(kwargs)
    merged.update(overrides)
    return cls(**merged)
