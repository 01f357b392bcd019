"""Env registry: @register_env + make() (port of
gsworld_tpu/envs/registry.py)."""

from __future__ import annotations

from typing import Dict

_ENV_REGISTRY: Dict[str, tuple] = {}


def register_env(env_id: str, max_episode_steps: int = 100, **default_kwargs):
    def deco(cls):
        cls.max_episode_steps = max_episode_steps
        _ENV_REGISTRY[env_id] = (cls, default_kwargs)
        cls.env_id = env_id
        return cls
    return deco


def make(env_id: str, **kwargs):
    if env_id not in _ENV_REGISTRY:
        raise KeyError(f"unknown env id {env_id!r}; known: "
                       f"{sorted(_ENV_REGISTRY)}")
    cls, defaults = _ENV_REGISTRY[env_id]
    merged = dict(defaults)
    merged.update(kwargs)
    env = cls(**merged)
    # what the caller asked for, so that the env can be made again with
    # another size or device (dist/sharded.py makes one per shard)
    env.make_kwargs = dict(kwargs)
    return env


def registered_envs():
    return sorted(_ENV_REGISTRY)
