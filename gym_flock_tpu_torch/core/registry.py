"""Environment registry: env ids to env factories (counterpart of
``gym_flock_tpu/core/registry.py``).

``env, params = make("FlockingRelative-v0")``; keyword arguments override
default params fields.  ``max_episode_steps`` of each entry is applied
through ``params.max_steps``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["register", "make", "registry", "EnvSpec"]


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    id: str
    factory: Callable[..., Tuple[Any, Any]]  # (**kwargs) -> (env, params)
    max_episode_steps: Optional[int] = None


registry: Dict[str, EnvSpec] = {}


def register(env_id: str, factory, max_episode_steps: Optional[int] = None) -> None:
    if env_id in registry:
        raise ValueError(f"Env id already registered: {env_id}")
    registry[env_id] = EnvSpec(env_id, factory, max_episode_steps)


def make(env_id: str, **kwargs):
    """Instantiate ``(env, params)`` for a registered id."""
    if env_id not in registry:
        known = ", ".join(sorted(registry))
        raise KeyError(f"Unknown env id {env_id!r}. Registered: {known}")
    spec = registry[env_id]
    env, params = spec.factory(**kwargs)
    if spec.max_episode_steps is not None and hasattr(params, "max_steps"):
        if params.max_steps is None or params.max_steps <= 0:
            params = dataclasses.replace(params, max_steps=spec.max_episode_steps)
    return env, params
