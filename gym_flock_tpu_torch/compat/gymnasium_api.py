"""The Gymnasium (0.26+) surface over the legacy facade (counterpart of
``gym_flock_tpu/compat/gymnasium_api.py``)::

    env = make_gymnasium("FlockingRelative-v0")        # on the card
    obs, info = env.reset(seed=0)
    u = env.controller()
    obs, reward, terminated, truncated, info = env.step(u)

It does not import the ``gymnasium`` package.

Terminated/truncated per env family (:func:`_done_semantics`):

* **time** (the flocking variants, shepherding, formation, LQR,
  FlockingMulti): the env's ``done`` is ``time >= max_steps``, a time
  limit, so it surfaces as ``truncated``; ``terminated`` is always False.
* **mixed** (the mapping family): ``done`` is all-targets-observed OR the
  time limit; the first is terminal, the second truncation, split by the
  elapsed steps against ``params.max_steps``.
* **terminal** (the coverage family): ``done`` is all-visited OR
  ``step == episode_length``, with the step counter in the observation, so
  it surfaces as ``terminated``.

``truncated`` also fires at the registration's ``max_episode_steps``,
counted outside the env as gymnasium's ``TimeLimit`` counts.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from gym_flock_tpu_torch.compat.gym_api import LegacyEnv, make_legacy
from gym_flock_tpu_torch.core.registry import registry as _registry

__all__ = ["GymnasiumEnv", "make_gymnasium"]


def _done_semantics(env_id: str) -> str:
    """Classify an env id's native done flag (see the module docstring)."""
    if env_id == "MappingAirsim-v0" or env_id.startswith(("Coverage", "Explore")):
        return "terminal"
    if env_id.startswith("Mapping"):
        return "mixed"
    return "time"


def split_done(kind: str, done, elapsed, limit: Optional[int], env_limit: Optional[int]):
    """``(terminated, truncated)`` from the env's ``done`` after ``elapsed``
    steps of the episode (NumPy scalars, or arrays or tensors): ``limit`` is
    the registration's ``max_episode_steps``, ``env_limit`` the env's own
    ``params.max_steps`` (read by the mixed family)."""
    limit_hit = elapsed >= limit if limit is not None else done & False
    if kind == "time":
        return done & False, done | limit_hit
    if kind == "mixed":
        time_hit = elapsed >= int(env_limit) if env_limit is not None else done & False
        return done & ~time_hit, (done & time_hit) | limit_hit
    return done, limit_hit


class GymnasiumEnv:
    """``reset(seed=...) -> (obs, info)`` / 5-tuple ``step`` facade over a
    :class:`LegacyEnv`; the expert stays reachable as ``controller(...)``
    and every other legacy attribute (``params``, ``update_state``, ...)
    forwards through.  ``np_random`` is the legacy
    ``numpy.random.RandomState``.
    """

    def __init__(self, legacy: LegacyEnv, max_episode_steps: Optional[int] = None,
                 render_mode: Optional[str] = None):
        self._legacy = legacy
        self.max_episode_steps = max_episode_steps
        self.render_mode = render_mode
        self._elapsed = 0
        self._needs_reset = True
        self._ever_seeded = False
        self._done_kind = _done_semantics(getattr(legacy, "env_id", "") or "")

    # -- gymnasium core surface -------------------------------------------

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[Dict] = None) -> Tuple[Any, Dict]:
        if seed is not None:
            self._legacy.seed(seed)
            self._ever_seeded = True
        elif not self._ever_seeded:
            # gymnasium's unseeded default is fresh entropy; a later unseeded
            # reset continues the stream
            self._legacy.seed(int(np.random.SeedSequence().entropy) & 0x7FFFFFFF)
            self._ever_seeded = True
        obs = self._legacy.reset()
        self._elapsed = 0
        self._needs_reset = False
        if self.render_mode == "human":
            self._legacy.render()
        return obs, {}

    def step(self, action) -> Tuple[Any, float, bool, bool, Dict]:
        if self._needs_reset:
            raise RuntimeError("the episode is over (terminated or truncated): call reset()")
        obs, reward, done, info = self._legacy.step(action)
        self._elapsed += 1
        terminated, truncated = split_done(
            self._done_kind, np.bool_(done), np.int64(self._elapsed), self.max_episode_steps,
            getattr(self._legacy.params, "max_steps", None))
        terminated, truncated = bool(terminated), bool(truncated)
        if terminated or truncated:
            self._needs_reset = True
        if self.render_mode == "human":
            self._legacy.render()
        return obs, float(reward), terminated, truncated, dict(info)

    def render(self):
        if self.render_mode is None:
            return None
        return self._legacy.render(self.render_mode)

    def close(self):
        return self._legacy.close()

    # -- passthroughs -------------------------------------------------------

    @property
    def unwrapped(self) -> LegacyEnv:
        return self._legacy

    @property
    def action_space(self):
        return self._legacy.action_space

    @property
    def observation_space(self):
        return self._legacy.observation_space

    @property
    def np_random(self) -> np.random.RandomState:
        return self._legacy.np_random

    def controller(self, *args, **kwargs):
        """Expert action (the reference's non-standard surface, kept)."""
        return self._legacy.controller(*args, **kwargs)

    def __getattr__(self, name):
        # private names never forward: copy/pickle rebuild instances without
        # __init__, and a _legacy lookup here would recurse
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "_legacy"), name)


def make_gymnasium(env_id: str, max_episode_steps: Optional[int] = None,
                   render_mode: Optional[str] = None, device="cuda",
                   **kwargs) -> GymnasiumEnv:
    """``gymnasium.make``-style construction on ``device`` (the card unless
    the caller asks for ``"cpu"``).  ``max_episode_steps`` defaults to the
    registered limit; ``0`` disables it.  ``render_mode``: ``None``,
    ``"human"`` (drawn on reset and step) or ``"rgb_array"`` (``render()``
    returns an ``[H, W, 3]`` uint8 frame)."""
    legacy = make_legacy(env_id, device=device, **kwargs)
    if max_episode_steps is None:
        spec = _registry.get(env_id)
        max_episode_steps = spec.max_episode_steps if spec is not None else None
    elif max_episode_steps == 0:
        max_episode_steps = None
    return GymnasiumEnv(legacy, max_episode_steps, render_mode)
