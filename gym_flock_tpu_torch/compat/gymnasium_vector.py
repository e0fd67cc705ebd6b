"""A Gymnasium ``VectorEnv``-style facade over the batched envs
(counterpart of ``gym_flock_tpu/compat/gymnasium_vector.py``)::

    venv = make_gymnasium_vector("FlockingRelative-v0", num_envs=1024)
    obs, infos = venv.reset(seed=0)
    u = venv.controller()                       # batched expert, NumPy
    obs, rew, term, trunc, infos = venv.step(u)

The whole batch lives on ``device`` (the card unless the caller asks for
``"cpu"``) and steps through ``reset_env``/``step_env``; NumPy goes in and
out, fetched with one synchronisation a step (two where an episode ends).
It does not import the ``gymnasium`` package.

Autoreset is SAME_STEP (gymnasium's ``SyncVectorEnv`` convention): where an
episode ends, the returned ``obs`` row is already the next episode's first
observation, and the finished episode's last one is in
``infos["final_observation"]`` (an object array) under the mask
``infos["_final_observation"]``.  Terminated/truncated split by family as
in :mod:`gymnasium_api`.

Deviations from the JAX facade, each pinned by a test:

* On a step where any episode ends, the WHOLE batch is reset from the
  generator and the finished rows take the new episodes (the JAX facade
  resets each env from its own key).  It costs a full reset, a flocking
  reset's synced draws among them, on such steps.
* The batched ``MultiDiscrete`` action space has gymnasium's shape
  ``[num_envs, len(nvec)]`` (the JAX facade flattens it to one row).
* ``controller(**kwargs)`` passes its options straight to the env's
  controller, array-valued ones too (the JAX facade keys a cache of
  compiled controllers on them, so an unhashable value fails there).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from gym_flock_tpu_torch.compat.gym_api import as_action, fetch, make_on, require_device
from gym_flock_tpu_torch.compat.gymnasium_api import _done_semantics, split_done
from gym_flock_tpu_torch.core.env import _select
from gym_flock_tpu_torch.core.registry import registry as _registry
from gym_flock_tpu_torch.core.spaces import Box, DictSpace, Discrete, MultiDiscrete

__all__ = ["GymnasiumVectorEnv", "make_gymnasium_vector", "batch_space"]


def batch_space(space, n: int):
    """The single-env space with a leading batch axis of ``n``
    (gymnasium's ``batch_space``)."""
    if isinstance(space, Box):
        return Box(space.low, space.high, (n,) + tuple(space.shape), space.dtype)
    if isinstance(space, Discrete):
        return MultiDiscrete((space.n,) * n)
    if isinstance(space, MultiDiscrete):
        return MultiDiscrete((tuple(space.nvec),) * n)
    if isinstance(space, DictSpace):
        return DictSpace({k: batch_space(v, n) for k, v in space.spaces.items()})
    raise TypeError(f"cannot batch space {space!r}")


class GymnasiumVectorEnv:
    """Synchronous vector env over one batch on one device."""

    def __init__(self, env_id: str, num_envs: int, max_episode_steps: Optional[int] = None,
                 device="cuda", **kwargs):
        self.env_id = env_id
        self.num_envs = int(num_envs)
        self.device = require_device(device)
        self._env, self._params = make_on(env_id, self.device, **kwargs)
        spec = _registry.get(env_id)
        if max_episode_steps is None and spec is not None:
            max_episode_steps = spec.max_episode_steps
        # 0 disables the limit, as make_gymnasium's
        self.max_episode_steps = max_episode_steps or None
        self._done_kind = _done_semantics(env_id)
        self._gen = torch.Generator(device=self.device)
        self._seeded = False
        self._state = None
        self._elapsed = None  # [B] int32 on the device

    # -- gymnasium.vector surface ------------------------------------------

    @property
    def single_observation_space(self):
        return self._env.observation_space(self._params)

    @property
    def single_action_space(self):
        return self._env.action_space(self._params)

    @property
    def observation_space(self):
        return batch_space(self.single_observation_space, self.num_envs)

    @property
    def action_space(self):
        return batch_space(self.single_action_space, self.num_envs)

    @property
    def params(self):
        return self._params

    @property
    def state(self):
        """The batch's current state, on the device."""
        return self._state

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[Dict] = None) -> Tuple[Any, Dict]:
        if seed is not None:
            self._gen.manual_seed(seed)
            self._seeded = True
        elif not self._seeded:
            # never seeded: fresh entropy; an unseeded reset after a seeded
            # one continues the stream
            self._gen.manual_seed(int(np.random.SeedSequence().entropy) & 0x7FFFFFFF)
            self._seeded = True
        self._state, obs = self._env.reset_env(self._gen, self._params, self.num_envs)
        self._elapsed = torch.zeros(self.num_envs, dtype=torch.int32, device=self.device)
        return fetch(obs), {}

    def step(self, actions) -> Tuple[Any, np.ndarray, np.ndarray, np.ndarray, Dict]:
        if self._state is None:
            raise RuntimeError("call reset() first")
        a = as_action(actions, self.single_action_space, self.device)
        state, obs, reward, done, _ = self._env.step_env(self._gen, self._state, a,
                                                         self._params)
        elapsed = self._elapsed + 1
        term, trunc = split_done(self._done_kind, done, elapsed, self.max_episode_steps,
                                 getattr(self._params, "max_steps", None))
        finish = term | trunc
        h_obs, h_reward, h_term, h_trunc = fetch((obs, reward, term, trunc))
        mask = h_term | h_trunc
        infos: Dict[str, Any] = {}
        if mask.any():
            # SAME_STEP autoreset: the finished rows take a fresh episode
            state_r, obs_r = self._env.reset_env(self._gen, self._params, self.num_envs)
            state = _select(finish, state, state_r)
            final = np.full((self.num_envs,), None, dtype=object)
            final_info = np.full((self.num_envs,), None, dtype=object)
            for i in np.nonzero(mask)[0]:
                final[i] = _row(h_obs, i)
                final_info[i] = {}  # these envs emit no per-step info
            h_obs = fetch(_select(finish, obs, obs_r))
            infos.update(final_observation=final, _final_observation=mask,
                         final_info=final_info, _final_info=mask)
        self._state = state
        self._elapsed = torch.where(finish, 0, elapsed)
        return h_obs, h_reward, h_term, h_trunc, infos

    def controller(self, **kwargs):
        """Batched expert actions ``[B, ...]`` at the current states (NumPy),
        the env's random choices drawn from the facade's generator;
        ``kwargs`` go to the env's controller as they are."""
        if self._state is None:
            raise RuntimeError("call reset() first")
        return fetch(self._env.controller(self._state, self._params, self._gen, **kwargs))

    def render(self):
        raise NotImplementedError("vector envs do not render; use make_gymnasium() for a "
                                  "single rendering env")

    def close(self):
        self._state = None

    def __repr__(self):
        return f"GymnasiumVectorEnv({self.env_id!r}, num_envs={self.num_envs})"


def _row(tree, i: int):
    if isinstance(tree, np.ndarray):
        return tree[i]
    if isinstance(tree, tuple):
        return tuple(_row(v, i) for v in tree)
    return {k: _row(v, i) for k, v in tree.items()}


def make_gymnasium_vector(env_id: str, num_envs: int = 64, device="cuda",
                          **kwargs) -> GymnasiumVectorEnv:
    """``gymnasium.make_vec``-style construction on ``device`` (see the
    module docstring)."""
    return GymnasiumVectorEnv(env_id, num_envs, device=device, **kwargs)
