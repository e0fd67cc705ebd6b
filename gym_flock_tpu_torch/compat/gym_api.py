"""The reference's gym 0.11 surface over the batched envs (counterpart of
``gym_flock_tpu/compat/gym_api.py``).

A user of the reference drives an env as

    env = gym.make('FlockingRelative-v0')
    obs = env.reset()
    u = env.controller()
    obs, reward, done, info = env.step(u)
    env.render()

(reference README.md:18-30, test.py:43-70).  :func:`make_legacy` plays
``gym.make``: the facade holds a batch of ONE env on ``device`` (the card
unless the caller asks for ``"cpu"``; without a card it raises) and a
``torch.Generator`` there that ``seed()`` reseeds.  Observations, actions
and rewards cross as the reference's unbatched NumPy values; each call
fetches its results with one synchronisation.

Left out: the JAX facade's K-deep speculative lookahead, which computes
many controller/step pairs in one device program and serves them from a
host queue.  It hides a remote device's dispatch latency; the port runs
the plain controller/step path.
"""
from __future__ import annotations

import configparser
import dataclasses
import inspect
from typing import Any, Dict, Optional

import numpy as np
import torch

from gym_flock_tpu_torch.core.registry import registry

__all__ = ["LegacyEnv", "make_legacy", "FlattenDictWrapper", "load_cfg_section", "make_on"]


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (no fallback to the host)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch.cuda.is_available() is "
                           "false; pass device='cpu' to run on the host")
    return dev


def make_on(env_id: str, device, **kwargs):
    """``make(env_id, **kwargs)`` with the env's tensors on ``device``:
    factories that place a bank, a system or a lattice take ``device``; the
    others hold no tensors and follow the generator's device."""
    dev = require_device(device)
    if env_id not in registry:
        raise KeyError(f"Unknown env id {env_id!r}. Registered: {', '.join(sorted(registry))}")
    if "device" in inspect.signature(registry[env_id].factory).parameters:
        kwargs["device"] = dev
    from gym_flock_tpu_torch.core.registry import make

    return make(env_id, **kwargs)


def fetch(tree):
    """Tensors (in tuples, dicts and dataclasses) as NumPy arrays, copied
    off the card without blocking and synchronised once."""
    pending = []

    def start(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                x = x.to("cpu", non_blocking=True)
                pending.append(x)
            return x
        if isinstance(x, tuple):
            return tuple(start(v) for v in x)
        if isinstance(x, dict):
            return {k: start(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: start(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x

    def finish(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        if isinstance(x, tuple):
            return tuple(finish(v) for v in x)
        if isinstance(x, dict):
            return {k: finish(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: finish(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x

    out = start(tree)
    if pending:
        torch.cuda.current_stream().synchronize()
    return finish(out)


def first(tree):
    """Row 0 of every array (or tensor) of a nested tree: a batch of one
    as the unbatched value."""
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return tree[0]
    if isinstance(tree, tuple):
        return tuple(first(v) for v in tree)
    if isinstance(tree, dict):
        return {k: first(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: first(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def as_action(action, space, device) -> torch.Tensor:
    """A NumPy action (int64 or float64, say) as a tensor of the action
    space's dtype on ``device``."""
    return torch.as_tensor(np.asarray(action)).to(device=device, dtype=space.dtype)


class LegacyEnv:
    """Stateful reset()/step()/controller()/render() facade over one env."""

    def __init__(self, env, params, env_id: str = "", device="cuda"):
        self.env = env
        self.params = params
        self.env_id = env_id
        self.device = require_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self._state = None
        self._renderer = None
        self.np_random = np.random.RandomState(0)

    # -- gym surface ------------------------------------------------------

    def seed(self, seed: Optional[int] = None):
        self._gen.manual_seed(0 if seed is None else seed)
        self.np_random = np.random.RandomState(seed)
        return [seed]

    def reset(self):
        self._state, obs = self.env.reset_env(self._gen, self.params, 1)
        return first(fetch(obs))

    def _check_reset(self):
        if self._state is None:
            raise RuntimeError("call reset() first")

    def step(self, action):
        self._check_reset()
        a = as_action(action, self.action_space, self.device)[None]
        self._state, obs, reward, done, info = self.env.step_env(
            self._gen, self._state, a, self.params)
        obs, reward, done = first(fetch((obs, reward, done)))
        return obs, float(reward), bool(done), info

    def controller(self, *args, **kwargs):
        """The env's expert action at the current state (its random choices
        drawn from the facade's generator)."""
        self._check_reset()
        return first(fetch(self.env.controller(self._state, self.params, self._gen,
                                               *args, **kwargs)))

    def render(self, mode: str = "human"):
        if mode not in ("human", "rgb_array"):
            return None
        from gym_flock_tpu_torch.render.plot import get_renderer

        if self._renderer is None:
            self._renderer = get_renderer(self.env_id, self.env, self.params)
        self._renderer.draw(first(fetch(self._state)))
        if mode == "rgb_array":
            buf = np.asarray(self._renderer.fig.canvas.buffer_rgba())
            return buf[..., :3].copy()
        return None

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None

    # -- reference extras -------------------------------------------------

    @property
    def state(self):
        """The current state: a batch of one on the facade's device."""
        return self._state

    @property
    def observation_space(self):
        return self.env.observation_space(self.params)

    @property
    def action_space(self):
        return self.env.action_space(self.params)

    def params_from_cfg(self, args):
        """Re-configure from a ConfigParser section (reference
        flocking_relative.py:68-85): n_agents, comm_radius, v_max, dt."""
        casts = {"comm_radius": float, "n_agents": int, "v_max": float, "dt": float}
        updates: Dict[str, Any] = {k: cast(args[k]) for k, cast in casts.items() if k in args}
        if updates:
            self.params = dataclasses.replace(self.params, **updates)
        return self.params

    def update_state(self, state_xy: np.ndarray):
        """Snap externally supplied robot positions onto the graph
        (reference coverage_arl.py:42-44), on the bank's device in float64:
        each robot moves to its nearest target of its graph."""
        from gym_flock_tpu_torch.envs.coverage import CoverageState

        if not isinstance(self._state, CoverageState):
            raise TypeError("update_state needs a coverage env's state")
        g = self._state.graph.long()[0]
        tp = self.params.bank["target_pos"][g].double()  # [T, 2]
        mask = self.params.bank["target_mask"][g]
        pos = torch.as_tensor(np.asarray(state_xy, dtype=np.float64)[:, 0:2], device=tp.device)
        d = torch.sqrt(((pos[:, None, :] - tp[None, :, :]) ** 2).sum(dim=-1))
        loc = torch.where(mask[None, :], d, torch.inf).argmin(dim=1).to(torch.int32)
        self._state = dataclasses.replace(self._state, robot_loc=loc[None])

    @property
    def keys(self):
        """Dict-obs key order (reference coverage.py:90)."""
        return ["nodes", "edges", "senders", "receivers", "step"]


class _CoverageLegacyEnv(LegacyEnv):
    """Coverage's controller signature (reference coverage.py:800-872):
    a random, greedy (K5 on the card) or VRP expert action."""

    def __init__(self, env, params, env_id="", device="cuda"):
        super().__init__(env, params, env_id, device)
        self._vrp = None

    def reset(self):
        if self._vrp is not None:
            self._vrp.reset()
        return super().reset()

    def observe(self):
        """Obs and reward at the current state without moving the robots:
        the reference's ``step(action=None)`` (coverage.py:180-202), which
        the ROS/AirSim drivers call after injecting a state."""
        self._check_reset()
        obs, reward, done, self._state = self.env._obs_reward(self._state, self.params)
        obs, reward, done = first(fetch((obs, reward, done)))
        return obs, float(reward), bool(done)

    def controller(self, random=False, greedy=False, reset_solution=False, strict=False):
        self._check_reset()
        if random:
            return self.np_random.choice(self.params.n_actions, size=(self.params.n_robots, 1))
        if greedy:
            return super().controller()
        from gym_flock_tpu_torch.experts.coverage_vrp import CoverageVRPPolicy

        if self._vrp is None or reset_solution or self._vrp.strict != strict:
            self._vrp = CoverageVRPPolicy(self.params, horizon=-1, strict=strict)
        return self._vrp(first(self._state))


class FlattenDictWrapper:
    """gym.wrappers.FlattenDictWrapper equivalent (reference test.py:33)."""

    def __init__(self, env: LegacyEnv, dict_keys=None):
        self.env = env
        self.dict_keys = dict_keys or env.keys

    def _flatten(self, obs):
        return np.concatenate(
            [np.asarray(obs[k], dtype=np.float32).ravel() for k in self.dict_keys]
        )

    def reset(self):
        return self._flatten(self.env.reset())

    def step(self, action):
        obs, r, d, info = self.env.step(action)
        return self._flatten(obs), r, d, info

    def render(self, mode="human"):
        return self.env.render(mode)

    def close(self):
        return self.env.close()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.env, name)


def make_legacy(env_id: str, device="cuda", **kwargs) -> LegacyEnv:
    """gym.make-style construction of a legacy-surface env on ``device``."""
    from gym_flock_tpu_torch.envs.coverage import CoverageEnv

    env, params = make_on(env_id, device, **kwargs)
    cls = _CoverageLegacyEnv if isinstance(env, CoverageEnv) else LegacyEnv
    return cls(env, params, env_id, device)


def load_cfg_section(path: str, section: str = "flock"):
    """Read a reference-style .cfg into a plain dict (the reference passes
    ConfigParser sections to ``params_from_cfg``; flocking_relative.py:68)."""
    cfg = configparser.ConfigParser()
    if not cfg.read(path):
        raise FileNotFoundError(f"config file not found or unreadable: {path}")
    return dict(cfg[section])
