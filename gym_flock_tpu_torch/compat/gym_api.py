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
and rewards cross as the reference's unbatched NumPy values.

The facade looks ahead, as the JAX package's does, once the calls show
that the controller's actions are stepped.  Until then ``controller()``
computes the action alone and ``step()`` computes the step as it comes (the
eager path).  A ``step()`` with the action the last ``controller()`` call
returned is a hit and lengthens the run of hits; a miss, a step without a
controller call and every call that changes the state, the generator or the
parameters end the run.  A queue holds one entry for each ``_RAMP`` hits of
the run, so that the pairs a miss wastes are at most a ``_RAMP``-th of the
pairs served since the last miss, and at most ``_SPEC_BYTES_BUDGET`` over an
entry's bytes (at most ``_SPEC_DEPTH_MAX``; coverage's greedy queue at most
``_SPEC_DEPTH``).

A queue launches K controller/step pairs back to back, keeps each new state
on the device, fetches the K actions, observations, rewards and dones with
one synchronisation, and serves the calls that follow from it: a ``step()``
with the served action commits the queued transition.  Each entry records
the generator's state after its controller, after its step and, for
coverage, after the reset that follows the step that ends an episode by its
length, and a served call commits the matching one, so that for every
interleaving of calls the values and the generator's state are those of the
unfused pair of calls.  A step with another action, a step without a
controller call, a second controller call of a controller that draws, and
every call that changes the state, the generator or the parameters flush
the queue.  Coverage's queue runs on through that reset, so that the
driver's ``reset()`` is served from the queue too.
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


def tree_map(fn, tree):
    """``fn`` applied to every tensor and array of a tree of tuples, dicts
    and dataclasses; other leaves pass through."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def fetch(tree):
    """Tensors (in tuples, dicts and dataclasses) as NumPy arrays, copied
    off the card without blocking and synchronised once."""
    pending = []

    def start(x):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            x = x.to("cpu", non_blocking=True)
            pending.append(x)
        return x

    out = tree_map(start, tree)
    if pending:
        torch.cuda.current_stream().synchronize()
    return tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, out)


def first(tree):
    """Row 0 of every array (or tensor) of a nested tree: a batch of one
    as the unbatched value."""
    return tree_map(lambda x: x[0], tree)


def nbytes(tree) -> int:
    """Bytes of every tensor and array of a tree."""
    sizes = []
    tree_map(lambda x: sizes.append(x.nbytes), tree)
    return sum(sizes)


def as_action(action, space, device) -> torch.Tensor:
    """A NumPy action (int64 or float64, say) as a tensor of the action
    space's dtype on ``device``."""
    return torch.as_tensor(np.asarray(action)).to(device=device, dtype=space.dtype)


@dataclasses.dataclass
class _Entry:
    """One controller/step pair computed ahead: the action and the step's
    results on the host, the new state on the device, and the generator's
    states before the controller (``g0``), after it (``g1``) and after the
    step (``g2``).  ``reset`` is ``(state, obs, g3)`` of the reset drawn
    after the step that ends an episode (coverage's autoreset), else None."""

    action: np.ndarray
    obs: Any
    reward: Any
    done: Any
    info: dict
    state: Any
    g0: torch.Tensor
    g1: torch.Tensor
    g2: torch.Tensor
    reset: Optional[tuple] = None


class LegacyEnv:
    """Stateful reset()/step()/controller()/render() facade over one env,
    with the controller's lookahead queue (module docstring)."""

    _SPEC_DEPTH_MAX = 32
    _SPEC_BYTES_BUDGET = 8 << 20  # the queue's bytes, host and device
    _RAMP = 8  # hits of the run for each entry of a queue

    def __init__(self, env, params, env_id: str = "", device="cuda"):
        self.env = env
        self.params = params
        self.env_id = env_id
        self.device = require_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self._state = None
        self._renderer = None
        self.np_random = np.random.RandomState(0)
        self._queue = []  # _Entry's ahead of the current state
        self._queue_sig = None  # the controller options the queue was built for
        self._head_served = False  # the head's controller call was served
        self._eager = None  # the action the last controller call computed alone
        self._run = 0  # hits since the last miss or flush
        self._deep_depth = None  # measured from the first transition's bytes
        self._pending_reset = None  # a queued reset, for the next reset()
        self.computed_pairs = 0  # controller/step pairs the queues computed
        self.controller_evals = 0  # controller evaluations, queued or alone

    def _flush_queue(self, keep_run=False):
        self._queue = []
        self._queue_sig = None
        self._head_served = False
        self._eager = None
        self._pending_reset = None
        if not keep_run:
            self._run = 0

    # -- gym surface ------------------------------------------------------

    def seed(self, seed: Optional[int] = None):
        self._gen.manual_seed(0 if seed is None else seed)
        self.np_random = np.random.RandomState(seed)
        self._flush_queue()
        return [seed]

    def reset(self):
        pending = self._pending_reset
        if pending is not None:
            # the queue ran on through this reset: serve it, keep the queue
            self._pending_reset = None
            self._state, obs, g3 = pending
            self._gen.set_state(g3)
            return obs
        self._flush_queue()
        self._state, obs = self.env.reset_env(self._gen, self.params, 1)
        return first(fetch(obs))

    def _check_reset(self):
        if self._state is None:
            raise RuntimeError("call reset() first")

    def step(self, action):
        self._check_reset()
        action = np.asarray(action)
        if self._head_served and np.array_equal(action, self._queue[0].action):
            return self._commit()
        # the eager path: after an action computed alone (a hit where this
        # is that action), a miss, a step without a controller call, or a
        # step past a done entry without reset(); the generator already
        # holds what the calls so far drew
        run = self._run + 1 if self._eager is not None and np.array_equal(
            action, self._eager) else 0
        self._flush_queue()
        self._run = run
        a = as_action(action, self.action_space, self.device)[None]
        self._state, obs, reward, done, info = self.env.step_env(
            self._gen, self._state, a, self.params)
        obs, reward, done = first(fetch((obs, reward, done)))
        self._measure((a, obs, reward, done), self._state)
        return obs, float(reward), bool(done), info

    def _commit(self):
        """A hit: the head's transition and the generator's state after it."""
        head = self._queue.pop(0)
        self._head_served = False
        self._run += 1
        self._gen.set_state(head.g2)
        self._state = head.state
        self._pending_reset = head.reset
        return head.obs, float(head.reward), bool(head.done), head.info

    def controller(self, *args, **kwargs):
        """The env's expert action at the current state (its random choices
        drawn from the facade's generator), served from the lookahead
        queue; an option that cannot be hashed computes it alone."""
        self._check_reset()
        sig = (args, tuple(sorted(kwargs.items())))
        try:
            hash(sig)
        except TypeError:
            self._flush_queue(keep_run=True)
            return self._alone(args, kwargs)
        return self._serve(sig, args, kwargs)

    def _alone(self, args, kwargs) -> np.ndarray:
        """The controller's action computed alone (the eager path)."""
        self.controller_evals += 1
        action = first(fetch(self.env.controller(self._state, self.params, self._gen,
                                                 *args, **kwargs)))
        self._eager = action.copy()
        return action

    def _cap(self) -> int:
        """The deepest queue: the byte budget over a transition's bytes."""
        return self._deep_depth if self._deep_depth is not None else 1

    def _depth(self) -> int:
        """0 (the controller alone) below ``_RAMP`` hits in a row, then one
        entry for each ``_RAMP`` hits of the run, up to the cap, and no
        further than the step that ends the episode by its length."""
        depth = min(self._cap(), self._run // self._RAMP)
        if depth > 1:
            left = self._steps_left()
            if left is not None and left > 0:
                depth = min(depth, left)
        return depth

    def _steps_left(self) -> Optional[int]:
        """Steps up to the one whose ``done`` the episode's length sets, from
        the state's step counter (read once a deep queue): every family's
        step is done from ``time + 1 >= max_steps`` on.  None where the env
        counts no steps; 0 or less past the end of an episode."""
        time, limit = getattr(self._state, "time", None), getattr(self.params, "max_steps", None)
        if time is None or limit is None:
            return None
        return limit - int(time[0])

    def _measure(self, host, state) -> None:
        """The cap, from the first transition's host values and state."""
        if self._deep_depth is None:
            per_entry = nbytes(host) + nbytes(state)
            self._deep_depth = int(max(1, min(self._SPEC_DEPTH_MAX,
                                              self._SPEC_BYTES_BUDGET // max(per_entry, 1))))

    def _serve(self, sig, args, kwargs):
        """The queue head's action (a copy: the caller may change it),
        committing the generator's state after its controller; a new queue
        where the head cannot serve this call, or the action alone where
        the run of hits is too short for one."""
        head = self._queue[0] if self._queue and sig == self._queue_sig else None
        if (head is None
                # after a done entry without reset(): the queue assumed the reset
                or self._pending_reset is not None
                # a second call of a controller that draws draws again
                or (self._head_served and not torch.equal(head.g0, head.g1))):
            self._flush_queue(keep_run=True)
            depth = self._depth()
            if depth == 0:
                return self._alone(args, kwargs)
            self._lookahead(sig, args, kwargs, depth)
            head = self._queue[0]
        self._head_served = True
        self._gen.set_state(head.g1)
        return head.action.copy()

    def _resets_after(self, depth: int) -> Optional[int]:
        """The entry of a ``depth``-deep queue after which the queue draws
        the reset that the driver is expected to ask for, or None."""
        return None

    def _lookahead(self, sig, args, kwargs, depth: int) -> None:
        """``depth`` controller/step pairs from the current state, launched
        back to back and fetched with one synchronisation."""
        env, params, gen = self.env, self.params, self._gen
        dtype = self.action_space.dtype
        state, ahead = self._state, []
        reset_at = self._resets_after(depth)
        for i in range(depth):
            g0 = gen.get_state()
            action = env.controller(state, params, gen, *args, **kwargs)
            g1 = gen.get_state()
            state, obs, reward, done, info = env.step_env(gen, state, action.to(dtype), params)
            entry = _Entry(action, obs, reward, done, info, state, g0, g1, gen.get_state())
            if i == reset_at:
                state, robs = env.reset_env(gen, params, 1)
                entry.reset = (state, robs, gen.get_state())
            ahead.append(entry)
        self.computed_pairs += depth
        self.controller_evals += depth
        host = first(fetch(tuple((e.action, e.obs, e.reward, e.done,
                                  None if e.reset is None else e.reset[1]) for e in ahead)))
        for e, (action, obs, reward, done, robs) in zip(ahead, host):
            e.action, e.obs, e.reward, e.done = action, obs, reward, done
            if e.reset is not None:
                e.reset = (e.reset[0], robs, e.reset[2])
        self._measure(host[0][:4], ahead[0].state)
        self._queue, self._queue_sig = ahead, sig

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
            self._flush_queue()
            self._deep_depth = None  # an entry's size may have changed
        return self.params

    def update_state(self, state_xy: np.ndarray):
        """Snap externally supplied robot positions onto the graph
        (reference coverage_arl.py:42-44), on the bank's device in float64:
        each robot moves to its nearest target of its graph."""
        from gym_flock_tpu_torch.envs.coverage import CoverageState

        if not isinstance(self._state, CoverageState):
            raise TypeError("update_state needs a coverage env's state")
        self._flush_queue()
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
    a random, greedy (K5 on the card) or VRP expert action.  The greedy
    expert is queued; its queue runs on through the reset after the step
    that ends an episode by its length (75 steps for Coverage-v0,
    reference coverage.py:357)."""

    _SPEC_DEPTH = 48  # JAX's depth, away from a resonance with the 75-step episode

    def __init__(self, env, params, env_id="", device="cuda"):
        super().__init__(env, params, env_id, device)
        self._vrp = None

    def _cap(self) -> int:
        return self._SPEC_DEPTH

    def _steps_left(self) -> Optional[int]:
        return None  # the queue runs on through the episode's end

    def _resets_after(self, depth: int) -> Optional[int]:
        """The entry whose step reaches ``episode_length``, from the step
        counter read once a deep queue (a step's ``done`` is never read
        while the queue is launched).  A done from full coverage comes
        unforeseen: the entries after it step on past it, and a reset()
        there flushes them."""
        if depth == 1:
            return None
        left = self.params.episode_length - int(self._state.time[0]) - 1
        return left if 0 <= left < depth else None

    def reset(self):
        if self._vrp is not None:
            self._vrp.reset()
        return super().reset()

    def observe(self):
        """Obs and reward at the current state without moving the robots:
        the reference's ``step(action=None)`` (coverage.py:180-202), which
        the ROS/AirSim drivers call after injecting a state."""
        self._check_reset()
        self._flush_queue()
        obs, reward, done, self._state = self.env._obs_reward(self._state, self.params)
        obs, reward, done = first(fetch((obs, reward, done)))
        return obs, float(reward), bool(done)

    def controller(self, random=False, greedy=False, reset_solution=False, strict=False):
        self._check_reset()
        if not greedy:
            self._flush_queue()
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
