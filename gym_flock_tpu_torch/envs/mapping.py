"""Mapping (target-observation) envs in PyTorch, batched (counterpart of
``gym_flock_tpu/envs/mapping.py``; the reference's ``old/`` mapping envs):

* ``MappingEnv``      — old/mapping.py:15-267: double integrator, 7-NN agent
  and 7 nearest-unobserved-target observations, scalar reward
  ``10 * newly_observed - dist_traveled``;
* ``MappingVelEnv``   — old/mapping_vel.py:15-262: single integrator, 4-NN,
  a reward an agent (the NEAREST agent is credited for each newly observed
  target, minus 0.1 * its distance traveled);
* ``MappingDiscEnv``  — old/mapping_disc.py:15-270: the action picks one of
  the 4 nearest-unobserved-target directions;
* ``MappingLocalEnv`` — old/mapping_local.py:15-272: double integrator, own
  velocity prepended to the observation.

The target set is a fixed ``[T, 2]`` lattice (``params.target_x``, on the
params' device) with an ``unobserved [B, T]`` mask: observed targets get
+inf masked distances, which reproduces the reference's compacted selection
with fixed shapes.  The k nearest unobserved targets are k rounds of
(min, first index of the min) over the ``[B, N, T]`` masked distances,
materialized once a pass, each round setting its picks to +inf in place: the
lower index first among equal distances, as the JAX package's rounds.

The reference's quirks are kept: the adjacency's "union-column" write sets
whole COLUMNS (every agent sees an edge to any agent in anyone's k-NN list;
the base env keeps the resulting diagonal, the others zero it); observation
slots past the last unobserved target stay zero; an agent nearest to
several newly observed targets is credited once.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from gym_flock_tpu_torch.core.env import Env, EnvState
from gym_flock_tpu_torch.core.spaces import Box, MultiDiscrete
from gym_flock_tpu_torch.envs.flocking import _div, _libm, _np_pairwise_sum

__all__ = [
    "MappingParams",
    "MappingState",
    "MappingEnv",
    "MappingVelEnv",
    "MappingDiscEnv",
    "MappingLocalEnv",
    "make_target_grid",
    "mapping_factory",
    "with_target_grid",
]


def make_target_grid(n_agents: int, px_max: float, py_max: float) -> np.ndarray:
    """``[n_agents^2, 2]`` meshgrid target lattice (reference old/mapping.py:74-83)."""
    x = np.linspace(-px_max, px_max, n_agents)
    y = np.linspace(-py_max, py_max, n_agents)
    tx, ty = np.meshgrid(x, y)
    return np.stack((tx.ravel(), ty.ravel()), axis=1)


@dataclasses.dataclass(frozen=True)
class MappingParams:
    """Defaults mirror reference old/mapping.py:24-92."""

    n_agents: int = 100
    nearest_agents: int = 7
    nearest_targets: int = 7
    mean_pooling: bool = True
    max_steps: int = 1000
    # variant switches (see the class docstrings)
    double_integrator: bool = True
    neighbor_dims: int = 4  # 4 or 2
    per_agent_reward: bool = False
    zero_adj_diag: bool = False
    observe_self_vel: bool = False
    observe_neighbors: bool = True
    discrete_actions: bool = False
    # bit-exact parity mode: the integration, the distances, the traveled
    # distance's sum (NumPy's pairwise order) and the expert follow the
    # reference's op order at float64 (envs.flocking's parity note); the
    # target lattice is then float64 too.  The selection equals the
    # reference's wherever distances do not tie
    parity_exact: bool = False
    dt: float = 0.1
    v_max: float = 5.0
    max_accel: float = 1.0  # max_vel for the single-integrator variants
    action_scalar: float = 10.0
    obs_rad: float = 2.0
    px_max: float = 100.0
    py_max: float = 100.0
    dist_penalty: float = 1.0  # 0.1 for the per-agent-reward variants
    reward_scale: float = 10.0  # 1.0 for the per-agent-reward variants
    # [T, 2] target lattice (T = n_agents^2) on the env's device, f32 (f64
    # in parity mode)
    target_x: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)

    @property
    def n_targets(self) -> int:
        return self.n_agents * self.n_agents

    @property
    def obs_rad2(self):
        return self.obs_rad * self.obs_rad


def _lattice_dtype(params: MappingParams) -> torch.dtype:
    return torch.float64 if params.parity_exact else torch.float32


def with_target_grid(params: MappingParams, device) -> MappingParams:
    """``params`` with ``target_x`` the lattice of its ``n_agents`` and arena
    on ``device`` (the card raises where there is none), float32 (float64
    in parity mode)."""
    grid = make_target_grid(params.n_agents, params.px_max, params.py_max)
    return dataclasses.replace(
        params, target_x=torch.as_tensor(grid, dtype=_lattice_dtype(params), device=device))


@dataclasses.dataclass(frozen=True)
class MappingState(EnvState):
    x: torch.Tensor  # [B, N, 4] (velocities zero for single-integrator variants)
    unobserved: torch.Tensor  # [B, T] bool
    # nearest-unobserved-target diffs of the LAST observation pass: the
    # reference's greedy expert and discrete action table read those of the
    # previous compute_helpers call (old/mapping.py:217,
    # old/mapping_disc.py:224), one pass stale relative to `unobserved`
    last_obs_target: torch.Tensor  # [B, N, nearest_targets * 2]


def _nearest_unobserved(masked: torch.Tensor, kt: int):
    """k rounds of (min, first index of the min) over the last axis of the
    ``[B, N, T]`` masked distances, each round setting its picks to +inf IN
    PLACE.  Returns ``(index [B, N, kt] int64, min [B, N, kt])``; a row that
    ran out of finite entries picks index 0 at +inf."""
    picks, mins = [], []
    for _ in range(kt):
        m, idx = masked.min(dim=-1)  # the first index among equal minima
        masked.scatter_(-1, idx[..., None], math.inf)
        picks.append(idx)
        mins.append(m)
    return torch.stack(picks, dim=-1), torch.stack(mins, dim=-1)


def _mapping_helpers(x: torch.Tensor, unobserved: torch.Tensor, params: MappingParams):
    """The observation and reward pass (reference old/mapping.py:167-222).

    Returns ``(state_values [B,N,D], network [B,N,N], obs_target [B,N,2kt],
    newly [B,T] bool, credit [B,N])``.
    """
    b, n = x.shape[:2]
    ka, kt = params.nearest_agents, params.nearest_targets
    rows = torch.arange(b, device=x.device)[:, None, None]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)

    # --- neighbours ------------------------------------------------------
    diff = x[:, :, None, :] - x[:, None, :, :]  # [B, N, N, 4]
    r2 = torch.where(eye, torch.inf, diff[..., 0] ** 2 + diff[..., 1] ** 2)
    nearest = torch.sort(r2, dim=-1, stable=True).indices[..., :ka]  # [B, N, ka]
    agents = torch.arange(n, device=x.device)[None, :, None]
    obs_neigh = diff[rows, agents, nearest, :params.neighbor_dims].reshape(b, n, -1)
    # union-column adjacency (old/mapping.py:186): column j is 1 in EVERY row
    # iff j is in some agent's k-NN list
    col = torch.zeros((b, n), dtype=x.dtype, device=x.device)
    col.scatter_(1, nearest.reshape(b, -1), 1.0)
    adj = col[:, None, :].expand(b, n, n)
    if params.zero_adj_diag:
        adj = torch.where(eye, 0.0, adj)
    n_neighbors = adj.sum(dim=-1, keepdim=True).clamp(min=1.0)
    network = adj / n_neighbors if params.mean_pooling else adj

    # --- targets -----------------------------------------------------------
    tgt = params.target_x  # [T, 2]
    masked = ((x[:, :, None, 0] - tgt[:, 0]) ** 2 + (x[:, :, None, 1] - tgt[:, 1]) ** 2)
    masked = torch.where(unobserved[:, None, :], masked, math.inf)  # [B, N, T]
    # detection and credit read the masked distances before the rounds
    col_min, nearest_agent = masked.min(dim=1)  # [B, T]: the first agent at the min
    newly = unobserved & (col_min < params.obs_rad2)
    credit = torch.zeros((b, n), dtype=x.dtype, device=x.device).scatter_reduce(
        1, nearest_agent, newly.to(x.dtype), reduce="amax")

    nearest_t, min_r2 = _nearest_unobserved(masked, kt)
    del masked
    tgt_diff = x[:, :, None, 0:2] - tgt[nearest_t]  # [B, N, kt, 2]
    tgt_diff = torch.where(torch.isfinite(min_r2)[..., None], tgt_diff, 0.0)
    obs_target = tgt_diff.reshape(b, n, kt * 2)

    parts = []
    if params.observe_self_vel:
        parts.append(x[..., 2:4])
    if params.observe_neighbors:
        parts.append(obs_neigh)
    parts.append(obs_target)
    return torch.cat(parts, dim=-1), network, obs_target, newly, credit


class MappingEnv(Env[MappingParams, MappingState]):
    """N agents sweep an N^2 target lattice (reference old/mapping.py:15-267);
    a target is observed when an agent comes within ``obs_rad``.  Scalar
    reward ``10 * #newly_observed - total_dist_traveled``; done when every
    target is observed or at ``max_steps``.  ``arena_tracks_n``: the
    factory scales the arena's half-width with ``n_agents``."""

    arena_tracks_n = False

    def _base_params(self) -> MappingParams:
        """The defaults without the target lattice."""
        return MappingParams()

    def default_params(self, device="cuda") -> MappingParams:
        """Defaults with the target lattice on ``device`` (default the card;
        pass ``"cpu"`` for the host; without a card it raises)."""
        return with_target_grid(self._base_params(), device)

    # ------------------------------------------------------------ protocol

    def reset_env(self, generator: torch.Generator, params: MappingParams, n_envs: int):
        """Uniform positions over the arena (and velocities for the double
        integrator); the reset's pass retires the targets already in a
        sensor's radius, with no reward (old/mapping.py:112 -> :212)."""
        n, dev = params.n_agents, generator.device

        def uniform(half):
            u = torch.rand((n_envs, n), generator=generator, device=dev)
            return -half + 2.0 * half * u

        px, py = uniform(params.px_max), uniform(params.py_max)
        if params.double_integrator:
            vx, vy = uniform(params.v_max), uniform(params.v_max)
        else:
            vx = vy = torch.zeros((n_envs, n), device=dev)
        x = torch.stack((px, py, vx, vy), dim=-1)
        unobserved = torch.ones((n_envs, params.n_targets), dtype=torch.bool, device=dev)
        values, network, obs_target, newly, _ = _mapping_helpers(x, unobserved, params)
        state = MappingState(
            time=torch.zeros(n_envs, dtype=torch.int32, device=dev),
            x=x, unobserved=unobserved & ~newly, last_obs_target=obs_target,
        )
        return state, (values, network)

    def _control(self, state: MappingState, action, params: MappingParams):
        return action.clamp(-params.max_accel, params.max_accel) * params.action_scalar

    def step_env(self, generator, state: MappingState, action, params: MappingParams):
        """Deterministic dynamics: ``generator`` is not used.  The reward is
        ``[B]``, or ``[B, N]`` for the per-agent variants."""
        u = self._control(state, action, params)
        x = state.x
        dt = params.dt
        if params.double_integrator:
            # Euler, then the velocity clipped (old/mapping.py:149-158)
            px = x[..., 0] + x[..., 2] * dt + u[..., 0] * dt * dt * 0.5
            py = x[..., 1] + x[..., 3] * dt + u[..., 1] * dt * dt * 0.5
            vx = (x[..., 2] + u[..., 0] * dt).clamp(-params.v_max, params.v_max)
            vy = (x[..., 3] + u[..., 1] * dt).clamp(-params.v_max, params.v_max)
        else:
            px = x[..., 0] + u[..., 0] * dt
            py = x[..., 1] + u[..., 1] * dt
            vx, vy = x[..., 2], x[..., 3]
        new_x = torch.stack((px, py, vx, vy), dim=-1)
        sqrt = functools.partial(_libm, torch.sqrt) if params.parity_exact else torch.sqrt
        dist = sqrt((px - x[..., 0]) ** 2 + (py - x[..., 1]) ** 2)  # [B, N]

        values, network, obs_target, newly, credit = _mapping_helpers(
            new_x, state.unobserved, params)
        new_unobserved = state.unobserved & ~newly
        if params.per_agent_reward:
            reward = credit - params.dist_penalty * dist
        elif params.parity_exact:
            # the reference's order (old/mapping.py:161-165): the integer
            # count, and the distances summed in NumPy's pairwise order
            reward = (params.reward_scale * newly.sum(dim=-1).to(x.dtype)
                      - params.dist_penalty * _np_pairwise_sum(dist))
        else:
            reward = (params.reward_scale * newly.sum(dim=-1).to(x.dtype)
                      - params.dist_penalty * dist.sum(dim=-1))
        # every target observed, or the registered step limit
        done = ~new_unobserved.any(dim=-1) | (state.time + 1 >= params.max_steps)
        new_state = MappingState(time=state.time + 1, x=new_x, unobserved=new_unobserved,
                                 last_obs_target=obs_target)
        return new_state, (values, network), reward, done, {}

    def controller(self, state: MappingState, params: MappingParams, generator=None):
        """Greedy: fly at the nearest unobserved target as the last
        observation pass saw it (old/mapping.py:217, 224-232)."""
        if params.parity_exact:
            return _div(-1.0 * state.last_obs_target[..., 0:2], params.action_scalar)
        return -1.0 * state.last_obs_target[..., 0:2] / params.action_scalar

    def observation_space(self, params: MappingParams):
        d = (2 * params.observe_self_vel
             + params.neighbor_dims * params.nearest_agents * params.observe_neighbors
             + 2 * params.nearest_targets)
        return Box(-math.inf, math.inf, (params.n_agents, d))

    def action_space(self, params: MappingParams):
        return Box(-params.max_accel, params.max_accel, (params.n_agents, 2))


class MappingVelEnv(MappingEnv):
    """Velocity-controlled variant (reference old/mapping_vel.py:15-262): 20
    agents, 4-NN position-only neighbour observations, a reward an agent."""

    arena_tracks_n = True  # mapping_vel.py:63-64

    def _base_params(self) -> MappingParams:
        n = 20
        return MappingParams(
            n_agents=n, nearest_agents=4, nearest_targets=4, double_integrator=False,
            neighbor_dims=2, per_agent_reward=True, zero_adj_diag=True, dt=0.1,
            action_scalar=1.0, obs_rad=1.0, px_max=float(n), py_max=float(n),
            dist_penalty=0.1, reward_scale=1.0,
        )


class MappingDiscEnv(MappingVelEnv):
    """Discrete-action variant (reference old/mapping_disc.py:15-270): an
    agent's action picks one of its ``nearest_targets`` unobserved-target
    directions (as the last observation pass saw them); it moves toward it
    at clipped velocity.  An index out of range is the zero action."""

    def _base_params(self) -> MappingParams:
        return dataclasses.replace(super()._base_params(), dt=0.5, discrete_actions=True)

    def _control(self, state, action, params):
        # u indexes hstack(-obs_target, zeros) of the last pass
        # (old/mapping_disc.py:132-133, 224)
        b, n, kt = state.x.shape[0], params.n_agents, params.nearest_targets
        cand = -state.last_obs_target.reshape(b, n, kt, 2)
        idx = torch.as_tensor(action, device=cand.device).reshape(b, n).long()
        in_range = (idx >= 0) & (idx < kt)
        u = torch.gather(cand, 2, idx.clamp(0, kt - 1)[..., None, None].expand(b, n, 1, 2))
        u = torch.where(in_range[..., None], u[:, :, 0], 0.0)
        return u.clamp(-params.max_accel, params.max_accel) * params.action_scalar

    def controller(self, state, params, generator=None):
        """``[B, N, 1]`` zeros: the reference expert is unimplemented and
        returns zeros, i.e. 'head for your nearest target'
        (old/mapping_disc.py:236-237)."""
        return torch.zeros(state.x.shape[:2] + (1,), dtype=torch.int32,
                           device=state.x.device)

    def action_space(self, params: MappingParams):
        # one choice an agent (the reference's bare Discrete cannot be stepped)
        return MultiDiscrete((params.nearest_targets,) * params.n_agents)


class MappingLocalEnv(MappingEnv):
    """Local-observation variant (reference old/mapping_local.py:15-272):
    double integrator, 4-NN, own velocity prepended, a reward an agent."""

    arena_tracks_n = True  # mapping_local.py:106-108

    def _base_params(self) -> MappingParams:
        n = 20
        return MappingParams(
            n_agents=n, nearest_agents=4, nearest_targets=4, neighbor_dims=4,
            per_agent_reward=True, zero_adj_diag=True, observe_self_vel=True, dt=0.1,
            v_max=5.0, action_scalar=10.0, obs_rad=1.0, px_max=float(n), py_max=float(n),
            dist_penalty=0.1, reward_scale=1.0,
        )


def mapping_factory(cls):
    """Registry factory of a mapping env: keyword arguments override the
    defaults; with ``n_agents`` the vel/disc/local arena's half-width
    follows it (reference old/mapping_vel.py:103-104), and the target
    lattice is derived from (n_agents, px_max, py_max) unless ``target_x``
    is given.  ``device`` (default ``"cuda"``; pass ``"cpu"`` for the host)
    places the lattice, and with it every tensor the env makes."""

    def factory(device="cuda", **kwargs):
        env = cls()
        params = dataclasses.replace(env._base_params(), **kwargs)
        if "n_agents" in kwargs and env.arena_tracks_n:
            n = float(params.n_agents)
            params = dataclasses.replace(params, px_max=kwargs.get("px_max", n),
                                         py_max=kwargs.get("py_max", n))
        if params.target_x is None:
            params = with_target_grid(params, device)
        else:
            params = dataclasses.replace(params, target_x=torch.as_tensor(
                params.target_x, dtype=_lattice_dtype(params), device=device))
        return env, params

    return factory
