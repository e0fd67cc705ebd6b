"""Delayed K-hop aggregation flocking in PyTorch, batched (counterpart of
``gym_flock_tpu/envs/flocking_multi.py``; the reference's
``old/flocking_multi.py:16-300``).

The env keeps the multi-hop aggregated observation of Tolstaya et al.'s
delayed-aggregation GNN: each step every agent receives the mean of its
neighbours' PREVIOUS aggregation buffer, shifted one filter tap, so
information diffuses one hop a step:

    agg_t = [features(x_t) | mean_{j in N(i)} agg_{t-1}[j, :-nx]]

``x_agg`` is ``[B, N, nx * filter_len]``.  The neighbour mean runs on K2
(``ops.adjacency_matmul``, mean-pooled: ``A prev / max(deg, 1)`` for the
radius adjacency with self excluded, which is symmetric), one call over
the buffer's newest ``filter_len - 1`` taps (one launch a chunk of 8
features: 2 at the default 12); an isolated agent pools to zero, as the
reference's NaN-mean.
The rejection reset's acceptance test runs on K1's "full" channels (min r^2
and degree), one launch a batch draw.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from gym_flock_tpu_torch.core.env import Env, EnvState, _rejection_reset
from gym_flock_tpu_torch.core.spaces import Box
from gym_flock_tpu_torch.ops.adjacency_matmul import adjacency_matmul
from gym_flock_tpu_torch.ops.flocking_sums import flocking_sums_block, reset_accepts, reset_minima

__all__ = ["FlockingMultiParams", "FlockingMultiState", "FlockingMultiEnv"]


@dataclasses.dataclass(frozen=True)
class FlockingMultiParams:
    """Defaults per flocking/params_flock.cfg (filter_length=3,
    N_features=18, network_size=80, comm_radius=0.9, system_dt=0.01,
    max_vel_init=3.0, max_rad_init=10.0, std_dev=0.1*dt)."""

    n_agents: int = 80
    filter_len: int = 3
    nx: int = 6  # (x, init_vel)
    max_steps: int = 1000
    max_reset_tries: int = 64
    comm_radius: float = 0.9
    dt: float = 0.01
    v_max: float = 3.0
    r_max: float = 10.0
    std_dev: float = 0.1 * 0.01  # cfg std_dev * dt (old/flocking_multi.py:36)
    max_accel: float = 40.0
    max_z: float = 200.0
    accel_gain: float = 0.1  # the "0.1 * u" of the dynamics (:106-109)

    @property
    def n_features(self) -> int:
        return self.nx * self.filter_len

    @property
    def comm_radius2(self) -> float:
        return self.comm_radius * self.comm_radius


@dataclasses.dataclass(frozen=True)
class FlockingMultiState(EnvState):
    x: torch.Tensor  # [B, N, 4]
    x_agg: torch.Tensor  # [B, N, nx * filter_len]
    init_vel: torch.Tensor  # [B, N, 2]
    mean_vel: torch.Tensor  # [B, 2]


def _aggregate(x: torch.Tensor, x_agg: torch.Tensor, init_vel: torch.Tensor,
               params: FlockingMultiParams) -> torch.Tensor:
    """One diffusion tap (reference aggregate/get_comms/get_pool,
    old/flocking_multi.py:182-263): this step's features, then the
    neighbour mean of the previous buffer without its oldest tap, on K2."""
    prev = x_agg[..., :params.nx * (params.filter_len - 1)]
    pooled = adjacency_matmul(x, prev, params.comm_radius2, mean_pool=True)
    return torch.cat((x, init_vel, pooled), dim=-1)


class FlockingMultiEnv(Env[FlockingMultiParams, FlockingMultiState]):
    """Noisy double-integrator flock whose observation is the in-env delayed
    K-hop aggregation buffer, clipped to +-max_z and flattened per swarm,
    ``[B, N * n_features]`` (reference old/flocking_multi.py:95-135).
    ``last_reset_tries`` holds the number of batch draws the latest
    :meth:`reset_env` took."""

    last_reset_tries: int = 0

    def default_params(self) -> FlockingMultiParams:
        return FlockingMultiParams()

    def _obs(self, state: FlockingMultiState, params: FlockingMultiParams):
        clipped = state.x_agg.clamp(-params.max_z, params.max_z)
        return clipped.reshape(clipped.shape[0], -1)

    def _draw(self, generator: torch.Generator, params: FlockingMultiParams, n_envs: int):
        """One reset proposal for the batch: positions uniform over the disk
        of radius sqrt(r_max), velocities uniform in [-v_max, v_max] plus a
        per-swarm bias (old/flocking_multi.py:136-177)."""
        n, dev = params.n_agents, generator.device

        def uniform(shape, low, high):
            return low + (high - low) * torch.rand(shape, generator=generator, device=dev)

        length = torch.sqrt(uniform((n_envs, n), 0.0, params.r_max))
        angle = math.pi * uniform((n_envs, n), 0.0, 2.0)
        bias = uniform((n_envs, 2), -params.v_max, params.v_max)
        vx = uniform((n_envs, n), -params.v_max, params.v_max)
        vy = uniform((n_envs, n), -params.v_max, params.v_max)
        return torch.stack((length * torch.cos(angle), length * torch.sin(angle),
                            vx + bias[:, 0:1], vy + bias[:, 1:2]), dim=-1)

    def _reset_accept(self, x: torch.Tensor, params: FlockingMultiParams) -> torch.Tensor:
        """``[B]``: min degree >= 2 and min pairwise distance >= 0.1 (note:
        ``>=``, old/flocking_multi.py:164), from K1's channels 8 and 9."""
        s = flocking_sums_block(x, x, 0, 0, params.comm_radius, params.comm_radius2,
                                channels="full")
        return reset_accepts(*reset_minima(s), 0.1, inclusive=True)

    def reset_env(self, generator: torch.Generator, params: FlockingMultiParams, n_envs: int):
        """Rejection-sampling reset (``core.env._rejection_reset``): each try
        redraws the batch, an env keeps its first accepted draw, or its last
        after ``max_reset_tries`` draws."""
        x, self.last_reset_tries = _rejection_reset(
            lambda: self._draw(generator, params, n_envs),
            lambda x: self._reset_accept(x, params), params.max_reset_tries)
        state = self.init_state(x, params)
        return state, self._obs(state, params)

    def init_state(self, x: torch.Tensor, params: FlockingMultiParams) -> FlockingMultiState:
        """The reset's state at ``x [B, N, 4]``: the first aggregation from
        an all-zero buffer."""
        init_vel = x[..., 2:4]
        agg0 = torch.zeros(x.shape[:2] + (params.n_features,), dtype=x.dtype, device=x.device)
        return FlockingMultiState(
            time=torch.zeros(x.shape[0], dtype=torch.int32, device=x.device),
            x=x, x_agg=_aggregate(x, agg0, init_vel, params), init_vel=init_vel,
            mean_vel=init_vel.mean(dim=-2),
        )

    def step_env(self, generator: torch.Generator, state: FlockingMultiState, action,
                 params: FlockingMultiParams):
        """Positions by the old velocity, velocities by ``accel_gain * u * dt``
        plus one ``randn`` of ``[B, N, 2]`` from ``generator`` times
        ``std_dev``; the reward is ``-sum ||v - mean_vel||^2`` against the
        reset's mean velocity (old/flocking_multi.py:118-121)."""
        x = state.x
        u = action.reshape(x.shape[0], -1, 2)
        noise = params.std_dev * torch.randn(u.shape, generator=generator,
                                             device=generator.device, dtype=x.dtype)
        pos = x[..., 0:2] + x[..., 2:4] * params.dt
        vel = x[..., 2:4] + params.accel_gain * u * params.dt + noise
        new_x = torch.cat((pos, vel), dim=-1)
        x_agg = _aggregate(new_x, state.x_agg, state.init_vel, params)
        new_state = dataclasses.replace(state, time=state.time + 1, x=new_x, x_agg=x_agg)
        reward = -((vel - state.mean_vel[:, None, :]) ** 2).sum(dim=(-2, -1))
        done = new_state.time >= params.max_steps
        return new_state, self._obs(new_state, params), reward, done, {}

    def controller(self, state: FlockingMultiState, params: FlockingMultiParams,
                   generator=None):
        """``[B, N, 2]`` consensus expert ``10 (mean_v - v)``, clipped
        (old/flocking_multi.py:271-279); deterministic."""
        v = state.x[..., 2:4]
        u = 10.0 * (v.mean(dim=-2, keepdim=True) - v)
        return u.clamp(-params.max_accel, params.max_accel)

    def observation_space(self, params: FlockingMultiParams):
        return Box(-params.max_z, params.max_z, (params.n_agents * params.n_features,))

    def action_space(self, params: FlockingMultiParams):
        return Box(-params.max_accel, params.max_accel, (params.n_agents, 2))
