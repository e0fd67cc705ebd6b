"""Shepherding in PyTorch, batched (counterpart of
``gym_flock_tpu/envs/shepherding.py``; reference shepherding.py:14-332).

10 shepherds herd 20 sheep into a goal disk at the origin.  Unicycle
dynamics by feedback linearization (offset d=0.3, reference :106-115); the
sheep are repelled by shepherds (weight 0.45) and other sheep (weight 0.075)
through 1/r^2 potentials cut off at r^2 > 2 (:164-178).  The reward is the
fraction of sheep inside the goal disk (:180-185).  ``x`` is ``[B, n, 3]``
rows of (px, py, theta), shepherds first.

The expert (:204-233) is a bang-bang policy on three line-of-sight tests a
shepherd (a sheep within +-2 deg, another shepherd within +-2 deg, the goal
within +-5 deg), as dense ``[B, S, M]`` bearing tests.  The reference's
quirks are kept: its angle wrap returns 0 for an exactly zero angle
(:236-238), and its shepherd test skips EVERY pair whose "all coordinates
nonzero" flags are equal, not just the pair with itself (:253-254).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import torch

from gym_flock_tpu_torch.core.env import Env, EnvState
from gym_flock_tpu_torch.core.spaces import Box
from gym_flock_tpu_torch.envs.flocking import _div, _libm, _seq_sum_cols

__all__ = ["ShepherdingParams", "ShepherdingState", "ShepherdingEnv", "shepherding_factory"]

# (v_left, v_right) wheel speeds of the expert's four branches (:214-232)
_VLR_SHEEP = (0.0082, 0.9996)
_VLR_SHEPHERD = (0.5471, 0.6098)
_VLR_GOAL = (0.9993, 0.9447)
_VLR_NONE = (0.9998, 0.8520)


@dataclasses.dataclass(frozen=True)
class ShepherdingParams:
    """Defaults mirror reference shepherding.py:16-70."""

    n_sheep: int = 20
    n_shepherds: int = 10
    max_steps: int = 1000
    # bit-exact parity mode: the step, the observation, the reward and the
    # expert follow the reference's NumPy op order at float64
    # (envs.flocking's parity note).  The expert's bearings go through
    # atan2, whose 1-ulp differences between libraries could flip a branch
    # only at a bearing within an ulp of its 2 or 5 degree threshold
    parity_exact: bool = False
    dt: float = 0.01
    v_max: float = 2.0
    action_scalar: float = 5.0
    r_max_init: float = 1.0
    comm_radius: float = 2.0
    shepherd_weight: float = 0.15 * 3.0
    sheep_weight: float = 0.15 * 0.5
    d_offset: float = 0.3  # feedback-linearization offset (:107)
    wheel_base: float = 0.6  # differential-drive L (:224)

    @property
    def n_agents(self) -> int:
        return self.n_sheep + self.n_shepherds

    @property
    def r_max(self) -> float:
        return self.r_max_init * math.sqrt(self.n_agents)

    @property
    def goal_region_radius(self) -> float:
        return 0.5 * self.r_max

    @property
    def goal_offset(self) -> Tuple[float, float]:
        return (-self.r_max * 3.0, 0.0)


@dataclasses.dataclass(frozen=True)
class ShepherdingState(EnvState):
    x: torch.Tensor  # [B, n_agents, 3]: (px, py, theta); shepherds first


def _pairwise_r2(x: torch.Tensor):
    """``(dx, dy, r2)``, each ``[B, n, n]``, row minus column."""
    dx = x[..., :, None, 0] - x[..., None, :, 0]
    dy = x[..., :, None, 1] - x[..., None, :, 1]
    return dx, dy, dx * dx + dy * dy


def _wrap(a: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """The reference's ``_wrapToPi`` (:236-238): 0 for an exactly zero angle."""
    if exact:
        return torch.where(a == 0.0, 0.0, _libm(torch.atan2, _libm(torch.sin, a),
                                               _libm(torch.cos, a)))
    return torch.where(a == 0.0, 0.0, torch.atan2(torch.sin(a), torch.cos(a)))


def _vlr_table(like: torch.Tensor) -> torch.Tensor:
    """``[4, 2]`` wheel speeds (sheep, shepherd, goal, none) in like's dtype."""
    return torch.tensor((_VLR_SHEEP, _VLR_SHEPHERD, _VLR_GOAL, _VLR_NONE),
                        dtype=like.dtype, device=like.device)


class ShepherdingEnv(Env[ShepherdingParams, ShepherdingState]):
    def default_params(self) -> ShepherdingParams:
        return ShepherdingParams()

    # ------------------------------------------------------------- helpers

    def _sheep_controller(self, x: torch.Tensor, params: ShepherdingParams):
        """``[B, n_sheep, 2]`` repulsion velocities of the sheep (:164-178)."""
        n = params.n_agents
        dx, dy, r2 = _pairwise_r2(x)
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        r2 = torch.where((r2 > 2.0) | eye, torch.inf, r2)
        # weight by the source agent j (reference force_weights, :50)
        w = torch.cat((
            torch.full((params.n_shepherds,), params.shepherd_weight, dtype=x.dtype,
                       device=x.device),
            torch.full((params.n_sheep,), params.sheep_weight, dtype=x.dtype, device=x.device),
        ))
        if params.parity_exact:
            # the reference's order (:174-177): w * (diff / r2), summed in j
            rx, ry = _seq_sum_cols(w * (dx / r2)), _seq_sum_cols(w * (dy / r2))
        else:
            rx = (w * dx / r2).sum(dim=-1)
            ry = (w * dy / r2).sum(dim=-1)
        return torch.stack((rx, ry), dim=-1)[:, params.n_shepherds:]

    def _adj_mat(self, x: torch.Tensor, params: ShepherdingParams):
        """``[B, n, n]`` weighted 1/r adjacency within ``comm_radius`` (:139-162)."""
        n = params.n_agents
        r2 = _pairwise_r2(x)[2]
        r2 = torch.where(torch.eye(n, dtype=torch.bool, device=x.device), torch.inf, r2)
        adj = (r2 < params.comm_radius ** 2).to(x.dtype)
        if params.parity_exact:
            return adj / _libm(torch.sqrt, r2)
        return adj / torch.sqrt(r2)

    def _obs(self, state: ShepherdingState, params: ShepherdingParams):
        """``([B, n, 4] = (px, py, theta, 1 for a shepherd), [B, n, n])``."""
        x = state.x
        ident = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        ident[:, :params.n_shepherds] = 1.0
        return torch.cat((x, ident), dim=-1), self._adj_mat(x, params)

    # ------------------------------------------------------------ protocol

    def reset_env(self, generator: torch.Generator, params: ShepherdingParams, n_envs: int):
        """Positions uniform over the disk of radius sqrt(r_max) around the
        goal offset, headings 0 (:187-202)."""
        n, dev = params.n_agents, generator.device
        length = torch.sqrt(params.r_max * torch.rand((n_envs, n), generator=generator,
                                                      device=dev))
        angle = math.pi * 2.0 * torch.rand((n_envs, n), generator=generator, device=dev)
        gx, gy = params.goal_offset
        x = torch.stack((length * torch.cos(angle) + gx, length * torch.sin(angle) + gy,
                         torch.zeros_like(length)), dim=-1)
        state = self.init_state(x, params)
        return state, self._obs(state, params)

    def init_state(self, x: torch.Tensor, params: ShepherdingParams) -> ShepherdingState:
        """A state from a ``[B, n_agents, 3]`` tensor."""
        if x.dim() != 3 or x.shape[1:] != (params.n_agents, 3):
            raise ValueError(f"x must be [B, {params.n_agents}, 3], got {tuple(x.shape)}")
        return ShepherdingState(
            time=torch.zeros(x.shape[0], dtype=torch.int32, device=x.device), x=x)

    def step_env(self, generator, state: ShepherdingState, action, params: ShepherdingParams):
        """Unicycle update by feedback linearization (:80-117); deterministic,
        so ``generator`` is not used."""
        x = state.x
        u = torch.cat((action * params.action_scalar, self._sheep_controller(x, params)),
                      dim=-2)
        theta = x[..., 2]
        d = params.d_offset
        if params.parity_exact:
            ct, st = _libm(torch.cos, theta), _libm(torch.sin, theta)
            w = u[..., 0] * _div(-st, d) + u[..., 1] * _div(ct, d)
        else:
            ct, st = torch.cos(theta), torch.sin(theta)
            w = u[..., 0] * (-st / d) + u[..., 1] * (ct / d)
        v = u[..., 0] * ct + u[..., 1] * st
        # the sheep move with a constant forward bias (:110)
        s = params.n_shepherds
        v = torch.cat((v[:, :s], v[:, s:] / 2.0 + 0.5), dim=-1)
        new_x = torch.stack((x[..., 0] + v * ct * params.dt, x[..., 1] + v * st * params.dt,
                             theta + w * params.dt), dim=-1)
        new_state = dataclasses.replace(state, x=new_x, time=state.time + 1)
        reward = self._instant_cost(new_x, params)
        done = new_state.time >= params.max_steps
        return new_state, self._obs(new_state, params), reward, done, {}

    def _instant_cost(self, x: torch.Tensor, params: ShepherdingParams):
        """``[B]`` fraction of sheep in the goal disk (:180-185)."""
        sheep = x[:, params.n_shepherds:, 0:2]
        if params.parity_exact:
            sx, sy = sheep[..., 0], sheep[..., 1]
            inside = _libm(torch.sqrt, sx * sx + sy * sy) < params.goal_region_radius
            return _div(inside.sum(dim=-1).to(x.dtype), params.n_sheep)
        inside = torch.linalg.vector_norm(sheep, dim=-1) < params.goal_region_radius
        return inside.sum(dim=-1).to(x.dtype) / params.n_sheep

    # ----------------------------------------------------------- controller

    def los_branches(self, state: ShepherdingState, params: ShepherdingParams):
        """``[B, S]`` int64 branch of each shepherd's expert action: 0 a sheep
        in line of sight (+-2 deg), 1 another shepherd (+-2 deg, with the
        reference's skip quirk), 2 the goal (+-5 deg), 3 none."""
        s = params.n_shepherds
        x = state.x
        sx = x[:, :s]
        theta = sx[..., 2]
        exact = params.parity_exact
        atan2 = functools.partial(_libm, torch.atan2) if exact else torch.atan2

        def in_los(targets, tol):
            # [B, S, M] test of |wrap(bearing - heading)| < tol
            dx = targets[:, None, :, 0] - sx[:, :, None, 0]
            dy = targets[:, None, :, 1] - sx[:, :, None, 1]
            return _wrap(atan2(dy, dx) - theta[..., None], exact).abs() < tol

        deg2 = math.radians(2.0)
        sheep_los = in_los(x[:, s:], deg2).any(dim=-1)
        all_nz = (sx != 0.0).all(dim=-1)  # [B, S]
        pair_skip = all_nz[:, :, None] == all_nz[:, None, :]
        shep_los = (in_los(sx, deg2) & ~pair_skip).any(dim=-1)
        goal = torch.zeros((x.shape[0], 1, 2), dtype=x.dtype, device=x.device)
        goal_los = in_los(goal, math.radians(5.0))[..., 0]
        return torch.where(sheep_los, 0, torch.where(shep_los, 1, torch.where(goal_los, 2, 3)))

    def controller(self, state: ShepherdingState, params: ShepherdingParams, generator=None):
        """``[B, S, 2]`` line-of-sight bang-bang expert (:204-233), priority
        sheep > shepherd > goal > none (:meth:`los_branches`); deterministic,
        so ``generator`` is not used."""
        theta = state.x[:, :params.n_shepherds, 2]
        vlr = _vlr_table(state.x)[self.los_branches(state, params)]  # [B, S, 2]
        L, d = params.wheel_base, params.d_offset
        v = (vlr[..., 1] + vlr[..., 0]) / 2.0
        if params.parity_exact:
            w = _div(vlr[..., 1] - vlr[..., 0], L)
            ct, st = _libm(torch.cos, theta), _libm(torch.sin, theta)
        else:
            w = (vlr[..., 1] - vlr[..., 0]) / L
            ct, st = torch.cos(theta), torch.sin(theta)
        vx = v * ct - w * d * st
        vy = v * st + w * d * ct
        return torch.stack((vx, vy), dim=-1)

    # ---------------------------------------------------------------- spaces

    def observation_space(self, params: ShepherdingParams):
        # (px, py, theta, shepherd identity): the reference declares nx=3 but
        # hstacks the identity column; this describes the actual obs
        return Box(-math.inf, math.inf, (params.n_agents, 4))

    def action_space(self, params: ShepherdingParams):
        return Box(-params.v_max, params.v_max, (params.n_shepherds, 2))


def shepherding_factory(**kwargs):
    env = ShepherdingEnv()
    return env, dataclasses.replace(env.default_params(), **kwargs)
