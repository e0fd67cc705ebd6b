"""Formation flying in PyTorch, batched (counterpart of
``gym_flock_tpu/envs/formation.py``; reference formation_flying.py:18-213).

Three single-integrator agents start at fixed points on the x-axis and must
reach a fixed goal triangle; the reward is minus the summed squared distance
to the goals (:81-90).  ``x`` is ``[B, n, 4]`` rows of (px, py, goal_x,
goal_y).  The connectivity is the degree-1 nearest-neighbour graph of the
GOAL coordinates (:160-177), the lower index first among equal distances, as
``jax.lax.top_k``.  The reference has no expert; a proportional go-to-goal
controller is the JAX package's extension.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from gym_flock_tpu_torch.core.env import Env, EnvState
from gym_flock_tpu_torch.core.spaces import Box

__all__ = ["FormationParams", "FormationState", "FormationFlyingEnv", "formation_factory"]

# the fixed start points and goal triangle, one row an agent: (px, py, gx, gy)
_START_AND_GOAL = ((0.0, 0.0, 0.0, 2.0), (-2.0, 0.0, -2.0, 2.0), (2.0, 0.0, 2.0, 2.0))


@dataclasses.dataclass(frozen=True)
class FormationParams:
    """Values from formation_flying.cfg and formation_flying.py:27-55."""

    n_agents: int = 3
    max_steps: int = 500
    degree: int = 1  # kNN degree (:30)
    mean_pooling: bool = False
    dynamic: bool = True
    comm_radius: float = 2.0
    dt: float = 0.01  # cfg system_dt (the step uses the 0.1 gain below, :75-77)
    v_max: float = 2.0
    r_max: float = 6.0
    max_accel: float = 1.0
    step_gain: float = 0.1  # the literal 0.1 of the reference step (:75-77)


@dataclasses.dataclass(frozen=True)
class FormationState(EnvState):
    x: torch.Tensor  # [B, n, 4]: (px, py, goal_x, goal_y)


class FormationFlyingEnv(Env[FormationParams, FormationState]):
    def default_params(self) -> FormationParams:
        return FormationParams()

    def connectivity(self, state: FormationState, params: FormationParams) -> torch.Tensor:
        """``[B, n, n]`` degree-k nearest-neighbour graph on the goal
        coordinates (reference ``get_connectivity``, :160-177)."""
        g = state.x[..., 2:4]
        d = g[:, :, None, :] - g[:, None, :, :]
        r2 = (d * d).sum(dim=-1)
        n = params.n_agents
        r2 = torch.where(torch.eye(n, dtype=torch.bool, device=r2.device), torch.inf, r2)
        idx = torch.sort(r2, dim=-1, stable=True).indices[..., :params.degree]
        a = torch.zeros_like(r2).scatter_(-1, idx, 1.0)
        if params.mean_pooling:
            deg = a.sum(dim=-1, keepdim=True)
            a = a / torch.where(deg == 0, 1.0, deg)
        return a

    def reset_env(self, generator: torch.Generator, params: FormationParams, n_envs: int):
        """The fixed start for every env; ``generator`` only sets the device."""
        x = torch.tensor(_START_AND_GOAL, device=generator.device).expand(n_envs, 3, 4)
        state = self.init_state(x.clone(), params)
        return state, state.x

    def init_state(self, x: torch.Tensor, params: FormationParams) -> FormationState:
        """A state from a ``[B, n, 4]`` tensor."""
        if x.dim() != 3 or x.shape[-1] != 4:
            raise ValueError(f"x must be [B, n, 4], got {tuple(x.shape)}")
        return FormationState(
            time=torch.zeros(x.shape[0], dtype=torch.int32, device=x.device), x=x)

    def step_env(self, generator, state: FormationState, action, params: FormationParams):
        """``action`` is the flat ``[B, 2n]`` (or ``[B, n, 2]``) velocity;
        deterministic, so ``generator`` is not used.  The observation is the
        state (reference ``_get_obs``, :141-150)."""
        x = state.x
        u = action.reshape(x.shape[0], -1, 2)
        x = torch.cat((x[..., 0:2] + u * params.step_gain, x[..., 2:4]), dim=-1)
        new_state = dataclasses.replace(state, x=x, time=state.time + 1)
        reward = -((x[..., 0] - x[..., 2]) ** 2 + (x[..., 1] - x[..., 3]) ** 2).sum(dim=-1)
        done = new_state.time >= params.max_steps
        return new_state, x, reward, done, {}

    def controller(self, state: FormationState, params: FormationParams, generator=None):
        """``[B, n, 2]`` proportional go-to-goal expert (the JAX package's
        extension); deterministic, so ``generator`` is not used."""
        err = state.x[..., 2:4] - state.x[..., 0:2]
        return err.clamp(-params.max_accel, params.max_accel)

    def observation_space(self, params: FormationParams):
        return Box(-math.inf, math.inf, (params.n_agents, 4))

    def action_space(self, params: FormationParams):
        return Box(-params.max_accel, params.max_accel, (2 * params.n_agents,))


def formation_factory(**kwargs):
    env = FormationFlyingEnv()
    return env, dataclasses.replace(env.default_params(), **kwargs)
