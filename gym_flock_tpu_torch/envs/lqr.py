"""Networked LQR in PyTorch, batched (counterpart of
``gym_flock_tpu/envs/lqr.py``; reference linear/lqr.py:12-108).

Node locations uniform in a box, the system matrix an RBF kernel of the
locations, exact discretization by the matrix exponential
(``torch.linalg.matrix_exp``), a degree-k nearest-neighbour communication
graph scaled to spectral radius 1, quadratic cost x'Qx + u'Ru.  One system
is shared by the batch of envs; it lives on the factory's device, and the
infinite-horizon gain of the expert is computed there once.

The system is built from node locations drawn by a torch generator seeded
``seed`` (on the host, so it is the same system on every device): it is not
the JAX package's ``key(0)`` system.  :func:`lqr_system_from_locations`
takes the locations, so a caller can build the system of any locations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gym_flock_tpu_torch.core.env import Env, EnvState
from gym_flock_tpu_torch.core.spaces import Box

__all__ = [
    "LQRSystem", "LQRParams", "LQRState", "LQREnv", "build_lqr_system",
    "lqr_system_from_locations", "lqr_factory",
]

RICCATI_SWEEPS = 50


@dataclasses.dataclass(frozen=True, eq=False)
class LQRSystem:
    a_net: torch.Tensor  # [n, n] communication graph (masked RBF kernel)
    a_sys: torch.Tensor  # [n, n] discretized dynamics e^{dt A}
    b_sys: torch.Tensor  # [n, n]
    q_sys: torch.Tensor  # [n, n]
    r_sys: torch.Tensor  # [n, n]
    std_dev: torch.Tensor  # scalar process-noise std
    k_gain: torch.Tensor  # [n, n] infinite-horizon LQR gain


@dataclasses.dataclass(frozen=True)
class LQRParams:
    """Values from params_lqr.cfg (network_size=100, alpha=10, dt=0.01,
    variance=0.01, xmax=1, b_scale=10, degree=8)."""

    n_nodes: int = 100
    degree: int = 8
    max_steps: int = 1000
    dt: float = 0.01
    alpha: float = 10.0
    var: float = 0.01
    x_max: float = 1.0
    b_scale: float = 10.0
    max_u: float = 40.0
    max_z: float = 200.0
    system: Optional[LQRSystem] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class LQRState(EnvState):
    x: torch.Tensor  # [B, n, 1]


def build_lqr_system(params: LQRParams, seed: int = 0, device="cuda") -> LQRSystem:
    """The f32 system of ``alpha * U[0, 1)^2`` node locations drawn on the
    host by a torch generator seeded ``seed``, built on ``device`` (reference
    lqr.py:32-61)."""
    gen = torch.Generator().manual_seed(seed)
    loc = params.alpha * torch.rand((params.n_nodes, 2), generator=gen)
    return lqr_system_from_locations(loc.to(device), params)


def lqr_system_from_locations(node_loc: torch.Tensor, params: LQRParams) -> LQRSystem:
    """The networked linear system of ``node_loc [n, 2]``, on its device and
    in its dtype (reference lqr.py:32-61; the JAX package's
    ``build_lqr_system`` after its draw)."""
    n = node_loc.shape[0]
    dev, dtype = node_loc.device, node_loc.dtype
    eye_b = torch.eye(n, dtype=torch.bool, device=dev)
    # RBF kernel with sklearn's default gamma = 1/n_features = 1/2
    d2 = ((node_loc[:, None, :] - node_loc[None, :, :]) ** 2).sum(dim=-1)
    a_sys = torch.where(eye_b, 0.0, torch.exp(-0.5 * d2))
    # degree-k nearest neighbours, the lower index first among equal distances
    idx = torch.sort(torch.where(eye_b, torch.inf, d2), dim=-1, stable=True).indices
    knn = torch.zeros_like(a_sys).scatter_(-1, idx[:, :params.degree], 1.0)
    a_net = a_sys * knn
    # the spectral radius of a nonsymmetric matrix: set-up math, on the host
    a_net = a_net / torch.linalg.eigvals(a_net.cpu()).abs().max().to(dtype=dtype, device=dev)

    eye = torch.eye(n, dtype=dtype, device=dev)
    a_expm = torch.linalg.matrix_exp(params.dt * a_sys)
    b_sys = torch.linalg.inv(a_sys) @ (a_expm - eye) @ (params.b_scale * eye)
    q_sys = torch.linalg.inv(2.0 * a_sys) @ (torch.linalg.matrix_exp(params.dt * 2.0 * a_sys)
                                             - eye)
    q_sys = (q_sys + q_sys.T) / 2.0
    r_sys = params.dt * eye * (params.b_scale ** 2)
    std_dev = torch.sqrt(q_sys[0, 0] * params.var)
    return LQRSystem(a_net=a_net, a_sys=a_expm, b_sys=b_sys, q_sys=q_sys, r_sys=r_sys,
                     std_dev=std_dev, k_gain=riccati_gain(a_expm, b_sys, q_sys, r_sys))


def riccati_gain(a, b, q, r) -> torch.Tensor:
    """Infinite-horizon discrete LQR gain by ``RICCATI_SWEEPS`` fixed-point
    sweeps of the Riccati recursion from P = Q (the JAX package's
    ``_riccati_gain``)."""
    p = q
    for _ in range(RICCATI_SWEEPS):
        k = torch.linalg.solve(r + b.T @ p @ b, b.T @ p @ a)
        p = q + a.T @ p @ (a - b @ k)
    return torch.linalg.solve(r + b.T @ p @ b, b.T @ p @ a)


class LQREnv(Env[LQRParams, LQRState]):
    def default_params(self, device="cuda") -> LQRParams:
        """Defaults with the system of :func:`build_lqr_system` on ``device``
        (default the card; pass ``"cpu"`` for the host; without a card it
        raises)."""
        params = LQRParams()
        return dataclasses.replace(params, system=build_lqr_system(params, device=device))

    def _obs(self, x: torch.Tensor, params: LQRParams):
        """``(x [B, n, 1], a_net [B, n, n])``, the network an expanded view."""
        a_net = params.system.a_net
        return x, a_net.expand((x.shape[0],) + a_net.shape)

    def reset_env(self, generator: torch.Generator, params: LQRParams, n_envs: int):
        u = torch.rand((n_envs, params.n_nodes, 1), generator=generator,
                       device=generator.device)
        state = self.init_state(-params.x_max + 2.0 * params.x_max * u, params)
        return state, self._obs(state.x, params)

    def init_state(self, x: torch.Tensor, params: LQRParams) -> LQRState:
        """A state from a ``[B, n, 1]`` tensor."""
        if x.dim() != 3 or x.shape[1:] != (params.n_nodes, 1):
            raise ValueError(f"x must be [B, {params.n_nodes}, 1], got {tuple(x.shape)}")
        return LQRState(time=torch.zeros(x.shape[0], dtype=torch.int32, device=x.device), x=x)

    def step_env(self, generator: torch.Generator, state: LQRState, action, params: LQRParams):
        """x' = A x + B u + noise, one ``randn`` of ``[B, n, 1]`` from
        ``generator``; reward ``-(x'Qx + u'Ru)`` at the pre-step x."""
        sys = params.system
        xt = state.x
        ut = action.reshape(xt.shape)
        noise = sys.std_dev * torch.randn(xt.shape, generator=generator,
                                          device=generator.device, dtype=xt.dtype)
        xt1 = sys.a_sys @ xt + sys.b_sys @ ut + noise
        cost = (xt.mT @ sys.q_sys @ xt + ut.mT @ sys.r_sys @ ut)[:, 0, 0]
        new_state = dataclasses.replace(state, x=xt1, time=state.time + 1)
        done = new_state.time >= params.max_steps
        return new_state, self._obs(xt1, params), -cost, done, {}

    def controller(self, state: LQRState, params: LQRParams, generator=None):
        """``[B, n, 1]`` infinite-horizon LQR expert ``-K x`` (the JAX
        package's extension: the reference controller is a no-op, lqr.py:106-107)."""
        return -(params.system.k_gain @ state.x)

    def observation_space(self, params: LQRParams):
        return Box(-params.max_z, params.max_z, (params.n_nodes, 1))

    def action_space(self, params: LQRParams):
        return Box(-params.max_u, params.max_u, (params.n_nodes, 1))


def lqr_factory(device="cuda", seed: int = 0, **kwargs):
    """``(LQREnv(), params)``; without ``system=`` the system of
    :func:`build_lqr_system` with ``seed`` on ``device`` (default the card;
    without one it raises)."""
    params = LQRParams(**kwargs)
    if params.system is None:
        params = dataclasses.replace(params, system=build_lqr_system(params, seed, device))
    return LQREnv(), params
