"""Flocking environments in PyTorch, batched (counterpart of
``gym_flock_tpu/envs/flocking.py``).

``FlockingRelativeEnv`` (``FlockingRelative-v0``) and its variants
``FlockingAbsoluteEnv`` (``Flocking-v0``), ``FlockingLeaderEnv``,
``FlockingObstacleEnv``, ``FlockingStochasticEnv`` and
``FlockingTwoFlocksEnv``; ``LargeFlockingEnv`` (``FlockingLarge-v0``) and
``SparseFlockingEnv`` (``FlockingSparse-v0``).  Every tensor leads with the
batch of swarms: ``x`` is ``[B, N, 4]`` rows of (px, py, vx, vy).

At small N the fused observation/expert pass of the rollout is K6
(``ops.dense_flocking``), one kernel launch a step on the card, where the
JAX package runs dense XLA ops; its plain version (dense PyTorch over
``[B, N, N]`` pair tensors) runs on the host, in float64 and under an
obstacle mask.  ``LargeFlockingEnv`` computes every pairwise reduction through K1
(``ops.flocking_sums``), and the rejection reset's acceptance test runs on
K1's "full" channels (min r^2 and degree) for every env that draws its
reset.  ``SparseFlockingEnv`` runs them on the cell-list pipeline and K3
(``ops.sparse_flocking``), with a Verlet table carried across the steps of
its fused rollout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from gym_flock_tpu_torch.core.env import Env, EnvState, _rejection_reset
from gym_flock_tpu_torch.core.spaces import Box
from gym_flock_tpu_torch.ops import sparse_flocking as sf
from gym_flock_tpu_torch.ops.dense_flocking import (
    dense_pass,
    expert_sums,
    feature_sums,
    pairwise_channels,
    turner_potential_grad,
)
from gym_flock_tpu_torch.ops import flocking_sums as k1
from gym_flock_tpu_torch.ops.flocking_sums import (
    flocking_features_large,
    flocking_sums,
    flocking_sums_block,
)
from gym_flock_tpu_torch.ops.pairwise import mean_pool_normalize, radius_adjacency
from gym_flock_tpu_torch.utils import formations
from gym_flock_tpu_torch.utils.profiling import span

__all__ = [
    "FlockingParams",
    "FlockingState",
    "FlockingRelativeEnv",
    "FlockingAbsoluteEnv",
    "FlockingLeaderEnv",
    "FlockingObstacleEnv",
    "FlockingStochasticEnv",
    "FlockingTwoFlocksEnv",
    "LargeFlockingEnv",
    "SparseFlockingEnv",
    "flocking_features",
    "flocking_features_exact",
    "turner_controller_exact",
    "flocking_obs_expert_pass",
    "turner_controller",
    "turner_potential_grad",
]


# =============================================================================
# Params / State
# =============================================================================


@dataclasses.dataclass(frozen=True)
class FlockingParams:
    """Parameters of the flocking family; defaults mirror reference
    flocking_relative.py:27-64."""

    n_agents: int = 100
    max_steps: int = 1000
    mean_pooling: bool = True
    centralized: bool = True
    # rejection-sampling reset: bounded trip count (the reference loops
    # unboundedly, flocking_relative.py:164)
    max_reset_tries: int = 64
    # reference params_from_cfg scales r_max by sqrt(n) (flocking_relative.py:75)
    auto_scale_r_max: bool = True
    # variant sizes: frozen leaders, obstacle agents, absolute-obs k
    n_leaders: int = 2
    n_obstacles: int = 4
    n_neighbors: int = 7
    # SparseFlockingEnv rollouts: Verlet slack distance (the Hilbert sort and
    # candidate table are rebuilt only when an agent moved > skin/2 since the
    # last build).  None resolves to comm_radius; <= 0 rebuilds every step.
    verlet_skin: float | None = None
    # bit-exact parity mode: the observation, the expert and the reward
    # follow the reference's NumPy op order (flocking_features_exact); a
    # correctness mode at float64, not the fast path
    parity_exact: bool = False
    comm_radius: float = 0.9
    dt: float = 0.01
    v_max: float = 5.0
    r_max: float = 1.0
    action_scalar: float = 10.0
    max_accel: float = 1.0
    min_dist_thresh: float = 0.1
    # stochastic-dt variant (reference flocking_stoch.py:9-12)
    dt_mean: float = 0.12
    dt_sigma: float = 0.018
    stoch_scale: float = 6.0
    stoch_max_accel: float = 0.5

    @property
    def comm_radius2(self) -> float:
        return self.comm_radius * self.comm_radius

    @property
    def v_bias(self) -> float:
        return self.v_max

    @property
    def r_max_eff(self) -> float:
        if self.auto_scale_r_max:
            return self.r_max * math.sqrt(self.n_agents)
        return self.r_max


@dataclasses.dataclass(frozen=True)
class FlockingState(EnvState):
    """x: [B, N, 4]; mean_vel [B, 2] and init_vel [B, N, 2] cached as in the
    reference."""

    x: torch.Tensor
    mean_vel: torch.Tensor
    init_vel: torch.Tensor


def _state_from_x(x: torch.Tensor) -> FlockingState:
    return FlockingState(
        time=torch.zeros(x.shape[0], dtype=torch.int32, device=x.device),
        x=x,
        mean_vel=x[..., 2:4].mean(dim=-2),
        init_vel=x[..., 2:4],
    )


# =============================================================================
# Dense pairwise functions
# =============================================================================


def flocking_features(x: torch.Tensor, comm_radius2,
                      obstacle_mask: torch.Tensor | None = None):
    """The ``compute_helpers`` pass (reference flocking_relative.py:111-134).

    Returns ``(state_values [B,N,6], adj [B,N,N], adj_mean [B,N,N],
    r2 [B,N,N])``; ``obstacle_mask`` as in ``ops.dense_flocking.pairwise_channels``.
    """
    dx, dy, dvx, dvy, r2 = pairwise_channels(x, obstacle_mask)
    adj = radius_adjacency(r2, comm_radius2)
    adj_mean = mean_pool_normalize(adj)
    return feature_sums(dx, dy, dvx, dvy, r2, adj), adj, adj_mean, r2


def turner_controller(
    x: torch.Tensor, params: FlockingParams, centralized: bool | None = None,
    obstacle_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Turner-2003 potential-field expert (reference flocking_relative.py:194-212):
    ``-(sum_j grad + sum_j dv)``, clipped to [-10, 10], over ``action_scalar``.
    Decentralized mode masks both terms by the adjacency."""
    if centralized is None:
        centralized = params.centralized
    dx, dy, dvx, dvy, r2 = pairwise_channels(x, obstacle_mask)
    gx = turner_potential_grad(dx, r2, params.comm_radius)
    gy = turner_potential_grad(dy, r2, params.comm_radius)
    if not centralized:
        adj = radius_adjacency(r2, params.comm_radius2)
        dvx, dvy, gx, gy = dvx * adj, dvy * adj, gx * adj, gy * adj
    return k1.turner_action(gx.sum(dim=-1), gy.sum(dim=-1), dvx.sum(dim=-1), dvy.sum(dim=-1),
                            params.action_scalar)


def flocking_obs_expert_pass(
    x: torch.Tensor, params: FlockingParams, centralized: bool = True,
    obstacle_mask: torch.Tensor | None = None, out=None,
):
    """One pairwise pass giving everything the observation AND the Turner
    expert need at state ``x``: ``ops.dense_flocking.dense_pass`` with the
    params' radii and pooling (K6 on the card, where the input allows).

    Returns ``(values [B,N,6], network [B,N,N], s_gx, s_gy, s_dvx, s_dvy)``,
    the last four ``[B,N]``: the expert's summed potential gradients and
    velocity differences (adjacency-masked when ``centralized=False``).
    ``out`` as in ``dense_pass``: views to write ``values`` and ``network``
    into, an entry ``None`` leaving that output out.
    """
    return dense_pass(x, params.comm_radius, params.comm_radius2, centralized,
                      params.mean_pooling, obstacle_mask, out)


def _instant_cost(x: torch.Tensor) -> torch.Tensor:
    """``[B]`` minus the summed velocity variances (reference
    flocking_relative.py:145-147); ``correction=0`` is NumPy's ddof=0."""
    v = x[..., 2:4]
    return -1.0 * torch.var(v, dim=-2, correction=0).sum(dim=-1)


def _integrate(x: torch.Tensor, u: torch.Tensor, dt,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Euler double-integrator update (reference flocking_relative.py:98-105).

    ``dt`` is a float or a ``[B]`` tensor (one dt per swarm).  ``mask``
    (float ``[N]``, 0 = frozen agent) makes the masked agents ignore their
    control input (flocking_leader.py:27-31, flocking_obstacle.py:41-47).
    """
    if isinstance(dt, torch.Tensor) and dt.dim() == 1:
        dt = dt[:, None]
    ux, uy = u[..., 0], u[..., 1]
    if mask is not None:
        ux, uy = ux * mask, uy * mask
    px = x[..., 0] + x[..., 2] * dt + ux * dt * dt * 0.5
    py = x[..., 1] + x[..., 3] * dt + uy * dt * dt * 0.5
    vx = x[..., 2] + ux * dt
    vy = x[..., 3] + uy * dt
    return torch.stack((px, py, vx, vy), dim=-1)


# =============================================================================
# Bit-exact parity mode (the reference's op order)
# =============================================================================
#
# The functions above may reorder float arithmetic (shared reciprocals, the
# reductions' own order).  These mirror the reference's NumPy sequence
# (flocking_relative.py:91-226) operation for operation, so that at float64
# a trajectory equals the reference's and the JAX package's parity mode bit
# for bit.  Eager PyTorch rounds every operation, so no a*b+c is contracted
# into an FMA (the JAX package's ``_rnd`` barriers have no counterpart);
# what must be written out are the reduction orders and the divisions:
#   * np.sum over a non-inner axis adds one slice at a time, in order
#     (:func:`_seq_sum_cols`, :func:`_seq_sum_rows`); over the contiguous
#     inner axis it sums pairwise, 8-way unrolled (:func:`_np_pairwise_sum`);
#   * CUDA divides by a host scalar through its rounded reciprocal, so the
#     divisor goes to the device as a tensor (:func:`_div`);
#   * the CPU's vectorised sqrt/cos/sin/atan2 are not the C library's (they
#     differ by an ulp on some inputs), so on the host these come from NumPy,
#     whose ufuncs are the reference's own (:func:`_libm`).  On the card
#     they are CUDA's: shepherding and mapping report their ulp gap there.
# A sequential sum is one launch per term: a correctness mode, not the fast
# path.


def _seq_sum_cols(a: torch.Tensor) -> torch.Tensor:
    """``[..., N, M] -> [..., N]``: the sum over the last axis, adding one
    column at a time from zero (np.add.reduce's order on a non-inner axis)."""
    acc = torch.zeros_like(a[..., 0])
    for j in range(a.shape[-1]):
        acc = acc + a[..., j]
    return acc


def _seq_sum_rows(a: torch.Tensor) -> torch.Tensor:
    """``[..., N, C] -> [..., C]``: the sum over axis -2, one row at a time."""
    acc = torch.zeros_like(a[..., 0, :])
    for i in range(a.shape[-2]):
        acc = acc + a[..., i, :]
    return acc


def _np_pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """``[..., n] -> [...]`` in NumPy's order for a contiguous inner-axis sum:
    below 8 terms in sequence, up to 128 in eight interleaved partial sums
    combined as a tree, above that the two halves (split at a multiple of 8)
    recursively (numpy's ``pairwise_sum``)."""
    n = v.shape[-1]
    if n < 8:
        s = v[..., 0]
        for i in range(1, n):
            s = s + v[..., i]
        return s
    if n <= 128:
        r = [v[..., i] for i in range(8)]
        i = 8
        while i + 8 <= n:
            for j in range(8):
                r[j] = r[j] + v[..., i + j]
            i += 8
        s = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        while i < n:
            s = s + v[..., i]
            i += 1
        return s
    ns = n // 2
    ns -= ns % 8
    return _np_pairwise_sum(v[..., :ns]) + _np_pairwise_sum(v[..., ns:])


def _div(a: torch.Tensor, n) -> torch.Tensor:
    """``a / n`` as a true division on every device (module note above)."""
    return a / torch.tensor(n, dtype=a.dtype, device=a.device)


_NUMPY_UFUNCS = {torch.sqrt: "sqrt", torch.cos: "cos", torch.sin: "sin", torch.atan2: "arctan2"}


def _libm(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)`` (``torch.sqrt``, ``cos``, ``sin`` or ``atan2``): NumPy's
    ufunc on the host, the device's own on the card (module note above)."""
    if args[0].device.type != "cpu":
        return fn(*args)
    import numpy as np

    out = getattr(np, _NUMPY_UFUNCS[fn])(*(a.detach().numpy() for a in args))
    return torch.from_numpy(np.asarray(out))


def flocking_features_exact(x: torch.Tensor, comm_radius2,
                            obstacle_mask: torch.Tensor | None = None):
    """:func:`flocking_features` in the reference's op order
    (flocking_relative.py:111-134): direct divisions (``dx / (r2*r2)``), the
    mean-pooled adjacency by element-wise division, sequential neighbour
    sums."""
    dx, dy, dvx, dvy, r2 = pairwise_channels(x, obstacle_mask)
    adj = (r2 < comm_radius2).to(x.dtype)
    deg = adj.sum(dim=-1)  # sums of 0/1: exact in any order
    deg = torch.where(deg == 0.0, 1.0, deg)
    adj_mean = adj / deg[..., None]
    r4 = r2 * r2
    chans = torch.stack((dvx, dx / r4, dx / r2, dvy, dy / r4, dy / r2), dim=-3)
    values = _seq_sum_cols(chans * adj[..., None, :, :]).movedim(-2, -1)
    return values, adj, adj_mean, r2


def turner_controller_exact(x: torch.Tensor, params: FlockingParams,
                            centralized: bool | None = None,
                            obstacle_mask: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`turner_controller` in the reference's op order
    (flocking_relative.py:194-226): the potential gradient as two divisions,
    sequential sums of the stacked terms."""
    if centralized is None:
        centralized = params.centralized
    dx, dy, dvx, dvy, r2 = pairwise_channels(x, obstacle_mask)
    r4 = r2 * r2
    gx = torch.where(r2 > params.comm_radius, 0.0, -2.0 * (dx / r4) + 2.0 * (dx / r2))
    gy = torch.where(r2 > params.comm_radius, 0.0, -2.0 * (dy / r4) + 2.0 * (dy / r2))
    chans = torch.stack((dvx, dvy, gx, gy), dim=-3)
    if not centralized:
        chans = chans * (r2 < params.comm_radius2).to(x.dtype)[..., None, :, :]
    s_dvx, s_dvy, s_gx, s_gy = _seq_sum_cols(chans).unbind(dim=-2)
    controls = torch.stack((-s_gx - s_dvx, -s_dvy - s_gy), dim=-1)
    return _div(controls.clamp(-10.0, 10.0), params.action_scalar)


def _instant_cost_exact(x: torch.Tensor) -> torch.Tensor:
    """:func:`_instant_cost` in np.var's order (flocking_relative.py:145-147):
    a sequential mean over the agents, the squared residuals, a sequential
    mean of those."""
    v = x[..., 2:4]
    n = v.shape[-2]
    m = _div(_seq_sum_rows(v), n)
    d = v - m[..., None, :]
    var = _div(_seq_sum_rows(d * d), n)
    return -1.0 * (var[..., 0] + var[..., 1])


# =============================================================================
# Envs
# =============================================================================


class FlockingRelativeEnv(Env[FlockingParams, FlockingState]):
    """2D double-integrator swarms with relative-feature observations.

    Observation: ``(state_values [B,N,6], state_network [B,N,N])``.  Reward:
    minus the summed velocity variances, ``[B]``.  ``done`` is the time
    limit ``params.max_steps``.  ``last_reset_tries`` holds the number of
    batch draws the latest :meth:`reset_env` took.
    """

    last_reset_tries: int = 0

    def default_params(self) -> FlockingParams:
        return FlockingParams()

    # ------------------------------------------------------------ helpers

    def _obs(self, state: FlockingState, params: FlockingParams):
        features = flocking_features_exact if params.parity_exact else flocking_features
        values, adj, adj_mean, _ = features(
            state.x, params.comm_radius2, self._obstacle_mask(params, state.x)
        )
        return values, (adj_mean if params.mean_pooling else adj)

    def _obstacle_mask(self, params: FlockingParams, x: torch.Tensor):
        """Bool ``[N]`` on x's device (True = obstacle agent), or ``None``."""
        return None

    def _integration_mask(self, params: FlockingParams, x: torch.Tensor):
        """``[N]`` in x's dtype (0 = agent ignores its control), or ``None``."""
        return None

    def _action_scale(self, params: FlockingParams):
        return params.action_scalar

    def _draw(self, generator: torch.Generator, params: FlockingParams, n_envs: int):
        """One reset proposal for the whole batch: positions uniform over the
        disk of radius sqrt(r_max_eff), velocities uniform in
        [-v_max, v_max] plus a per-swarm bias (flocking_relative.py:167-174)."""
        n, dev = params.n_agents, generator.device

        def uniform(shape, low, high):
            u = torch.rand(shape, generator=generator, device=dev)
            return low + (high - low) * u

        length = torch.sqrt(uniform((n_envs, n), 0.0, params.r_max_eff))
        angle = math.pi * uniform((n_envs, n), 0.0, 2.0)
        bias = uniform((n_envs, 2), -params.v_bias, params.v_bias)
        vx = uniform((n_envs, n), -params.v_max, params.v_max)
        vy = uniform((n_envs, n), -params.v_max, params.v_max)
        return torch.stack(
            (
                length * torch.cos(angle),
                length * torch.sin(angle),
                vx + bias[:, 0:1],
                vy + bias[:, 1:2],
            ),
            dim=-1,
        )

    def _reset_accept(self, x: torch.Tensor, params: FlockingParams) -> torch.Tensor:
        """``[B]`` acceptance of the rejection-sampling reset (reference
        flocking_relative.py:164): min degree >= 2 and min pairwise distance
        > ``min_dist_thresh``, from K1's channels 8 and 9."""
        s = flocking_sums_block(
            x, x, 0, 0, params.comm_radius, params.comm_radius2, channels="full"
        )
        return k1.reset_accepts(*k1.reset_minima(s), params.min_dist_thresh)

    # ------------------------------------------------------------ protocol

    def reset_env(self, generator: torch.Generator, params: FlockingParams, n_envs: int):
        """Rejection-sampling reset (reference flocking_relative.py:156-192).

        Each try redraws the whole batch (``core.env._rejection_reset``):
        an env keeps its first accepted draw, or its last after
        ``params.max_reset_tries`` draws.
        """
        with span("gft.reset"):
            x, self.last_reset_tries = _rejection_reset(
                lambda: self._draw(generator, params, n_envs),
                lambda x: self._reset_accept(x, params), params.max_reset_tries)
            state = _state_from_x(x)
            return state, self._obs(state, params)

    def init_state(self, x: torch.Tensor, params: FlockingParams) -> FlockingState:
        """A state from an externally supplied ``[B, N, 4]`` tensor."""
        if x.dim() != 3 or x.shape[1:] != (params.n_agents, 4):
            raise ValueError(
                f"x must be [B, {params.n_agents}, 4], got {tuple(x.shape)}"
            )
        return _state_from_x(x)

    def step_env(self, generator, state: FlockingState, action, params: FlockingParams):
        """Deterministic dynamics: ``generator`` is not used."""
        x = _integrate(state.x, action * self._action_scale(params), params.dt,
                       self._integration_mask(params, state.x))
        new_state = dataclasses.replace(state, x=x, time=state.time + 1)
        obs = self._obs(new_state, params)
        reward = (_instant_cost_exact if params.parity_exact else _instant_cost)(x)
        done = new_state.time >= params.max_steps
        return new_state, obs, reward, done, {}

    def controller(self, state: FlockingState, params: FlockingParams, generator=None,
                   centralized=None):
        """The Turner expert; deterministic, so ``generator`` is not used."""
        ctrl = turner_controller_exact if params.parity_exact else turner_controller
        return ctrl(state.x, params, centralized, self._obstacle_mask(params, state.x))

    # ---------------------------------------------------- fused expert rollout

    def _fused_pass(self, x: torch.Tensor, params: FlockingParams, centralized: bool,
                    out=None):
        """``(values, network, s_gx, s_gy, s_dvx, s_dvy)`` at ``x``; ``out``
        as in :func:`flocking_obs_expert_pass`.  Variants whose pass writes
        into no view take ``out`` and return their own outputs."""
        return flocking_obs_expert_pass(x, params, centralized,
                                        self._obstacle_mask(params, x), out)

    def _fused_carry_init(self, x: torch.Tensor, params: FlockingParams):
        """State carried across the steps of the fused rollout: ``None`` for
        the dense envs; the sparse env's Verlet table."""
        return None

    def _fused_pass_carry(self, x, params: FlockingParams, centralized: bool, carry,
                          out=None):
        """``(fused pass at x, carry')``; envs with cross-step kernel state
        override this pair of hooks, not the rollout loop."""
        return self._fused_pass(x, params, centralized, out), carry

    def expert_rollout(
        self,
        state: FlockingState,
        params: FlockingParams,
        n_steps: int,
        centralized: bool | None = None,
        generator: torch.Generator | None = None,
    ):
        """Closed-loop Turner-expert rollout with ONE pairwise pass per step:
        the pass at x_{t+1} that gives step t's observation also gives the
        expert sums that drive step t+1's action.

        Returns ``(final_state, traj)``; ``traj`` maps ``u`` (the expert
        action taken at step t), ``values``, ``network`` and ``reward`` to
        ``[B, n_steps, ...]`` tensors.  ``generator`` is accepted for
        variants with stochastic dynamics; these envs do not use it.
        """
        if centralized is None:
            centralized = params.centralized
        x = state.x
        b, n = x.shape[:2]
        carry = self._fused_carry_init(x, params)
        with span("gft.pair_pass"):
            (values, network, *sums), carry = self._fused_pass_carry(
                x, params, centralized, carry, out=(None, None)
            )
        # the trajectory, allocated once: the dense pass writes each step's
        # values and network straight into their slots; a pass that writes
        # into no view returned its outputs, which give their shapes
        shapes = {"u": (n, 2), "values": (n, 6), "network": (n, n), "reward": ()}
        for k, v in (("values", values), ("network", network)):
            if v is not None:
                shapes[k] = tuple(v.shape[1:])
        traj: Dict[str, torch.Tensor] = {
            k: x.new_empty((b, n_steps) + shape) for k, shape in shapes.items()}
        # each step's views of the trajectory, made once a call
        slots = list(zip(traj["values"].unbind(1), traj["network"].unbind(1)))
        u_slots, reward_slots = traj["u"].unbind(1), traj["reward"].unbind(1)
        for t in range(n_steps):
            with span("gft.step"):
                u = self._expert_action(*sums, params)
                x = self._rollout_integrate(x, u, params, generator)
                with span("gft.pair_pass"):
                    (values, network, *sums), carry = self._fused_pass_carry(
                        x, params, centralized, carry, out=slots[t])
                u_slots[t].copy_(u)
                reward_slots[t].copy_(_instant_cost(x))
                for slot, v in zip(slots[t], (values, network)):
                    if v is not slot:
                        slot.copy_(v)
        final = dataclasses.replace(state, x=x, time=state.time + n_steps)
        return final, traj

    def _expert_action(self, s_gx, s_gy, s_dvx, s_dvy, params: FlockingParams):
        """The expert's action from its four sums: the hook variants override."""
        return k1.turner_action(s_gx, s_gy, s_dvx, s_dvy, params.action_scalar)

    def _rollout_integrate(self, x, u, params: FlockingParams, generator):
        """One dynamics step inside the fused rollout (variants override)."""
        return _integrate(x, u * self._action_scale(params), params.dt,
                          self._integration_mask(params, x))

    def potential(self, state: FlockingState, params: FlockingParams) -> torch.Tensor:
        """``[B]`` total Turner potential (reference flocking_relative.py:228-232):
        the sum of 1/r^2 + log(r^2) over ordered pairs, out-of-range pairs
        clamped to the value at the communication radius, the diagonal
        zeroed."""
        r2 = pairwise_channels(state.x)[4]
        cr2 = params.comm_radius2
        p = 1.0 / r2 + torch.log(r2)
        p = torch.where(r2 > cr2, 1.0 / cr2 + math.log(cr2), p)
        n = params.n_agents
        p = torch.where(torch.eye(n, dtype=torch.bool, device=r2.device), 0.0, p)
        return p.sum(dim=(-2, -1))

    def get_stats(self, state: FlockingState) -> Dict[str, torch.Tensor]:
        """vel_diffs / min_dists, each ``[B, N]`` (reference
        flocking_relative.py:136-143)."""
        v = state.x[..., 2:4]
        vel_diffs = torch.sqrt(((v - v.mean(dim=-2, keepdim=True)) ** 2).sum(dim=-1))
        r2 = pairwise_channels(state.x)[4]
        return {"vel_diffs": vel_diffs, "min_dists": torch.sqrt(r2).amin(dim=-2)}

    # ------------------------------------------------------------ spaces

    def observation_space(self, params: FlockingParams):
        return Box(-math.inf, math.inf, (params.n_agents, 6))

    def action_space(self, params: FlockingParams):
        return Box(-params.max_accel, params.max_accel, (params.n_agents, 2))


def _nearest(r2: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, N, k]`` int64 column indices of each row's k smallest ``r2``,
    ascending, the lower index first among equal distances (as
    ``jax.lax.top_k(-r2, k)``; ``torch.topk`` promises no tie order)."""
    return torch.sort(r2, dim=-1, stable=True).indices[..., :k]


def _neighbor_table(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[B, N, 4k]``: ``x_i - x_j`` for each row's neighbours ``idx [B, N,
    k]``, nearest first (reference flocking/flocking.py:20-25)."""
    b, n, k = idx.shape
    rows = torch.arange(b, device=x.device)[:, None, None]
    return (x[:, :, None, :] - x[rows, idx]).reshape(b, n, 4 * k)


class FlockingAbsoluteEnv(FlockingRelativeEnv):
    """``Flocking-v0``: the observation is the state difference to each of
    the ``n_neighbors`` (7) nearest agents by r^2, ``[B, N, 4k]`` (reference
    flocking/flocking.py:20-25); the network is the relative env's."""

    def _obs(self, state: FlockingState, params: FlockingParams):
        x = state.x
        _, adj, adj_mean, r2 = flocking_features(x, params.comm_radius2)
        obs = _neighbor_table(x, _nearest(r2, params.n_neighbors))
        return obs, (adj_mean if params.mean_pooling else adj)

    def observation_space(self, params: FlockingParams):
        return Box(-math.inf, math.inf, (params.n_agents, params.n_neighbors * 4))

    def _fused_pass(self, x, params, centralized, out=None):
        """The neighbour table shares the pass's r^2 with the expert sums, so
        the fused rollout's ``values`` are this env's observation.  Writes
        into no view: ``out`` is not read."""
        channels = pairwise_channels(x)
        r2 = channels[4]
        adj = radius_adjacency(r2, params.comm_radius2)
        network = mean_pool_normalize(adj) if params.mean_pooling else adj
        obs = _neighbor_table(x, _nearest(r2, params.n_neighbors))
        return (obs, network,
                *expert_sums(x, channels, adj, params.comm_radius, centralized, masked=False))


class FlockingLeaderEnv(FlockingRelativeEnv):
    """``FlockingLeader-v0``: the first ``n_leaders`` agents ignore their
    control input (reference flocking_leader.py:21-40).

    The reference's quirks are kept: actions are NOT scaled by
    ``action_scalar`` (:24), all leaders of a swarm share one uniform
    velocity in both components (:38-39), and the reset returns the
    observation from before that override (:36-40), as do ``mean_vel`` and
    ``init_vel``.
    """

    def default_params(self) -> FlockingParams:
        return FlockingParams(max_steps=200)

    def _integration_mask(self, params: FlockingParams, x: torch.Tensor):
        n = params.n_agents
        return (torch.arange(n, device=x.device) >= params.n_leaders).to(x.dtype)

    def _action_scale(self, params: FlockingParams):
        return 1.0

    def reset_env(self, generator: torch.Generator, params: FlockingParams, n_envs: int):
        state, obs = super().reset_env(generator, params, n_envs)
        u = torch.rand((n_envs, 1, 1), generator=generator, device=generator.device,
                       dtype=state.x.dtype)
        lead_v = -params.v_max + 2.0 * params.v_max * u
        x = state.x.clone()  # init_vel stays a view of the drawn state
        x[:, :params.n_leaders, 2:4] = lead_v
        return dataclasses.replace(state, x=x), obs


class FlockingObstacleEnv(FlockingRelativeEnv):
    """``FlockingObstacle-v0``: the first ``n_obstacles`` agents are frozen
    obstacles (reference flocking_obstacle.py:13-104).

    Deterministic reset: the swarm on a 0.8-spaced grid moving at (0, -7),
    the obstacles on a half-scale 2-wide grid 10 units below, at rest
    (:58-73).  Obstacle velocity rows and columns are zeroed in the pairwise
    differences (:80-81), actions are not scaled (:38), and ``mean_vel`` /
    ``init_vel`` cover the other agents only.  ``r_max`` is 3 (:22), used
    by rendering only.
    """

    def default_params(self) -> FlockingParams:
        return FlockingParams(max_steps=200, r_max=3.0, auto_scale_r_max=False)

    def _obstacle_mask(self, params: FlockingParams, x: torch.Tensor):
        return torch.arange(params.n_agents, device=x.device) < params.n_obstacles

    def _integration_mask(self, params: FlockingParams, x: torch.Tensor):
        n = params.n_agents
        return (torch.arange(n, device=x.device) >= params.n_obstacles).to(x.dtype)

    def _action_scale(self, params: FlockingParams):
        return 1.0

    def reset_env(self, generator: torch.Generator, params: FlockingParams, n_envs: int):
        """The same state for every swarm; ``generator`` only sets the device."""
        n, n_obs = params.n_agents, params.n_obstacles
        x = torch.zeros(n, 4)
        x[:, 0:2] = torch.as_tensor(formations.grid(n), dtype=torch.float32)
        x[:, 3] = -7.0
        obs_pos = torch.as_tensor(formations.grid(n_obs, side=2), dtype=torch.float32) * 0.5
        obs_pos[:, 1] += -10.0
        x[:n_obs, 0:2] = obs_pos
        x[:n_obs, 2:4] = 0.0
        x = x.to(generator.device).expand(n_envs, n, 4).clone()
        self.last_reset_tries = 0
        state = FlockingState(
            time=torch.zeros(n_envs, dtype=torch.int32, device=x.device),
            x=x,
            mean_vel=x[:, n_obs:, 2:4].mean(dim=-2),
            init_vel=x[:, n_obs:, 2:4],
        )
        return state, self._obs(state, params)


class FlockingStochasticEnv(FlockingRelativeEnv):
    """``FlockingStochastic-v0``: a random dt ~ N(0.12, 0.018) a step, one per
    swarm (reference flocking_stoch.py:14-45): the action is clipped to
    +-``stoch_max_accel``, state and control are scaled by ``stoch_scale``
    before the Euler step and unscaled after; the expert clips its output to
    +-``stoch_max_accel``.
    """

    def default_params(self) -> FlockingParams:
        return FlockingParams(max_steps=500)

    @staticmethod
    def _draw_dt(generator: torch.Generator, params: FlockingParams, like: torch.Tensor):
        """``[B]`` dts: one ``randn(B)`` from ``generator``, nothing else."""
        z = torch.randn((like.shape[0],), generator=generator, device=generator.device,
                        dtype=like.dtype)
        return params.dt_mean + params.dt_sigma * z

    def step_env(self, generator, state: FlockingState, action, params: FlockingParams):
        return self.step_with_dt(state, action, self._draw_dt(generator, params, state.x),
                                 params)

    def step_with_dt(self, state: FlockingState, action, dt, params: FlockingParams):
        """A step with the given dt: a float or a ``[B]`` tensor."""
        x = self._integrate_scaled(state.x, action, dt, params)
        new_state = dataclasses.replace(state, x=x, time=state.time + 1)
        obs = self._obs(new_state, params)
        return new_state, obs, _instant_cost(x), new_state.time >= params.max_steps, {}

    @staticmethod
    def _integrate_scaled(x, action, dt, params: FlockingParams):
        u = action.clamp(-params.stoch_max_accel, params.stoch_max_accel)
        s = params.stoch_scale
        return _integrate(x * s, u * s, dt) / s

    def controller(self, state, params, generator=None, centralized=None):
        u = turner_controller(state.x, params, centralized)
        return u.clamp(-params.stoch_max_accel, params.stoch_max_accel)

    def expert_rollout(self, state, params, n_steps, centralized=None, generator=None):
        """The fused rollout with one ``[B]`` dt a step drawn from
        ``generator`` (a fresh one seeded 0 on the state's device when
        ``None``, as the JAX package defaults to ``key(0)``)."""
        if generator is None:
            generator = torch.Generator(device=state.x.device).manual_seed(0)
        return super().expert_rollout(state, params, n_steps, centralized, generator)

    def _expert_action(self, s_gx, s_gy, s_dvx, s_dvy, params):
        u = super()._expert_action(s_gx, s_gy, s_dvx, s_dvy, params)
        return u.clamp(-params.stoch_max_accel, params.stoch_max_accel)

    def _rollout_integrate(self, x, u, params, generator):
        return self._integrate_scaled(x, u, self._draw_dt(generator, params, x), params)


class FlockingTwoFlocksEnv(FlockingRelativeEnv):
    """``FlockingTwoFlocks-v0``: positions on a grid of ``int(n/10)`` columns,
    velocities ``-grid + bias`` with one bias ~ U(-v_bias/2, v_bias/2)^2 a
    swarm (reference flocking_twoflocks.py:8-26)."""

    def default_params(self) -> FlockingParams:
        return FlockingParams(max_steps=500)

    def reset_env(self, generator: torch.Generator, params: FlockingParams, n_envs: int):
        n, dev = params.n_agents, generator.device
        u = torch.rand((n_envs, 2), generator=generator, device=dev)
        bias = -params.v_bias / 2.0 + params.v_bias * u
        grids = torch.as_tensor(formations.grid(n, side=int(n / 10)), dtype=torch.float32,
                                device=dev).expand(n_envs, n, 2)
        self.last_reset_tries = 0
        state = _state_from_x(torch.cat((grids, -grids + bias[:, None, :]), dim=-1))
        return state, self._obs(state, params)


class LargeFlockingEnv(FlockingRelativeEnv):
    """Large-swarm variant (N >~ 1k): every pairwise reduction runs on K1.

    Same dynamics, reward and expert as :class:`FlockingRelativeEnv`; the
    observation is ``(state_values [B,N,6], degree [B,N])`` instead of the
    dense ``[B,N,N]`` network.
    """

    def default_params(self) -> FlockingParams:
        return FlockingParams(n_agents=4096, max_steps=1000)

    def _obs(self, state: FlockingState, params: FlockingParams):
        return flocking_features_large(state.x, params.comm_radius, params.comm_radius2)

    def controller(self, state, params, generator=None, centralized=None):
        """The fused pass's expert sums, then :meth:`_expert_action`."""
        if centralized is None:
            centralized = params.centralized
        _, _, *sums = self._fused_pass(state.x, params, centralized)
        return self._expert_action(*sums, params)

    def _sums(self, x, params, channels: str = "core"):
        """Channel sums at ``x``: ``"core"``, or ``"expert"`` for the
        decentralized expert's masked gradient sums (10/11), which the dense
        kernel has in its "full" set."""
        if channels == "core":
            return flocking_sums(x, params.comm_radius, params.comm_radius2)
        return flocking_sums_block(
            x, x, 0, 0, params.comm_radius, params.comm_radius2, channels="full"
        )

    def _fused_pass(self, x, params, centralized, out=None):
        """K1's channel sums, unpacked; writes into no view: ``out`` is not
        read."""
        s = self._sums(x, params, channels="core" if centralized else "expert")
        return (*k1.feature_channels(s), *k1.expert_channels(s, x, centralized))


class SparseFlockingEnv(LargeFlockingEnv):
    """Cell-list variant: pairwise work that grows with the neighbour count,
    not with N^2.

    Same semantics as :class:`LargeFlockingEnv`: the Hilbert sort and block
    pruning of ``ops.sparse_flocking`` remove only pairs that add nothing,
    so only the summation order differs.  ``n_agents`` must be a multiple of
    128.  A batch whose candidate table overflows runs on the dense K1 pass
    instead (the JAX package's semantics).  The fused rollout carries a
    Verlet table, rebuilt only when an agent has moved more than
    ``verlet_skin/2`` since the last build; ``verlet_skin <= 0`` rebuilds
    every step.
    """

    def default_params(self) -> FlockingParams:
        return FlockingParams(n_agents=16384, max_steps=1000)

    def _sums(self, x, params, channels: str = "core"):
        return sf.flocking_sums_sparse(
            x, params.comm_radius, params.comm_radius2, channels=channels
        )

    def _reset_accept(self, x, params):
        # the cell-list test is exact and touches no [B, N, N] array
        return sf.sparse_reset_accept(
            x, params.comm_radius, params.comm_radius2, params.min_dist_thresh
        )

    def _obs(self, state: FlockingState, params: FlockingParams):
        return k1.feature_channels(self._sums(state.x, params))

    def _verlet_skin(self, params: FlockingParams):
        """The resolved Verlet slack, or ``None`` when reuse is off."""
        if params.verlet_skin is not None and params.verlet_skin <= 0.0:
            return None
        if params.n_agents % sf.BLOCK != 0:
            return None
        return params.comm_radius if params.verlet_skin is None else params.verlet_skin

    def _fused_carry_init(self, x, params):
        skin = self._verlet_skin(params)
        if skin is None:
            return None
        return sf.verlet_build(x, params.comm_radius, skin)

    def _fused_pass_carry(self, x, params, centralized, carry, out=None):
        if carry is None:  # reuse off: a fresh table every pass
            return super()._fused_pass_carry(x, params, centralized, carry)
        s, carry = sf.flocking_sums_sparse_verlet(
            x, carry, params.comm_radius, params.comm_radius2,
            self._verlet_skin(params),
            channels="core" if centralized else "expert",
        )
        return (*k1.feature_channels(s), *k1.expert_channels(s, x, centralized)), carry
