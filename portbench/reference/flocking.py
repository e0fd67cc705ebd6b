"""Plain reference of the flocking world: the dynamics, the observation, the
Turner expert, the reward and the rejection-sampling reset of gym-flock's
``FlockingRelative-v0`` (katetolstaya/gym-flock, ``flocking_relative.py``,
the environment of Tolstaya et al., CoRL 2019, arXiv:1903.10527).

Plain ``torch`` only: nothing here imports the program under test.  Pair
terms are formed in the state's precision (float32 for the benchmark, so the
adjacency test ``r2 < comm_radius**2`` decides as the configuration states
it), and every sum accumulates in float64.  Each sum comes with the sum of
the magnitudes of its terms, the scale against which a float32 result is
judged.  ``term_dtype`` lowers the precision of the pair terms: the
differences are formed in the state's precision and then held, with
everything computed from them, in ``term_dtype`` (the control of the
comparison runs them in bfloat16).

Rows are taken in blocks, so no temporary exceeds ``PAIRS_PER_BLOCK``
pairs: the N=4096 swarms fit beside the program's own state.

Semantics kept from the original (as the port documents them):
  * differences are row minus column, ``x_i - x_j``; r2 is +inf on the
    diagonal;
  * the six observation sums use the binary adjacency ``r2 < cr**2``:
    dvx, dx/r^4, dx/r^2, dvy, dy/r^4, dy/r^2;
  * the expert's potential gradient is cut off where ``r2 > cr`` (r2
    against the radius, NOT its square), the velocity term sums over every
    agent; the action is ``-(sum grad + sum dv)`` clipped to [-10, 10] over
    ``action_scalar``;
  * the reward is minus the summed velocity variances (ddof 0);
  * the Euler step is ``p += v dt + u dt^2 / 2``, ``v += u dt`` with ``u``
    the action times ``action_scalar``;
  * the reset draws a whole batch at a time, positions uniform over the
    disk of radius ``sqrt(r_max * sqrt(N))``, velocities uniform in
    ``[-v_max, v_max]`` plus one bias a swarm in ``[-v_max, v_max]``; a
    swarm keeps its first draw with min degree >= 2 and min distance >
    ``min_dist_thresh``, and after ``max_reset_tries`` draws its last.
"""
from __future__ import annotations

import dataclasses
import math

import torch

PAIRS_PER_BLOCK = 1 << 24


@dataclasses.dataclass(frozen=True)
class World:
    """The numbers of the flocking world that the reference needs."""

    n_agents: int
    comm_radius: float = 0.9
    dt: float = 0.01
    v_max: float = 5.0
    r_max: float = 1.0
    action_scalar: float = 10.0
    min_dist_thresh: float = 0.1
    max_reset_tries: int = 64

    @property
    def comm_radius2(self) -> float:
        return self.comm_radius * self.comm_radius

    @property
    def r_max_eff(self) -> float:
        return self.r_max * math.sqrt(self.n_agents)

    @classmethod
    def from_params(cls, params: dict) -> "World":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in params.items() if k in names})


def _rows(b: int, n: int) -> int:
    return max(1, PAIRS_PER_BLOCK // max(1, b * n))


def _differences(x: torch.Tensor, r0: int, r1: int, term_dtype):
    """Rows ``r0:r1`` minus every column, ``(dx, dy, dvx, dvy)`` each ``[B,
    r1-r0, N]``: formed in x's precision, then held in ``term_dtype``."""
    xs = x[:, r0:r1]
    return tuple((xs[..., c, None] - x[:, None, :, c]).to(term_dtype) for c in range(4))


def pair_pass(x: torch.Tensor, world: World, term_dtype=None) -> dict:
    """Every pairwise sum of one state ``x [B, N, 4]``.

    Returns float64 tensors: ``values [B,N,6]`` and their scales
    ``values_scale`` (1 + the sum of the terms' magnitudes), ``degree
    [B,N]``, ``grad [B,N,2]`` (the expert's cut-off gradient sums) and
    ``grad_abs``, ``min_r2 [B]`` over distinct pairs."""
    term_dtype = term_dtype or x.dtype
    b, n, _ = x.shape
    cr2 = torch.tensor(world.comm_radius2, dtype=torch.float32).to(term_dtype).item()
    cr = world.comm_radius
    f64 = torch.float64
    values = torch.zeros(b, n, 6, dtype=f64, device=x.device)
    scale = torch.ones(b, n, 6, dtype=f64, device=x.device)
    degree = torch.zeros(b, n, dtype=f64, device=x.device)
    grad = torch.zeros(b, n, 2, dtype=f64, device=x.device)
    grad_abs = torch.zeros(b, n, 2, dtype=f64, device=x.device)
    min_r2 = torch.full((b,), math.inf, dtype=f64, device=x.device)
    col = torch.arange(n, device=x.device)
    step = _rows(b, n)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        dx, dy, dvx, dvy = _differences(x, r0, r1, term_dtype)
        r2 = dx * dx + dy * dy
        diag = (torch.arange(r0, r1, device=x.device)[:, None] == col[None, :])
        r2 = torch.where(diag, torch.inf, r2)
        adj = r2 < cr2
        inv = 1.0 / r2
        inv2 = inv * inv
        terms = (dvx, dx * inv2, dx * inv, dvy, dy * inv2, dy * inv)
        adj64 = adj.to(f64)
        for c, t in enumerate(terms):
            t64 = t.to(f64) * adj64
            values[:, r0:r1, c] = t64.sum(-1)
            scale[:, r0:r1, c] += t64.abs().sum(-1)
        degree[:, r0:r1] = adj64.sum(-1)
        cut = r2 > cr
        for c, d in enumerate((dx, dy)):
            g = torch.where(cut, 0.0, -2.0 * (d * inv2) + 2.0 * (d * inv)).to(f64)
            grad[:, r0:r1, c] = g.sum(-1)
            grad_abs[:, r0:r1, c] = g.abs().sum(-1)
        min_r2 = torch.minimum(min_r2, r2.to(f64).amin(dim=(-2, -1)))
    return {"values": values, "values_scale": scale, "degree": degree,
            "grad": grad, "grad_abs": grad_abs, "min_r2": min_r2}


def expert_action(x: torch.Tensor, p: dict, world: World):
    """The centralized Turner action ``[B,N,2]`` (float64) from one pass,
    and the scale of its error (the magnitudes of its terms over
    ``action_scalar``)."""
    v = x[..., 2:4].to(torch.float64)
    n = x.shape[-2]
    s_dv = n * v - v.sum(dim=-2, keepdim=True)
    dv_abs = n * v.abs() + v.abs().sum(dim=-2, keepdim=True)
    controls = -(p["grad"] + s_dv)
    u = controls.clamp(-10.0, 10.0) / world.action_scalar
    return u, (1.0 + p["grad_abs"] + dv_abs) / world.action_scalar


def mean_pooled(x: torch.Tensor, world: World, term_dtype=None) -> torch.Tensor:
    """The mean-pooled adjacency ``[B,N,N]`` (a row divided by its degree, 1
    where the degree is 0), float64, the test ``r2 < cr**2`` made on terms
    in ``term_dtype`` (x's precision by default), for ``FlockingRelative``'s
    ``network``.  Dense: meant for the small swarms."""
    term_dtype = term_dtype or x.dtype
    dx, dy, _, _ = _differences(x, 0, x.shape[-2], term_dtype)
    r2 = dx * dx + dy * dy
    n = x.shape[-2]
    r2 = torch.where(torch.eye(n, dtype=torch.bool, device=x.device), torch.inf, r2)
    cr2 = torch.tensor(world.comm_radius2, dtype=torch.float32).to(term_dtype).item()
    adj = (r2 < cr2).to(torch.float64)
    deg = adj.sum(-1, keepdim=True)
    return adj / torch.where(deg == 0, 1.0, deg)


def reward(x: torch.Tensor):
    """``[B]`` minus the summed velocity variances, float64, and its scale
    (1 + the mean squared velocity)."""
    v = x[..., 2:4].to(torch.float64)
    var = ((v - v.mean(dim=-2, keepdim=True)) ** 2).mean(dim=-2)
    return -var.sum(-1), 1.0 + (v * v).mean(dim=-2).sum(-1)


def integrate(x: torch.Tensor, u: torch.Tensor, world: World) -> torch.Tensor:
    """One Euler step of the double integrator in x's precision."""
    dt = world.dt
    ux = u[..., 0] * world.action_scalar
    uy = u[..., 1] * world.action_scalar
    px = x[..., 0] + x[..., 2] * dt + ux * dt * dt * 0.5
    py = x[..., 1] + x[..., 3] * dt + uy * dt * dt * 0.5
    vx = x[..., 2] + ux * dt
    vy = x[..., 3] + uy * dt
    return torch.stack((px, py, vx, vy), dim=-1)


def draw(generator: torch.Generator, world: World, n_envs: int,
         dtype=torch.float32) -> torch.Tensor:
    """One reset proposal for ``n_envs`` swarms, ``[B, N, 4]``."""
    n, dev = world.n_agents, generator.device
    u = torch.rand((5, n_envs, n), generator=generator, device=dev, dtype=dtype)
    length = torch.sqrt(world.r_max_eff * u[0])
    angle = 2.0 * math.pi * u[1]
    bias = world.v_max * (2.0 * u[2, :, :2] - 1.0)
    vx = world.v_max * (2.0 * u[3] - 1.0) + bias[:, 0:1]
    vy = world.v_max * (2.0 * u[4] - 1.0) + bias[:, 1:2]
    return torch.stack((length * torch.cos(angle), length * torch.sin(angle), vx, vy), dim=-1)


def accepted(x: torch.Tensor, world: World, term_dtype=None, slack: float = 0.0) -> torch.Tensor:
    """``[B]`` bool: min degree >= 2 and min distance > ``min_dist_thresh``.
    With ``slack`` both tests are eased by that share (the radius widened,
    the distance threshold lowered), so that only a swarm that fails them
    by more than rounding reads as rejected."""
    term_dtype = term_dtype or x.dtype
    b, n, _ = x.shape
    cr2 = torch.tensor(world.comm_radius2 * (1.0 + slack),
                       dtype=torch.float32).to(term_dtype).item()
    min_deg = torch.full((b,), n, dtype=torch.int64, device=x.device)
    min_r2 = torch.full((b,), math.inf, dtype=torch.float64, device=x.device)
    col = torch.arange(n, device=x.device)
    step = _rows(b, n)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        dx, dy, _, _ = _differences(x, r0, r1, term_dtype)
        r2 = dx * dx + dy * dy
        r2 = torch.where(torch.arange(r0, r1, device=x.device)[:, None] == col, torch.inf, r2)
        min_deg = torch.minimum(min_deg, (r2 < cr2).sum(-1).amin(-1))
        min_r2 = torch.minimum(min_r2, r2.amin(dim=(-2, -1)).to(torch.float64))
    return (min_deg >= 2) & (min_r2.sqrt() > world.min_dist_thresh * (1.0 - slack))


def out_of_support(x: torch.Tensor, world: World) -> int:
    """Entries of reset states ``x [B,N,4]`` that no draw can give: a
    position outside the disk, a velocity component beyond ``2 v_max``, or a
    value that is not finite."""
    tol = 1e-5
    r2 = x[..., 0].double() ** 2 + x[..., 1].double() ** 2
    bad_p = r2 > world.r_max_eff * (1.0 + tol)
    bad_v = (x[..., 2:4].double().abs() > 2.0 * world.v_max * (1.0 + tol)).any(-1)
    bad_f = ~torch.isfinite(x).all(-1)
    return int((bad_p | bad_v | bad_f).sum())


def reset(generator: torch.Generator, world: World, n_envs: int, term_dtype=None):
    """The rejection-sampling reset: ``(x [B,N,4], accepted [B], draws)``.
    Each draw redraws the whole batch, a swarm keeps its first accepted
    draw (or, never accepted, its last), and the draws stop once every
    swarm is accepted or after ``max_reset_tries``."""
    x = draw(generator, world, n_envs)
    ok = accepted(x, world, term_dtype)
    tries = 1
    while tries < world.max_reset_tries and not bool(ok.all()):
        x_new = draw(generator, world, n_envs)
        ok_new = accepted(x_new, world, term_dtype)
        x = torch.where(ok[:, None, None], x, x_new)
        ok = ok | ok_new
        tries += 1
    return x, ok, tries
