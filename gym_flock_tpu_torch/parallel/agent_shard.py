"""Agent-axis sharding of the flocking pairwise passes over
``torch.distributed`` (counterpart of ``gym_flock_tpu/parallel/agent_shard.py``).

A swarm of N agents is split over the ranks of a group (the ``"ap"``
dimension of :func:`make_flock_mesh`): each rank holds a row block of ``m =
N / P`` agents, ``x_local [B, m, 4]``, and computes its block's pairwise
reductions from tiles of K1 (``ops.flocking_sums.flocking_sums_block``) or
K2 (``ops.adjacency_matmul.adjacency_matmul_block``) with global-id offsets:

- ``mode="allgather"``: one all-gather of the swarm's state, then one
  ``[m, N]`` tile;
- ``mode="ring"``: the column blocks travel around the ring; rank ``r``
  receives from ``r + 1`` and sends to ``r - 1``, P - 1 shifts a pass, each
  followed by one ``[m, m]`` tile.  The parts combine in the JAX package's
  order: the own tile first, then the visitors in ring order; channel 9
  (min r^2) by ``min``, the others by ``+``.

The K2 path is differentiable in the features: the ring shift's backward is
the shift in the opposite direction, the tiled all-gather's is the
all-reduced cotangent's own slice, and each tile's is K2's swapped-operand
backward.  The K1 path (sums, controller, step, reset, rollout) is not
differentiated.

Every function runs inside a process group and raises without one.  On the
card the group is NCCL; on the host the CPU tests run gloo ranks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from gym_flock_tpu_torch.core.env import _rejection_reset
from gym_flock_tpu_torch.envs.flocking import FlockingParams, LargeFlockingEnv, _integrate
from gym_flock_tpu_torch.ops.adjacency_matmul import adjacency_matmul_block
from gym_flock_tpu_torch.ops import flocking_sums as k1
from gym_flock_tpu_torch.ops.flocking_sums import flocking_sums_block
from gym_flock_tpu_torch.parallel.distributed import mesh_device_type
from gym_flock_tpu_torch.utils.profiling import host_bool

__all__ = [
    "make_flock_mesh",
    "ring_shift",
    "all_gather_agents",
    "combine_ring_parts",
    "flocking_sums_sharded",
    "flocking_features_sharded",
    "turner_controller_sharded",
    "adjacency_matmul_sharded",
    "khop_aggregate_sharded",
    "flocking_step_sharded",
    "flocking_reset_sharded",
    "agent_sharded_rollout",
]

_MODES = ("ring", "allgather")
last_reset_tries = 0  # batch draws of the latest flocking_reset_sharded


def make_flock_mesh(dp: int, ap: int):
    """A 2-D ``DeviceMesh`` over the default group's ranks: env batch
    ``"dp"`` x agent axis ``"ap"`` (``ap`` the faster-varying dimension, so
    a ring's neighbours are adjacent ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if world != dp * ap:
        raise ValueError(f"a {dp} x {ap} mesh needs {dp * ap} ranks, the group has {world}")
    return init_device_mesh(mesh_device_type(), (dp, ap), mesh_dim_names=("dp", "ap"))


def _size_rank(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {_MODES}")


def _shift(tensors, group, step: int):
    """Each tensor of this rank goes to rank ``r - step``; the returned ones
    came from rank ``r + step`` (ranks of ``group``, modulo its size)."""
    p, r = _size_rank(group)

    def peer(i):  # the default group's ranks are the global ones
        return i % p if group is None else dist.get_global_rank(group, i % p)

    dst, src = peer(r - step), peer(r + step)
    outs, ops = [], []
    for t in tensors:
        t = t.contiguous()
        out = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, dst, group), dist.P2POp(dist.irecv, out, src, group)]
        outs.append(out)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_shift(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        # a block moved one rank down the ring; its cotangent moves back up
        need = [i for i, n in enumerate(ctx.needs_input_grad[1:]) if n]
        back = _shift([grads[i] for i in need], ctx.group, -1) if need else []
        out = [None] * len(grads)
        for i, g in zip(need, back):
            out[i] = g
        return (None, *out)


def ring_shift(*tensors, group=None):
    """One step of the ring: rank ``r`` sends its tensors to ``r - 1`` and
    returns those of ``r + 1``, in one batch of point-to-point operations.
    Differentiable: the cotangents travel the other way."""
    return _RingShift.apply(group, *tensors)


# torch 2.13 renamed reduce_scatter_tensor and deprecated the old name
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class _AllGatherAgents(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        p, _ = _size_rank(group)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(p)]
        dist.all_gather(parts, t, group=group)
        ctx.m = t.shape[1]
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        # every rank's tile read every block: the block's cotangent is the
        # sum of all ranks' cotangents for it, one reduce-scatter (JAX's
        # psum_scatter) over the blocks laid out rank-major
        p, _ = _size_rank(ctx.group)
        b, _, *rest = g.shape
        blocks = g.reshape(b, p, ctx.m, *rest).transpose(0, 1).contiguous()
        out = g.new_empty(b, ctx.m, *rest)
        _reduce_scatter(out, blocks.reshape(p * b, ctx.m, *rest), group=ctx.group)
        return None, out


def all_gather_agents(t: torch.Tensor, group=None) -> torch.Tensor:
    """``[B, m, C]`` blocks of every rank, concatenated in rank order on the
    agent axis: ``[B, m * P, C]``.  Differentiable: a block's gradient is
    its block of the reduce-scattered cotangent."""
    return _AllGatherAgents.apply(group, t)


# K1 sums of one row block from its tiles, the own first, then the visitors in ring order
combine_ring_parts = k1.combine_tiles


def flocking_sums_sharded(x_local: torch.Tensor, comm_radius, comm_radius2, group=None,
                          mode: str = "ring", channels: str = "full") -> torch.Tensor:
    """K1's ``[B, m, 16]`` channel sums of this rank's agents ``x_local [B,
    m, 4]`` against the whole swarm split over ``group`` (layout in
    ``ops.flocking_sums``).  ``channels="core"`` computes channels 0-8."""
    _check_mode(mode)
    p, me = _size_rank(group)
    m = x_local.shape[1]
    if mode == "allgather":
        x_all = all_gather_agents(x_local, group)
        return flocking_sums_block(x_local, x_all, me * m, 0, comm_radius, comm_radius2,
                                   channels)
    parts = [flocking_sums_block(x_local, x_local, me * m, me * m, comm_radius, comm_radius2,
                                 channels)]
    block = x_local
    for s in range(1, p):
        (block,) = _shift([block], group, 1)
        src = (me + s) % p
        parts.append(flocking_sums_block(x_local, block, me * m, src * m, comm_radius,
                                         comm_radius2, channels))
    return combine_ring_parts(parts)


def flocking_features_sharded(x_local: torch.Tensor, comm_radius, comm_radius2, group=None,
                              mode: str = "ring"):
    """``(state_values [B, m, 6], degree [B, m])`` of this rank's agents; no
    ``[N, N]`` network exists (aggregate with :func:`adjacency_matmul_sharded`)."""
    return k1.feature_channels(
        flocking_sums_sharded(x_local, comm_radius, comm_radius2, group, mode, channels="core"))


def turner_controller_sharded(x_local: torch.Tensor, params: FlockingParams, group=None,
                              mode: str = "ring", sums: Optional[torch.Tensor] = None,
                              centralized: Optional[bool] = None) -> torch.Tensor:
    """The Turner expert's ``[B, m, 2]`` actions for this rank's agents.

    Centralized (the default of ``params``): the velocity term by the closed
    form ``N v_i - sum_j v_j`` with one all-reduce of the velocity sum, the
    gradient from channels 6/7.  Decentralized: channels 0/3 and 10/11.
    ``sums`` (from :func:`flocking_sums_sharded`) shares a pass already made.
    """
    if centralized is None:
        centralized = params.centralized
    p, _ = _size_rank(group)
    n = x_local.shape[1] * p
    if sums is None:
        sums = flocking_sums_sharded(x_local, params.comm_radius, params.comm_radius2, group,
                                     mode, channels="core" if centralized else "full")
    v_tot = None
    if centralized:
        v_tot = x_local[..., 2:4].sum(dim=1)  # [B, 2]
        dist.all_reduce(v_tot, group=group)
    return k1.turner_action(*k1.expert_channels(sums, x_local, centralized, v_tot, n),
                            params.action_scalar)


def adjacency_matmul_sharded(x_local: torch.Tensor, h_local: torch.Tensor, comm_radius2,
                             group=None, mode: str = "ring",
                             mean_pool: bool = True) -> torch.Tensor:
    """``A(x) @ H`` for this rank's rows, with both operands split over the
    agent axis: ``x_local [B, m, >=2]``, ``h_local [B, m, F]`` f32 ->
    ``[B, m, F]``.  Each tile is K2 (the visiting block's positions and
    features against this rank's rows); ``mean_pool`` divides by the degree,
    1 where it is 0.  Differentiable in ``h_local`` (module docstring)."""
    _check_mode(mode)
    p, me = _size_rank(group)
    m = x_local.shape[1]
    if mode == "allgather":
        x_all = all_gather_agents(x_local.detach(), group)
        h_all = all_gather_agents(h_local, group)
        out, deg = adjacency_matmul_block(x_local, x_all, h_all, me * m, 0, comm_radius2)
    else:
        out, deg = adjacency_matmul_block(x_local, x_local, h_local, me * m, me * m,
                                          comm_radius2)
        xb, hb = x_local.detach(), h_local
        for s in range(1, p):
            xb, hb = ring_shift(xb, hb, group=group)
            src = (me + s) % p
            o, d = adjacency_matmul_block(x_local, xb, hb, me * m, src * m, comm_radius2)
            out = out + o
            deg = deg + d
    if mean_pool:
        out = out / torch.where(deg == 0, 1.0, deg)[..., None].to(out.dtype)
    return out


def khop_aggregate_sharded(x_local: torch.Tensor, features_local: torch.Tensor, comm_radius2,
                           k_hops: int, group=None, mode: str = "ring",
                           mean_pool: bool = True) -> torch.Tensor:
    """``[X, AX, A^2 X, ...]`` of this rank's agents, ``[B, m, k_hops * F]``:
    ``ops.adjacency_matmul.khop_aggregate`` with the agent axis split, as
    ``LargeAggregationGNN(aggregate_fn=...)`` takes it.  Differentiable in
    the features."""
    zs = [features_local]
    z = features_local
    for _ in range(k_hops - 1):
        z = adjacency_matmul_sharded(x_local, z, comm_radius2, group, mode, mean_pool)
        zs.append(z)
    return torch.cat(zs, dim=-1)


def _reward(x2: torch.Tensor, n: int, group) -> torch.Tensor:
    """``[B]`` minus the summed velocity variances of the whole swarm, from
    its all-reduced first and second moments."""
    v = x2[..., 2:4]
    moments = torch.cat((v.sum(dim=1), (v * v).sum(dim=1)), dim=-1)  # [B, 4]
    dist.all_reduce(moments, group=group)
    mean = moments[:, 0:2] / n
    return -1.0 * (moments[:, 2:4] / n - mean * mean).sum(dim=-1)


def flocking_step_sharded(x_local: torch.Tensor, params: FlockingParams, group=None,
                          mode: str = "ring"):
    """One expert, dynamics, observation and reward step of a split swarm:
    ``(x_local', values_local [B, m, 6], reward [B])``, the reward the same
    on every rank.  The controller's output ``u`` is integrated as it is
    (``x += v dt + u dt^2 / 2``), as the JAX package's sharded step does;
    the env's ``step_env`` integrates ``u * action_scalar``."""
    u = turner_controller_sharded(x_local, params, group, mode)
    x2 = _integrate(x_local, u, params.dt)
    values, _ = flocking_features_sharded(x2, params.comm_radius, params.comm_radius2, group,
                                          mode)
    p, _ = _size_rank(group)
    return x2, values, _reward(x2, x_local.shape[1] * p, group)


def flocking_reset_sharded(generator: torch.Generator, params: FlockingParams, n_envs: int,
                           group=None, mode: str = "ring", dp_group=None) -> torch.Tensor:
    """Rejection-sampling reset of ``n_envs`` swarms with the acceptance test
    split over ``group``: this rank's ``[n_envs / dp, m, 4]`` block.

    Every rank draws the whole ``[n_envs, N, 4]`` proposal from
    ``generator`` (held in the same state on every rank) and keeps its own
    envs (its rank in ``dp_group``, when given) and agents; each env's min
    degree and min r^2 come from one sharded K1 "full" pass, min-all-reduced
    over ``group``.  An env keeps its first accepted draw; the loop stops
    when every env of every rank has one, or after ``params.max_reset_tries``
    draws (a never-accepted env keeps its last).  The result depends on the
    generator alone, not on the split.  ``last_reset_tries`` holds the draws.
    """
    global last_reset_tries
    p, me = _size_rank(group)
    n = params.n_agents
    if n % p:
        raise ValueError(f"n_agents={n} does not split over {p} ranks")
    m = n // p
    dp, dme = _size_rank(dp_group) if dp_group is not None else (1, 0)
    if n_envs % dp:
        raise ValueError(f"n_envs={n_envs} does not split over {dp} ranks")
    e = n_envs // dp
    drawer = LargeFlockingEnv()

    def draw():
        full = drawer._draw(generator, params, n_envs)
        return full[dme * e:(dme + 1) * e, me * m:(me + 1) * m].contiguous()

    def accept(x):
        s = flocking_sums_sharded(x, params.comm_radius, params.comm_radius2, group, mode)
        mins = torch.stack(k1.reset_minima(s))  # [2, e]
        dist.all_reduce(mins, op=dist.ReduceOp.MIN, group=group)
        return k1.reset_accepts(mins[0], mins[1], params.min_dist_thresh)

    def all_accepted(ok):
        flag = ok.all().to(torch.int32).reshape(1)
        if dp_group is not None:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=dp_group)
        return host_bool(flag)  # the same on every rank: it is all-reduced

    x, last_reset_tries = _rejection_reset(draw, accept, params.max_reset_tries, all_accepted)
    return x


def agent_sharded_rollout(params: FlockingParams, generator: torch.Generator, n_envs: int,
                          n_steps: int, mesh=None, mode: str = "ring"):
    """Roll ``n_envs`` swarms over a 2-D mesh from :func:`make_flock_mesh`:
    envs split over ``"dp"``, every swarm's agents over ``"ap"``.

    A :func:`flocking_reset_sharded`, then one K1 pass a step: the pass at
    ``x_{t+1}`` that gives step t's reward carries its expert channels into
    step t+1's controller.  Returns ``(x_final, mean_reward)``: this rank's
    ``[n_envs / dp, m, 4]`` block of the final states, and the reward's mean
    over steps and envs, all-reduced over ``"dp"``, the same on every rank.
    """
    _check_mode(mode)
    if mesh is None:
        mesh = make_flock_mesh(1, dist.get_world_size())
    return _rollout(params, generator, n_envs, n_steps, mesh.get_group("ap"),
                    mesh.get_group("dp"), mode)


def _rollout(params, generator, n_envs, n_steps, ap, dp, mode):
    """:func:`agent_sharded_rollout` over the process groups ``ap`` and ``dp``."""
    x = flocking_reset_sharded(generator, params, n_envs, ap, mode, dp_group=dp)
    n = params.n_agents
    chan = "core" if params.centralized else "full"
    s = flocking_sums_sharded(x, params.comm_radius, params.comm_radius2, ap, mode, chan)
    total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(n_steps):
        u = turner_controller_sharded(x, params, ap, mode, sums=s)
        x = _integrate(x, u, params.dt)
        s = flocking_sums_sharded(x, params.comm_radius, params.comm_radius2, ap, mode, chan)
        total = total + _reward(x, n, ap)
    mean_r = (total / n_steps).mean().reshape(1)
    dist.all_reduce(mean_r, group=dp)
    return x, mean_r[0] / dist.get_world_size(dp)
