"""K6, the dense flocking pass of the small-N envs: the CUDA kernel's
wrapper, its plain PyTorch version and the dispatch between them.

One pass over a swarm's ``[N, N]`` pairs gives everything the observation
and the Turner expert need at a state ``x [B, N, 4]``: the six feature sums
``values [B,N,6]``, the ``network [B,N,N]`` (the adjacency ``r2 <
comm_radius^2``, mean-pooled by the degree when ``mean_pooling``), and the
expert's potential-gradient and velocity-difference sums ``s_gx, s_gy,
s_dvx, s_dvy [B,N]``.  The JAX package computes it as dense ops
(``gym_flock_tpu/envs/flocking.py:flocking_obs_expert_pass``) that XLA
fuses; it has no Pallas kernel.  The kernel (``csrc/dense_pass.cu``) does
it in one launch, one block a swarm, and writes ``values`` and ``network``
straight into caller-given views, such as a rollout's trajectory slot.

:func:`dense_pass` routes by device: a CUDA tensor launches the kernel
(counted in :data:`launches`), which takes float32 swarms of at most
:data:`MAX_AGENTS` agents, with or without an obstacle mask, and raises on
anything else (float64 runs on the CPU only, as in K1); a CPU tensor takes
the plain version :func:`dense_pass_reference`, in float32 or float64.  The
network and the adjacency are the plain version's bit for bit on the card;
the sums are the same value terms summed in another order and in f64, and
K1's form of the Turner gradient (``2 inv (1 - inv) d``), which rounds
otherwise than the plain version's ``-2 d inv^2 + 2 d inv``.
"""
from __future__ import annotations

import torch

from gym_flock_tpu_torch.ops.flocking_sums import float4_rows
from gym_flock_tpu_torch.ops.pairwise import mean_pool_normalize, radius_adjacency

__all__ = [
    "MAX_AGENTS",
    "dense_pass",
    "dense_pass_kernel",
    "dense_pass_reference",
    "expert_sums",
    "feature_sums",
    "pairwise_channels",
    "turner_potential_grad",
]

# the largest swarm the kernel takes (gft_dense_pass_max_agents): its rows,
# adjacency words, row reciprocals and obstacle flags fill at most 43 KB of
# shared memory
MAX_AGENTS = 512

launches = 0  # K6 kernel launches in this process; only _launch adds to it


# ------------------------------------------------------------ plain version


def pairwise_channels(x: torch.Tensor, obstacle_mask: torch.Tensor | None = None):
    """Channel-separated pairwise diffs ``(dx, dy, dvx, dvy, r2)``, each
    ``[B, N, N]``, row minus column; r2 is +inf on the diagonal.

    ``obstacle_mask`` (bool ``[N]``, shared by the batch; True = obstacle)
    zeroes the velocity differences of obstacle rows AND columns (reference
    flocking_obstacle.py:80-81)."""
    px, py, vx, vy = x.unbind(dim=-1)
    dx = px[..., :, None] - px[..., None, :]
    dy = py[..., :, None] - py[..., None, :]
    dvx = vx[..., :, None] - vx[..., None, :]
    dvy = vy[..., :, None] - vy[..., None, :]
    if obstacle_mask is not None:
        keep = ~obstacle_mask
        vel_keep = keep[:, None] & keep[None, :]
        dvx = torch.where(vel_keep, dvx, 0.0)
        dvy = torch.where(vel_keep, dvy, 0.0)
    r2 = dx * dx + dy * dy
    n = x.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    r2 = torch.where(eye, torch.inf, r2)
    return dx, dy, dvx, dvy, r2


def feature_sums(dx, dy, dvx, dvy, r2, adj):
    """The six observation sums (reference flocking_relative.py:124-128):
    0 dvx, 1 dx/r^4, 2 dx/r^2, 3 dvy, 4 dy/r^4, 5 dy/r^2, over neighbors."""
    inv = 1.0 / r2
    inv2 = inv * inv
    return torch.stack(
        (
            (dvx * adj).sum(dim=-1),
            (dx * inv2 * adj).sum(dim=-1),
            (dx * inv * adj).sum(dim=-1),
            (dvy * adj).sum(dim=-1),
            (dy * inv2 * adj).sum(dim=-1),
            (dy * inv * adj).sum(dim=-1),
        ),
        dim=-1,
    )


def turner_potential_grad(pos_diff_c: torch.Tensor, r2: torch.Tensor, comm_radius):
    """Gradient of the Turner-2003 flocking potential (reference :214-226).

    The reference's quirk is kept: the cutoff compares ``r2`` (distance
    SQUARED) with ``comm_radius`` (NOT squared), flocking_relative.py:225.
    """
    inv = 1.0 / r2
    inv2 = inv * inv
    grad = -2.0 * (pos_diff_c * inv2) + 2.0 * (pos_diff_c * inv)
    return torch.where(r2 > comm_radius, 0.0, grad)


def expert_sums(x, channels, adj, comm_radius, centralized: bool, masked: bool,
                s_dvx=None, s_dvy=None):
    """``(s_gx, s_gy, s_dvx, s_dvy)`` of the Turner expert from one pass's
    pairwise ``channels`` and adjacency: the potential gradients summed
    (adjacency-masked when not ``centralized``) and the velocity-difference
    sums, by the closed form ``N v_i - sum_j v_j`` when centralized and not
    ``masked`` by an obstacle mask (whose zeroed rows and columns it would
    not see).  A caller that already has the decentralized velocity sums
    passes them as ``s_dvx``/``s_dvy``."""
    dx, dy, dvx, dvy, r2 = channels
    gx = turner_potential_grad(dx, r2, comm_radius)
    gy = turner_potential_grad(dy, r2, comm_radius)
    if not centralized:
        gx, gy = gx * adj, gy * adj
        if s_dvx is None:
            s_dvx, s_dvy = (dvx * adj).sum(dim=-1), (dvy * adj).sum(dim=-1)
    elif not masked:
        n = x.shape[-2]
        s_dvx = n * x[..., 2] - x[..., 2].sum(dim=-1, keepdim=True)
        s_dvy = n * x[..., 3] - x[..., 3].sum(dim=-1, keepdim=True)
    else:
        s_dvx, s_dvy = dvx.sum(dim=-1), dvy.sum(dim=-1)
    return gx.sum(dim=-1), gy.sum(dim=-1), s_dvx, s_dvy


def dense_pass_reference(x: torch.Tensor, comm_radius, comm_radius2, centralized: bool = True,
                         mean_pooling: bool = True, obstacle_mask: torch.Tensor | None = None,
                         out=None):
    """The plain version of :func:`dense_pass`, with its contract; it also
    takes float64 and an ``obstacle_mask`` (as in :func:`pairwise_channels`;
    the centralized velocity sums are then the masked row sums)."""
    channels = pairwise_channels(x, obstacle_mask)
    adj = radius_adjacency(channels[4], comm_radius2)
    values = feature_sums(*channels, adj)
    network = mean_pool_normalize(adj) if mean_pooling else adj
    # decentralized velocity-consensus sums ARE feature channels 0/3
    sums = expert_sums(x, channels, adj, comm_radius, centralized, obstacle_mask is not None,
                       values[..., 0], values[..., 3])
    if out is not None:
        values, network = (None if slot is None else slot.copy_(v)
                           for slot, v in zip(out, (values, network)))
    return (values, network, *sums)


# ------------------------------------------------------------------ kernel


def _check_out(name: str, t: torch.Tensor, x: torch.Tensor, row: int) -> None:
    """``t`` must be a float32 ``[B, N, row]`` view on x's device whose rows
    are contiguous (any batch stride)."""
    b, n, _ = x.shape
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32 or t.device != x.device:
        raise TypeError(f"{name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != (b, n, row):
        raise ValueError(f"{name} must have shape {(b, n, row)}, got {tuple(t.shape)}")
    if b and n and ((row > 1 and t.stride(-1) != 1) or (n > 1 and t.stride(-2) != row)):
        raise ValueError(f"{name} must have contiguous [N, {row}] rows, got strides "
                         f"{tuple(t.stride())}")


def _launch(x, mask, comm_radius, comm_radius2, centralized, mean_pooling, values_out,
            network_out):
    global launches
    from gym_flock_tpu_torch.ops import _build

    b, n, _ = x.shape
    sums = torch.empty(b, n, 4, dtype=torch.float32, device=x.device)
    if b == 0 or n == 0:
        return sums
    # the library makes x's card current for the launch: a host cost of
    # microseconds a step, not torch.cuda.device's tens
    card = x.device.index
    rc = _build.load().gft_dense_pass(
        x.data_ptr(), 0 if mask is None else mask.data_ptr(), b, n, float(comm_radius),
        float(comm_radius2), int(bool(centralized)), int(bool(mean_pooling)),
        0 if values_out is None else values_out.data_ptr(),
        0 if values_out is None else values_out.stride(0),
        0 if network_out is None else network_out.data_ptr(),
        0 if network_out is None else network_out.stride(0),
        sums.data_ptr(), card, torch.cuda.current_stream(card).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K6 (dense_pass) launch failed: CUDA error {rc}")
    launches += 1
    return sums


def dense_pass_kernel(x: torch.Tensor, comm_radius, comm_radius2, centralized: bool = True,
                      mean_pooling: bool = True, obstacle_mask: torch.Tensor | None = None,
                      out=None):
    """The kernel: :func:`dense_pass` for a float32 CUDA ``x`` of at most
    :data:`MAX_AGENTS` agents; raises on anything else.  A non-contiguous or
    misaligned ``x`` is copied first."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x).__name__}")
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise TypeError(f"x must be float32 on a CUDA device (float64 runs on the CPU only), "
                        f"got {x.dtype} on {x.device}")
    if x.dim() != 3 or x.shape[-1] != 4 or x.shape[1] > MAX_AGENTS:
        raise ValueError(f"x must have shape [B, N <= {MAX_AGENTS}, 4], got {tuple(x.shape)}")
    b, n, _ = x.shape
    if obstacle_mask is not None:
        if (not isinstance(obstacle_mask, torch.Tensor) or obstacle_mask.dtype != torch.bool
                or tuple(obstacle_mask.shape) != (n,) or obstacle_mask.device != x.device):
            raise ValueError(f"obstacle_mask must be a bool [{n}] tensor on {x.device}")
        obstacle_mask = obstacle_mask.contiguous()
    if out is None:
        out = (x.new_empty(b, n, 6), x.new_empty(b, n, n))
    values_out, network_out = out
    if values_out is not None:
        _check_out("values_out", values_out, x, 6)
    if network_out is not None:
        _check_out("network_out", network_out, x, n)
    sums = _launch(float4_rows(x), obstacle_mask, comm_radius, comm_radius2, centralized,
                   mean_pooling, values_out, network_out)
    return (values_out, network_out, *sums.unbind(dim=-1))


def dense_pass(x: torch.Tensor, comm_radius, comm_radius2, centralized: bool = True,
               mean_pooling: bool = True, obstacle_mask: torch.Tensor | None = None, out=None):
    """``(values, network, s_gx, s_gy, s_dvx, s_dvy)`` at ``x [B, N, 4]``
    (module docstring): the kernel on a CUDA tensor, the plain version on
    a CPU one.

    ``obstacle_mask``: bool ``[N]`` (True = obstacle agent), shared by the
    batch, as in :func:`pairwise_channels`.  ``out``: ``None`` returns fresh
    ``values`` and ``network``; a pair ``(values_out, network_out)`` writes
    each into the given view (float32 ``[B,N,6]`` / ``[B,N,N]``, rows
    contiguous, any batch stride) and returns it, and an entry ``None`` is
    neither written nor returned (``None`` in its place)."""
    if x.device.type == "cuda":
        return dense_pass_kernel(x, comm_radius, comm_radius2, centralized, mean_pooling,
                                 obstacle_mask, out)
    return dense_pass_reference(x, comm_radius, comm_radius2, centralized, mean_pooling,
                                obstacle_mask, out)
