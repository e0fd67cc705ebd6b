"""K1, the flocking pairwise channel sums: the CUDA kernel's wrapper and its
plain PyTorch version (counterpart of ``gym_flock_tpu/ops/pallas_flocking.py``
``flocking_sums``, ``flocking_sums_block``, ``flocking_features_large`` and
``turner_controller_large``).

Channel layout of the ``[B, m, 16]`` output (unused channels are zero):
  0: sum adj*dvx        1: sum adj*dx/r^4   2: sum adj*dx/r^2
  3: sum adj*dvy        4: sum adj*dy/r^4   5: sum adj*dy/r^2
  6: sum grad_x         7: sum grad_y       8: degree (sum adj)
  "full" only:
  9: min r^2            10: sum adj*grad_x  11: sum adj*grad_y
adj = r^2 < comm_radius^2 over pairs of distinct global ids; the gradient
is cut off where r^2 > comm_radius (NOT squared; reference
flocking_relative.py:225).

The layout is read here only (``*_channels``, ``reset_minima``,
``combine_tiles``), and :func:`turner_action` owns the Turner expert's
action over its sums, whichever pass (K1, K3 or K6) made them.

Dispatch is by the device of the input: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (``csrc/block_sums.cu``, built at
first use) or raises, any other device raises.  The plain version takes
float32 or float64 and returns the input's type; the kernel takes float32
only.  A non-contiguous or misaligned input is copied first (the kernel
reads 16-byte rows).
"""
from __future__ import annotations

import torch

__all__ = [
    "N_OUT",
    "flocking_sums",
    "flocking_sums_block",
    "flocking_sums_block_reference",
    "flocking_features_large",
    "turner_controller_large",
    "turner_action", "velocity_diff_sums", "feature_channels", "expert_channels",
    "reset_minima", "reset_accepts", "combine_tiles",
    "launch_grid",
    "float4_rows",
]

N_OUT = 16
_CHANNELS = ("core", "full")
_N_CHANNELS = {"core": 9, "full": 12}
_MAX_GRID_Y = 65535  # CUDA's limit on the batch axis of the kernel's grid
# pairs per chunk of the plain version: bounds each [B, rows, k] temporary
_CHUNK_PAIRS = 1 << 25

launches = 0  # K1 kernel launches in this process; only _launch adds to it


def flocking_sums_block_reference(
    xr: torch.Tensor,
    xc: torch.Tensor,
    row_offset: int,
    col_offset: int,
    comm_radius,
    comm_radius2,
    channels: str = "full",
) -> torch.Tensor:
    """The plain PyTorch version of K1 (written like the JAX package's
    ``_flocking_sums_xla``, with global-id offsets and both channel sets).

    Pair terms are formed in f32 exactly as the JAX kernel forms them; the
    sums accumulate in f64, as the CUDA kernel's do.  Rows are processed in
    chunks so that no ``[B, rows, k]`` temporary exceeds ``_CHUNK_PAIRS``.
    """
    b, m, _ = xr.shape
    k = xc.shape[1]
    dtype, dev = xr.dtype, xr.device
    out = torch.zeros(b, m, N_OUT, dtype=dtype, device=dev)
    if k == 0:
        if channels == "full":
            out[..., 9] = torch.inf
        return out
    qx, qy, wx, wy = (xc[..., c][:, None, :] for c in range(4))  # [B, 1, k]
    col_ids = col_offset + torch.arange(k, device=dev)
    rows = max(1, _CHUNK_PAIRS // max(1, b * k))

    def total(t):
        return t.sum(dim=-1, dtype=torch.float64)

    for r0 in range(0, m, rows):
        xs = xr[:, r0:r0 + rows]
        r = xs.shape[1]
        dx = xs[..., 0, None] - qx
        dy = xs[..., 1, None] - qy
        dvx = xs[..., 2, None] - wx
        dvy = xs[..., 3, None] - wy
        r2 = dx * dx + dy * dy
        row_ids = row_offset + r0 + torch.arange(r, device=dev)
        r2 = torch.where(row_ids[:, None] == col_ids[None, :], torch.inf, r2)
        adj = (r2 < comm_radius2).to(dtype)
        inv = 1.0 / r2
        inv2 = inv * inv
        gfac = torch.where(r2 > comm_radius, 0.0, 2.0 * inv * (1.0 - inv))
        chans = [
            total(dvx * adj),
            total(dx * inv2 * adj),
            total(dx * inv * adj),
            total(dvy * adj),
            total(dy * inv2 * adj),
            total(dy * inv * adj),
            total(dx * gfac),
            total(dy * gfac),
            total(adj),
        ]
        if channels == "full":
            chans += [
                r2.amin(dim=-1).to(torch.float64),
                total(dx * gfac * adj),
                total(dy * gfac * adj),
            ]
        out[:, r0:r0 + r, :len(chans)] = torch.stack(chans, dim=-1).to(dtype)
    return out


def check_float_type(name: str, t: torch.Tensor) -> None:
    """float32, or float64 on the CPU only: the plain versions follow the
    input's type, the kernels are f32 and nothing casts silently."""
    allowed = (torch.float32, torch.float64) if t.device.type == "cpu" else (torch.float32,)
    if t.dtype not in allowed:
        where = "float32 or float64 on the CPU" if t.device.type == "cpu" else "float32"
        raise TypeError(f"{name} must be {where}, got {t.dtype} on {t.device}")


def float4_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if it is contiguous and 16-byte aligned, as the kernels
    read its ``[.., 4]`` rows, else a fresh contiguous copy (a view's
    ``.contiguous()`` keeps its offset)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_inputs(xr, xc, channels):
    if channels not in _CHANNELS:
        raise ValueError(f"channels must be one of {_CHANNELS}, got {channels!r}")
    for name, t in (("xr", xr), ("xc", xc)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        check_float_type(name, t)
        if t.dim() != 3 or t.shape[-1] != 4:
            raise ValueError(f"{name} must have shape [B, n, 4], got {tuple(t.shape)}")
    if xr.dtype != xc.dtype:
        raise TypeError(f"xr is {xr.dtype}, xc {xc.dtype}")
    if xr.shape[0] != xc.shape[0]:
        raise ValueError(f"batch sizes differ: {xr.shape[0]} and {xc.shape[0]}")
    if xr.device != xc.device:
        raise ValueError(f"xr is on {xr.device}, xc on {xc.device}")


def _launch(xr, xc, row_offset, col_offset, comm_radius, comm_radius2, channels):
    global launches
    from gym_flock_tpu_torch.ops import _build

    b, m, _ = xr.shape
    k = xc.shape[1]
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel grid's limit {_MAX_GRID_Y}")
    out = torch.empty(b, m, N_OUT, dtype=torch.float32, device=xr.device)
    if b == 0 or m == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gft_block_sums(
            xr.data_ptr(), xc.data_ptr(), out.data_ptr(), b, m, k,
            int(row_offset), int(col_offset), float(comm_radius),
            float(comm_radius2), int(channels == "full"), stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 (block_sums) launch failed: CUDA error {rc}")
    launches += 1
    return out


def launch_grid(b: int, m: int, k: int) -> tuple:
    """``(blocks, threads a block, warps that split a row's columns)`` of
    the kernel's launch for ``m`` rows against ``k`` columns in ``b`` swarms
    (chosen from the shape; needs the built library)."""
    import ctypes

    from gym_flock_tpu_torch.ops import _build

    grid = (ctypes.c_int * 3)()
    _build.load().gft_block_sums_grid(b, m, k, grid)
    return tuple(grid)


def flocking_sums_block(
    xr: torch.Tensor,
    xc: torch.Tensor,
    row_offset: int,
    col_offset: int,
    comm_radius,
    comm_radius2,
    channels: str = "full",
) -> torch.Tensor:
    """Row agents ``xr`` [B, m, 4] against column agents ``xc`` [B, k, 4]:
    ``[B, m, 16]`` channel sums (layout in the module docstring).

    ``row_offset``/``col_offset`` are the blocks' global agent ids, so the
    self-pair mask is a global-id equality: tiling rows against column blocks
    and combining (channel 9 by ``min``, the others by ``+``) reproduces the
    whole-swarm result.  ``channels="core"`` computes channels 0-8,
    ``"full"`` adds 9-11.
    """
    _check_inputs(xr, xc, channels)
    symmetric = xc is xr
    xr = float4_rows(xr)
    xc = xr if symmetric else float4_rows(xc)
    device = xr.device.type
    if device == "cpu":
        return flocking_sums_block_reference(
            xr, xc, row_offset, col_offset, comm_radius, comm_radius2, channels
        )
    if device == "cuda":
        return _launch(
            xr, xc, row_offset, col_offset, comm_radius, comm_radius2, channels
        )
    raise ValueError(f"flocking_sums_block runs on cpu or cuda, not {device}")


def flocking_sums(x: torch.Tensor, comm_radius, comm_radius2) -> torch.Tensor:
    """All of one swarm's pairs, "core" channels: ``[B, N, 16]``."""
    return flocking_sums_block(x, x, 0, 0, comm_radius, comm_radius2, channels="core")


def feature_channels(s: torch.Tensor):
    """``(state_values [B,m,6], degree [B,m])``: channels 0-5 and 8 of ``s``."""
    return s[..., 0:6], s[..., 8]


def velocity_diff_sums(x: torch.Tensor, v_sum: torch.Tensor | None = None, n=None):
    """``(s_dvx, s_dvy)`` ``[B, m]``: sum_j (v_i - v_j) = N v_i - sum_j v_j
    at the rows ``x [B, m, 4]``; a split swarm's block passes the swarm's
    velocity total ``v_sum [B, 2]`` and size ``n``, else x's own are used."""
    if v_sum is None:
        n = x.shape[-2]
        tx, ty = x[..., 2].sum(dim=-1, keepdim=True), x[..., 3].sum(dim=-1, keepdim=True)
    else:
        tx, ty = v_sum[..., 0:1], v_sum[..., 1:2]
    return n * x[..., 2] - tx, n * x[..., 3] - ty


def expert_channels(s: torch.Tensor, x: torch.Tensor, centralized: bool,
                    v_sum: torch.Tensor | None = None, n=None):
    """``(s_gx, s_gy, s_dvx, s_dvy)`` of the Turner expert at the rows ``x``
    from their sums ``s``.  Centralized: the cutoff gradient sums 6/7 and
    the velocity term by :func:`velocity_diff_sums` (``v_sum``, ``n`` as
    there).  Decentralized (reference flocking_relative.py:201-207), both
    terms masked by the adjacency: 10/11 of the "full" set and 0/3."""
    if centralized:
        return (s[..., 6], s[..., 7], *velocity_diff_sums(x, v_sum, n))
    return s[..., 10], s[..., 11], s[..., 0], s[..., 3]


def turner_action(s_gx, s_gy, s_dvx, s_dvy, action_scalar) -> torch.Tensor:
    """The Turner expert's ``[B, m, 2]`` action from its four sums
    (reference flocking_relative.py:208-211): ``-(sum grad + sum dv)``,
    clipped to [-10, 10], over ``action_scalar``."""
    controls = torch.stack((-s_gx - s_dvx, -s_dvy - s_gy), dim=-1)
    return controls.clamp(-10.0, 10.0) / action_scalar


def reset_minima(s: torch.Tensor):
    """``(min degree [B], min r^2 [B])`` over each swarm's rows of the
    "full" sums ``s``: channels 8 and 9."""
    return s[..., 8].amin(dim=-1), s[..., 9].amin(dim=-1)


def reset_accepts(min_degree, min_r2, min_dist_thresh, inclusive: bool = False):
    """``[B]`` reset acceptance (reference flocking_relative.py:164): min
    degree >= 2, min distance > ``min_dist_thresh`` (``>=`` if ``inclusive``)."""
    min_dist = torch.sqrt(min_r2)
    near_ok = min_dist >= min_dist_thresh if inclusive else min_dist > min_dist_thresh
    return (min_degree >= 2) & near_ok


def combine_tiles(parts):
    """One row block's ``[B, m, 16]`` sums from its tiles against column
    blocks, in order: channel 9 (min r^2) by ``min``, the others by ``+``."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    if len(parts) > 1:
        acc[..., 9] = torch.stack([q[..., 9] for q in parts]).amin(dim=0)
    return acc


def flocking_features_large(x: torch.Tensor, comm_radius, comm_radius2):
    """``(state_values [B,N,6], degree [B,N])`` without any [N, N] array."""
    return feature_channels(flocking_sums(x, comm_radius, comm_radius2))


def turner_controller_large(
    x: torch.Tensor,
    comm_radius,
    comm_radius2,
    action_scalar,
    centralized: bool = True,
) -> torch.Tensor:
    """Turner expert through K1: ``[B, N, 2]`` actions from the "core"
    sums when centralized, else the "full" set (:func:`expert_channels`)."""
    s = flocking_sums_block(x, x, 0, 0, comm_radius, comm_radius2,
                            channels="core" if centralized else "full")
    return turner_action(*expert_channels(s, x, centralized), action_scalar)
