"""K3, the cell-list (block-sparse) flocking channel sums: the CUDA kernel's
wrapper, its plain PyTorch version and the pipeline around them
(counterpart of ``gym_flock_tpu/ops/sparse_flocking.py``).

Pipeline, batched over ``x [B, N, 4]`` with N a multiple of ``BLOCK``:
  1. ``hilbert_order``: sort the agents of each swarm along a Hilbert curve
     over cells of side ``comm_radius``, so that every run of 128 agents
     covers one compact patch.
  2. ``block_pair_table``: a row block lists the column blocks whose
     bounding box lies within reach of its own.  The bound is a lower bound
     on every pair's distance, so the pruning is exact.  The table is
     ``[B, n_b, k_max]`` int32, -1 pads; a row block with more than
     ``k_max`` candidates overflows its swarm.
  3. K3 (``sparse_sums_sorted``) sums K1's channels over the listed block
     pairs only, in sorted order; 4. the result is scattered back.

If any swarm of the batch overflows, the whole batch takes the dense K1
pass instead: one host ``if`` on one flag, as the JAX package's batch-wide
scalar ``lax.cond``.  That branch is the reference's semantics, not a
fallback from a failed kernel.

Channel sets of K3 (layout of ``ops.flocking_sums``): ``"core"`` is 0-8;
``"expert"`` adds 10/11 (adjacency-masked gradient sums) and leaves 9 at
zero; ``"full"`` also sets 9 = min r^2 over the listed pairs (the reset's
acceptance test only).

K4 (``sparse_adj_sorted``) is K2's GNN aggregation ``(A @ H, degree)`` over
the same kind of table; ``adjacency_matmul_sparse`` and
``khop_aggregate_sparse`` run it in agent order, differentiably, with the
dense K2 pass for a batch whose table overflows.

Dispatch is by the device of the input: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (``csrc/sparse_sums.cu`` and
``csrc/sparse_adj.cu``, built at first use) or raises, any other device
raises.  The plain versions take float32 or float64 and follow the input's
type; the kernels take float32 (K4's ``hs`` also bf16 or f16).
Non-contiguous or misaligned operands are copied first.
"""
from __future__ import annotations

import dataclasses

import torch

from gym_flock_tpu_torch.ops import adjacency_matmul as k2
from gym_flock_tpu_torch.ops import flocking_sums as k1
from gym_flock_tpu_torch.ops.flocking_sums import N_OUT, check_float_type, float4_rows
from gym_flock_tpu_torch.utils.profiling import host_bool

__all__ = [
    "BLOCK",
    "hilbert_order",
    "block_pair_table",
    "sparse_sums_sorted",
    "sparse_sums_sorted_reference",
    "launch_grid",
    "adj_launch_grid",
    "permute",
    "unsort",
    "flocking_sums_sparse",
    "VerletState",
    "verlet_build",
    "flocking_sums_sparse_verlet",
    "sparse_reset_accept",
    "sparse_adj_sorted",
    "sparse_adj_sorted_reference",
    "adjacency_matmul_sparse",
    "khop_aggregate_sparse",
]

BLOCK = 128
_HILBERT_BITS = 16
_SET_CODE = {"core": 0, "expert": 1, "full": 2}  # channel sets, as the kernel numbers them
_MAX_GRID_Y = 65535  # CUDA's limit on the batch axis of the kernel's grid
# pairs per chunk of the plain version: bounds each [B, rows, 128, 128] temporary
_CHUNK_PAIRS = 1 << 25

launches = 0  # K3 kernel launches in this process; only _launch adds to it
# proof of path for callers that check which kernel a pass took: passes
# that overflowed the table and ran on K1 instead, and Verlet rebuilds
overflow_passes = 0
verlet_rebuilds = 0
adj_launches = 0  # K4 kernel launches in this process; only _launch_adj adds to it
adj_backward_launches = 0  # those of them made for a backward pass
# adjacency passes (forward or backward) whose table overflowed, so that they
# ran on dense K2 instead of K4
adj_overflow_passes = 0


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def hilbert_order(x: torch.Tensor, cell) -> torch.Tensor:
    """``[B, N]`` permutation sorting each swarm's agents along a Hilbert
    curve over cells of side ``cell`` (``gym_flock_tpu/ops/sparse_flocking.py:93-123``).

    The cell index is ``floor(x / cell)`` in f32, shifted to start at 0 and
    clamped to 16 bits; the curve index d < 2^32 is formed in int64.  The
    sort is stable, as ``jnp.argsort`` is, so ties keep agent order.
    """
    q = torch.floor(x[..., :2] / _f32(cell, x.device)).to(torch.int64)
    q = q - q.amin(dim=-2, keepdim=True)
    q = q.clamp(max=(1 << _HILBERT_BITS) - 1)
    hx, hy = q[..., 0], q[..., 1]
    d = torch.zeros_like(hx)
    s = 1 << (_HILBERT_BITS - 1)
    while s > 0:
        rx = ((hx & s) > 0).to(torch.int64)
        ry = ((hy & s) > 0).to(torch.int64)
        d = d + s * s * ((3 * rx) ^ ry)
        # rotate the quadrant so the sub-curve's orientation matches
        swap = ry == 0
        flip = swap & (rx == 1)
        hx_f = torch.where(flip, s - 1 - hx, hx)
        hy_f = torch.where(flip, s - 1 - hy, hy)
        hx, hy = torch.where(swap, hy_f, hx_f), torch.where(swap, hx_f, hy_f)
        s //= 2
    return torch.argsort(d, dim=-1, stable=True)


def _reach2(comm_radius, skin, device) -> torch.Tensor:
    """Squared pruning reach ``(max(cr, sqrt(cr)) + skin)^2`` in f32, as the
    JAX package forms it: the gradient cutoff compares r^2 with the
    unsquared radius, so it reaches sqrt(cr) for radii below 1."""
    cr = _f32(comm_radius, device)
    reach = torch.maximum(cr, torch.sqrt(cr)) + _f32(skin, device)
    return reach * reach


def block_pair_table(xs: torch.Tensor, comm_radius, k_max: int, skin=0.0):
    """Candidate column blocks of each row block from bounding-box distance
    (``gym_flock_tpu/ops/sparse_flocking.py:126-164``).

    ``xs`` is ``[B, N, 4]`` curve-sorted.  Returns ``(table [B, n_b,
    min(n_b, k_max)] int32, overflow [B] bool)``: candidates compacted to
    the front of each row in block order, -1 pads.  ``skin`` widens the
    reach so the table stays a superset of the in-range block pairs while
    every agent stays within ``skin/2`` of where it was (Verlet slack).
    """
    b, n, _ = xs.shape
    n_b = n // BLOCK
    pos = xs[..., :2].reshape(b, n_b, BLOCK, 2)
    lo, hi = pos.amin(dim=2), pos.amax(dim=2)  # [B, n_b, 2]
    sep = torch.maximum(lo[:, :, None] - hi[:, None], lo[:, None] - hi[:, :, None])
    sep = sep.clamp(min=0.0)
    dist2 = (sep * sep).sum(dim=-1)  # [B, n_b, n_b]
    cand = dist2 <= _reach2(comm_radius, skin, xs.device)
    counts = cand.sum(dim=-1)
    overflow = (counts > k_max).any(dim=-1)
    order = torch.argsort((~cand).to(torch.int8), dim=-1, stable=True)
    slot = torch.arange(n_b, device=xs.device) < counts[..., None]
    packed = torch.where(slot, order, -1)[..., :k_max]
    return packed.to(torch.int32).contiguous(), overflow


# ----------------------------------------------------------------- K3


def sparse_sums_sorted_reference(
    xs: torch.Tensor, table: torch.Tensor, comm_radius, comm_radius2,
    channels: str = "core",
) -> torch.Tensor:
    """The plain PyTorch version of K3 on sorted operands: ``[B, N, 16]``.

    Follows ``_sparse_sums_sorted`` and ``_block_sums_tile``
    (``gym_flock_tpu/ops/sparse_flocking.py:167-246``): a loop over the
    table's slots, each gathering whole 128-agent column blocks; a pad slot
    adds nothing.  Self pairs are masked by sorted global id.  Pair terms
    are formed in f32 as the JAX kernel forms them; the sums accumulate in
    f64, as K1's plain version and the CUDA kernel do.  Row blocks are
    processed in chunks of at most ``_CHUNK_PAIRS`` pairs a slot.
    """
    b, n, _ = xs.shape
    n_b, k_max = n // BLOCK, table.shape[-1]
    dev = xs.device
    full = channels == "full"
    n_acc = 9 if channels == "core" else 11  # "expert"/"full": 0-8, 10, 11
    out = torch.zeros(b, n, N_OUT, dtype=xs.dtype, device=dev)
    xb = xs.reshape(b, n_b, BLOCK, 4)
    eye = torch.eye(BLOCK, dtype=torch.bool, device=dev)
    bidx = torch.arange(b, device=dev)[:, None]
    rows_per_chunk = max(1, _CHUNK_PAIRS // max(1, b * BLOCK * BLOCK))

    def total(t):
        return t.sum(dim=-1, dtype=torch.float64)

    for r0 in range(0, n_b, rows_per_chunk):
        r1 = min(n_b, r0 + rows_per_chunk)
        xr = xb[:, r0:r1]  # [B, r, 128, 4]
        acc = torch.zeros(b, r1 - r0, BLOCK, n_acc, dtype=torch.float64, device=dev)
        rmin = torch.full((b, r1 - r0, BLOCK), torch.inf, dtype=xs.dtype, device=dev)
        row_blk = torch.arange(r0, r1, device=dev)
        for s in range(k_max):
            j = table[:, r0:r1, s].long()  # [B, r]
            valid = (j >= 0)[..., None, None]
            xc = xb[bidx, j.clamp(min=0)]  # [B, r, 128, 4]
            dx = xr[..., 0, None] - xc[..., None, :, 0]
            dy = xr[..., 1, None] - xc[..., None, :, 1]
            dvx = xr[..., 2, None] - xc[..., None, :, 2]
            dvy = xr[..., 3, None] - xc[..., None, :, 3]
            r2 = dx * dx + dy * dy
            self_pair = (j == row_blk)[..., None, None] & eye
            r2 = torch.where(self_pair, torch.inf, r2)
            adj = (r2 < comm_radius2).to(xs.dtype)
            inv = 1.0 / r2
            inv2 = inv * inv
            gfac = torch.where(r2 > comm_radius, 0.0, 2.0 * inv * (1.0 - inv))
            chans = [
                total(dvx * adj), total(dx * inv2 * adj), total(dx * inv * adj),
                total(dvy * adj), total(dy * inv2 * adj), total(dy * inv * adj),
                total(dx * gfac), total(dy * gfac), total(adj),
            ]
            if channels != "core":
                chans += [total(dx * gfac * adj), total(dy * gfac * adj)]
            t = torch.stack(chans, dim=-1)
            acc = acc + torch.where(valid, t, 0.0)
            if full:
                rmin = torch.minimum(rmin, torch.where(valid[..., 0], r2.amin(dim=-1), torch.inf))
        o = out[:, r0 * BLOCK:r1 * BLOCK].view(b, r1 - r0, BLOCK, N_OUT)
        o[..., :9] = acc[..., :9].to(xs.dtype)
        if channels != "core":
            o[..., 10:12] = acc[..., 9:11].to(xs.dtype)
        if full:
            o[..., 9] = rmin
    return out


def _check_inputs(xs, table, channels):
    if channels not in _SET_CODE:
        raise ValueError(f"channels must be one of {tuple(_SET_CODE)}, got {channels!r}")
    if not isinstance(xs, torch.Tensor) or not isinstance(table, torch.Tensor):
        raise TypeError("xs and table must be torch.Tensors")
    check_float_type("xs", xs)
    if table.dtype != torch.int32:
        raise TypeError(f"table must be int32, got {table.dtype}")
    if xs.dim() != 3 or xs.shape[-1] != 4 or xs.shape[1] % BLOCK != 0:
        raise ValueError(f"xs must be [B, N, 4] with N a multiple of {BLOCK}, got "
                         f"{tuple(xs.shape)}")
    b, n, _ = xs.shape
    if table.dim() != 3 or table.shape[:2] != (b, n // BLOCK):
        raise ValueError(f"table must be [{b}, {n // BLOCK}, k], got {tuple(table.shape)}")
    if xs.device != table.device:
        raise ValueError(f"xs is on {xs.device}, table on {table.device}")


def _launch(xs, table, comm_radius, comm_radius2, channels):
    global launches
    from gym_flock_tpu_torch.ops import _build

    b, n, _ = xs.shape
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel grid's limit {_MAX_GRID_Y}")
    out = torch.empty(b, n, N_OUT, dtype=torch.float32, device=xs.device)
    if b == 0 or n == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gft_sparse_sums(
            xs.data_ptr(), table.data_ptr(), out.data_ptr(), b, n, table.shape[-1],
            float(comm_radius), float(comm_radius2), _SET_CODE[channels], stream,
        )
    if rc != 0:
        raise RuntimeError(f"K3 (sparse_sums) launch failed: CUDA error {rc}")
    launches += 1
    return out


def launch_grid(b: int, n: int, k_max: int) -> tuple:
    """``(blocks, threads a block, warps that split a row's listed blocks)``
    of K3's launch for ``b`` swarms of ``n`` agents and a table ``k_max``
    wide (chosen from the shape; needs the built library)."""
    import ctypes

    from gym_flock_tpu_torch.ops import _build

    grid = (ctypes.c_int * 3)()
    _build.load().gft_sparse_sums_grid(b, n, k_max, grid)
    return tuple(grid)


def sparse_sums_sorted(
    xs: torch.Tensor, table: torch.Tensor, comm_radius, comm_radius2,
    channels: str = "core",
) -> torch.Tensor:
    """K3: K1's channel sums over the block pairs that ``table`` lists.

    ``xs`` is ``[B, N, 4]`` f32 in curve order, ``table`` ``[B, n_b, k]``
    int32 with -1 pads (entries in ``[0, n_b)`` otherwise).  Returns ``[B,
    N, 16]`` in the same sorted order; channel sets in the module
    docstring.  The contract of ``_sparse_sums_pallas`` in the JAX package.
    """
    _check_inputs(xs, table, channels)
    xs, table = float4_rows(xs), table.contiguous()
    device = xs.device.type
    if device == "cpu":
        return sparse_sums_sorted_reference(xs, table, comm_radius, comm_radius2, channels)
    if device == "cuda":
        return _launch(xs, table, comm_radius, comm_radius2, channels)
    raise ValueError(f"sparse_sums_sorted runs on cpu or cuda, not {device}")


# ------------------------------------------------------------ pipeline


def permute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows in curve order: ``x[b, perm[b]]`` for every swarm b, contiguous."""
    return torch.gather(x, 1, perm[..., None].expand(-1, -1, x.shape[-1]))


def unsort(out_sorted: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows back to agent order: ``out[b, perm[b, i]] = out_sorted[b, i]``."""
    idx = perm[..., None].expand(-1, -1, out_sorted.shape[-1])
    return torch.empty_like(out_sorted).scatter_(1, idx, out_sorted)


def _check_sparse_channels(channels):
    if channels not in ("core", "expert"):
        # the dense kernels' vocabulary is {"core", "full"}; treating "full"
        # as core would zero the masked-gradient channels
        raise ValueError(f"sparse channels must be 'core' or 'expert', got {channels!r}")


def _dense_sums(x, comm_radius, comm_radius2, channels):
    """The overflow branch: K1 over every pair, in the sparse contract
    (``gym_flock_tpu/ops/sparse_flocking.py:390-403``)."""
    global overflow_passes
    overflow_passes += 1
    if channels == "core":
        return k1.flocking_sums(x, comm_radius, comm_radius2)
    out = k1.flocking_sums_block(x, x, 0, 0, comm_radius, comm_radius2, channels="full")
    out[..., 9] = 0.0  # min r^2 is not part of the sparse contract
    return out


def _sparse_or_dense(x, perm, table, overflow, comm_radius, comm_radius2, channels):
    if host_bool(overflow.any()):
        return _dense_sums(x, comm_radius, comm_radius2, channels)
    out = sparse_sums_sorted(permute(x, perm), table, comm_radius, comm_radius2, channels)
    return unsort(out, perm)


def _check_x(x):
    if x.dim() != 3 or x.shape[-1] != 4 or x.shape[1] % BLOCK != 0:
        raise ValueError(f"x must be [B, N, 4] with N a multiple of {BLOCK} (pad the "
                         f"swarm), got {tuple(x.shape)}")


def flocking_sums_sparse(
    x: torch.Tensor, comm_radius, comm_radius2, k_max: int = 16,
    channels: str = "core",
) -> torch.Tensor:
    """Cell-list ``ops.flocking_sums``: ``[B, N, 16]`` from ``x [B, N, 4]``.

    Sort, table, K3, scatter back (``gym_flock_tpu/ops/sparse_flocking.py:406-453``).
    Adjacency-masked sums are exact (the pruning is conservative); only the
    summation order differs from the dense pass.  If any swarm overflows
    ``k_max``, the whole batch runs on K1.
    """
    _check_sparse_channels(channels)
    _check_x(x)
    perm = hilbert_order(x, comm_radius)
    table, overflow = block_pair_table(permute(x, perm), comm_radius, k_max)
    return _sparse_or_dense(x, perm, table, overflow, comm_radius, comm_radius2, channels)


# -------------------------------------------------------------- Verlet


@dataclasses.dataclass(frozen=True)
class VerletState:
    """A Hilbert permutation and skin-widened candidate table built at
    ``anchor``; valid while every agent stays within ``skin/2`` of its
    anchor.  A stale permutation only makes blocks less compact: the kernel
    masks at ``comm_radius2`` itself, so the sums stay exact."""

    perm: torch.Tensor  # [B, N] int64, curve order at build time
    table: torch.Tensor  # [B, n_b, k] int32, -1 pads
    anchor: torch.Tensor  # [B, N, 2], positions at build time
    overflow: torch.Tensor  # [B] bool, table capacity exceeded at build time


def verlet_build(x: torch.Tensor, comm_radius, skin, k_max: int = 16) -> VerletState:
    """A :class:`VerletState` at ``x [B, N, 4]``
    (``gym_flock_tpu/ops/sparse_flocking.py:545-551``)."""
    _check_x(x)
    perm = hilbert_order(x, comm_radius)
    table, overflow = block_pair_table(permute(x, perm), comm_radius, k_max, skin=skin)
    return VerletState(perm, table, x[..., :2].clone(), overflow)


def flocking_sums_sparse_verlet(
    x: torch.Tensor, vstate: VerletState, comm_radius, comm_radius2, skin,
    channels: str = "core",
):
    """:func:`flocking_sums_sparse` through a table carried across calls;
    returns ``(sums [B, N, 16], vstate')``
    (``gym_flock_tpu/ops/sparse_flocking.py:554-614``).

    Every swarm of the batch is rebuilt when the batch's largest squared
    displacement from the anchors exceeds ``(skin/2)^2`` (compared in f32);
    then the overflow branch is taken as in :func:`flocking_sums_sparse`.
    Two host syncs a call: the rebuild test and the overflow test.
    """
    global verlet_rebuilds
    _check_sparse_channels(channels)
    _check_x(x)
    disp2 = ((x[..., :2] - vstate.anchor) ** 2).sum(dim=-1).amax()
    half = 0.5 * _f32(skin, x.device)
    if host_bool(disp2 > half * half):
        vstate = verlet_build(x, comm_radius, skin, k_max=vstate.table.shape[-1])
        verlet_rebuilds += 1
    out = _sparse_or_dense(x, vstate.perm, vstate.table, vstate.overflow,
                           comm_radius, comm_radius2, channels)
    return out, vstate


# --------------------------------------------------------------- reset


def sparse_reset_accept(
    x: torch.Tensor, comm_radius, comm_radius2, min_dist_thresh, k_max: int = 16,
) -> torch.Tensor:
    """``[B]`` acceptance of the rejection-sampling reset: min degree >= 2
    and min pairwise distance > ``min_dist_thresh``
    (``gym_flock_tpu/ops/sparse_flocking.py:1057-1193``), from K3's "full"
    channels 8 and 9.

    The table is built at ``max(comm_radius, min_dist_thresh)``, so every
    pair that adds degree or breaks the distance threshold is listed.  If
    the table overflows, the batch takes K1 "full" over every pair.
    Nothing ``[B, N, N]`` is materialised.
    """
    global overflow_passes
    _check_x(x)
    prune_r = torch.maximum(_f32(comm_radius, x.device), _f32(min_dist_thresh, x.device))
    perm = hilbert_order(x, comm_radius)
    xs = permute(x, perm)
    table, overflow = block_pair_table(xs, prune_r, k_max)
    if host_bool(overflow.any()):
        overflow_passes += 1
        s = k1.flocking_sums_block(x, x, 0, 0, comm_radius, comm_radius2, channels="full")
    else:
        s = sparse_sums_sorted(xs, table, comm_radius, comm_radius2, channels="full")
    return k1.reset_accepts(*k1.reset_minima(s), min_dist_thresh)


# ------------------------------------------------------------------ K4


def sparse_adj_sorted_reference(xs: torch.Tensor, hs: torch.Tensor, table: torch.Tensor,
                                comm_radius2):
    """The plain PyTorch version of K4 on sorted operands: ``(out [B, N, F]
    in hs's dtype, deg [B, N] f32)``.

    Follows ``_sparse_adj_xla`` (``gym_flock_tpu/ops/sparse_flocking.py:786-828``):
    a loop over the table's slots, each gathering whole 128-agent column
    blocks; a pad slot adds nothing, and the self pair is "same block, same
    lane".  The adjacency is formed in xs's type (f32 as the kernel forms
    it, or f64 on the CPU); the products accumulate in f64, as the CUDA
    kernel's do, and are rounded to f32 once unless hs is f64.
    """
    b, n, _ = xs.shape
    n_b, k_max, f = n // BLOCK, table.shape[-1], hs.shape[-1]
    dev = xs.device
    cr2 = torch.as_tensor(comm_radius2, dtype=xs.dtype, device=dev)
    pos = xs[..., :2].reshape(b, n_b, BLOCK, 2)
    hb = hs.to(torch.float64).reshape(b, n_b, BLOCK, f)
    eye = torch.eye(BLOCK, dtype=torch.bool, device=dev)
    bidx = torch.arange(b, device=dev)[:, None]
    row_blk = torch.arange(n_b, device=dev)
    out = torch.zeros(b, n_b, BLOCK, f, dtype=torch.float64, device=dev)
    deg = torch.zeros(b, n_b, BLOCK, dtype=torch.float32, device=dev)
    rows_per_chunk = max(1, _CHUNK_PAIRS // max(1, b * BLOCK * BLOCK))
    for r0 in range(0, n_b, rows_per_chunk):
        r1 = min(n_b, r0 + rows_per_chunk)
        pr = pos[:, r0:r1]  # [B, r, 128, 2]
        for s in range(k_max):
            j = table[:, r0:r1, s].long()  # [B, r]
            valid = (j >= 0)[..., None, None]
            jc = j.clamp(min=0)
            pc = pos[bidx, jc]  # [B, r, 128, 2]
            dx = pc[..., None, :, 0] - pr[..., 0, None]
            dy = pc[..., None, :, 1] - pr[..., 1, None]
            r2 = dx * dx + dy * dy
            self_pair = (j == row_blk[r0:r1])[..., None, None] & eye
            adj = (r2 < cr2) & ~self_pair & valid
            out[:, r0:r1] += torch.matmul(adj.to(torch.float64), hb[bidx, jc])
            deg[:, r0:r1] += adj.sum(dim=-1).to(torch.float32)
    out = out.reshape(b, n, f)
    if hs.dtype != torch.float64:
        out = out.to(torch.float32)
    return out.to(hs.dtype), deg.reshape(b, n)


def _check_adj_inputs(xs, hs, table):
    if not all(isinstance(t, torch.Tensor) for t in (xs, hs, table)):
        raise TypeError("xs, hs and table must be torch.Tensors")
    check_float_type("xs", xs)
    if not hs.is_floating_point() or (hs.dtype == torch.float64 and hs.device.type != "cpu"):
        raise TypeError(f"hs must be float32, bfloat16 or float16 (or float64 on the CPU), "
                        f"got {hs.dtype} on {hs.device}")
    if table.dtype != torch.int32:
        raise TypeError(f"table must be int32, got {table.dtype}")
    if xs.dim() != 3 or xs.shape[-1] != 4 or xs.shape[1] % BLOCK != 0:
        raise ValueError(f"xs must be [B, N, 4] with N a multiple of {BLOCK}, got "
                         f"{tuple(xs.shape)}")
    b, n, _ = xs.shape
    if hs.dim() != 3 or hs.shape[:2] != (b, n) or hs.shape[-1] == 0:
        raise ValueError(f"hs must be [{b}, {n}, F] with F >= 1, got {tuple(hs.shape)}")
    if table.dim() != 3 or table.shape[:2] != (b, n // BLOCK):
        raise ValueError(f"table must be [{b}, {n // BLOCK}, k], got {tuple(table.shape)}")
    if not xs.device == hs.device == table.device:
        raise ValueError(f"xs, hs and table lie on {xs.device}, {hs.device}, {table.device}")


def _launch_adj(xs, hs, table, comm_radius2, backward):
    global adj_launches, adj_backward_launches
    from gym_flock_tpu_torch.ops import _build

    b, n, _ = xs.shape
    f = hs.shape[-1]
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel grid's limit {_MAX_GRID_Y}")
    hs32 = hs if hs.dtype == torch.float32 else hs.to(torch.float32)
    out = torch.empty(b, n, f, dtype=torch.float32, device=xs.device)
    deg = torch.empty(b, n, dtype=torch.float32, device=xs.device)
    if b and n:
        lib = _build.load()
        with torch.cuda.device(xs.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gft_sparse_adj(
                xs.data_ptr(), hs32.data_ptr(), table.data_ptr(), out.data_ptr(),
                deg.data_ptr(), b, n, table.shape[-1], f, float(comm_radius2), stream,
            )
        if rc != 0:
            raise RuntimeError(f"K4 (sparse_adj) launch failed: CUDA error {rc}")
        adj_launches += k2.launches_for(f)
        adj_backward_launches += k2.launches_for(f) if backward else 0
    return out.to(hs.dtype), deg


def adj_launch_grid(b: int, n: int, k_max: int) -> tuple:
    """``(blocks, threads a block, warps that split a row's listed blocks)``
    of each of K4's launches (one for each chunk of 8 features) for ``b``
    swarms of ``n`` agents and a table ``k_max`` wide (chosen from the
    shape; needs the built library)."""
    import ctypes

    from gym_flock_tpu_torch.ops import _build

    grid = (ctypes.c_int * 3)()
    _build.load().gft_sparse_adj_grid(b, n, k_max, grid)
    return tuple(grid)


def _sparse_adj(xs, hs, table, comm_radius2, backward=False):
    _check_adj_inputs(xs, hs, table)
    xs, hs, table = float4_rows(xs), hs.contiguous(), table.contiguous()
    device = xs.device.type
    if device == "cpu":
        return sparse_adj_sorted_reference(xs, hs, table, comm_radius2)
    if device == "cuda":
        return _launch_adj(xs, hs, table, comm_radius2, backward)
    raise ValueError(f"sparse_adj_sorted runs on cpu or cuda, not {device}")


def sparse_adj_sorted(xs: torch.Tensor, hs: torch.Tensor, table: torch.Tensor, comm_radius2):
    """K4: ``(A @ hs, degree)`` over the block pairs that ``table`` lists.

    ``xs`` is ``[B, N, 4]`` f32 in curve order, ``hs`` ``[B, N, F]`` in the
    same order, ``table`` ``[B, n_b, k]`` int32 with -1 pads.  Returns
    ``(out [B, N, F] in hs's dtype, deg [B, N] f32)``, sorted.  The contract
    of ``_sparse_adj_pallas`` in the JAX package.
    """
    return _sparse_adj(xs, hs, table, comm_radius2)


def _adj_pass(x, h, perm, table, dense, comm_radius2, backward):
    """One raw ``(A(x) @ h, degree)`` in agent order: K4 through the table,
    or dense K2 over every pair where the table overflowed."""
    global adj_overflow_passes
    if dense:
        adj_overflow_passes += 1
        return k2._adj(x, x, h, 0, 0, comm_radius2, backward)
    out, deg = _sparse_adj(permute(x, perm), permute(h, perm), table, comm_radius2, backward)
    return unsort(out, perm), unsort(deg[..., None], perm)[..., 0]


class _AdjacencyMatmulSparse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, comm_radius2, mean_pool, k_max):
        # the table at cr = sqrt(cr2) in f32, as the JAX package builds it
        cr = torch.sqrt(_f32(comm_radius2, x.device))
        perm = hilbert_order(x, cr)
        table, overflow = block_pair_table(permute(x, perm), cr, k_max)
        dense = host_bool(overflow.any())
        out, deg = _adj_pass(x, h, perm, table, dense, comm_radius2, backward=False)
        ctx.args = (dense, comm_radius2)
        degc = torch.where(deg == 0, 1.0, deg)[..., None].to(out.dtype) if mean_pool else None
        ctx.save_for_backward(x, perm, table, degc)
        return out / degc if mean_pool else out

    @staticmethod
    def backward(ctx, dy):
        x, perm, table, degc = ctx.saved_tensors
        dense, comm_radius2 = ctx.args
        dh = None
        if ctx.needs_input_grad[1]:
            if degc is not None:
                dy = dy / degc
            # A and the candidate relation are symmetric: the forward's table
            # serves the transposed pass, dH = A dy
            dh, _ = _adj_pass(x, dy.contiguous(), perm, table, dense, comm_radius2,
                              backward=True)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        return dx, dh, None, None, None


def adjacency_matmul_sparse(x: torch.Tensor, h: torch.Tensor, comm_radius2,
                            mean_pool: bool = True, k_max: int = 16) -> torch.Tensor:
    """Cell-list ``ops.adjacency_matmul``: ``A(x) @ h`` over the listed block
    pairs only, ``x [B, N, 4]`` (N a multiple of 128), ``h [B, N, F]`` ->
    ``[B, N, F]`` in h's dtype (``gym_flock_tpu/ops/sparse_flocking.py:831-1031``).

    Sort, table at ``sqrt(comm_radius2)``, K4, scatter back; the pruning is
    exact, so only the summation order differs from the dense pass.  If any
    swarm overflows ``k_max``, the whole batch runs on dense K2 (one host
    ``if``; counted in ``adj_overflow_passes``).  Differentiable in ``h``:
    the backward reruns the same pass on ``dy`` (``dy / degc`` when
    mean-pooled); the positions get a zero gradient.
    """
    _check_x(x)
    return _AdjacencyMatmulSparse.apply(x.contiguous(), h.contiguous(), comm_radius2,
                                        mean_pool, k_max)


def khop_aggregate_sparse(x: torch.Tensor, features: torch.Tensor, comm_radius2, k_hops: int,
                          mean_pool: bool = True, k_max: int = 16) -> torch.Tensor:
    """``[X, AX, A^2 X, ...]`` through :func:`adjacency_matmul_sparse`: the
    input pipeline of ``models.LargeAggregationGNN`` on cell-list swarms
    (pass it as the model's ``aggregate_fn``)."""
    zs = [features]
    z = features
    for _ in range(k_hops - 1):
        z = adjacency_matmul_sparse(x, z, comm_radius2, mean_pool=mean_pool, k_max=k_max)
        zs.append(z)
    return torch.cat(zs, dim=-1)
