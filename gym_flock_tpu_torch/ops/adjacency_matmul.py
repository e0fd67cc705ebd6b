"""K2, the GNN aggregation ``A(x) @ H`` with the radius adjacency built on the
fly: the CUDA kernel's wrapper, its plain PyTorch version and the
differentiable functions around them (counterpart of
``gym_flock_tpu/ops/pallas_flocking.py:488-807``).

``A(xr, xc)[i, j] = r2 < comm_radius2`` over pairs of distinct global ids
(``row_offset + i`` and ``col_offset + j``), with ``r2`` formed in f32 from
``dx = xc - xr`` as the JAX kernel forms it.  No ``[B, N, N]`` adjacency
exists on the kernel's path.  The kernel returns the raw ``(A @ H, degree)``;
mean pooling divides outside it by ``degc = where(deg == 0, 1, deg)``.

Gradients (``torch.autograd.Function``): the adjacency is a step function of
the positions, so they get a zero gradient; ``dH = A(xc, xr) @ d_out`` for
the block form (the same kernel with operands and offsets swapped), and
``dH = A (dy / degc)`` (``A dy`` without pooling) for the symmetric one.

Dispatch is by the device of the input: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (``csrc/adj_matmul.cu``, built at
first use) or raises, any other device raises.  The kernel reads positions
as 16-byte ``[.., 4]`` rows: the main path's ``[B, N, 4]`` state goes as it
is, other widths are packed into such rows first.
"""
from __future__ import annotations

import torch

# CUDA's limit on a grid's y axis (the batch here), and the pairs per chunk
# of the plain version, as K1's
from gym_flock_tpu_torch.ops.flocking_sums import _CHUNK_PAIRS, _MAX_GRID_Y, float4_rows

__all__ = [
    "adjacency_matmul_block_reference",
    "adjacency_matmul_block",
    "adjacency_matmul",
    "khop_aggregate",
    "launch_grid",
    "launches_for",
]

FEATURES_A_LAUNCH = 8  # csrc/adj_matmul.cu's kFeat: one launch a chunk of 8 features
launches = 0  # K2 kernel launches in this process; only _launch adds to it
backward_launches = 0  # those of them made for a backward pass


def launches_for(f: int) -> int:
    """Kernel launches of one K2 or K4 call over ``f`` features."""
    return -(-f // FEATURES_A_LAUNCH)


def adjacency_matmul_block_reference(
    xr: torch.Tensor,
    xc: torch.Tensor,
    h: torch.Tensor,
    row_offset: int,
    col_offset: int,
    comm_radius2,
):
    """The plain PyTorch version of K2: ``(out [B, m, F] in h's dtype, deg
    [B, m] f32)`` for rows ``xr [B, m, >=2]`` against columns ``xc [B, k,
    >=2]`` and ``h [B, k, F]``.

    The adjacency is formed in f32 as the JAX kernel forms it; the products
    accumulate in f64, as the CUDA kernel's do, and are rounded to f32 once.
    Rows are processed in chunks so that no ``[B, rows, k]`` temporary
    exceeds ``_CHUNK_PAIRS``.
    """
    b, m, _ = xr.shape
    k, f = xc.shape[1], h.shape[-1]
    dev = xr.device
    out = torch.zeros(b, m, f, dtype=torch.float64, device=dev)
    deg = torch.zeros(b, m, dtype=torch.float32, device=dev)
    if k and m:
        cr2 = torch.as_tensor(comm_radius2, dtype=torch.float32, device=dev)
        qx, qy = xc[..., 0][:, None, :], xc[..., 1][:, None, :]  # [B, 1, k]
        col_ids = col_offset + torch.arange(k, device=dev)
        h64 = h.to(torch.float64)
        rows = max(1, _CHUNK_PAIRS // max(1, b * k))
        for r0 in range(0, m, rows):
            xs = xr[:, r0:r0 + rows]
            r = xs.shape[1]
            dx = qx - xs[..., 0, None]
            dy = qy - xs[..., 1, None]
            r2 = dx * dx + dy * dy
            row_ids = row_offset + r0 + torch.arange(r, device=dev)
            adj = (r2 < cr2) & (row_ids[:, None] != col_ids[None, :])
            out[:, r0:r0 + r] = torch.matmul(adj.to(torch.float64), h64)
            deg[:, r0:r0 + r] = adj.sum(dim=-1).to(torch.float32)
    return out.to(torch.float32).to(h.dtype), deg


def _check_inputs(xr, xc, h):
    for name, t in (("xr", xr), ("xc", xc), ("h", h)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [B, n, *], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("xr", xr), ("xc", xc)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape[-1] < 2:
            raise ValueError(f"{name} must hold positions in columns 0 and 1, got "
                             f"{tuple(t.shape)}")
    if not h.is_floating_point() or h.dtype == torch.float64:
        raise TypeError(f"h must be float32, bfloat16 or float16, got {h.dtype}")
    if h.shape[-1] == 0:
        raise ValueError("h has no feature columns")
    if not xr.shape[0] == xc.shape[0] == h.shape[0]:
        raise ValueError(f"batch sizes differ: {xr.shape[0]}, {xc.shape[0]}, {h.shape[0]}")
    if h.shape[1] != xc.shape[1]:
        raise ValueError(f"h has {h.shape[1]} rows for {xc.shape[1]} column agents")
    if not xr.device == xc.device == h.device:
        raise ValueError(f"xr, xc and h lie on {xr.device}, {xc.device}, {h.device}")


def _position_rows(t):
    """``[B, n, 4]`` f32 rows, 16-byte aligned, with the positions of ``t
    [B, n, >=2]`` in columns 0 and 1: ``t`` itself when it is such a
    tensor."""
    if t.shape[-1] == 4:
        return float4_rows(t)
    rows = torch.zeros(t.shape[:-1] + (4,), dtype=torch.float32, device=t.device)
    rows[..., :2] = t[..., :2]
    return rows


def _launch(xr, xc, h, row_offset, col_offset, comm_radius2, backward):
    global launches, backward_launches
    from gym_flock_tpu_torch.ops import _build

    b, m, _ = xr.shape
    k, f = xc.shape[1], h.shape[-1]
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the kernel grid's limit {_MAX_GRID_Y}")
    h32 = h if h.dtype == torch.float32 else h.to(torch.float32)
    out = torch.empty(b, m, f, dtype=torch.float32, device=xr.device)
    deg = torch.empty(b, m, dtype=torch.float32, device=xr.device)
    if b and m:
        rows = _position_rows(xr)
        cols = rows if xc is xr else _position_rows(xc)
        lib = _build.load()
        with torch.cuda.device(xr.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gft_adj_matmul(
                rows.data_ptr(), cols.data_ptr(), h32.data_ptr(), out.data_ptr(),
                deg.data_ptr(), b, m, k, f, int(row_offset), int(col_offset),
                float(comm_radius2), stream,
            )
        if rc != 0:
            raise RuntimeError(f"K2 (adj_matmul) launch failed: CUDA error {rc}")
        launches += launches_for(f)
        backward_launches += launches_for(f) if backward else 0
    return out.to(h.dtype), deg


def launch_grid(b: int, m: int, k: int) -> tuple:
    """``(blocks, threads a block, warps that split a row's columns)`` of
    each of the kernel's launches (one for each chunk of 8 features) for
    ``m`` rows against ``k`` columns in ``b`` swarms (chosen from the shape;
    needs the built library)."""
    import ctypes

    from gym_flock_tpu_torch.ops import _build

    grid = (ctypes.c_int * 3)()
    _build.load().gft_adj_matmul_grid(b, m, k, grid)
    return tuple(grid)


def _adj(xr, xc, h, row_offset, col_offset, comm_radius2, backward=False):
    """The raw ``(A(xr, xc) @ h, degree)`` on the input's device."""
    _check_inputs(xr, xc, h)
    device = xr.device.type
    if device == "cpu":
        return adjacency_matmul_block_reference(xr, xc, h, row_offset, col_offset,
                                                comm_radius2)
    if device == "cuda":
        return _launch(xr, xc, h, row_offset, col_offset, comm_radius2, backward)
    raise ValueError(f"adjacency_matmul runs on cpu or cuda, not {device}")


def _zero_grad(ctx, index, t):
    """The a.e. gradient of a step function of ``t``: zeros, where asked for."""
    return torch.zeros_like(t) if ctx.needs_input_grad[index] else None


class _AdjacencyMatmulBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xr, xc, h, row_offset, col_offset, comm_radius2):
        out, deg = _adj(xr, xc, h, row_offset, col_offset, comm_radius2)
        ctx.save_for_backward(xr, xc)
        ctx.args = (row_offset, col_offset, comm_radius2)
        ctx.mark_non_differentiable(deg)
        return out, deg

    @staticmethod
    def backward(ctx, d_out, _d_deg):
        xr, xc = ctx.saved_tensors
        row_offset, col_offset, comm_radius2 = ctx.args
        dh = None
        if ctx.needs_input_grad[2]:
            # A(xr, xc)^T is the swapped block A(xc, xr): global-id masking commutes
            dh, _ = _adj(xc, xr, d_out.contiguous(), col_offset, row_offset, comm_radius2,
                         backward=True)
        return (_zero_grad(ctx, 0, xr), _zero_grad(ctx, 1, xc), dh, None, None, None)


def adjacency_matmul_block(
    xr: torch.Tensor,
    xc: torch.Tensor,
    h: torch.Tensor,
    row_offset: int,
    col_offset: int,
    comm_radius2,
):
    """K2: ``(A(xr, xc) @ h, degree)`` for rows ``xr [B, m, >=2]`` against the
    column block ``xc [B, k, >=2]``, ``h [B, k, F]``; ``out`` is ``[B, m, F]``
    in h's dtype, ``deg`` ``[B, m]`` f32.

    ``row_offset``/``col_offset`` are the blocks' global agent ids, so the
    self-pair mask is a global-id equality and partial tiles sum to the
    whole swarm's product.  Differentiable in ``h``: the transposed tile is
    the swapped block, one more run of the same kernel.
    """
    return _AdjacencyMatmulBlock.apply(xr.contiguous(), xc.contiguous(), h.contiguous(),
                                       row_offset, col_offset, comm_radius2)


class _AdjacencyMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, comm_radius2, mean_pool):
        out, deg = _adj(x, x, h, 0, 0, comm_radius2)
        ctx.comm_radius2 = comm_radius2
        if not mean_pool:
            ctx.save_for_backward(x)
            return out
        degc = torch.where(deg == 0, 1.0, deg)[..., None].to(out.dtype)
        ctx.save_for_backward(x, degc)
        return out / degc

    @staticmethod
    def backward(ctx, dy):
        x, *degc = ctx.saved_tensors
        dh = None
        if ctx.needs_input_grad[1]:
            if degc:
                dy = dy / degc[0]
            # A is symmetric: dH = A dy (A (dy / degc) when mean-pooled)
            dh, _ = _adj(x, x, dy.contiguous(), 0, 0, ctx.comm_radius2, backward=True)
        return _zero_grad(ctx, 0, x), dh, None, None


def adjacency_matmul(x: torch.Tensor, h: torch.Tensor, comm_radius2, mean_pool: bool = True):
    """``A(x) @ h`` over one swarm per batch row: ``x [B, N, >=2]``, ``h [B,
    N, F]`` -> ``[B, N, F]`` in h's dtype; with ``mean_pool`` each row is
    divided by its degree (1 where it is 0), as ``mean_pool_normalize``
    pools the dense adjacency.  Differentiable in ``h`` (one more kernel
    pass); the positions get a zero gradient."""
    return _AdjacencyMatmul.apply(x.contiguous(), h.contiguous(), comm_radius2, mean_pool)


def khop_aggregate(
    x: torch.Tensor, features: torch.Tensor, comm_radius2, k_hops: int, mean_pool: bool = True
) -> torch.Tensor:
    """``[X, AX, A^2 X, ...]`` side by side, ``[B, N, k_hops * F]``: the
    input pipeline of ``models.LargeAggregationGNN`` (A is never
    materialised)."""
    zs = [features]
    z = features
    for _ in range(k_hops - 1):
        z = adjacency_matmul(x, z, comm_radius2, mean_pool=mean_pool)
        zs.append(z)
    return torch.cat(zs, dim=-1)
