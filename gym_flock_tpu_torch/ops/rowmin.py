"""K5, the greedy coverage expert's row gather + packed min: the CUDA
kernel's wrapper, its plain PyTorch version and the operand layout
(counterpart of ``gym_flock_tpu/ops/rowmin.py``).

For each env b and robot r::

    m[b, r] = min_t  where(blocked[b, t], 1024, C[rowidx[b, r], t]) * 8192 + t

over the real columns t < T of the flattened ``[G*T, Tp]`` bf16 cost operand
(row ``g*T + cur``).  Costs are integers <= 256 with 1024 for unreachable and
T <= 8192, so every value is an integer below 2^24, exact in f32, and the min
is the first-index argmin packed with its cost.  Decode: ``loc = m mod
8192``; unreachable when ``(m - loc) / 8192 >= MAX_COST``.

The operand's rows are padded to Tp, a multiple of 64 bf16 (128-byte rows);
pad columns hold 1024 at indices >= T, which pack strictly above every real
column and never win.  The JAX package's sublane fold of the rows is a TPU
layout and is not ported.

Dispatch is by the device of the inputs: CPU tensors take the plain version,
CUDA tensors launch the kernel (``csrc/rowmin.cu``, built at first use) or
raise, any other device raises.
"""
from __future__ import annotations

import torch

__all__ = ["packed_greedy_min", "packed_greedy_min_reference", "pad_cost_rows"]

MULT = 8192.0
BLOCKED = 1024.0  # == coverage_graph._mm_cost_copy's unreachable sentinel
ROW_ALIGN = 64  # bf16 per padded row: a multiple of 64 is 128 bytes
MAX_T = 8192  # the packing's index range

launches = 0  # K5 kernel launches in this process; only _launch adds to it


def pad_cost_rows(mm: torch.Tensor) -> torch.Tensor:
    """``[G, T, T]`` costs -> the ``[G*T, Tp]`` bf16 operand, Tp = T rounded
    up to a multiple of 64, pad columns 1024."""
    if mm.dim() != 3 or mm.shape[1] != mm.shape[2]:
        raise ValueError(f"mm must be [G, T, T], got {tuple(mm.shape)}")
    g, t, _ = mm.shape
    tp = -(-t // ROW_ALIGN) * ROW_ALIGN
    out = torch.full((g * t, tp), BLOCKED, dtype=torch.bfloat16, device=mm.device)
    out[:, :t] = mm.reshape(g * t, t)
    return out


def packed_greedy_min_reference(
    rowidx: torch.Tensor, blocked: torch.Tensor, cost_rows_pad: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version of K5 (written like the JAX package's
    ``_rowmin_xla``): gather the rows, f32, mask, pack, min."""
    t = blocked.shape[-1]
    rows = cost_rows_pad[rowidx.long()][..., :t].float()  # [B, R, T]
    idx = torch.arange(t, dtype=torch.float32, device=rows.device)
    packed = torch.where(blocked[:, None, :], BLOCKED, rows) * MULT + idx
    return packed.amin(dim=-1)


def _check_inputs(rowidx, blocked, cost_rows_pad):
    for name, x, dtype in (("rowidx", rowidx, torch.int32), ("blocked", blocked, torch.bool),
                           ("cost_rows_pad", cost_rows_pad, torch.bfloat16)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rowidx.shape[0] != blocked.shape[0]:
        raise ValueError(f"batch sizes differ: {rowidx.shape[0]} and {blocked.shape[0]}")
    t, tp = blocked.shape[1], cost_rows_pad.shape[1]
    if not 1 <= t <= MAX_T:
        raise ValueError(f"T must be in [1, {MAX_T}], got {t}")
    if tp < t or tp % ROW_ALIGN:
        raise ValueError(f"cost rows must be padded to a multiple of {ROW_ALIGN} >= T={t}, "
                         f"got {tp}")
    if not rowidx.device == blocked.device == cost_rows_pad.device:
        raise ValueError(f"inputs on {rowidx.device}, {blocked.device} and "
                         f"{cost_rows_pad.device}")


def _launch(rowidx, blocked, cost_rows_pad):
    global launches
    from gym_flock_tpu_torch.ops import _build

    b, r = rowidx.shape
    t, tp = blocked.shape[1], cost_rows_pad.shape[1]
    out = torch.empty(b, r, dtype=torch.float32, device=rowidx.device)
    if b == 0 or r == 0:
        return out
    if cost_rows_pad.data_ptr() % 16:
        raise ValueError("cost_rows_pad must be 16-byte aligned")
    lib = _build.load()
    with torch.cuda.device(rowidx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gft_rowmin(
            rowidx.data_ptr(), blocked.data_ptr(), cost_rows_pad.data_ptr(),
            out.data_ptr(), b, r, t, tp, cost_rows_pad.shape[0], stream,
        )
    if rc != 0:
        raise RuntimeError(f"K5 (rowmin) launch failed: CUDA error {rc}")
    launches += 1
    return out


def packed_greedy_min(
    rowidx: torch.Tensor, blocked: torch.Tensor, cost_rows_pad: torch.Tensor
) -> torch.Tensor:
    """``[B, R]`` f32 packed minima (module docstring) from ``rowidx [B, R]``
    int32 rows of ``cost_rows_pad [G*T, Tp]`` bf16 and ``blocked [B, T]``
    bool.  A row index outside the operand raises on the CPU; the kernel
    writes NaN for it."""
    _check_inputs(rowidx, blocked, cost_rows_pad)
    device = rowidx.device.type
    if device == "cpu":
        return packed_greedy_min_reference(rowidx, blocked, cost_rows_pad)
    if device == "cuda":
        return _launch(rowidx, blocked, cost_rows_pad)
    raise ValueError(f"packed_greedy_min runs on cpu or cuda, not {device}")
