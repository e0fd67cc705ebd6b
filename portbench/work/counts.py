"""Frozen counts of the operations and bytes the flocking work needs, and
the least time one NVIDIA H100 could take for them.

Copied from ``chip_smoke.py`` (``F32_FLOPS``, ``HBM_BYTES``,
``PAIR_TEST_FLOPS``, ``PAIR_BODY_FLOPS``, ``bound``, ``k1_pair_counts``)
so that a later change to the program cannot move the yardstick.  Counts follow the algorithm, not an implementation: each
input byte read once, each output byte written once; where the work depends
on the data (the pairs within reach), it is counted on the data.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, at the full 700 W: float32 outside the tensor
# cores (TF32 stays off in the program), and HBM3
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# flops of the pair test (every pair) and of the body of a pair within reach
# (r2 < cr**2 or r2 <= cr): the divide, the terms, the sums
PAIR_TEST_FLOPS = 5
PAIR_BODY_FLOPS = 30
F32 = 4


def bound_s(flops: float, nbytes: float):
    """``(seconds, "operations" | "bytes")``: the least time for the work."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def pair_counts(x: torch.Tensor, comm_radius: float, comm_radius2: float):
    """``(pairs, pairs within reach, neighbour pairs)`` of all the distinct
    pairs of each swarm of ``x [B,N,>=2]``: within reach is ``r2 < cr**2``
    or ``not r2 > cr``, a neighbour ``r2 < cr**2``; r2 in float32."""
    b, n, _ = x.shape
    x = x.float()
    rows = max(1, (1 << 25) // max(1, b * n))
    col = torch.arange(n, device=x.device)
    hits = neighbours = 0
    for r0 in range(0, n, rows):
        xs = x[:, r0:r0 + rows]
        dx = xs[..., 0, None] - x[:, None, :, 0]
        dy = xs[..., 1, None] - x[:, None, :, 1]
        r2 = dx * dx + dy * dy
        other = (r0 + torch.arange(xs.shape[1], device=x.device))[:, None] != col
        near = (r2 < comm_radius2) & other
        hits += int(((near | ~(r2 > comm_radius)) & other).sum())
        neighbours += int(near.sum())
    return b * n * (n - 1), hits, neighbours


def pair_sums_work(b: int, n: int, pairs: int, hits: int, n_out: int = 16):
    """``(flops, bytes)`` of one pass of the pair sums over ``b`` swarms of
    ``n``: the test on every pair, the body on those within reach; the state
    read once, ``n_out`` float32 channels a row written once."""
    return (PAIR_TEST_FLOPS * pairs + PAIR_BODY_FLOPS * hits,
            b * n * 4 * F32 + b * n * n_out * F32)


def dense_pass_work(b: int, n: int, pairs: int, hits: int, observation: bool = True):
    """``(flops, bytes)`` of one dense pass (K6) over ``b`` swarms of ``n``:
    the test on every pair, the body on those within reach; the state read
    once, the expert's four sums a row written once and, with
    ``observation``, the six features and the ``n`` network entries of a
    row written once too."""
    return pair_sums_work(b, n, pairs, hits, n_out=4 + (6 + n if observation else 0))


def env_step_work(b: int, n: int, pairs: int, hits: int, dense_network: bool):
    """``(flops, bytes)`` of one expert env-step of ``b`` swarms: one pass of
    the pair sums, the state read and written, and the step's trajectory
    written (action, six features, the network, the reward)."""
    flops = PAIR_TEST_FLOPS * pairs + PAIR_BODY_FLOPS * hits
    network = b * n * n if dense_network else b * n
    nbytes = 2 * b * n * 4 * F32 + (b * n * (2 + 6) + network + b) * F32
    return flops, nbytes
