"""Frozen counts of the work of K5, the greedy coverage expert's packed row
minimum, and the least time one NVIDIA H100 could take for it (the bound of
``counts.bound_s``).

Each robot gathers one row of the ``t`` real bf16 costs by its row index
from one table of ``g * t`` rows shared by every world, so the least bytes
read each distinct row once: at most ``min(b * r, g * t)`` rows.  Each
world's ``t`` blocked flags (bool) are read once, each robot's row index
(int32) read and its packed minimum (float32) written once; two operations
an element (the masked select and the minimum), for every robot.
"""
from __future__ import annotations

from portbench.work.counts import F32, bound_s

BF16 = 2
I32 = 4
BOOL = 1
OPS_PER_ELEMENT = 2


def rowmin_work(b: int, r: int, t: int, g: int):
    """``(flops, bytes)`` of one K5 launch over ``b`` worlds of ``r`` robots
    and ``t`` targets, on a table of ``g`` graphs."""
    return (OPS_PER_ELEMENT * b * r * t,
            min(b * r, g * t) * t * BF16 + b * t * BOOL + b * r * (I32 + F32))


def rowmin_bound_s(b: int, r: int, t: int, g: int):
    """``(seconds, "operations" | "bytes")``: the least time of one launch."""
    return bound_s(*rowmin_work(b, r, t, g))
