"""Shared arithmetic of the metric readers (``metrics/<name>.py``): each
reader is a few lines over these.  A reader returns ``None`` where it finds
nothing to read, and the harness then leaves its metric out of the line.
"""
from __future__ import annotations

from typing import Optional

import torch

from portbench.work import counts


def on_card(run) -> bool:
    return run.device.startswith("cuda")


def idle_pct(run) -> Optional[float]:
    """The traced span's share with no device operation running."""
    t = run.trace
    if not t or not t.get("busy_s") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def launches_per_unit(run) -> Optional[float]:
    """Kernels in the traced span over the units of work it completed."""
    t = run.trace
    if not t or not t.get("busy_s") or not t.get("units"):
        return None
    return t["kernels"] / t["units"]


def window_s_per_unit(run, unit: str) -> Optional[float]:
    """Seconds a unit of work took over the window's calls that ran without
    the profiler."""
    w = run.window
    n = w.total(unit, traced=False)
    return w.untraced_seconds() / n if n else None


def share_pct(flops: float, nbytes: float, seconds: Optional[float]) -> Optional[float]:
    """The least time for the work over the time it took, in percent."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * counts.bound_s(flops, nbytes)[0] / seconds


def pair_counts(run, x: torch.Tensor):
    p = run.config["params"]
    return counts.pair_counts(x, p["comm_radius"], p["comm_radius"] ** 2)
