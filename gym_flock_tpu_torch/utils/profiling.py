"""Profiling helpers (counterpart of ``gym_flock_tpu/utils/profiling.py``):
a ``torch.profiler`` trace, a step rate timed with CUDA events on the card
(with the host clock on the CPU), and the env paths' own instrumentation:
named spans that appear in a trace only while a profiler runs, and a count
of the host's reads of device values."""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator

import torch

__all__ = ["trace", "measure_steps_per_second", "span", "host_bool"]

# host reads of device values on the env paths in this process; only
# host_bool adds to it
syncs = 0

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs (the
    span then shares the device trace's clock), else a shared no-op context:
    off, a span costs one flag read, no sync and no device allocation."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def host_bool(t: torch.Tensor) -> bool:
    """``bool(t)`` for a host decision on a device value, which waits for
    the device: counted in ``syncs`` and traced as the span ``gft.sync``."""
    global syncs
    syncs += 1
    with span("gft.sync"):
        return bool(t)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the CPU and, where there is a card, CUDA;
    writes a Chrome trace under ``log_dir`` on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof


def measure_steps_per_second(
    run: Callable[[int], object],
    n_steps_per_call: int,
    iters: int = 3,
    warmup: bool = True,
    device="cuda",
) -> float:
    """Steps a second of ``run(seed)``, a call that does ``n_steps_per_call``
    steps, over ``iters`` calls after a warm-up call.  On a CUDA ``device``
    the time is a pair of CUDA events around the calls (the work queued on
    the current stream); on the CPU, the host clock."""
    if warmup:
        run(0)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            run(i + 1)
        stop.record()
        stop.synchronize()
        seconds = start.elapsed_time(stop) / 1e3
    else:
        t0 = time.perf_counter()
        for i in range(iters):
            run(i + 1)
        seconds = time.perf_counter() - t0
    return n_steps_per_call * iters / seconds
