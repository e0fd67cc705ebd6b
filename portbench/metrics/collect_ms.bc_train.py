"""The collect's device milliseconds a call: the median, over the window's
calls that ran without the profiler, of the time between the CUDA event the
cell records as the call starts and the one it records after the collect
is queued (the reset and the greedy-expert steps, with the host's waits
inside).  Nothing without a card."""
import statistics


def read(run):
    half_ms = getattr(run.cell, "half_ms", None)
    ms = half_ms("collect") if half_ms is not None else None
    return statistics.median(ms) if ms else None
