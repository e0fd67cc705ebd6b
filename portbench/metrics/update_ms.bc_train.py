"""The GNN update's device milliseconds a call: the median, over the
window's calls that ran without the profiler, of the time between the CUDA
event the cell records after the collect is queued and the one it records
after the update is queued (the update's forward, backward and Adam step,
with any wait for the host inside it).  Nothing without a card."""
import statistics


def read(run):
    half_ms = getattr(run.cell, "half_ms", None)
    ms = half_ms("update") if half_ms is not None else None
    return statistics.median(ms) if ms else None
