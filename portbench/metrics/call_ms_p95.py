"""The 95th percentile of the latency of every call the window drove: a
pair of CUDA events around the call, the second recorded once the call has
returned, read after a synchronisation (the device's clock; a call's host
work before its first kernel falls inside, as the stream is idle)."""
from portbench.harness import percentile


def read(run):
    return percentile(run.window.latencies_ms, 95.0)
