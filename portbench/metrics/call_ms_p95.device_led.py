"""The 95th percentile of the latency of every call the window drove, in
the cells whose step the device leads: as ``call_ms_p95``, under a name of
its own so that its bound holds only these cells."""
from portbench.harness import percentile


def read(run):
    return percentile(run.window.latencies_ms, 95.0)
