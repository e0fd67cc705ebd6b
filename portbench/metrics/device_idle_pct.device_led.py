"""In the cells whose step the device leads: the traced span's share in
which no operation ran on the device (the union of the kernels, copies and
sets in the profiler's trace)."""
from portbench import readers


def read(run):
    return readers.idle_pct(run)
