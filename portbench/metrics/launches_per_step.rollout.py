"""Kernels in the traced span over the env-steps it completed."""
from portbench import readers


def read(run):
    return readers.launches_per_unit(run)
