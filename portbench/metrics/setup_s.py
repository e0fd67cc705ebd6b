"""Seconds from the process's start to the first timed call: imports, the
card's start-up, the kernel library (built on a checkout's first run), the
benchmark's states and weights, the warm-up; host clock."""


def read(run):
    return run.setup_s
