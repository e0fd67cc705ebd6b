"""Rounds of the coverage step's conflict fixed point a step (each one host
read of a device value), in the exploration cells: the env's own counter
``CoverageEnv.conflict_rounds`` from the window's first call to its end,
over the window's env-steps.  The control has no such counter and reads
nothing."""


def read(run):
    rounds = getattr(run.cell, "conflict_rounds", None)
    n = rounds() if rounds is not None else None
    steps = run.window.total("steps")
    return n / steps if n is not None and steps else None
