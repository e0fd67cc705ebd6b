"""Host milliseconds a reset took, on the mean over the window's resets
that ran without the profiler: the host clock around ``env.reset_env``,
whose draws each end in a synchronisation; the resets together span
seconds, so the clock's own error is small beside them."""


def read(run):
    s = [sec for sec, traced in getattr(run.cell, "reset_s", []) if not traced]
    return 1e3 * sum(s) / len(s) if s else None
