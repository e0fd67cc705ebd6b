"""K6's share of its roofline in the traced calls: the dense pass
(``dense_pass_kernel``: one at a call's start that writes the expert's sums
alone, then one a step that also writes the step's features and network
into the trajectory) as the device trace times it, against the least time
for that work.  The work comes from the frozen counts (``work/counts.py``),
the pairs within reach counted on each traced call's start state and taken
for each of that call's passes as the driver counts them (``cell.traced``),
less the observation of a reset the call begins with, which the dense envs
compute outside K6.  The trace ends with the last traced call's host span,
so where the card leads, the passes it runs after that are not in the
trace: they are the last call's last passes, and their work is left out
too."""
from portbench import readers
from portbench.work import counts

KERNEL = "dense_pass_kernel"


def read(run):
    t = run.trace
    traced = getattr(run.cell, "traced", None)
    if not t or not t.get("kernel_s") or not traced:
        return None
    k6 = [(s, n) for name, (s, n) in t["kernel_s"].items() if KERNEL in name]
    seconds = sum(s for s, _ in k6)
    if seconds <= 0:
        return None
    resets = [u.get("resets", 0.0) for u, on in zip(run.window.units, run.window.traced) if on]
    calls = [[x, passes - 1 - int(reset)] for (x, passes), reset in zip(traced, resets)]
    lost = sum(1 + n for _, n in calls) - sum(n for _, n in k6)
    if not 0 <= lost <= calls[-1][1]:
        return None
    calls[-1][1] -= lost
    flops = nbytes = 0.0
    for x, n in calls:
        pairs, hits, _ = readers.pair_counts(run, x)
        for observation, passes in ((False, 1), (True, n)):
            f, b = counts.dense_pass_work(x.shape[0], x.shape[1], pairs, hits, observation)
            flops += passes * f
            nbytes += passes * b
    return readers.share_pct(flops, nbytes, seconds)
