"""The pair sums' share of their roofline in the traced calls: K1's "core"
passes (``block_sums_kernel<false>``: one at a call's start, one a step,
one for a reset's observation) as the device trace times them, against the
least time for that work.  The work comes from the frozen counts
(``work/counts.py``), the pairs within reach counted on each traced call's
start state and taken for each pass of that call."""
from portbench import readers
from portbench.work import counts

KERNEL = "block_sums_kernel<false>"


def read(run):
    t = run.trace
    traced = getattr(run.cell, "traced", None)
    if not t or not t.get("kernel_s") or not traced:
        return None
    seconds = sum(s for name, (s, _) in t["kernel_s"].items() if KERNEL in name)
    if seconds <= 0:
        return None
    flops = nbytes = 0.0
    for x, passes in traced:
        pairs, hits, _ = readers.pair_counts(run, x)
        f, b = counts.pair_sums_work(x.shape[0], x.shape[1], pairs, hits)
        flops += passes * f
        nbytes += passes * b
    return readers.share_pct(flops, nbytes, seconds)
