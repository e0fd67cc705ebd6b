"""K5's share of its roofline in the traced calls: the greedy expert's
packed row minimum (``rowmin_kernel``, one launch a step) as the device
trace times it, against the least time for the launches' work
(``work/rowmin_counts.py``: each distinct bf16 cost row the robots can
gather, the blocked flags, the row index and the output each read or
written once) at the cell's batch, robots, targets and graphs."""
from portbench import readers
from portbench.work import rowmin_counts

KERNEL = "rowmin_kernel"


def read(run):
    t = run.trace
    shape = [getattr(run.cell, k, None) for k in ("b", "r", "t", "g")]
    if not t or not t.get("kernel_s") or None in shape:
        return None
    k5 = [(s, n) for name, (s, n) in t["kernel_s"].items() if KERNEL in name]
    seconds = sum(s for s, _ in k5)
    launches = sum(n for _, n in k5)
    flops, nbytes = rowmin_counts.rowmin_work(*shape)
    return readers.share_pct(launches * flops, launches * nbytes, seconds)
