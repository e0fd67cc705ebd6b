"""In the cells whose step the device leads: the whole env-step's share of
the card's peak, the least time of one expert env-step (one pass of the
pair sums, the state read and written, the trajectory written;
``work/counts.py``, the pairs within reach counted on the window's last
state) over the window's seconds an env-step, resets included, from the
calls that ran without the profiler."""
from portbench import readers
from portbench.work import counts


def read(run):
    x = run.cell.live_state()
    seconds = readers.window_s_per_unit(run, "steps")
    if x is None or seconds is None:
        return None
    pairs, hits, _ = readers.pair_counts(run, x)
    flops, nbytes = counts.env_step_work(x.shape[0], x.shape[1], pairs, hits, run.cell.dense)
    return readers.share_pct(flops, nbytes, seconds)
