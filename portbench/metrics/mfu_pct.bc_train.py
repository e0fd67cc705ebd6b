"""The whole behaviour-cloning iteration's share of the card's peak: the
least time of the update's work (``work/edge_graph_net_counts.py``: the
encoders, every round and the logit head, forward and backward, and the
Adam step, at 67 TFLOP/s float32 and 3.35 TB/s) over the window's seconds
a call, from the calls that ran without the profiler.  The samples come
from the model's own ``message_rows`` counter (``b * e * rounds`` a
forward pass); a program without it, the control, or a run off the card
reads nothing."""
from portbench import readers
from portbench.work import edge_graph_net_counts as counts


def read(run):
    rows_per_call = getattr(run.cell, "message_rows_per_call", None)
    rows = rows_per_call() if rows_per_call is not None else None
    seconds = readers.window_s_per_unit(run, "calls")
    if not readers.on_card(run) or not rows or seconds is None:
        return None
    w, m = run.config["world"], run.config["model"]
    b = rows / (w["max_edges"] * m["rounds"])
    flops, nbytes = counts.update_work(b, w["max_nodes"], w["max_edges"], m["rounds"],
                                       m["latent"], m["n_node_feat"], m["n_edge_feat"],
                                       run.config["params"]["n_robots"])
    return readers.share_pct(flops, nbytes, seconds)
