"""The comparisons that decide ``correct`` for the behaviour-cloning update
of the coverage GNN: the program's update against the plain reference
(``reference/edge_graph_net.py``), each reduced to one number that grows
with the error.

For a kept call the cell keeps what the update started from (the weights
and Adam's ``exp_avg``, ``exp_avg_sq`` and ``step``, copied on the device
before the update: :func:`before`) and what it produced (the loss it
returned, every parameter's ``.grad``, which stays set until the next
update's ``zero_grad``, and the new weights: :func:`after`), beside the
batch.  The reference recomputes from the same weights and batch:

- ``loss_gap``: |loss_p - loss_r| / (1 + |loss_r|);
- ``grad_gap``: the worst parameter's relative L2 error, the largest over
  parameters of ||g_p - g_r|| / max(||g_r||, FLOOR * the largest
  ||g_r||).  Each parameter is judged by itself, so a gradient that is
  wrong in one layer alone (a weight's gradient dropped or mis-scaled)
  reads its own error, however few of the batch's elements it holds.  An
  L2 norm, not the largest element: on the card the sums into receivers
  are atomic, so a forward pass varies in its last bits and a few ReLUs
  that sit near zero flip, and each flip moves the few elements fed by
  that unit's row by up to ~4e-3 of the largest gradient (the program's
  gradient differs so from itself, on the same weights and batch), while
  a product in a lower precision moves every element of the parameter.
  ``FLOOR`` keeps parameters whose gradient is zero but for rounding (the
  last node MLP, which feeds no logit, and the logit head's last bias,
  whose shift every robot's softmax ignores) from dividing by their
  rounding;
- ``adam_gap``: the reference's Adam applied to the program's own
  gradients and moments, against the program's new weights, the largest
  |w_p - w_r| over the learning rate.  It judges Adam apart from the
  gradients: where |g| is near 0, Adam's normalised step magnifies any
  difference of the gradients, so the program's step is judged on the
  program's own gradients.

A parameter without a gradient (one the forward pass never used) counts as
a zero gradient, and one without Adam's state as a fresh one.  A NaN
counts as infinitely large.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch

from portbench.reference import edge_graph_net as ref

Named = Mapping[str, torch.Tensor]
# the share of the largest parameter's gradient norm below which a
# parameter's error is measured against that share, not against its norm
FLOOR = 1e-2


def before(named: Named, state: Mapping) -> dict:
    """Copies of the weights and Adam's state of every parameter ``named``
    (``state``: an optimizer's ``state``, keyed by the parameter)."""
    out = {"weights": {}, "exp_avg": {}, "exp_avg_sq": {}, "step": {}}
    for k, p in named.items():
        st = state.get(p, {})
        out["weights"][k] = p.detach().clone()
        out["exp_avg"][k] = st["exp_avg"].clone() if "exp_avg" in st else torch.zeros_like(p)
        out["exp_avg_sq"][k] = (st["exp_avg_sq"].clone() if "exp_avg_sq" in st
                                else torch.zeros_like(p))
        out["step"][k] = st["step"].clone() if "step" in st else torch.zeros(())
    return out


def after(named: Named, loss: torch.Tensor) -> dict:
    """Copies of what the update produced: its loss, every parameter's
    gradient and the new weights."""
    return {"loss": loss.detach().clone(),
            "grads": {k: p.grad.detach().clone() if p.grad is not None
                      else torch.zeros_like(p) for k, p in named.items()},
            "after": {k: p.detach().clone() for k, p in named.items()}}


def _finite_max(t: torch.Tensor) -> float:
    return float(torch.nan_to_num(t.double(), nan=math.inf).max())


def grad_gap(got: Named, want: Named) -> float:
    """The worst parameter's relative L2 error of the gradient ``got``
    against ``want`` (module docstring)."""
    norms = {k: float(g.double().norm()) for k, g in want.items()}
    floor = FLOOR * max(norms.values())
    worst = 0.0
    for k, g in want.items():
        err = float((got[k].double() - g.double()).norm())
        den = max(norms[k], floor)
        if err != 0.0:
            worst = max(worst, err / den if den > 0.0 and not math.isnan(err) else math.inf)
    return worst


def update_gaps(entries: List[dict], n_robots: int, n_actions: int, lr: float, betas,
                eps: float) -> Dict[str, float]:
    """The three gaps, each the largest over ``entries``: dicts of
    ``batch`` and what :func:`before` and :func:`after` keep."""
    if not entries:
        return {"loss_gap": math.inf, "grad_gap": math.inf, "adam_gap": math.inf}
    g = {"loss_gap": 0.0, "grad_gap": 0.0, "adam_gap": 0.0}
    for e in entries:
        loss_r, grads_r = ref.loss_and_grads(e["weights"], e["batch"], n_robots, n_actions)
        want_loss, got_loss = float(loss_r), float(e["loss"])
        g["loss_gap"] = max(g["loss_gap"], abs(got_loss - want_loss) / (1.0 + abs(want_loss))
                            if math.isfinite(got_loss) else math.inf)
        g["grad_gap"] = max(g["grad_gap"], grad_gap(e["grads"], grads_r))
        steps = {k: float(s) for k, s in e["step"].items()}
        want, _, _ = ref.adam(e["weights"], e["grads"], e["exp_avg"], e["exp_avg_sq"], steps,
                              lr, betas, eps)
        for k, w in want.items():
            gap = _finite_max((e["after"][k].double() - w).abs()) / lr
            g["adam_gap"] = max(g["adam_gap"], gap)
    return g
