"""The plain reference of one behaviour-cloning update of the coverage GNN:
``EdgeGraphNet``'s forward pass, the cross-entropy to the greedy expert's
actions, its gradients and one Adam step, in plain PyTorch and float32,
written from the layer equations.

The model is the message-passing network of Tolstaya et al., *Multi-Robot
Coverage and Exploration using Spatial Graph Neural Networks*
(arXiv:2011.01119), as the JAX package's flax module defines it: a graph
of nodes ``x [N, nf]`` and directed edges ``(s, r)`` with features
``f [E, ef]``, latent width ``L``, ``K`` rounds.

- encoders: ``h = W_n x + b_n``, ``e = W_e f + b_e`` (one dense layer each);
- round ``k``: the message ``m = MLP_m([e, h[s], h[r]]) * mask`` of every
  edge (two dense layers, a ReLU between), the sum of the messages into
  each receiver ``a_i = sum_{r = i} m``, the node update ``h = MLP_h([h,
  a])`` (two layers), and the messages become the edge features, ``e = m``;
- the logit head: ``z = MLP_z(e)`` (two layers, ``L`` then 1) on every
  edge.

A padded edge (sender ``-1``) has mask 0: its message is zero, so it adds
nothing to its receiver, and its ids are read as node 0.  Each robot's
action logits are its ``n_actions`` node->robot edges at the buffer's
tail, ``E - 2 R A + i A + a``; the loss is the cross-entropy to the label,
the mean over robots, then over samples.  The gradients come from autograd
on that forward pass; Adam is written out from ``(m, v, step)`` (the
bias-corrected moments, ``eps`` outside the square root).

Weights are a dict of tensors under the names ``<mlp>.layers.<i>.weight``
(``[out, in]``) and ``.bias``, the MLPs ``node_encoder``,
``edge_encoder``, ``message_mlps.<k>``, ``node_mlps.<k>`` and
``logit_head``: a checkpoint's layout, read as data.

Departures from upstream and from the program:

- the forward pass runs one graph at a time, not a padded batch; the
  gradients of a batch are summed over blocks of samples, each block's
  share of the mean backpropagated by itself, so that the whole batch need
  not be held at once;
- upstream's observation may carry robot-robot comm edges before the
  action edges (``comm_edges``); ExploreFullEnv-v0 has none, so the tail
  offset counts the action edges alone;
- the Adam step is computed in float64 from the float32 state it is given,
  so that a comparison with it sees the other side's rounding alone;
- ``low`` (``torch.bfloat16``) runs every dense layer, its inputs, weights
  and bias, one precision below the configuration's float32: the control.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Weights = Dict[str, torch.Tensor]
Graph = Dict[str, torch.Tensor]
# samples whose share of the mean is backpropagated at once
BLOCK = 16
# dense layers of each MLP
LAYERS = {"node_encoder": 1, "edge_encoder": 1, "message_mlps": 2, "node_mlps": 2,
          "logit_head": 2}


def no_tf32() -> None:
    """float32 means float32 here: no product of the reference may run as
    TF32 (set again before each update, since the process may have turned it
    on since the import)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


no_tf32()


def rounds_of(weights: Weights) -> int:
    """``K``: the message MLPs the weights hold."""
    return len({k.split(".")[1] for k in weights if k.startswith("message_mlps.")})


def mlp(weights: Weights, name: str, x: torch.Tensor,
        low: Optional[torch.dtype] = None) -> torch.Tensor:
    """The dense layers of MLP ``name`` on ``x [M, in]``, a ReLU between
    them; with ``low`` each layer in that precision, its output float32."""
    n = LAYERS[name.split(".")[0]]
    for i in range(n):
        w, b = weights[f"{name}.layers.{i}.weight"], weights[f"{name}.layers.{i}.bias"]
        if low is None:
            x = x @ w.t() + b
        else:
            x = (x.to(low) @ w.to(low).t() + b.to(low)).float()
        if i + 1 < n:
            x = torch.relu(x)
    return x


def forward(weights: Weights, graph: Graph,
            low: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h [N, L], z [E])`` of one graph: ``nodes [N, nf]``, ``edges [E,
    ef]``, ``senders`` and ``receivers [E]`` (sender ``-1`` padded)."""
    real = graph["senders"] != -1
    s = torch.where(real, graph["senders"], 0).long()
    r = torch.where(real, graph["receivers"], 0).long()
    mask = real[:, None].float()
    h = mlp(weights, "node_encoder", graph["nodes"].float(), low)
    e = mlp(weights, "edge_encoder", graph["edges"].float(), low)
    for k in range(rounds_of(weights)):
        m = mlp(weights, f"message_mlps.{k}",
                torch.cat([e, h.index_select(0, s), h.index_select(0, r)], dim=1), low) * mask
        a = torch.zeros_like(h).index_add(0, r, m)
        h = mlp(weights, f"node_mlps.{k}", torch.cat([h, a], dim=1), low)
        e = m
    return h, mlp(weights, "logit_head", e, low)[:, 0]


def action_logits(z: torch.Tensor, n_robots: int, n_actions: int) -> torch.Tensor:
    """``[R, A]``: each robot's node->robot action edges at the tail."""
    start = z.shape[0] - 2 * n_robots * n_actions
    return z[start:start + n_robots * n_actions].reshape(n_robots, n_actions)


def sample_loss(weights: Weights, graph: Graph, label: torch.Tensor, n_robots: int,
                n_actions: int, low: Optional[torch.dtype] = None) -> torch.Tensor:
    """The cross-entropy of one sample's action logits to its labels ``[R]``,
    the mean over robots."""
    z = action_logits(forward(weights, graph, low)[1].float(), n_robots, n_actions)
    picked = z.gather(1, label.long()[:, None])[:, 0]
    return (torch.logsumexp(z, dim=1) - picked).mean()


def sample(batch: Graph, i: int) -> Graph:
    return {k: batch[k][i] for k in ("nodes", "edges", "senders", "receivers")}


def loss_and_grads(weights: Weights, batch: Graph, n_robots: int, n_actions: int,
                   low: Optional[torch.dtype] = None,
                   block: int = BLOCK) -> Tuple[torch.Tensor, Weights]:
    """The batch's loss (the mean over samples) and its gradient with
    respect to every weight.  ``batch`` holds ``[n, ...]`` samples and
    ``label [n, R]``."""
    no_tf32()
    leaves = {k: v.detach().float().clone().requires_grad_(True) for k, v in weights.items()}
    n = batch["label"].shape[0]
    total = torch.zeros((), device=batch["label"].device)
    for i0 in range(0, n, block):
        part = sum(sample_loss(leaves, sample(batch, i), batch["label"][i], n_robots,
                               n_actions, low) for i in range(i0, min(n, i0 + block))) / n
        part.backward()
        total = total + part.detach()
    # the last node MLP feeds no logit: its gradient is zero
    return total, {k: v.grad if v.grad is not None else torch.zeros_like(v)
                   for k, v in leaves.items()}


def adam(weights: Weights, grads: Weights, exp_avg: Weights, exp_avg_sq: Weights,
         steps: Dict[str, float], lr: float, betas: Tuple[float, float],
         eps: float) -> Tuple[Weights, Weights, Weights]:
    """``(weights, m', v')`` after one Adam step from each weight's ``(m,
    v)`` after ``steps[name]`` steps: ``m' = b1 m + (1 - b1) g``, ``v' = b2 v
    + (1 - b2) g^2``, ``w - lr (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) +
    eps)`` with ``t = steps[name] + 1``; in float64."""
    b1, b2 = betas
    out, ms, vs = {}, {}, {}
    for k, w in weights.items():
        t = float(steps[k]) + 1.0
        g = grads[k].double()
        m = b1 * exp_avg[k].double() + (1.0 - b1) * g
        v = b2 * exp_avg_sq[k].double() + (1.0 - b2) * g * g
        out[k] = w.double() - lr * (m / (1.0 - b1 ** t)) / ((v / (1.0 - b2 ** t)).sqrt() + eps)
        ms[k], vs[k] = m, v
    return out, ms, vs
