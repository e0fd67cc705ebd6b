"""Frozen counts of the work of one behaviour-cloning update of
``EdgeGraphNet`` (forward, backward and the Adam step), for the least time
one NVIDIA H100 could take for it (``counts.bound_s``).

The operations are the dense layers' multiply-adds, 2 a weight a row
forward, and backward 2 more for the weight's gradient and, but in the
encoders (whose inputs are data), 2 more for the input's gradient; the
elementwise work (biases, ReLUs, the mask, the sums into receivers, the
cross-entropy), under 2% of it, is left out.  The bytes: each dense layer's
input read and output written forward, its saved input and its output's
gradient read and its input's gradient written backward (float32; the
gathers, concatenations and sums fused into those reads and writes), the
batch read once, and Adam's weights, gradients and two moments read and
the weights and moments written.

The rows: the node encoder and each round's node MLP run on ``b * n`` node
rows, the edge encoder, each round's message MLP and the logit head on
``b * e`` edge rows; ``b * e * rounds`` is the model's ``message_rows``
counter for one forward pass.  The last round's node MLP is left out: its
output feeds no logit, so the update requires neither its forward pass
(which the model runs) nor its backward pass.
"""
from __future__ import annotations

from portbench.work.counts import F32

I32 = 4


def _dense(rows: int, fan_in: int, fan_out: int, input_grad: bool = True):
    """``(flops, bytes)`` of one dense layer on ``rows`` rows, forward and
    backward."""
    mults = 2 * rows * fan_in * fan_out
    flops = mults * (3 if input_grad else 2)
    nbytes = F32 * rows * (2 * fan_in + 2 * fan_out + (fan_in if input_grad else 0))
    return flops, nbytes


def _mlp(rows: int, sizes, input_grad: bool = True):
    flops = nbytes = 0
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        f, n = _dense(rows, a, b, input_grad or i > 0)
        flops, nbytes = flops + f, nbytes + n
    return flops, nbytes


def n_params(latent: int, rounds: int, n_node_feat: int, n_edge_feat: int) -> int:
    """The model's weights and biases."""
    def mlp(sizes):
        return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))

    return (mlp((n_node_feat, latent)) + mlp((n_edge_feat, latent))
            + rounds * (mlp((3 * latent, latent, latent)) + mlp((2 * latent, latent, latent)))
            + mlp((latent, latent, 1)))


def update_work(b: int, n: int, e: int, rounds: int, latent: int, n_node_feat: int,
                n_edge_feat: int, n_robots: int):
    """``(flops, bytes)`` of one update on ``b`` samples of ``n`` nodes and
    ``e`` edges (``n_robots`` labels a sample)."""
    node_rows, edge_rows = b * n, b * e
    parts = [_mlp(node_rows, (n_node_feat, latent), input_grad=False),
             _mlp(edge_rows, (n_edge_feat, latent), input_grad=False),
             _mlp(edge_rows, (latent, latent, 1))]
    for k in range(rounds):
        parts.append(_mlp(edge_rows, (3 * latent, latent, latent)))
        if k + 1 < rounds:  # the last node update feeds no logit: no work required
            parts.append(_mlp(node_rows, (2 * latent, latent, latent)))
    flops = sum(f for f, _ in parts)
    batch = b * (n * n_node_feat * F32 + e * (n_edge_feat * F32 + 2 * I32) + n_robots * I32)
    adam = 7 * F32 * n_params(latent, rounds, n_node_feat, n_edge_feat)
    return flops, sum(n for _, n in parts) + batch + adam
