"""GNN policies for imitation learning on swarm observations (counterpart
of ``gym_flock_tpu/models/gnn.py``).

* ``AggregationGNN`` and ``LargeAggregationGNN``: the K-hop aggregation GNN
  of the flocking papers, ``z = [X, AX, A^2 X, ..., A^{K-1} X]`` side by
  side per agent, then one MLP shared by the agents;
* ``EdgeGraphNet``: message passing over the coverage envs' padded edge
  list, scoring every edge (the caller reads each robot's action edges);
* ``unpack_obs`` / ``unpack_obs_state`` / ``get_number_nodes``: the flat
  coverage observation's decoding into a masked graph batch.

Inputs lead with the batch: ``[B, N, ...]``.

Weights start as flax initialises ``nn.Dense``, so that training dynamics
carry over: kernels ``lecun_normal`` (a normal truncated at two standard
deviations, scaled to variance 1/fan_in), biases zero.  That is not
``nn.Linear``'s default; :meth:`reset_parameters` draws it from an explicit
``torch.Generator``.  ``convert.gnn_params_from_flax`` and
``convert.edge_graph_net_params_from_flax`` load flax weights.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from gym_flock_tpu_torch.ops.adjacency_matmul import khop_aggregate
from gym_flock_tpu_torch.utils.profiling import span

__all__ = [
    "AggregationGNN",
    "LargeAggregationGNN",
    "EdgeGraphNet",
    "unpack_obs",
    "unpack_obs_state",
    "get_number_nodes",
    "lecun_normal_",
]


def unpack_obs(
    obs: torch.Tensor,
    n_nodes: int,
    n_node_feat: int = 3,
    n_edge_feat: int = 1,
    max_edges_per_node: int = 4,
    n_glob_feat: int = 1,
):
    """Decode flat coverage observations ``[B, flat_dim]`` (the
    concatenation nodes, edges, senders, receivers, step; reference
    coverage.py:689-741) into a masked graph batch of fixed shapes.

    Returns ``dict(nodes [B,N,nf], edges [B,E,ef], senders [B,E],
    receivers [B,E], edge_mask [B,E] bool, globs [B,G])``: ids are int32
    (truncated as ``astype(int32)`` truncates), ``edge_mask`` is
    ``senders != -1`` and padded ids read 0.
    """
    b = obs.shape[0]
    n = n_nodes
    e = n * max_edges_per_node
    sizes = [n * n_node_feat, e * n_edge_feat, e, e, n_glob_feat]
    o = [int(v) for v in np.cumsum([0] + sizes)]
    senders = obs[:, o[2]:o[3]].reshape(b, e).to(torch.int32)
    receivers = obs[:, o[3]:o[4]].reshape(b, e).to(torch.int32)
    edge_mask = senders != -1
    return {
        "nodes": obs[:, o[0]:o[1]].reshape(b, n, n_node_feat),
        "edges": obs[:, o[1]:o[2]].reshape(b, e, n_edge_feat),
        "senders": torch.where(edge_mask, senders, 0),
        "receivers": torch.where(edge_mask, receivers, 0),
        "edge_mask": edge_mask,
        "globs": obs[:, o[4]:o[5]].reshape(b, n_glob_feat),
    }


def unpack_obs_state(
    obs: torch.Tensor,
    state: torch.Tensor,
    n_nodes: int,
    dim_state: int,
    n_node_feat: int = 3,
    n_edge_feat: int = 1,
    max_edges_per_node: int = 4,
    n_glob_feat: int = 1,
):
    """:func:`unpack_obs` with each node's pair of state vectors (reference
    coverage.py:743-798): ``state`` reshapes to ``[B, n_nodes,
    2*dim_state]``; ``nodes1`` / ``nodes2`` are the node features with the
    first / second half appended."""
    g = unpack_obs(obs, n_nodes, n_node_feat=n_node_feat, n_edge_feat=n_edge_feat,
                   max_edges_per_node=max_edges_per_node, n_glob_feat=n_glob_feat)
    st = state.reshape(g["nodes"].shape[0], n_nodes, 2 * dim_state)
    g["nodes1"] = torch.cat([g["nodes"], st[..., :dim_state]], dim=-1)
    g["nodes2"] = torch.cat([g["nodes"], st[..., dim_state:]], dim=-1)
    return g


def get_number_nodes(flat_dim: int, n_node_feat: int = 3, n_edge_feat: int = 1,
                     max_edges_per_node: int = 4, n_glob_feat: int = 1) -> int:
    """Node count of a flat observation of ``flat_dim`` entries (reference
    coverage.py:675-680), the inverse of ``n*nf + n*epn*(ef + 2) + glob``."""
    return (flat_dim - n_glob_feat) // (max_edges_per_node * (2 + n_edge_feat) + n_node_feat)


_TRUNC_STD = 0.87962566103423978  # std of the standard normal truncated to [-2, 2]


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` in place on a ``[out, in]`` weight: the
    standard normal truncated to [-2, 2] (by the inverse CDF, as
    ``jax.random.truncated_normal`` draws it), times ``sqrt(1/in) /
    _TRUNC_STD``."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(weight.shape, generator=generator, device=generator.device,
                   dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    with torch.no_grad():
        return weight.copy_((z.clamp(-2.0, 2.0) * std).to(weight.device, weight.dtype))


class _MLP(nn.Module):
    """Dense layers with ReLU between them (flax ``_MLP``)."""

    def __init__(self, in_features: int, features: Sequence[int], device=None):
        super().__init__()
        sizes = (in_features, *features)
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(sizes[:-1], sizes[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i + 1 < len(self.layers):
                x = torch.relu(x)
        return x


class _KHopGNN(nn.Module):
    """The shared parts: the input squash, the MLP and its initialisation."""

    def __init__(self, k_hops, hidden, out_dim, squash_inputs, in_features, generator, device):
        super().__init__()
        self.k_hops = k_hops
        self.squash_inputs = squash_inputs
        self.mlp = _MLP(k_hops * in_features, (*hidden, out_dim), device=device)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisation, drawn from ``generator``: the kernels in
        layer order, each then its zero bias."""
        for layer in self.mlp.layers:
            lecun_normal_(layer.weight, generator)
            with torch.no_grad():
                layer.bias.zero_()

    def _squash(self, features: torch.Tensor) -> torch.Tensor:
        # the raw 1/r^2 and 1/r^4 channels span many decades; arcsinh brings
        # them to a trainable scale and stays odd and smooth
        return torch.asinh(features) if self.squash_inputs else features


class AggregationGNN(_KHopGNN):
    """K-hop aggregation GNN over a dense adjacency (the mean-pooled
    ``network`` of ``FlockingRelative-v0``): ``forward(features [B, N, F],
    adjacency [B, N, N]) -> [B, N, out_dim]``.  The A^k X products are dense
    ``torch.matmul``, as the JAX package leaves them to XLA."""

    def __init__(self, k_hops: int = 3, hidden: Sequence[int] = (64, 64), out_dim: int = 2,
                 squash_inputs: bool = True, in_features: int = 6,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(k_hops, hidden, out_dim, squash_inputs, in_features, generator, device)

    def forward(self, features: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
        features = self._squash(features)
        zs = [features]
        z = features
        for _ in range(self.k_hops - 1):
            z = torch.matmul(adjacency, z)
            zs.append(z)
        return self.mlp(torch.cat(zs, dim=-1))


class LargeAggregationGNN(_KHopGNN):
    """:class:`AggregationGNN` for swarms too large for a dense adjacency:
    ``forward(x [B, N, 4], features [B, N, F])``.  The A^k X products run
    through K2 (``ops.adjacency_matmul.khop_aggregate``, mean-pooled at
    ``comm_radius2``) unless ``aggregate_fn(x, features)`` replaces them,
    e.g. with ``functools.partial(ops.sparse_flocking.khop_aggregate_sparse,
    comm_radius2=..., k_hops=...)`` for K4.  The weights are the same in
    both, so they transfer between the variants."""

    def __init__(self, k_hops: int = 3, hidden: Sequence[int] = (64, 64), out_dim: int = 2,
                 comm_radius2: float = 0.81, squash_inputs: bool = True, in_features: int = 6,
                 aggregate_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(k_hops, hidden, out_dim, squash_inputs, in_features, generator, device)
        self.comm_radius2 = comm_radius2
        self.aggregate_fn = aggregate_fn

    def forward(self, x: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        features = self._squash(features)
        if self.aggregate_fn is not None:
            h = self.aggregate_fn(x, features)
        else:
            h = khop_aggregate(x, features, self.comm_radius2, self.k_hops, mean_pool=True)
        return self.mlp(h)


class EdgeGraphNet(nn.Module):
    """Message passing over a batch of padded coverage graphs:
    ``forward(graph) -> (h [B, N, latent], edge_logits [B, E, 1])`` with
    ``graph`` holding ``nodes [B,N,nf]``, ``edges [B,E,ef]``,
    ``senders``/``receivers [B,E]`` (padded ids 0) and ``edge_mask [B,E]``.

    Each round: the message MLP on ``[e_feat, h[senders], h[receivers]]``,
    times the mask; the messages summed into their receivers
    (``index_add_`` over the flattened ``b*N + receiver`` ids, so padding
    adds zeros); the node MLP on ``[h, agg]``; the messages become the edge
    features.  The edge logits are an MLP of the last messages.

    The JAX module is per graph and vmapped; its segment sum is XLA, not a
    Pallas kernel, so this one is plain PyTorch.  On the card ``index_add_``
    sums with atomics: the aggregation varies in its last bits from run to
    run.
    """

    def __init__(self, latent: int = 64, rounds: int = 2, n_node_feat: int = 3,
                 n_edge_feat: int = 1, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.latent = latent
        self.rounds = rounds
        self.node_encoder = _MLP(n_node_feat, (latent,), device=device)
        self.edge_encoder = _MLP(n_edge_feat, (latent,), device=device)
        self.message_mlps = nn.ModuleList(
            _MLP(3 * latent, (latent, latent), device=device) for _ in range(rounds))
        self.node_mlps = nn.ModuleList(
            _MLP(2 * latent, (latent, latent), device=device) for _ in range(rounds))
        self.logit_head = _MLP(latent, (latent, 1), device=device)
        self.message_rows = 0
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def mlps(self):
        """The MLPs in flax's creation order: node encoder, edge encoder,
        (message, node) per round, logit head."""
        rounds = [m for pair in zip(self.message_mlps, self.node_mlps) for m in pair]
        return [self.node_encoder, self.edge_encoder, *rounds, self.logit_head]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisation, drawn from ``generator`` in creation order."""
        for mlp in self.mlps():
            for layer in mlp.layers:
                lecun_normal_(layer.weight, generator)
                with torch.no_grad():
                    layer.bias.zero_()

    def forward(self, graph):
        nodes, edges = graph["nodes"], graph["edges"]
        b, n = nodes.shape[:2]
        e = edges.shape[1]
        mask = graph["edge_mask"][..., None].to(nodes.dtype)  # [B, E, 1]
        offset = (torch.arange(b, device=nodes.device) * n)[:, None]
        send = (graph["senders"].long() + offset).reshape(-1)
        recv = (graph["receivers"].long() + offset).reshape(-1)

        h = self.node_encoder(nodes)
        e_feat = self.edge_encoder(edges)
        for message_mlp, node_mlp in zip(self.message_mlps, self.node_mlps):
            with span("gft.gnn.round"):
                flat = h.reshape(b * n, -1)
                msg_in = torch.cat([e_feat, flat[send].reshape(b, e, -1),
                                    flat[recv].reshape(b, e, -1)], dim=-1)
                msg = message_mlp(msg_in) * mask
                agg = torch.zeros_like(flat).index_add_(0, recv, msg.reshape(b * e, -1))
                h = node_mlp(torch.cat([h, agg.reshape(b, n, -1)], dim=-1))
                e_feat = msg
            self.message_rows += b * e
        return h, self.logit_head(e_feat)
