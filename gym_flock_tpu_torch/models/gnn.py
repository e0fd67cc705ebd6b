"""GNN policies for imitation learning on flocking swarms (counterpart of
``gym_flock_tpu/models/gnn.py``: ``AggregationGNN`` and
``LargeAggregationGNN``).

Both are the K-hop aggregation GNN of the flocking papers: ``z = [X, AX,
A^2 X, ..., A^{K-1} X]`` side by side per agent, then one MLP shared by the
agents.  Inputs lead with the batch: ``[B, N, ...]``.

Weights start as flax initialises ``nn.Dense``, so that training dynamics
carry over: kernels ``lecun_normal`` (a normal truncated at two standard
deviations, scaled to variance 1/fan_in), biases zero.  That is not
``nn.Linear``'s default; :meth:`reset_parameters` draws it from an explicit
``torch.Generator``.  ``convert.gnn_params_from_flax`` loads flax weights.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from gym_flock_tpu_torch.ops.adjacency_matmul import khop_aggregate

__all__ = ["AggregationGNN", "LargeAggregationGNN", "lecun_normal_"]

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
