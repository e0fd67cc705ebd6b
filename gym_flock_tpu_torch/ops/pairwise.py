"""Dense pairwise helpers (counterpart of ``gym_flock_tpu/ops/pairwise.py``).

Every function takes any leading batch dimensions; the pair axes are the
last two.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "pairwise_sq_dists", "radius_adjacency", "mean_pool_normalize", "nodes_within_radius",
]


def pairwise_sq_dists(
    diff: torch.Tensor, fill_diagonal: Optional[float] = None
) -> torch.Tensor:
    """Squared distances from a ``[..., N, M, D]`` diff tensor, from its
    first two coordinates (positions); optionally fill the diagonal
    (reference flocking_relative.py:114-115)."""
    r2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    if fill_diagonal is not None:
        n = r2.shape[-1]
        eye = torch.eye(n, dtype=torch.bool, device=r2.device)
        r2 = torch.where(eye, torch.full_like(r2, fill_diagonal), r2)
    return r2


def radius_adjacency(r2: torch.Tensor, comm_radius2) -> torch.Tensor:
    """Binary adjacency ``r2 < comm_radius^2`` as float (flocking_relative.py:117)."""
    return (r2 < comm_radius2).to(r2.dtype)


def mean_pool_normalize(adj: torch.Tensor) -> torch.Tensor:
    """Row-normalize adjacency by neighbor count (flocking_relative.py:120-122).

    Rows with zero neighbors divide by 1, as the reference does.
    Reciprocal-then-multiply equals ``adj / n`` bitwise for a binary ``adj``.
    """
    n_neighbors = adj.sum(dim=-1, keepdim=True)
    n_neighbors = torch.where(
        n_neighbors == 0, torch.ones_like(n_neighbors), n_neighbors
    )
    return adj * (1.0 / n_neighbors)


def nodes_within_radius(rad, pos1: torch.Tensor, pos2: torch.Tensor) -> torch.Tensor:
    """``[..., M]`` mask of the ``pos2 [..., M, 2]`` entries with at least one
    ``pos1 [..., N, 2]`` entry within ``rad`` (reference utils.py:27-39).

    The reference's quirk is kept: a node at exactly zero distance adds 0
    to the sum of the kept distances, so it does not by itself mark a node
    as seen (the reference zeroes distances > rad, sums, and tests > 0).
    """
    diff = pos1[..., :, None, :] - pos2[..., None, :, :]
    r = torch.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)
    r = torch.where(r > rad, 0.0, r)
    return r.sum(dim=-2) > 0
