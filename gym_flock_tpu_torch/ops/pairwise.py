"""Dense pairwise helpers (counterpart of ``gym_flock_tpu/ops/pairwise.py``).

Every function takes any leading batch dimensions; the pair axes are the
last two.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "pos_diff", "pairwise_sq_dists", "radius_adjacency", "mean_pool_normalize",
    "radius_edges_masked", "knn_edges", "nodes_within_radius",
]


def pos_diff(sender_loc: torch.Tensor, receiver_loc: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """All-pairs differences ``sender[..., i, :] - receiver[..., j, :]``,
    ``[..., N, M, D]`` (reference utils.py:42-57)."""
    if receiver_loc is None:
        receiver_loc = sender_loc
    return sender_loc[..., :, None, :] - receiver_loc[..., None, :, :]


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
    r = _distances(pos_diff(pos1, pos2))
    r = torch.where(r > rad, 0.0, r)
    return r.sum(dim=-2) > 0


def _distances(diff: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)


def radius_edges_masked(
    rad, pos1: torch.Tensor, pos2: Optional[torch.Tensor] = None, self_loops: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The radius graph as a dense masked edge set (reference utils.py:8-24,
    whose ``np.nonzero`` edge list has a data-dependent length):
    ``(mask, dist, diff [..., N, M, 2], r)``, ``mask`` where ``0 < r <= rad``
    and ``dist`` the distance there, else 0.

    ``self_loops`` has no effect, as in the reference: its ``np.nonzero``
    drops every zero distance, the diagonal's included.
    """
    del self_loops
    diff = pos_diff(pos1, pos2)
    r = _distances(diff)
    mask = (r <= rad) & (r > 0)
    return mask, torch.where(mask, r, 0.0), diff, r


def knn_edges(
    k: int, pos1: torch.Tensor, pos2: Optional[torch.Tensor] = None,
    self_loops: bool = False, allow_nearest: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's k nearest as ``(index [..., N, k], dist, diff [..., N, k,
    D])`` (reference utils.py:60-88): with ``allow_nearest`` the k nearest,
    else the 2nd to (k+1)-th nearest (the reference drops the nearest).
    Without ``pos2`` a row's own entry is never a neighbour unless
    ``self_loops``.  Ties go to the lower index (a stable sort), as
    ``jax.lax.top_k`` breaks them.
    """
    same = pos2 is None
    diff = pos_diff(pos1, pos2)
    r = _distances(diff)
    if same and not self_loops:
        n = r.shape[-1]
        r = torch.where(torch.eye(n, dtype=torch.bool, device=r.device), torch.inf, r)
    dists, idx = torch.sort(r, dim=-1, stable=True)
    lo = 0 if allow_nearest else 1
    dists, idx = dists[..., lo:lo + k], idx[..., lo:lo + k]
    diffs = diff.gather(-2, idx[..., None].expand(*idx.shape, diff.shape[-1]))
    return idx, dists, diffs
