"""Pairwise operations: dense helpers (``pairwise``) and the kernels'
wrappers with their plain versions (``flocking_sums``: K1,
``adjacency_matmul``: K2, ``sparse_flocking``: K3/K4, ``rowmin``: K5).

The names of ``gym_flock_tpu/ops/__init__.py`` are here, but for
``flocking_sums`` and ``adjacency_matmul``: bound here, those functions
would hide the submodules of the same names, which hold the kernels'
launch counters.  They are ``ops.flocking_sums.flocking_sums`` and
``ops.adjacency_matmul.adjacency_matmul``.
"""
from gym_flock_tpu_torch.ops.adjacency_matmul import khop_aggregate
from gym_flock_tpu_torch.ops.flocking_sums import (
    flocking_features_large,
    turner_controller_large,
)
from gym_flock_tpu_torch.ops.pairwise import (
    knn_edges,
    mean_pool_normalize,
    nodes_within_radius,
    pairwise_sq_dists,
    pos_diff,
    radius_adjacency,
    radius_edges_masked,
)

__all__ = ["pos_diff", "pairwise_sq_dists", "radius_adjacency", "mean_pool_normalize",
           "radius_edges_masked", "knn_edges", "nodes_within_radius",
           "turner_controller_large", "flocking_features_large", "khop_aggregate"]
