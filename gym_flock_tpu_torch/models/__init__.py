"""GNN policy models (counterpart of ``gym_flock_tpu/models``)."""
from gym_flock_tpu_torch.models.gnn import (
    AggregationGNN,
    EdgeGraphNet,
    LargeAggregationGNN,
    get_number_nodes,
    unpack_obs,
    unpack_obs_state,
)

__all__ = [
    "AggregationGNN",
    "LargeAggregationGNN",
    "EdgeGraphNet",
    "unpack_obs",
    "unpack_obs_state",
    "get_number_nodes",
]
