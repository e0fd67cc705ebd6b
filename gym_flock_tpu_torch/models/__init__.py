"""GNN policy models (counterpart of ``gym_flock_tpu/models``)."""
from gym_flock_tpu_torch.models.gnn import AggregationGNN, LargeAggregationGNN

__all__ = ["AggregationGNN", "LargeAggregationGNN"]
