"""Rollout loops over batches of envs, imitation training on them, and their
scale-out over ``torch.distributed`` (the env batch and the agent axis).

The function ``rollout`` stays in its module: bound here, its name would
hide the submodule ``parallel.rollout``.
"""
from gym_flock_tpu_torch.parallel.agent_shard import (
    adjacency_matmul_sharded,
    agent_sharded_rollout,
    flocking_features_sharded,
    flocking_reset_sharded,
    flocking_step_sharded,
    flocking_sums_sharded,
    make_flock_mesh,
    turner_controller_sharded,
)
from gym_flock_tpu_torch.parallel.dagger import DaggerState, DaggerTrainer
from gym_flock_tpu_torch.parallel.distributed import global_env_mesh, host_fold
from gym_flock_tpu_torch.parallel.distributed import initialize as distributed_initialize
from gym_flock_tpu_torch.parallel.rollout import (
    batch_expert_rollout,
    batch_rollout,
    make_env_mesh,
    sharded_rollout,
)
from gym_flock_tpu_torch.parallel.train import (
    FlockingImitationTrainer,
    LargeFlockingImitationTrainer,
    collect_flocking_batch,
    collect_large_flocking_batch,
    restore_checkpoint,
    save_checkpoint,
)
from gym_flock_tpu_torch.parallel.train_coverage import (
    CoverageDaggerTrainer,
    CoverageImitationTrainer,
    action_edge_logits,
    collect_coverage_batch,
)
from gym_flock_tpu_torch.parallel.vrp_labels import collect_vrp_labeled_batch, vrp_label_states

__all__ = [
    "batch_rollout",
    "batch_expert_rollout",
    "sharded_rollout",
    "make_env_mesh",
    "distributed_initialize",
    "global_env_mesh",
    "host_fold",
    "make_flock_mesh",
    "flocking_sums_sharded",
    "flocking_features_sharded",
    "turner_controller_sharded",
    "adjacency_matmul_sharded",
    "flocking_step_sharded",
    "flocking_reset_sharded",
    "agent_sharded_rollout",
    "FlockingImitationTrainer",
    "LargeFlockingImitationTrainer",
    "collect_flocking_batch",
    "collect_large_flocking_batch",
    "save_checkpoint",
    "restore_checkpoint",
    "CoverageImitationTrainer",
    "CoverageDaggerTrainer",
    "collect_coverage_batch",
    "action_edge_logits",
    "DaggerTrainer",
    "DaggerState",
    "collect_vrp_labeled_batch",
    "vrp_label_states",
]
