"""Rollout loops over batches of envs, and imitation training on them.

The function ``rollout`` stays in its module: bound here, its name would
hide the submodule ``parallel.rollout``.
"""
from gym_flock_tpu_torch.parallel.dagger import DaggerState, DaggerTrainer
from gym_flock_tpu_torch.parallel.rollout import batch_expert_rollout, batch_rollout
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
