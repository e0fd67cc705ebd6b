"""Environment families: flocking (and its variants), coverage, shepherding,
formation flying, networked LQR, mapping and delayed-aggregation flocking."""
from gym_flock_tpu_torch.envs.flocking import (
    FlockingAbsoluteEnv,
    FlockingLeaderEnv,
    FlockingObstacleEnv,
    FlockingParams,
    FlockingRelativeEnv,
    FlockingState,
    FlockingStochasticEnv,
    FlockingTwoFlocksEnv,
    LargeFlockingEnv,
    SparseFlockingEnv,
)
from gym_flock_tpu_torch.envs.coverage import CoverageEnv, CoverageParams, CoverageState
from gym_flock_tpu_torch.envs.shepherding import ShepherdingEnv, ShepherdingParams
from gym_flock_tpu_torch.envs.formation import FormationFlyingEnv, FormationParams
from gym_flock_tpu_torch.envs.lqr import LQREnv, LQRParams
from gym_flock_tpu_torch.envs.mapping import (
    MappingDiscEnv,
    MappingEnv,
    MappingLocalEnv,
    MappingParams,
    MappingState,
    MappingVelEnv,
)
from gym_flock_tpu_torch.envs.flocking_multi import (
    FlockingMultiEnv,
    FlockingMultiParams,
    FlockingMultiState,
)

__all__ = [
    "FlockingRelativeEnv", "FlockingAbsoluteEnv", "FlockingLeaderEnv", "FlockingObstacleEnv",
    "FlockingStochasticEnv", "FlockingTwoFlocksEnv", "FlockingParams", "FlockingState",
    "LargeFlockingEnv", "SparseFlockingEnv", "CoverageEnv", "CoverageParams", "CoverageState",
    "ShepherdingEnv", "ShepherdingParams", "FormationFlyingEnv", "FormationParams", "LQREnv",
    "LQRParams", "MappingEnv", "MappingVelEnv", "MappingDiscEnv", "MappingLocalEnv",
    "MappingParams", "MappingState", "FlockingMultiEnv", "FlockingMultiParams",
    "FlockingMultiState",
]
