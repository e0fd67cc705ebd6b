"""Populate the registry with the env ids ported so far, with their
``max_episode_steps`` as in ``gym_flock_tpu/_register_all.py``: every id but
the two AirSim ones."""
from __future__ import annotations

import dataclasses

from gym_flock_tpu_torch.core.registry import register
from gym_flock_tpu_torch.envs.coverage import coverage_factory
from gym_flock_tpu_torch.envs.flocking import (
    FlockingAbsoluteEnv,
    FlockingLeaderEnv,
    FlockingObstacleEnv,
    FlockingRelativeEnv,
    FlockingStochasticEnv,
    FlockingTwoFlocksEnv,
    LargeFlockingEnv,
    SparseFlockingEnv,
)
from gym_flock_tpu_torch.envs.flocking_multi import FlockingMultiEnv
from gym_flock_tpu_torch.envs.formation import formation_factory
from gym_flock_tpu_torch.envs.lqr import lqr_factory
from gym_flock_tpu_torch.envs.mapping import (
    MappingDiscEnv,
    MappingEnv,
    MappingLocalEnv,
    MappingVelEnv,
    mapping_factory,
)
from gym_flock_tpu_torch.envs.shepherding import shepherding_factory


def _flocking_factory(cls):
    def factory(**kwargs):
        env = cls()
        params = dataclasses.replace(env.default_params(), **kwargs)
        return env, params

    return factory


register("FlockingRelative-v0", _flocking_factory(FlockingRelativeEnv), 1000)
register("Flocking-v0", _flocking_factory(FlockingAbsoluteEnv), 1000)
register("FlockingLeader-v0", _flocking_factory(FlockingLeaderEnv), 200)
register("FlockingObstacle-v0", _flocking_factory(FlockingObstacleEnv), 200)
register("FlockingStochastic-v0", _flocking_factory(FlockingStochasticEnv), 500)
register("FlockingTwoFlocks-v0", _flocking_factory(FlockingTwoFlocksEnv), 500)
register("FlockingLarge-v0", _flocking_factory(LargeFlockingEnv), 1000)
register("FlockingSparse-v0", _flocking_factory(SparseFlockingEnv), 1000)

register("Coverage-v0", coverage_factory("coverage"), 75)
register("CoverageARL-v0", coverage_factory("arl"), 100000)
register("CoverageARL-v1", coverage_factory("arl"), 100000)
register("CoverageFull-v0", coverage_factory("full"), 100000)
register("ExploreEnv-v0", coverage_factory("explore"), 100000)
register("ExploreEnv-v1", coverage_factory("explore"), 100000)
register("ExploreFullEnv-v0", coverage_factory("explore_full"), 100000)

register("Shepherding-v0", shepherding_factory, 1000)
register("FormationFlying-v0", formation_factory, 500)
register("LQR-v0", lqr_factory, None)  # unregistered in the reference (lqr.py:12)

# the reference's never-registered old/ family; the ids are the JAX package's
register("Mapping-v0", mapping_factory(MappingEnv), 1000)
register("MappingVel-v0", mapping_factory(MappingVelEnv), 1000)
register("MappingDisc-v0", mapping_factory(MappingDiscEnv), 1000)
register("MappingLocal-v0", mapping_factory(MappingLocalEnv), 1000)
register("FlockingMulti-v0", _flocking_factory(FlockingMultiEnv), 1000)
