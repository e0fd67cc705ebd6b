"""Populate the registry with the env ids ported so far, with their
``max_episode_steps`` as in ``gym_flock_tpu/_register_all.py``."""
from __future__ import annotations

import dataclasses

from gym_flock_tpu_torch.core.registry import register
from gym_flock_tpu_torch.envs.coverage import coverage_factory
from gym_flock_tpu_torch.envs.flocking import (
    FlockingRelativeEnv,
    LargeFlockingEnv,
    SparseFlockingEnv,
)


def _flocking_factory(cls):
    def factory(**kwargs):
        env = cls()
        params = dataclasses.replace(env.default_params(), **kwargs)
        return env, params

    return factory


register("FlockingRelative-v0", _flocking_factory(FlockingRelativeEnv), 1000)
register("FlockingLarge-v0", _flocking_factory(LargeFlockingEnv), 1000)
register("FlockingSparse-v0", _flocking_factory(SparseFlockingEnv), 1000)

register("Coverage-v0", coverage_factory("coverage"), 75)
register("CoverageARL-v0", coverage_factory("arl"), 100000)
register("CoverageARL-v1", coverage_factory("arl"), 100000)
register("CoverageFull-v0", coverage_factory("full"), 100000)
register("ExploreEnv-v0", coverage_factory("explore"), 100000)
register("ExploreEnv-v1", coverage_factory("explore"), 100000)
register("ExploreFullEnv-v0", coverage_factory("explore_full"), 100000)
