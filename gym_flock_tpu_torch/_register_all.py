"""Populate the registry with every env id of ``gym_flock_tpu/_register_all.py``,
each with its ``max_episode_steps``."""
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


def _airsim_factory(env_id):
    def factory(client=None, settings_path=None, names=None, home=None, device="cuda",
                **kwargs):
        """AirSim-bridged envs need a simulator client (the reference gates
        these ids on ``import airsim``, gym_flock/__init__.py:97-112; here
        the client is injected: see ``gym_flock_tpu_torch.bridges``)."""
        if client is None:
            raise ValueError(
                f"{env_id} requires an AirSim-compatible client: "
                f"make('{env_id}', client=..., settings_path=... | names=..., home=...). "
                "See gym_flock_tpu_torch.bridges.airsim_bridge."
            )
        from gym_flock_tpu_torch.bridges.airsim_bridge import (
            AirsimCoverageBridge,
            AirsimFlockingBridge,
        )

        if env_id == "FlockingAirsimAccel-v0":
            bridge = AirsimFlockingBridge(client, settings_path=settings_path, names=names,
                                          home=home, device=device)
            return bridge, bridge.params
        # MappingAirsim-v0: the coverage graph MDP over AirSim drones (the
        # reference's registration names a class that does not exist)
        from gym_flock_tpu_torch.compat.gym_api import make_legacy

        legacy = make_legacy("Coverage-v0", device=device, **kwargs)
        bridge = AirsimCoverageBridge(client, legacy, settings_path=settings_path,
                                      names=names, home=home)
        return bridge, legacy.params

    return factory


register("FlockingAirsimAccel-v0", _airsim_factory("FlockingAirsimAccel-v0"), 200)
register("MappingAirsim-v0", _airsim_factory("MappingAirsim-v0"), 100000)
