"""AirSim hardware-in-the-loop bridges, host code with the simulator client
injected (counterpart of ``gym_flock_tpu/bridges/airsim_bridge.py``;
reference flocking_airsim_accel.py:8-175, coverage_airsim.py:27-115,
airsim/utils.py:7-97).

The bridge owns no dynamics (AirSim does): it reads the drones' states
back, and the env core computes observations, rewards and experts from
them on ``device`` (the card unless the caller asks for ``"cpu"``).  Any
object with the AirSim MultirotorClient methods used here works
(``enableApiControl``, ``armDisarm``, ``takeoffAsync``,
``moveByAngleZAsync``, ``moveByVelocityZAsync``, ``moveToPositionAsync``,
``getMultirotorState``), a fake for testing included.
"""
from __future__ import annotations

from time import sleep
from typing import List, Optional, Sequence

import numpy as np
import torch

from gym_flock_tpu_torch.compat.gym_api import fetch, first, require_device
from gym_flock_tpu_torch.utils.formations import grid, parse_settings

__all__ = ["AirsimFlockingBridge", "AirsimCoverageBridge", "quaternion_to_yaw"]

GRAVITY = 9.8


def quaternion_to_yaw(q) -> float:
    """Yaw (z rotation) from a quaternion with w/x/y/z_val attributes
    (reference airsim/utils.py:250-259)."""
    w, x, y, z = (float(q.w_val), float(q.x_val), float(q.y_val), float(q.z_val))
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    return float(np.arctan2(siny_cosp, cosy_cosp))


def _at(z, i: int) -> float:
    """Entry i of a per-vehicle altitude array, or the scalar itself."""
    return float(np.ravel(z)[i] if np.ndim(z) else z)


class _ClientOps:
    """Fan-out async RPC helpers (reference airsim/utils.py:182-242)."""

    def __init__(self, client, names: Sequence[str], home: np.ndarray):
        self.client = client
        self.names = list(names)
        self.home = np.asarray(home)

    def setup_drones(self):
        for n in self.names:
            self.client.enableApiControl(True, n)
        for n in self.names:
            self.client.armDisarm(True, n)
        for f in [self.client.takeoffAsync(vehicle_name=n) for n in self.names]:
            f.join()

    def get_states(self):
        n = len(self.names)
        states = np.zeros((n, 4))
        yaws = np.zeros((n, 1))
        for i, name in enumerate(self.names):
            k = self.client.getMultirotorState(vehicle_name=name).kinematics_estimated
            states[i, 0] = float(k.position.x_val) + self.home[i][0]
            states[i, 1] = float(k.position.y_val) + self.home[i][1]
            states[i, 2] = float(k.linear_velocity.x_val)
            states[i, 3] = float(k.linear_velocity.y_val)
            yaws[i] = quaternion_to_yaw(k.orientation)
        return states, yaws

    def send_accel(self, roll_pitch: np.ndarray, z, duration=0.01):
        futures = [
            self.client.moveByAngleZAsync(float(roll_pitch[i, 0]), float(roll_pitch[i, 1]),
                                          _at(z, i), 0.0, duration, vehicle_name=n)
            for i, n in enumerate(self.names)
        ]
        for f in futures:
            f.join()

    def send_velocity(self, u: np.ndarray, z, duration=0.01):
        futures = [
            self.client.moveByVelocityZAsync(float(u[i, 0]), float(u[i, 1]), _at(z, i),
                                             duration, vehicle_name=n)
            for i, n in enumerate(self.names)
        ]
        for f in futures:
            f.join()

    def send_locations(self, loc: np.ndarray, z, offset=(0.0, 0.0), timeout=10):
        futures = [
            self.client.moveToPositionAsync(
                float(loc[i][0] - self.home[i][0] + offset[0]),
                float(loc[i][1] - self.home[i][1] + offset[1]),
                _at(z, i), 6.0, vehicle_name=n,
            )
            for i, n in enumerate(self.names)
        ]
        sleep(0.1)
        for f in futures:
            # quads sometimes get stuck in a crash and never arrive
            # (reference flocking_airsim_accel.py:160)
            f._timeout = timeout
            f.join()


class AirsimFlockingBridge:
    """Acceleration-command flocking on AirSim multirotors (reference
    ``FlockingAirsimAccelEnv``): actions are accelerations turned into
    roll/pitch through the current yaw (:90-93), states read back each step
    with the home offsets added, and the flocking features, reward and
    Turner expert evaluated on them on ``device``."""

    def __init__(self, client, settings_path: Optional[str] = None,
                 names: Optional[List[str]] = None, home: Optional[np.ndarray] = None,
                 device="cuda"):
        if settings_path is not None:
            names, home = parse_settings(settings_path)
        if names is None or home is None:
            raise ValueError("pass settings_path=, or names= and home=")
        self.device = require_device(device)
        self.ops = _ClientOps(client, names, home)
        self.n_agents = len(names)
        self.scale = 6.0
        self.z = -50.0
        self.max_accel = 0.5
        self.v_max = 1.0
        self.yaws = np.zeros((self.n_agents, 1))

        from gym_flock_tpu_torch.envs.flocking import FlockingParams

        self.params = FlockingParams(n_agents=self.n_agents)
        self.x = np.zeros((self.n_agents, 4))

    def _x(self) -> torch.Tensor:
        return torch.as_tensor(self.x, dtype=torch.float32, device=self.device)[None]

    def _obs(self):
        from gym_flock_tpu_torch.envs.flocking import flocking_features

        values, _, adj_mean, _ = flocking_features(self._x(), self.params.comm_radius2)
        return first(fetch((values, adj_mean)))

    def reset(self, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        self.ops.client.reset()
        self.ops.setup_drones()

        x0 = grid(self.n_agents)
        bias = rng.uniform(-self.v_max, self.v_max, size=(2,))
        v0 = rng.uniform(-self.v_max, self.v_max, size=(self.n_agents, 2)) + bias

        states, self.yaws = self.ops.get_states()
        mean_xy = (np.mean(states[:, 0]), np.mean(states[:, 1]))
        self.ops.send_locations(x0 * self.scale, self.z, offset=mean_xy)
        self.ops.send_velocity(v0 * self.scale, self.z, duration=2.0)

        states, self.yaws = self.ops.get_states()
        self.x = states / self.scale
        return self._obs()

    def step(self, u: np.ndarray):
        u = np.clip(u, -self.max_accel, self.max_accel) * self.scale
        yaw = self.yaws[:, 0]
        # acceleration -> roll/pitch through the yaw (reference :90-93)
        roll = (u[:, 1] * np.cos(yaw) - u[:, 0] * np.sin(yaw)) / GRAVITY
        pitch = (-u[:, 0] * np.cos(yaw) - u[:, 1] * np.sin(yaw)) / GRAVITY
        self.ops.send_accel(np.stack((pitch, roll), axis=1), self.z)

        states, self.yaws = self.ops.get_states()
        self.x = states / self.scale
        values, network = self._obs()
        reward = -float(np.sum(np.var(self.x[:, 2:4], axis=0)))
        return (values, network), reward, False, {}

    def controller(self):
        from gym_flock_tpu_torch.envs.flocking import turner_controller

        u = first(fetch(turner_controller(self._x(), self.params)))
        return np.clip(u, -self.max_accel, self.max_accel)


class AirsimCoverageBridge:
    """Coverage on AirSim drones (reference ``CoverageAirsimEnv``): the sim
    owns the motion, the env core the graph MDP.  The chosen action edge
    becomes a waypoint, a P-controller turns the position offset into a
    velocity command (:101-103), and the robots snap back onto graph nodes
    after each physics interval.  ``legacy_env`` is a
    ``compat.make_legacy`` coverage env (on the card unless it was made on
    the host)."""

    def __init__(self, client, legacy_env, settings_path: Optional[str] = None,
                 names: Optional[List[str]] = None, home: Optional[np.ndarray] = None):
        if settings_path is not None:
            names, home = parse_settings(settings_path)
        if names is None or home is None:
            raise ValueError("pass settings_path=, or names= and home=")
        n_robots = int(legacy_env.params.n_robots)
        if len(names) != n_robots:
            raise ValueError(
                f"{len(names)} vehicles for an env with {n_robots} robots; pass a "
                f"matching settings.json or make the env with n_robots={len(names)}"
            )
        self.ops = _ClientOps(client, names, home)
        self.env = legacy_env
        self.v_max = 2.0
        self.z = np.linspace(-50, -30, num=len(names))

    def _graph(self):
        """The current graph's node positions, neighbor table and the
        robots' nodes, on the host."""
        st = self.env.state
        g = st.graph[0].long()
        bank = self.env.params.bank
        return fetch((bank["target_pos"][g], bank["neighbor_table"][g], st.robot_loc[0]))

    def reset(self):
        self.ops.client.reset()
        self.ops.setup_drones()
        obs = self.env.reset()
        pos, _, cur = self._graph()
        self.ops.send_locations(pos[cur], self.z)  # fly to the start nodes
        self._sync()
        return obs

    def _sync(self):
        states, _ = self.ops.get_states()
        self.env.update_state(states[:, 0:2])

    def step(self, u_ind: np.ndarray):
        pos, nbr, cur = self._graph()
        nxt = nbr[cur, np.asarray(u_ind).reshape(-1)]
        # one RPC sweep serves the state snap and the P-controller
        states, _ = self.ops.get_states()
        self.env.update_state(states[:, 0:2])
        u = -1.0 * np.clip(states[:, 0:2] - pos[nxt], -self.v_max, self.v_max)
        self.ops.send_velocity(u, self.z, duration=0.1)
        self._sync()
        return self.env.step(u_ind)
