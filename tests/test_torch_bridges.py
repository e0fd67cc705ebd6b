"""The port's AirSim and ROS bridges and ``parse_settings`` against the JAX
package's, with a fake AirSim client (the suite has no simulator).

The same client reads go into both packages' bridges, and the commands
the clients receive are held equal: the coverage bridge's exactly (NumPy
float64 from the same bank positions and states), the flocking bridge's
within 1e-5 (its Turner expert runs in f32 in both packages, in other
summation orders).
"""
import json
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.bridges import airsim_bridge as jbridge
from gym_flock_tpu.bridges import ros_bridge as jros
from gym_flock_tpu.compat import gym_api as jgym
from gym_flock_tpu.utils import formations as jformations
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.bridges import (
    AirsimCoverageBridge,
    AirsimFlockingBridge,
    RosCoverageDriver,
    quaternion_to_yaw,
)
from gym_flock_tpu_torch.compat import make_legacy
from gym_flock_tpu_torch.utils import formations

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CMD_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


class _Future:
    def join(self):
        pass


class _Vec:
    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x_val, self.y_val, self.z_val = x, y, z


class _Quat:
    def __init__(self, w=1.0, x=0.0, y=0.0, z=0.0):
        self.w_val, self.x_val, self.y_val, self.z_val = w, x, y, z


class FakeClient:
    """AirSim-compatible physics stub that records every command: velocity
    commands integrate, position commands teleport, tilt commands turn
    into an acceleration; each drone has its own yaw."""

    def __init__(self, names, yaw=0.3):
        self.pos = {n: np.zeros(2) for n in names}
        self.vel = {n: np.zeros(2) for n in names}
        self.yaw = {n: yaw * i for i, n in enumerate(names)}
        self.calls = []

    def reset(self):
        self.calls.append(("reset",))

    def enableApiControl(self, flag, name):
        self.calls.append(("api", name))

    def armDisarm(self, flag, name):
        self.calls.append(("arm", name))

    def takeoffAsync(self, vehicle_name):
        self.calls.append(("takeoff", vehicle_name))
        return _Future()

    def moveToPositionAsync(self, x, y, z, speed, vehicle_name):
        self.calls.append(("position", vehicle_name, x, y, z, speed))
        self.pos[vehicle_name] = np.array([x, y])
        return _Future()

    def moveByVelocityZAsync(self, vx, vy, z, duration, vehicle_name):
        self.calls.append(("velocity", vehicle_name, vx, vy, z, duration))
        self.vel[vehicle_name] = np.array([vx, vy])
        self.pos[vehicle_name] = self.pos[vehicle_name] + duration * self.vel[vehicle_name]
        return _Future()

    def moveByAngleZAsync(self, pitch, roll, z, yaw, duration, vehicle_name):
        self.calls.append(("angle", vehicle_name, pitch, roll, z, yaw, duration))
        accel = 9.8 * np.array([-pitch, roll])
        self.vel[vehicle_name] = self.vel[vehicle_name] + accel * duration * 10
        self.pos[vehicle_name] = self.pos[vehicle_name] + self.vel[vehicle_name] * duration * 10
        return _Future()

    def getMultirotorState(self, vehicle_name):
        class S:
            pass

        s = S()
        s.kinematics_estimated = S()
        s.kinematics_estimated.position = _Vec(*self.pos[vehicle_name], 0.0)
        s.kinematics_estimated.linear_velocity = _Vec(*self.vel[vehicle_name], 0.0)
        yaw = self.yaw[vehicle_name]
        s.kinematics_estimated.orientation = _Quat(np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
        return s


def _assert_calls_equal(got, want, atol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and len(g) == len(w)
        np.testing.assert_allclose(np.asarray(g[2:], float), np.asarray(w[2:], float),
                                   rtol=0, atol=atol, err_msg=str(w[:2]))


def test_quaternion_to_yaw_equals_jax():
    for q in (_Quat(1, 0, 0, 0), _Quat(np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)),
              _Quat(0.3, 0.1, -0.2, 0.9)):
        assert quaternion_to_yaw(q) == jbridge.quaternion_to_yaw(q)


@pytest.mark.parametrize("name", ["settings.json", "settings2.json", "settings50.json"])
def test_parse_settings_equals_jax(name):
    path = str(REPO / "gym_flock_tpu" / "bridges" / "configs" / name)
    names, homes = formations.parse_settings(path)
    jnames, jhomes = jformations.parse_settings(path)
    assert names == jnames
    np.testing.assert_array_equal(homes, jhomes)


def test_parse_settings_pretty_printed_equals_jax(tmp_path):
    p = tmp_path / "settings.json"
    p.write_text(json.dumps({"Vehicles": {"A": {"X": 0, "Y": 1, "Z": -2},
                                          "B": {"X": 3.5, "Y": -1}}}, indent=4))
    names, homes = formations.parse_settings(str(p))
    assert names == ["A", "B"]
    np.testing.assert_array_equal(homes, jformations.parse_settings(str(p))[1])
    p.write_text(json.dumps({"Vehicles": {}}))
    with pytest.raises(ValueError, match="no Vehicles"):
        formations.parse_settings(str(p))


def test_flocking_bridge_sends_jax_commands():
    """Reset and 6 expert steps of both bridges, each on its own fake
    client from the same reads: the tilt commands agree."""
    names = [f"Drone{i}" for i in range(10)]
    home = np.stack([np.arange(10) * 0.5, np.zeros(10), np.zeros(10)], axis=1)
    jc, tc = FakeClient(names), FakeClient(names)
    jb = jbridge.AirsimFlockingBridge(jc, names=names, home=home)
    tb = AirsimFlockingBridge(tc, names=names, home=home, device="cpu")
    jobs = jb.reset(np.random.RandomState(0))
    tobs = tb.reset(np.random.RandomState(0))
    assert tobs[0].shape == (10, 6) and tobs[1].shape == (10, 10)
    np.testing.assert_allclose(tobs[0], jobs[0], rtol=1e-5, atol=1e-5)
    for _ in range(6):
        ju, tu = jb.controller(), tb.controller()
        np.testing.assert_allclose(tu, ju, rtol=0, atol=CMD_ATOL)
        (jv, jn), jr, jd, _ = jb.step(ju)
        (tv, tn), tr, td, _ = tb.step(ju)  # the same action into both
        np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-6)
        assert tr == jr and td == jd is False
    _assert_calls_equal(tc.calls, jc.calls, atol=CMD_ATOL)
    assert ("reset",) in tc.calls


def _coverage_pair(seed):
    """JAX's legacy coverage env after a reset, and the port's with JAX's
    state carried over (the two reset streams differ)."""
    jl = jgym.make_legacy("Coverage-v0", n_graphs=1)
    jl.seed(seed)
    jl.reset()
    tl = make_legacy("Coverage-v0", device="cpu", n_graphs=1)
    tl.reset()
    tl._state = convert.coverage_state_from_numpy(
        jax.tree.map(lambda x: np.asarray(x)[None], jl.state))
    return jl, tl


def test_coverage_bridge_sends_jax_commands():
    """From the same state and start positions, 5 greedy steps of both
    bridges send the same velocity commands and reach the same states."""
    jl, tl = _coverage_pair(0)
    names = [f"Drone{i}" for i in range(6)]
    home = np.zeros((6, 3))
    jc, tc = FakeClient(names), FakeClient(names)
    jb = jbridge.AirsimCoverageBridge(jc, jl, names=names, home=home)
    tb = AirsimCoverageBridge(tc, tl, names=names, home=home)
    g = int(jl.state.graph)
    start = np.asarray(jl.params.bank["target_pos"][g])[np.asarray(jl.state.robot_loc)]
    for b, c in ((jb, jc), (tb, tc)):
        b.ops.send_locations(start, b.z)
        b._sync()
    for _ in range(5):
        a = jl.controller(random=False, greedy=True)
        np.testing.assert_array_equal(tl.controller(greedy=True), a)
        jobs, jr, jd, _ = jb.step(a)
        tobs, tr, td, _ = tb.step(a)
        assert (tr, td) == (jr, jd)
        for k in ("senders", "receivers", "nodes"):
            np.testing.assert_array_equal(tobs[k], jobs[k], err_msg=k)
        np.testing.assert_array_equal(tl.state.robot_loc[0].numpy(),
                                      np.asarray(jl.state.robot_loc))
    _assert_calls_equal(tc.calls, jc.calls)


def test_coverage_bridge_reset_and_vehicle_count():
    tl = make_legacy("Coverage-v0", device="cpu", n_graphs=1)
    names = [f"D{i}" for i in range(6)]
    client = FakeClient(names)
    obs = AirsimCoverageBridge(client, tl, names=names, home=np.zeros((6, 3))).reset()
    assert set(obs) == set(tl.keys) and ("reset",) in client.calls
    with pytest.raises(ValueError, match="4 vehicles"):
        AirsimCoverageBridge(FakeClient(names[:4]), tl, names=names[:4], home=np.zeros((4, 3)))


def test_ros_driver_sends_jax_goals():
    jl, tl = _coverage_pair(1)
    g = int(jl.state.graph)
    pos = np.asarray(jl.params.bank["target_pos"][g])
    cur = np.asarray(jl.state.robot_loc)
    sent = {"jax": [], "port": []}
    drivers = {
        "jax": jros.RosCoverageDriver(
            jl, get_poses=lambda: pos[cur] + 0.1,
            send_goal=[lambda goal, i=i: sent["jax"].append((i, goal)) for i in range(6)]),
        "port": RosCoverageDriver(
            tl, get_poses=lambda: pos[cur] + 0.1,
            send_goal=[lambda goal, i=i: sent["port"].append((i, goal)) for i in range(6)]),
    }
    for _ in range(3):
        assert drivers["port"].tick() == drivers["jax"].tick()
    assert len(sent["port"]) == 18
    for (i, goal), (j, want) in zip(sent["port"], sent["jax"]):
        assert i == j
        np.testing.assert_array_equal(goal, want)
    with pytest.raises(ValueError, match="goto services"):
        RosCoverageDriver(tl, get_poses=lambda: None, send_goal=[print])


def test_airsim_ids_registered_as_in_jax():
    """Both AirSim ids, with JAX's ``max_episode_steps``; without a client
    each raises JAX's ValueError; with a fake client they build bridges
    (MappingAirsim-v0 over ``make_legacy("Coverage-v0")``)."""
    for env_id in ("FlockingAirsimAccel-v0", "MappingAirsim-v0"):
        assert gft.registry[env_id].max_episode_steps == \
            gft_jax.registry[env_id].max_episode_steps
        with pytest.raises(ValueError, match="requires an AirSim-compatible client"):
            gft.make(env_id)
    names = [f"D{i}" for i in range(5)]
    bridge, params = gft.make("FlockingAirsimAccel-v0", client=FakeClient(names), names=names,
                              home=np.zeros((5, 3)), device="cpu")
    assert isinstance(bridge, AirsimFlockingBridge) and params.n_agents == 5
    assert bridge.reset(np.random.RandomState(0))[0].shape == (5, 6)
    names6 = [f"D{i}" for i in range(6)]
    cov, cparams = gft.make("MappingAirsim-v0", client=FakeClient(names6), names=names6,
                            home=np.zeros((6, 3)), n_graphs=1, device="cpu")
    assert isinstance(cov, AirsimCoverageBridge) and cparams.n_robots == 6
    assert "nodes" in cov.reset()
