"""ROS/Unity live driver, host code over an injected pose source and
per-robot goal services (counterpart of
``gym_flock_tpu/bridges/ros_bridge.py``; the reference's test_sim.py:33-133
loop without importing rospy).

    import rospy
    driver = RosCoverageDriver(
        env,                               # compat.make_legacy("CoverageARL-v0")
        get_poses=lambda: pose_buffer.copy(),
        send_goal=[make_goto_service(i) for i in range(n_robots)],
    )
    while not rospy.is_shutdown():
        driver.tick()
        rate.sleep()
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from gym_flock_tpu_torch.compat.gym_api import fetch

__all__ = ["RosCoverageDriver"]


class RosCoverageDriver:
    def __init__(
        self,
        legacy_env,
        get_poses: Callable[[], np.ndarray],
        send_goal: Sequence[Callable[[np.ndarray], None]],
        altitudes: Optional[Sequence[float]] = None,
    ):
        self.env = legacy_env
        self.get_poses = get_poses
        self.send_goal = list(send_goal)
        n = len(self.send_goal)
        n_robots = int(legacy_env.params.n_robots)
        if n != n_robots:
            raise ValueError(
                f"{n} goto services for an env with {n_robots} robots: uncommanded or "
                "mis-snapped robots would otherwise go unnoticed"
            )
        self.altitudes = list(altitudes) if altitudes is not None else [-40.0] * n
        self.total_reward = 0.0

    def tick(self):
        """One loop iteration (reference test_sim.py:94-133): take the poses,
        compute the reward, run the greedy expert and send each robot its
        next waypoint.  Returns ``(reward, done)``; done fires on the tick
        the episode ends (all targets covered or time == episode_length)."""
        env = self.env
        env.update_state(self.get_poses())
        # obs and reward at the snapped state (the reference's action=None
        # step, coverage.py:180-202)
        obs, reward, done = env.observe()
        self.total_reward += reward
        action = env.controller(random=False, greedy=True)

        st = env.state
        g = st.graph[0].long()
        bank = env.params.bank
        pos, nbr, cur = fetch((bank["target_pos"][g], bank["neighbor_table"][g],
                               st.robot_loc[0]))
        waypoints = pos[nbr[cur, np.asarray(action).reshape(-1)]]
        for i, service in enumerate(self.send_goal):
            goal = np.asarray([waypoints[i, 0], waypoints[i, 1], self.altitudes[i], -1.57])
            try:
                service(goal)
            except Exception:
                # the reference swallows a failed service call
                # (ServiceException, test_sim.py:125-127) and goes on
                pass
        return float(reward), bool(done)
