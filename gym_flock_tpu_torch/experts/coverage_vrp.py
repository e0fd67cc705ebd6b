"""Host-side VRP expert policy for the coverage envs (counterpart of
``gym_flock_tpu/experts/coverage_vrp.py``).

The reference's expert pipeline (reference coverage.py:800-872 and
vrp_solver.py:15-58): a depot-augmented vehicle routing problem over the
unvisited targets, solved natively (``experts.vrp``), the per-robot
waypoint routes cached, and each step's next waypoint mapped to a discrete
action through the predecessor matrix.

This is host NumPy: the solver is sequential combinatorial search.  Bulk
rollouts on the card use the greedy expert (``CoverageEnv.controller``,
K5); this policy labels states with the better expert
(``parallel.vrp_labels``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gym_flock_tpu_torch.envs.coverage import MAX_COST, CoverageParams
from gym_flock_tpu_torch.experts.vrp import solve_vrp_raw

__all__ = ["CoverageVRPPolicy", "create_vrp_problem"]

PENALTY_MULTIPLIER = 500.0  # reference vrp_solver.py:12


def _host(value) -> np.ndarray:
    """A tensor (on any device) or array as a NumPy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def create_vrp_problem(
    graph_cost: np.ndarray,
    visited: np.ndarray,
    discovered: Optional[np.ndarray],
    robot_loc: np.ndarray,
    n_targets: int,
):
    """Depot-augmented time matrix, penalties and 1-based start nodes
    (reference vrp_solver.py:15-58)."""
    init_loc = np.asarray(robot_loc)

    need = (visited[:n_targets] == 0).astype(np.float64)
    if discovered is not None:
        need = need * (discovered[:n_targets] != 0)
    penalties = np.concatenate(([0.0], need * PENALTY_MULTIPLIER))

    dist = np.array(graph_cost[:n_targets, :n_targets], dtype=np.float64)
    fill = np.ones(n_targets)
    fill[init_loc] = 0
    ignore = np.where((visited[:n_targets] != 0) & (fill != 0))[0]
    dist[ignore, :] = PENALTY_MULTIPLIER
    dist[:, ignore] = PENALTY_MULTIPLIER

    from_depot = np.full((1, n_targets), 100000.0)
    from_depot[:, init_loc] = 0.0
    to_depot = np.zeros((n_targets + 1, 1))
    dist = np.vstack((from_depot, dist))
    dist = np.hstack((to_depot, dist))
    return dist, penalties, init_loc + 1  # node ids shifted by the depot


class CoverageVRPPolicy:
    """Stateful VRP expert for ONE env: ``policy(state) -> [R, 1]`` int32
    actions, where ``state`` has the fields ``graph``, ``robot_loc``,
    ``visited``, ``discovered`` and ``time`` of one env (tensors on any
    device, or arrays).

    Keeps each robot's cached route between steps and solves again when
    the cache runs out, or every step under a rolling ``horizon``
    (reference coverage.py:833-837).  ``mode``, ``last_accept`` and ``rot``
    go to :func:`solve_vrp_raw`; ``strict`` raises where the reference's
    decode asserts (vrp_solver.py:144-146) instead of falling back to the
    greedy target or a random action.  The fallback draws from
    ``np.random.RandomState(0)``, as the JAX package's does.
    """

    def __init__(self, params: CoverageParams, horizon: int = -1,
                 mode: str = "or_default", strict: bool = False,
                 last_accept: bool = False, rot: int = 0):
        self.params = params
        self.horizon = horizon
        self.mode = mode
        self.last_accept = last_accept
        self.rot = rot
        self.strict = strict
        self.cached: Optional[List[List[int]]] = None
        self._rng = np.random.RandomState(0)

    def reset(self):
        self.cached = None

    def __call__(self, state) -> np.ndarray:
        p = self.params
        R = p.n_robots
        g = int(_host(state.graph))
        bank = p.bank
        n_targets = int(_host(bank["n_targets"][g]))
        graph_cost = _host(bank["graph_cost"][g])
        graph_prev = _host(bank["graph_prev"][g])
        nbr = _host(bank["neighbor_table"][g])
        visited = _host(state.visited)
        discovered = _host(state.discovered) if p.hide_nodes else None
        cur = _host(state.robot_loc)

        # greedy fallback targets (reference coverage.py:814-826)
        r = graph_cost[cur, :].copy()
        blocked = (visited >= 1.0).copy()
        if discovered is not None:
            blocked |= discovered <= 0.0
        r[:, blocked[: r.shape[1]]] = MAX_COST
        r[:, n_targets:] = MAX_COST
        greedy_loc = np.argmin(r, axis=1)
        for i in range(R):
            if r[i, greedy_loc[i]] >= MAX_COST:
                greedy_loc[i] = -1

        # (re-)solve the VRP (reference coverage.py:833-837)
        if self.cached is None or self.horizon > -1:
            if self.horizon > -1:
                budget = min(self.horizon, p.episode_length - int(_host(state.time)))
            else:
                budget = p.episode_length
            tm, pen, init = create_vrp_problem(graph_cost, visited, discovered, cur, n_targets)
            routes = solve_vrp_raw(tm, pen, init, float(budget), mode=self.mode,
                                   last_accept=self.last_accept, rot=self.rot)
            if self.strict:
                for i, route in enumerate(routes):
                    if not route or route[0] != int(init[i]):
                        raise AssertionError("First stop is not an initial position")
            # depot-node ids -> target indices
            self.cached = [[n - 1 for n in route] for route in routes]

        # follow the cached waypoints (reference coverage.py:839-857)
        next_loc = np.zeros((R,), dtype=int)
        for i in range(R):
            sol = self.cached[i]
            if len(sol) > 1:
                if cur[i] == sol[0]:
                    self.cached[i] = sol = sol[1:]
                next_loc[i] = sol[0]
            elif len(sol) == 1:
                if cur[i] == sol[0]:
                    self.cached[i] = []
                    next_loc[i] = 0  # the reference leaves 0 in next_loc
                else:
                    next_loc[i] = sol[0]
            else:
                next_loc[i] = greedy_loc[i]

        # waypoint -> action index via the predecessors (reference :859-871)
        u = np.zeros((R, 1), dtype=np.int32)
        for i in range(R):
            if next_loc[i] == -1 or graph_prev[next_loc[i], cur[i]] == -1:
                u[i] = self._rng.choice(p.n_actions)
            else:
                nxt = graph_prev[next_loc[i], cur[i]]
                u[i] = np.where(nbr[cur[i]] == nxt)[0][0]
        return u
