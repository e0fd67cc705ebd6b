"""Legacy-RNG parity resets: bit-identical initial states from a seed (a copy
of ``gym_flock_tpu/compat/parity.py``, host NumPy; the port cannot import
the JAX package's modules, which import JAX).

The reference's flocking reset draws from the *global* ``np.random`` stream
(reference flocking_relative.py:167-174 — not the seeded ``self.np_random``,
SURVEY.md §5.9a).  For golden-trajectory reproduction from a seed, this
module performs byte-identical draw sequences on the host (same ops, same
order, same MT19937 stream); the resulting state enters a batched env through
``init_state`` (a ``[1, n, 4]`` tensor).  With ``parity_exact=True`` the
envs' dynamics then follow the reference's NumPy op order, so trajectories
match it end to end at float64.

Coverage resets mix two streams (``self.np_random`` for center/robots/
unvisited, global ``np.random`` in map generation at make_map.py:208);
:func:`reference_coverage_reset` replays both byte-exactly, and
:func:`reference_coverage_arl_subgraph` replays CoverageARL's additional
random-subwindow stream (coverage_arl.py:64-82) on top — both proven
against the real reference envs by the JAX package's tests, the ARL one on
the real occupancy map; this copy is held bit for bit to the JAX package's
(tests/test_torch_parity_exact.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "reference_flocking_reset",
    "reference_twoflocks_reset",
    "reference_stochastic_dt",
    "reference_shepherding_reset",
    "reference_coverage_reset",
    "reference_coverage_arl_subgraph",
    "gym011_np_random",
]


def reference_flocking_reset(
    n_agents: int,
    r_max: float,
    v_max: float,
    comm_radius2: float,
    v_bias: Optional[float] = None,
    min_dist_thresh: float = 0.1,
    rng=np.random,
) -> np.ndarray:
    """Replay the reference flocking reset's exact draw sequence.

    ``rng`` defaults to the global ``np.random`` module — seed it with
    ``np.random.seed(s)`` to reproduce the reference under the same seed
    (that is what the reference itself consumes).  Returns x [n, 4].

    Draw order per rejection-loop iteration (flocking_relative.py:164-184):
    uniform lengths, uniform angles, uniform 2-bias, uniform vx, uniform vy;
    accept when min degree >= 2 and min pairwise distance > 0.1.
    """
    if v_bias is None:
        v_bias = v_max
    x = np.zeros((n_agents, 4))
    degree = 0
    min_dist = 0.0
    guard = 0
    while degree < 2 or min_dist < min_dist_thresh:
        guard += 1
        if guard > 10000:
            raise RuntimeError(
                "reset rejection sampling did not terminate — the reference "
                "default config has acceptance ~0 (SURVEY.md §5.9b); scale "
                "r_max by sqrt(n_agents) as params_from_cfg does"
            )
        length = np.sqrt(rng.uniform(0, r_max, size=(n_agents,)))
        angle = np.pi * rng.uniform(0, 2, size=(n_agents,))
        x[:, 0] = length * np.cos(angle)
        x[:, 1] = length * np.sin(angle)
        bias = rng.uniform(low=-v_bias, high=v_bias, size=(2,))
        x[:, 2] = rng.uniform(low=-v_max, high=v_max, size=(n_agents,)) + bias[0]
        x[:, 3] = rng.uniform(low=-v_max, high=v_max, size=(n_agents,)) + bias[1]

        x_loc = np.reshape(x[:, 0:2], (n_agents, 2, 1))
        a_net = np.sum(
            np.square(
                np.transpose(x_loc, (0, 2, 1)) - np.transpose(x_loc, (2, 0, 1))
            ),
            axis=2,
        )
        np.fill_diagonal(a_net, np.inf)
        min_dist = np.sqrt(np.min(np.min(a_net)))
        a_net = a_net < comm_radius2
        degree = np.min(np.sum(a_net.astype(int), axis=1))
    return x


def reference_twoflocks_reset(
    n_agents: int = 100,
    v_bias: float = 5.0,
    rng=np.random,
) -> np.ndarray:
    """Replay the reference ``FlockingTwoFlocksEnv.reset()`` draw sequence
    (flocking_twoflocks.py:8-26) byte-exactly.

    One draw on the global stream: ``bias ~ U(-v_bias/2, v_bias/2, size=2)``;
    positions are the deterministic 0.8-grid (``utils/formations.grid`` is
    byte-identical to reference flocking/utils.py:23-30) and velocities are
    ``-grid + bias``.  Returns x [n, 4].
    """
    from gym_flock_tpu_torch.utils.formations import grid

    bias = rng.uniform(low=-v_bias / 2.0, high=v_bias / 2.0, size=(2,))
    x = np.zeros((n_agents, 4))
    grids = grid(n_agents, side=int(n_agents / 10))
    x[:, 0:2] = grids
    x[:, 2:4] = -grids
    x[:, 2] = x[:, 2] + bias[0]
    x[:, 3] = x[:, 3] + bias[1]
    return x


def reference_stochastic_dt(
    rng=np.random, dt_mean: float = 0.12, dt_sigma: float = 0.018
) -> float:
    """One per-step dt draw of ``FlockingStochasticEnv`` (flocking_stoch.py:20:
    ``np.random.normal(dt_mean, dt_sigma)`` on the GLOBAL stream).

    For seed-exact golden trajectories, replay the whole stream: seed a
    ``RandomState``, consume the reset draws via
    :func:`reference_flocking_reset`, then call this once per step and feed
    the dt into ``FlockingStochasticEnv.step_with_dt``.
    """
    return float(rng.normal(dt_mean, dt_sigma))


def gym011_np_random(seed: int) -> np.random.RandomState:
    """A RandomState seeded exactly as gym 0.11's ``seeding.np_random``.

    gym 0.11 does NOT seed with the raw integer: it sha512-hashes
    ``str(seed)``, takes the first 8 bytes as a little-endian bigint, and
    seeds with that bigint split into uint32 limbs.  Replaying the real
    reference's ``self.np_random`` stream requires the same pipeline.
    """
    import hashlib
    import struct

    digest = hashlib.sha512(str(seed).encode("utf8")).digest()[:8]
    # _bigint_from_bytes: little-endian uint32 limbs -> bigint
    padded = digest + b"\0" * ((4 - len(digest) % 4) % 4)
    accum = 0
    for i, val in enumerate(struct.unpack("%dI" % (len(padded) // 4), padded)):
        accum += 2 ** (32 * i) * val
    # _int_list_from_bigint
    limbs = []
    big = accum
    while big > 0:
        big, mod = divmod(big, 2**32)
        limbs.append(mod)
    rng = np.random.RandomState()
    rng.seed(limbs if limbs else 0)
    return rng


def reference_shepherding_reset(
    seed: int,
    n_agents: int = 30,
    r_max: float = None,
    goal_offset=None,
    prev_theta: np.ndarray = None,
) -> np.ndarray:
    """Replay the reference shepherding reset's exact draw sequence.

    Unlike flocking, the shepherding reset draws from the *seeded*
    ``self.np_random`` stream (reference shepherding.py:187-202) through
    gym 0.11's hashed seeding (:func:`gym011_np_random`), so a bare seed
    fully determines the fresh-env initial state: uniform lengths, then
    uniform angles.  The reference's reset only overwrites x[:, 0:2] —
    theta persists from any earlier episode — so pass ``prev_theta`` when
    replaying a non-fresh env; a fresh env has theta = 0.
    """
    if r_max is None:
        r_max = 1.0 * np.sqrt(n_agents)
    if goal_offset is None:
        goal_offset = (-r_max * 3.0, 0.0)
    rng = gym011_np_random(seed)
    x = np.zeros((n_agents, 3))
    length = np.sqrt(rng.uniform(0, r_max, size=(n_agents,)))
    angle = np.pi * rng.uniform(0, 2, size=(n_agents,))
    x[:, 0] = length * np.cos(angle) + goal_offset[0]
    x[:, 1] = length * np.sin(angle) + goal_offset[1]
    if prev_theta is not None:
        x[:, 2] = prev_theta
    return x


def reference_coverage_reset(
    seed: int,
    n_robots: int = 6,
    frac_active_targets: float = 0.5,
    nearby_density: int = 5,
    map_rng=None,
    rng=None,
    targets=None,
    motion_radius=None,
):
    """Replay the reference ``CoverageEnv.reset()`` draw sequence byte-exactly.

    The reference's coverage reset consumes TWO RNG streams (SURVEY.md §5.9a):
    the *global* ``np.random`` inside map generation
    (make_map.py:208 via coverage.py:516-527) and the seeded
    ``self.np_random`` for the nearby-start center, robot placement, and
    unvisited selection (coverage.py:399-417, 596-599).  This replays both:

    1. map: ``generate_coverage_targets`` is byte-identical to the
       reference's ``_generate_targets`` from the same stream (tested);
       pass ``map_rng`` (default: the global ``np.random`` module, i.e.
       seed it with ``np.random.seed(s)`` exactly as for the reference).
    2. nearby-start region: BFS ring expansion from a ``np_random.choice``
       center until >= ``n_robots * nearby_density`` nodes are reached
       (coverage.py:655-673's ``get_n_nearest``), replayed via unweighted
       shortest-path levels.
    3. robots: ``choice(region, size=n_robots, replace=False)``;
       unvisited: ``choice(all_targets, size=int(n*frac), replace=False)``
       — both on the gym-0.11 sha512-hashed stream (:func:`gym011_np_random`).

    Pass ``rng`` to continue an existing ``self.np_random`` stream across
    multiple resets of the same env instance (like the reference, which
    seeds once and keeps drawing).

    Pass ``targets`` to skip map generation (e.g. an ARL subwindow from
    :func:`reference_coverage_arl_subgraph`) and ``motion_radius`` when the
    env's differs from Coverage-v0's (ARL: res 5.0 * 1.2 = 6.0).

    Returns ``(targets [n_t, 2], robot_loc [n_robots], visited [n_t])`` —
    target-local indices/masks ready for ``CoverageState`` injection.
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from gym_flock_tpu_torch.envs.coverage_graph import DELTA, generate_coverage_targets

    if targets is None:
        if map_rng is None:
            map_rng = np.random
        targets = generate_coverage_targets(map_rng)
    n_t = targets.shape[0]
    if rng is None:
        rng = gym011_np_random(seed)

    # nearby-start region (coverage.py:596-599 under graph_changed=True)
    center = rng.choice(n_t)
    if motion_radius is None:
        motion_radius = DELTA * 1.2
    d = np.linalg.norm(targets[:, None, :] - targets[None, :, :], axis=2)
    adj = (d <= motion_radius).astype(float)  # self_loops=True upstream
    hops = shortest_path(csr_matrix(adj), method="D", unweighted=True)
    want = n_robots * nearby_density
    level = 0
    reachable = int(np.sum(np.isfinite(hops[center])))
    if reachable < want:
        # the center's connected component is too small: the ring expansion
        # can never reach `want` and the reference's loop
        # (coverage.py:655-673 get_n_nearest) would spin forever — fail
        # loudly instead (same spirit as reference_flocking_reset's guard)
        raise ValueError(
            f"start component has {reachable} nodes < {want} wanted "
            f"(n_robots*nearby_density) — map too fragmented for this seed"
        )
    while np.sum(hops[center] <= level) < want:
        level += 1
    start_region = hops[center] <= level

    robot_loc = rng.choice(
        np.arange(n_t)[start_region], size=(n_robots,), replace=False
    )
    # the reference draws from GLOBAL node ids (targets shifted by n_robots,
    # coverage.py:410-414) — replicate the exact choice input
    unvisited_global = np.arange(n_t) + n_robots
    chosen = rng.choice(
        unvisited_global,
        size=(int(len(unvisited_global) * frac_active_targets),),
        replace=False,
    )
    visited = np.ones((n_t,))
    visited[chosen - n_robots] = 0.0
    return targets, robot_loc.astype(np.int64), visited


def reference_coverage_arl_subgraph(
    all_targets: np.ndarray,
    motion_radius: float = 5.0 * 1.2,
    num_subgraphs: float = 3.0,
    min_graph_size: int = 200,
    map_rng=None,
):
    """Replay CoverageARL's per-episode random subwindow selection
    (reference coverage_arl.py:64-82) byte-exactly.

    Draws ``graph_start ~ U(min_xy, max_xy - subgraph_size)`` from the
    GLOBAL ``np.random`` stream (the reference's, coverage_arl.py:69),
    crops, keeps the largest connected component, retries until
    >= ``min_graph_size`` nodes.  ``all_targets`` is the full map after
    ``load_graph`` (our ``targets_from_occupancy`` is byte-identical to the
    reference's ``from_occupancy`` — tested on the real ARL map).
    """
    from gym_flock_tpu_torch.envs.coverage_graph import _largest_component

    if map_rng is None:
        map_rng = np.random
    min_xy = np.min(all_targets, axis=0).reshape((1, 2))
    max_xy = np.max(all_targets, axis=0).reshape((1, 2))
    subgraph_size = (max_xy - min_xy) / num_subgraphs
    while True:
        graph_start = map_rng.uniform(low=min_xy, high=max_xy - subgraph_size)
        graph_end = graph_start + subgraph_size
        inside = np.all(
            np.logical_and(graph_start <= all_targets, all_targets < graph_end), axis=1
        )
        targets = all_targets[inside, :]
        if targets.shape[0] < min_graph_size:
            continue
        targets = _largest_component(targets, motion_radius)
        if targets.shape[0] >= min_graph_size:
            return targets
