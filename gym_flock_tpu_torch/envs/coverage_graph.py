"""Host-side map generation and static graph preprocessing for the coverage
envs (counterpart of ``gym_flock_tpu/envs/coverage_graph.py``).

The NumPy/SciPy code is carried over unchanged: road-lattice and
occupancy-map targets, the per-graph :class:`GraphSpec` (neighbor tables,
padded motion-edge buffers, the reference's all-pairs hop costs and
predecessors).  Only the conversion changes: :func:`build_graph_bank`
stacks the specs into a dict of torch tensors on one device.

Not ported: the one-hot / matrix-multiply operands of the JAX package
(``hide_mm_operands``, ``disc_reach_operand``), which exist to avoid slow
gathers on the TPU; the port takes the gather formulations, and
:func:`disc_reach_lists` replaces the reach table.  Banks are saved and
loaded in the JAX package's ``.npz`` format (:func:`save_graph_bank`,
:func:`load_graph_bank`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.spatial import Delaunay
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

__all__ = [
    "GraphSpec",
    "build_graph_spec",
    "generate_lattice",
    "generate_geometric_roads",
    "generate_coverage_targets",
    "build_graph_bank",
    "generate_occupancy_map",
    "targets_from_occupancy",
    "disc_reach_lists",
    "reach_key",
    "in_obstacle",
    "gen_obstacle_grid",
    "reject_collisions",
    "gen_square",
    "gen_grid",
    "gen_sparse_grid",
    "BANK_SCHEMA",
    "save_graph_bank",
    "load_graph_bank",
    "strip_operands",
]

# reference constants (coverage.py:54-80)
N_ACTIONS = 4
MAX_COST = 1000.0
DELTA = 5.5


# =============================================================================
# Map generation (reference make_map.py)
# =============================================================================


def generate_lattice(free_region, lattice_vectors) -> np.ndarray:
    """Sheared-lattice points inside a box (reference make_map.py:30-67).

    Same construction: integer grid sheared by the lattice vectors, trimmed
    to the box, translated to the center.
    """
    (xmin, xmax, ymin, ymax) = free_region
    image_shape = np.array([xmax - xmin, ymax - ymin])
    center_pix = image_shape // 2
    dx_cell = max(abs(lattice_vectors[0][0]), abs(lattice_vectors[1][0]))
    dy_cell = max(abs(lattice_vectors[0][1]), abs(lattice_vectors[1][1]))
    nx = image_shape[0] // dx_cell
    ny = image_shape[1] // dy_cell
    x_sq = np.arange(-nx, nx, dtype=float)[:, None]
    # NOTE: the reference's y range is arange(-ny, nx) — kept for parity
    y_sq = np.arange(-ny, nx, dtype=float)[None, :]
    x_lattice = lattice_vectors[0][0] * x_sq + lattice_vectors[1][0] * y_sq
    y_lattice = lattice_vectors[0][1] * x_sq + lattice_vectors[1][1] * y_sq
    mask = (
        (x_lattice < image_shape[0] / 2.0)
        & (x_lattice > -image_shape[0] / 2.0)
        & (y_lattice < image_shape[1] / 2.0)
        & (y_lattice > -image_shape[1] / 2.0)
    )
    x_l = x_lattice[mask] + (center_pix[0] + xmin)
    y_l = y_lattice[mask] + (center_pix[1] + ymin)
    out = np.empty((len(x_l), 2))
    out[:, 0] = y_l
    out[:, 1] = x_l
    return out


def generate_geometric_roads(
    n_cities: int, world_radius: float, road_radius: float, rng: np.random.RandomState
) -> np.ndarray:
    """Random city graph -> Delaunay edges -> road waypoints
    (reference make_map.py:207-231), with an explicit RNG instead of the
    global ``np.random`` stream (SURVEY.md §5.9a)."""
    vertices = rng.uniform(-world_radius, world_radius, size=(n_cities, 2))
    tri = Delaunay(vertices)
    indices, indptr = tri.vertex_neighbor_vertices
    edges = []
    for i in range(vertices.shape[0]):
        for j in indptr[indices[i] : indices[i + 1]]:
            if i < j:
                edges.append((i, j))
    waypoints = [vertices]
    for (s, r) in edges:
        p1, p2 = vertices[s : s + 1], vertices[r : r + 1]
        dist = np.linalg.norm(p1 - p2)
        n_new = int(dist / road_radius)
        for n in range(n_new):
            waypoints.append(p1 + (p2 - p1) / dist * n * road_radius)
    return np.vstack(waypoints)


def _largest_component(points: np.ndarray, radius: float) -> np.ndarray:
    """Keep the largest connected component under a radius graph
    (reference coverage.py:523-526)."""
    d = np.linalg.norm(points[:, None, :] - points[None, :, :], axis=2)
    d[d > radius] = 0
    _, labels = connected_components(
        csgraph=csr_matrix(d), directed=False, return_labels=True
    )
    return points[labels == np.argmax(np.bincount(labels)), :]


def generate_coverage_targets(
    rng: np.random.RandomState,
    xmax: float = 120.0,
    ymax: float = 120.0,
    res: float = DELTA,
    n_cities: int = 12,
) -> np.ndarray:
    """Coverage-v0 map: square lattice ∩ random roads, largest component
    (reference coverage.py:516-527)."""
    lattice_vectors = [np.array([-res, 0.0]), np.array([0.0, -res])]
    motion_radius = res * 1.2
    lattice = generate_lattice((-xmax, xmax, -ymax, ymax), lattice_vectors)
    roads = generate_geometric_roads(n_cities, xmax, motion_radius, rng)
    d = np.linalg.norm(lattice[:, None, :] - roads[None, :, :], axis=2)
    flag = np.min(d, axis=1) <= (motion_radius / 1.4)
    targets = lattice[flag, :]
    return _largest_component(targets, motion_radius)


# =============================================================================
# Occupancy-grid maps (CoverageARL family)
# =============================================================================


def generate_occupancy_map(
    rng: np.random.RandomState,
    shape: Tuple[int, int] = (128, 110),
    n_rooms: int = 14,
) -> np.ndarray:
    """Procedurally generate a building-like boolean occupancy grid.

    The reference ships binary occupancy maps of a real ARL facility
    (gym_flock/envs/spatial/maps/grid_slice{2,5,10}.npy, loaded at
    make_map.py:234-240).  Those are data assets, not code; the occupancy
    env factories auto-discover a real map when one is reachable
    (``envs.maps.find_reference_map``) and fall back to this
    procedural generator (occupied = True, free corridors and rooms =
    False) so the CoverageARL/Explore family stays self-contained without
    one.  Real maps can also be supplied explicitly via
    ``targets_from_occupancy(arr=...)`` / ``make(..., real_map=path)``.
    """
    occ = np.ones(shape, dtype=bool)
    h, w = shape
    # carve rooms
    for _ in range(n_rooms):
        rh = rng.randint(h // 10, h // 3)
        rw = rng.randint(w // 10, w // 3)
        r0 = rng.randint(1, h - rh - 1)
        c0 = rng.randint(1, w - rw - 1)
        occ[r0 : r0 + rh, c0 : c0 + rw] = False
    # carve connecting corridors (L-shaped between room centers)
    free = np.argwhere(~occ)
    centers = free[rng.choice(len(free), size=min(n_rooms, len(free)), replace=False)]
    for a, b in zip(centers[:-1], centers[1:]):
        occ[min(a[0], b[0]) : max(a[0], b[0]) + 1, a[1] - 1 : a[1] + 2] = False
        occ[b[0] - 1 : b[0] + 2, min(a[1], b[1]) : max(a[1], b[1]) + 1] = False
    occ[0, :] = occ[-1, :] = True
    occ[:, 0] = occ[:, -1] = True
    return occ


def targets_from_occupancy(
    arr: Optional[np.ndarray] = None,
    downsample_rate: int = 10,
    perimeter_delta: float = 2.0,
    rng: Optional[np.random.RandomState] = None,
    path: Optional[str] = None,
    map_shape: Tuple[int, int] = (128, 110),
) -> np.ndarray:
    """Free cells adjacent to occupied perimeter -> world-frame targets.

    Mirrors reference make_map.py:234-271 (``from_occupancy``): keep free
    cells within ``perimeter_delta`` of an occupied cell, scale by
    ``0.5 * downsample_rate``, apply the fixed ARL world offset and the
    90-degree rotation.  ``arr`` (or ``path`` to an .npy) may supply a real
    map; otherwise a procedural one is generated.
    """
    if arr is None:
        if path is not None:
            arr = np.load(path)
        else:
            arr = generate_occupancy_map(rng or np.random.RandomState(0), shape=map_shape)

    xs, ys = np.meshgrid(np.arange(arr.shape[0]), np.arange(arr.shape[1]))
    xs, ys = xs.flatten(), ys.flatten()
    occ_flags = arr[xs, ys]
    vertices = np.stack((xs[~occ_flags], ys[~occ_flags]), axis=1).astype(float)
    vertices_occ = np.stack((xs[occ_flags], ys[occ_flags]), axis=1).astype(float)
    # nearest-occupied-cell distance via KD-tree: the reference's dense
    # free x occupied matrix (make_map.py:259) is O(n^2) and takes minutes
    # on full maps (its ~12 s load in BASELINE.md is the same computation)
    from scipy.spatial import cKDTree

    dmin, _ = cKDTree(vertices_occ).query(vertices, k=1)
    flag = dmin <= perimeter_delta
    targets = vertices[flag, :]

    xyz_min = np.array([[-321.0539855957031, -276.5395050048828]])
    res = np.array([[0.5, 0.5]]) * downsample_rate
    targets = targets * res + xyz_min + res / 2
    # 90-degree world rotation (reference make_map.py:269)
    return np.stack((targets[:, 1], -targets[:, 0]), axis=1)


# =============================================================================
# Graph preprocessing -> static-shape GraphSpec
# =============================================================================


@dataclasses.dataclass
class GraphSpec:
    """All static per-graph arrays the device step needs.  NumPy on host;
    converted/stacked to device arrays by :func:`build_graph_bank`.

    Node indexing follows the reference convention: global node
    ``i < n_robots`` is robot ``i``; global node ``n_robots + t`` is target
    ``t`` (coverage.py:534-537).  Target arrays here are indexed by ``t``.
    """

    n_targets: int  # actual target count (<= max_targets)
    target_pos: np.ndarray  # [max_targets, 2], zeros beyond n_targets
    target_mask: np.ndarray  # [max_targets] bool
    # per-target motion options, reference neighbor order (ascending receiver,
    # as produced by np.nonzero row-major; coverage.py:216), padded with the
    # node's own index up to N_ACTIONS (coverage.py:219-221)
    neighbor_table: np.ndarray  # [max_targets, N_ACTIONS] int32, target idx
    neighbor_dist: np.ndarray  # [max_targets, N_ACTIONS] float32 (0 for self-pad)
    # flat motion-edge buffers, already laid out for the obs front section
    # (coverage.py:589-592): global indices, -1 beyond n_motion_edges
    motion_senders: np.ndarray  # [max_motion_edges] int32
    motion_receivers: np.ndarray  # [max_motion_edges] int32
    motion_dists: np.ndarray  # [max_motion_edges] float32
    n_motion_edges: int
    # all-pairs hop costs and predecessors (coverage.py:621-653)
    graph_cost: np.ndarray  # [max_targets, max_targets] float32, MAX_COST-filled
    graph_prev: np.ndarray  # [max_targets, max_targets] int32, -1-filled
    # UNCAPPED hop distances (inf = unreachable): the reference's
    # get_n_nearest BFS (coverage.py:655-673) has no horizon, so start-region
    # levels must not saturate at the horizon like graph_cost does
    graph_hops: np.ndarray  # [max_targets, max_targets] float32


def construct_time_matrix(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_targets: int,
    horizon: int = -1,
    edge_time: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs hop costs + predecessors, exact reference emulation.

    Reference coverage.py:621-653: repeated sweeps over the flat edge list,
    relaxing columns; loop exits when nothing changed OR no Inf remains;
    sweeps capped at ``horizon`` when ``horizon > -1``.  Vectorized over the
    source axis (the reference already is); edge order inside a sweep is
    preserved so predecessor tie-breaks match the reference exactly.
    """
    # Receiver-major storage: tm_t[r] IS the reference's time_matrix[:, r],
    # so each relaxation touches contiguous rows instead of strided columns
    # (4-6x on the 5.7k-node facility map).  Update order, comparisons and
    # tie-breaks are unchanged: a cost row is rewritten exactly where
    # base < cur — the same elements np.minimum would lower and np.where
    # would repoint — so the emulation stays element-exact.
    tm_t = np.full((n_targets, n_targets), np.inf)
    prev_t = np.full((n_targets, n_targets), -1, dtype=np.int64)
    np.fill_diagonal(tm_t, 0.0)
    changed_last_iter = True
    n_steps = 0
    while changed_last_iter and np.isinf(tm_t).any():
        changed_last_iter = False
        for sender, receiver in zip(senders, receivers):
            base = tm_t[sender] + edge_time
            cur = tm_t[receiver]
            mask = base < cur
            if mask.any():
                changed_last_iter = True
                prev_t[receiver] = np.where(mask, sender, prev_t[receiver])
                tm_t[receiver] = np.where(mask, base, cur)
        n_steps += 1
        if n_steps > horizon > -1:
            break
    time_matrix = np.nan_to_num(tm_t.T, posinf=MAX_COST)
    return time_matrix, np.ascontiguousarray(prev_t.T)


def build_graph_spec(
    targets: np.ndarray,
    max_targets: int,
    n_robots: int,
    motion_radius: float,
    horizon: int = -1,
    max_edges: Optional[int] = None,
) -> GraphSpec:
    """Preprocess target positions into a :class:`GraphSpec`.

    Motion edges are pairs with ``0 < dist <= motion_radius`` (the
    reference's ``_get_graph_edges`` keeps exactly those — utils.py:18-24;
    its ``self_loops=True`` flag has no effect because zero distances are
    dropped by ``np.nonzero``).
    """
    n_targets = targets.shape[0]
    if n_targets > max_targets:
        raise ValueError(
            f"graph has {n_targets} targets > max_targets={max_targets}; "
            f"raise max_nodes (reference raises at coverage.py:325 — SURVEY §5.9c)"
        )

    d = np.linalg.norm(targets[:, None, :] - targets[None, :, :], axis=2)
    adj = (d <= motion_radius) & (d > 0)
    s_idx, r_idx = np.nonzero(adj)  # row-major: ascending (sender, receiver)
    dists = d[s_idx, r_idx]
    n_motion = len(s_idx)

    degree = adj.sum(axis=1)
    if degree.max(initial=0) > N_ACTIONS:
        raise ValueError(
            f"node degree {degree.max()} exceeds N_ACTIONS={N_ACTIONS}; "
            f"the reference hardcodes 4 motion options (coverage.py:223)"
        )

    # per-node neighbor table in reference order, self-padded
    neighbor_table = np.tile(
        np.arange(max_targets, dtype=np.int64)[:, None], (1, N_ACTIONS)
    )
    neighbor_dist = np.zeros((max_targets, N_ACTIONS), dtype=np.float64)
    for t in range(n_targets):
        nbrs = r_idx[s_idx == t]
        neighbor_table[t, : len(nbrs)] = nbrs
        neighbor_dist[t, : len(nbrs)] = d[t, nbrs]
        # pad (already = t itself with dist 0)

    if max_edges is None:
        max_edges = (max_targets + n_robots) * N_ACTIONS
    max_motion_edges = max_edges - 2 * N_ACTIONS * n_robots
    if n_motion > max_motion_edges:
        raise ValueError(
            f"{n_motion} motion edges exceed buffer {max_motion_edges} "
            f"(reference asserts at coverage.py:288)"
        )

    motion_senders = np.full((max_motion_edges,), -1, dtype=np.int64)
    motion_receivers = np.full((max_motion_edges,), -1, dtype=np.int64)
    motion_dists = np.zeros((max_motion_edges,), dtype=np.float64)
    motion_senders[:n_motion] = s_idx + n_robots  # global indices
    motion_receivers[:n_motion] = r_idx + n_robots
    motion_dists[:n_motion] = dists

    cost, prev = construct_time_matrix(s_idx, r_idx, n_targets, horizon=horizon)
    graph_cost = np.full((max_targets, max_targets), MAX_COST, dtype=np.float64)
    graph_cost[:n_targets, :n_targets] = cost
    graph_prev = np.full((max_targets, max_targets), -1, dtype=np.int64)
    graph_prev[:n_targets, :n_targets] = prev

    from scipy.sparse.csgraph import shortest_path

    adj_sp = csr_matrix(
        (np.ones(n_motion), (s_idx, r_idx)), shape=(n_targets, n_targets)
    )
    hops = shortest_path(adj_sp, method="D", unweighted=True)
    graph_hops = np.full((max_targets, max_targets), np.inf, dtype=np.float64)
    graph_hops[:n_targets, :n_targets] = hops

    target_pos = np.zeros((max_targets, 2))
    target_pos[:n_targets] = targets
    target_mask = np.zeros((max_targets,), dtype=bool)
    target_mask[:n_targets] = True

    return GraphSpec(
        n_targets=n_targets,
        target_pos=target_pos,
        target_mask=target_mask,
        neighbor_table=neighbor_table.astype(np.int32),
        neighbor_dist=neighbor_dist.astype(np.float32),
        motion_senders=motion_senders.astype(np.int32),
        motion_receivers=motion_receivers.astype(np.int32),
        motion_dists=motion_dists.astype(np.float32),
        n_motion_edges=n_motion,
        graph_cost=graph_cost.astype(np.float32),
        graph_prev=graph_prev.astype(np.int32),
        graph_hops=graph_hops.astype(np.float32),
    )


def build_graph_bank(specs: List[GraphSpec], device="cpu"):
    """Stack GraphSpecs into a dict of tensors on ``device`` with a leading
    bank axis; the env gathers a graph by bank index."""

    def stack(field):
        return torch.from_numpy(np.stack([getattr(s, field) for s in specs])).to(device)

    return {
        "n_targets": torch.tensor([s.n_targets for s in specs], dtype=torch.int32,
                                  device=device),
        "target_pos": stack("target_pos").to(torch.float32),
        "target_mask": stack("target_mask"),
        "neighbor_table": stack("neighbor_table"),
        "neighbor_dist": stack("neighbor_dist"),
        "motion_senders": stack("motion_senders"),
        "motion_receivers": stack("motion_receivers"),
        "motion_dists": stack("motion_dists"),
        "n_motion_edges": torch.tensor([s.n_motion_edges for s in specs],
                                       dtype=torch.int32, device=device),
        "graph_cost": stack("graph_cost"),
        "graph_prev": stack("graph_prev"),
        "graph_hops": stack("graph_hops"),
        **_mm_cost_copy(specs, device),
        **_cost_pack_marker(specs, device),
    }


def _cost_pack_marker(specs, device="cpu"):
    """Presence marker ``cost_pack_ok``: the greedy expert may select the
    nearest target with a packed single-value min (``cost * 8192 + idx``).

    Exactness requires every cost (unreachable clamps included) to be a
    non-negative integer bounded by 2047, and T <= 8192: the largest packed
    value 2047 * 8192 + 8191 = 2^24 - 1 is exact in f32, and among tied
    costs the smallest packed value carries the smallest index (argmin's
    first-match tie-break).  The marker is a bank KEY; its value is a
    placeholder scalar."""
    costs = np.stack([s.graph_cost for s in specs])
    if costs.shape[-1] > 8192:
        return {}
    if costs.size and (
        costs.min() < 0 or costs.max() > 2047 or (costs != np.round(costs)).any()
    ):
        return {}
    return {"cost_pack_ok": torch.tensor(1, dtype=torch.int32, device=device)}


def _mm_cost_copy(specs, device="cpu"):
    """bf16 copy of graph_cost, emitted whenever every finite cost is
    bf16-exact (integer hop counts <= 256); unreachable (MAX_COST) is stored
    as 1024.0, a bf16-exact power of two that still satisfies the
    controller's ``>= MAX_COST`` unreachable test.  The greedy expert's
    packed min (K5) reads its rows, padded by ``ops.rowmin.pad_cost_rows``."""
    costs = np.stack([s.graph_cost for s in specs])
    finite = costs[costs < MAX_COST]
    if finite.size and (finite.max() > 256 or (finite != np.round(finite)).any()):
        return {}
    mm = np.where(costs >= MAX_COST, 1024.0, costs).astype(np.float32)
    return {"graph_cost_mm": torch.from_numpy(mm).to(device=device, dtype=torch.bfloat16)}


def reach_key(discover_radius: float) -> str:
    """Bank key for the discovery reach lists of ``discover_radius``, the
    key of the JAX package's reach table.  ``float.hex()`` keeps full
    precision, so two radii never share a key."""
    return f"disc_reach_r{float(discover_radius).hex()}"


def disc_reach_lists(bank, discover_radius: float):
    """Per-node discovery reach lists for the hide-nodes update.

    Robots sit ON nodes, so "target t is within ``discover_radius`` of some
    robot" is a static per-graph relation of the robots' nodes.  Returns
    ``{reach_key(r): [G, T, K] int32}``: row ``[g, t1]`` lists, ascending,
    every ``t2`` with ``0 < dist(pos[g,t1], pos[g,t2]) <= r``, padded with -1
    to the longest list K.  Distances are computed in float64 over the
    bank's f32 positions with the diff/square/sum/sqrt sequence of the JAX
    package's ``disc_reach_operand`` (whose ``[G*T, T]`` 0/1 table holds the
    same relation), including the d > 0 self-exclusion quirk.
    """
    pos = bank["target_pos"].detach().cpu().numpy().astype(np.float64)  # [G, T, 2]
    G, T, _ = pos.shape
    rad = float(discover_radius)
    chunk = max(1, (32 << 20) // max(T * 24, 1))
    per_graph = []
    for g in range(G):
        rows, cols = [], []
        for lo in range(0, T, chunk):
            hi = min(lo + chunk, T)
            d = pos[g][lo:hi, None, :] - pos[g][None, :, :]
            r = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
            rr, cc = np.nonzero((r > 0.0) & (r <= rad))
            rows.append(rr + lo)
            cols.append(cc)
        per_graph.append((np.concatenate(rows), np.concatenate(cols)))
    counts = [np.bincount(rr, minlength=T) for rr, _ in per_graph]
    k = max(1, max(int(c.max(initial=0)) for c in counts))
    out = np.full((G, T, k), -1, dtype=np.int32)
    for g, ((rr, cc), cnt) in enumerate(zip(per_graph, counts)):
        start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        out[g, rr, np.arange(rr.shape[0]) - start[rr]] = cc
    device = bank["target_pos"].device
    return {reach_key(discover_radius): torch.from_numpy(out).to(device)}


# =============================================================================
# Obstacle rejection & legacy target layouts (reference make_map.py:8-27,70-180)
# =============================================================================


def in_obstacle(obstacles, px: float, py: float) -> bool:
    """Point-in-any-rectangle test (reference make_map.py:8-19)."""
    for (xmin, xmax, ymin, ymax) in obstacles:
        if xmin <= px <= xmax and ymin <= py <= ymax:
            return True
    return False


def gen_obstacle_grid(ranges):
    """Cartesian product of 1-D ranges into rectangles (make_map.py:22-27)."""
    return [(x1, x2, y1, y2) for (x1, x2) in ranges for (y1, y2) in ranges]


def reject_collisions(points: np.ndarray, obstacles=None) -> np.ndarray:
    """Drop points inside rectangular obstacles (make_map.py:70-87)."""
    if obstacles is None or len(obstacles) == 0:
        return points
    flag = np.array(
        [not in_obstacle(obstacles, p[0], p[1]) for p in points], dtype=bool
    )
    return points[flag, :]


def _layout(sides, x_max: float, y_max: float) -> np.ndarray:
    """The sorted set of meshgrid points of each ``(xs, ys)`` side, plus the
    corner ``(x_max, y_max)``."""
    targets = set()
    for tempx, tempy in sides:
        tx, ty = np.meshgrid(tempx, tempy)
        targets |= set(zip(tx.flatten(), ty.flatten()))
    targets.add((x_max, y_max))
    return np.array(sorted(targets))


def gen_square(n_targets: int, x_max: float, y_max: float) -> np.ndarray:
    """Targets on the perimeter of a square (reference make_map.py:90-122,
    returned as an array instead of mutating an env in place)."""
    per_side = int(n_targets / 4)
    return _layout((
        (np.linspace(-x_max, -x_max, 1), np.linspace(-y_max, y_max, per_side, endpoint=False)),
        (np.linspace(x_max, x_max, 1), np.linspace(-y_max, y_max, per_side, endpoint=False)),
        (np.linspace(-x_max, x_max, per_side, endpoint=False), np.linspace(y_max, y_max, 1)),
        (np.linspace(-x_max, x_max, per_side, endpoint=False), np.linspace(-y_max, -y_max, 1)),
    ), x_max, y_max)


def gen_grid(n_targets: int, spacing: float) -> np.ndarray:
    """Square grid of targets (reference make_map.py:125-133)."""
    side = int(np.sqrt(n_targets))
    extent = spacing * side
    tempx = np.linspace(-extent, extent, side)
    tempy = np.linspace(-extent, extent, side)
    tx, ty = np.meshgrid(tempx, tempy)
    return np.stack((tx.flatten(), ty.flatten()), axis=1)


def gen_sparse_grid(n_targets: int, x_max: float, y_max: float,
                    x_step: float, y_step: float) -> np.ndarray:
    """Perimeter + center-cross sparse layout (reference make_map.py:136-180)."""
    per_side = int(n_targets / 6)
    return _layout((
        (np.linspace(-x_max, -x_max, 1), np.linspace(-y_max, y_max, per_side, endpoint=False)),
        (np.linspace(x_max, x_max, 1), np.linspace(-y_max, y_max, per_side, endpoint=False)),
        (np.linspace(0, 0, 1), np.linspace(-y_max + y_step, y_max, per_side, endpoint=False)),
        (np.linspace(-x_max, x_max, per_side, endpoint=False), np.linspace(y_max, y_max, 1)),
        (np.linspace(-x_max, x_max, per_side, endpoint=False), np.linspace(-y_max, -y_max, 1)),
        (np.linspace(-x_max + x_step, x_max, per_side, endpoint=False), np.linspace(0, 0, 1)),
    ), x_max, y_max)


# =============================================================================
# Bank save / load (the JAX package's .npz format)
# =============================================================================

# On-disk bank schema, written into every .npz and checked at load; equal to
# the JAX package's, whose files this module reads and writes.
BANK_SCHEMA = 6
# operands derived from a bank's build keys, whose layout differs between the
# packages under the same key: the JAX package's one-hot discovery operands
# and its folded K5 operand; the reach tables/lists (``disc_reach_r*``) too
_OPERAND_KEYS = ("hide_send_onehot", "hide_recv_onehot", "hide_adj", "cost_rows_pad")


def strip_operands(bank) -> dict:
    """``bank`` without its derived operands (either package's), to be
    rebuilt for the port by ``envs.coverage.prepare_bank``."""
    return {k: v for k, v in bank.items()
            if k not in _OPERAND_KEYS and not k.startswith("disc_reach_r")}


def save_graph_bank(path: str, bank) -> None:
    """Write ``bank`` (tensors on any device) to ``path`` in the JAX
    package's ``save_graph_bank`` format: an ``.npz``, bfloat16 arrays
    stored as float32 and listed under ``__bf16_keys__``, the schema under
    ``__bank_schema__``, written to a temp file and renamed into place so a
    concurrent reader never sees a torn file.  The JAX package compresses
    its file; this one is stored uncompressed (larger, no compression time
    on the write), which ``np.load``, and so either package's loader, reads
    the same."""
    arrays, bf16_keys = {}, []
    for k, v in bank.items():
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                v = v.float()
                bf16_keys.append(k)
            a = v.detach().cpu().numpy()
        else:
            a = np.asarray(v)
            if a.dtype.name == "bfloat16":
                a = a.astype(np.float32)
                bf16_keys.append(k)
        arrays[k] = a
    arrays["__bf16_keys__"] = np.asarray(bf16_keys)
    arrays["__bank_schema__"] = np.asarray(BANK_SCHEMA, dtype=np.int64)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_graph_bank(path: str, device="cpu") -> dict:
    """A bank written by :func:`save_graph_bank` (or the JAX package's), as
    tensors on ``device``, bfloat16 keys restored.  Raises ``ValueError``
    when the file has no ``__bank_schema__`` or another schema."""
    with np.load(path) as data:
        if "__bank_schema__" not in data.files:
            raise ValueError(f"{path}: no __bank_schema__ key (a bank file from before "
                             "versioning); rebuild it")
        found = int(data["__bank_schema__"])
        if found != BANK_SCHEMA:
            raise ValueError(f"{path}: bank schema {found} != current {BANK_SCHEMA}; rebuild")
        bf16 = set(data["__bf16_keys__"].tolist()) if "__bf16_keys__" in data.files else set()
        bank = {}
        for k in data.files:
            if k in ("__bf16_keys__", "__bank_schema__"):
                continue
            t = torch.from_numpy(data[k]).to(device)
            bank[k] = t.to(torch.bfloat16) if k in bf16 else t
        return bank
