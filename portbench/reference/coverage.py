"""The plain reference of gym-flock's coverage / exploration MDP as
``ExploreFullEnv-v0`` runs it (``gym_flock/envs/spatial/coverage.py``, with
the flags of ``coverage_explore_full.py``: hidden nodes, a fourth node
feature), in plain PyTorch, float32, written from upstream's equations.

Its data is the map, as weights are a model's: the target positions and
mask.  Everything the dynamics and the expert need beyond that it derives
itself, from upstream's definitions: the motion edges (pairs within
``1.2 res``, row-major), each node's motion options (its neighbours in
ascending order, padded with the node itself) and the hop distances (its
own breadth-first search over the options).  The state is a dict of
tensors: ``graph [B]``, ``robot_loc [B,R]`` (target indices), ``visited``
and ``discovered [B,T]`` (0/1 floats), ``episode_reward [B]`` and ``time
[B]``.

Upstream's equations, and where they depart from the program's routes:

- the greedy expert (``controller``, coverage.py:800-871): for each robot
  the nearest target neither visited nor hidden, the first index among
  ties, by a plain masked argmin over the hop distances within the
  ``horizon``; then a motion option one hop closer to it.  Upstream reads
  the next node off its predecessor matrix, whose tie-break among equally
  short paths follows the order of its relaxation sweeps; the reference
  does not emulate that order, so where several options are one hop
  closer it allows each of them, and the choice is exact where one is.
  Upstream's costs, from ``horizon + 1`` sweeps, are exact up to that many
  hops and may reach further; the reference determines the expert only
  where the nearest target lies within ``horizon`` hops, and elsewhere,
  where upstream may draw a uniform action, allows any action;
- a step's conflicts (``step``, coverage.py:186-201) by upstream's two
  passes, robot by robot: a robot that stays claims its node, then each
  robot in index order moves to its chosen node unless that node is already
  in the partly filled result, else stays where it was; not a fixed point;
- discovery (coverage.py:334-346, utils.py:27-39) by the distance from each
  robot's node to each target's position, ``0 < d <= discover_radius``
  (a robot does not discover the node it stands on by itself), not by
  per-node reach lists;
- the observation graph and the reward (``_get_obs_reward``,
  coverage.py:234-364): motion edges recomputed from the positions, pairs
  with ``0 < d <= 1.2 res`` in row-major order, their raw lengths as the
  feature; the action edges of each robot (its node's motion options,
  padded with self loops) doubled, node->robot then robot->node, their
  lengths over ``res``, at the buffer's end; node features robot, landmark,
  not visited (hidden where not discovered) and the frontier flag (a
  discovered node with an undiscovered sender into it); motion edges with an
  undiscovered end hidden (sender -1); the reward the targets newly visited;
- the reset (``reset``, coverage.py:366-425): a uniform centre, the start
  region the full BFS levels around it that hold ``R * nearby_density``
  nodes, hop distances from the reference's own breadth-first search over
  the motion options (``hops``); ``R`` distinct robots drawn uniformly from
  it; ``floor(T * frac_active)`` targets drawn unvisited.

``low`` (``torch.bfloat16``) computes the discovery distances and the edge
features one precision below the configuration's float32: the control.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

MAX_COST = 1000.0
N_ACTIONS = 4
MOTION_RADIUS = 1.2  # x res: the motion edges' reach (upstream's motion_radius)
# envs a chunk where a step's [B, R, T] work is large
CHUNK = 64

State = Dict[str, torch.Tensor]

# float32 means float32 here: no product of the reference may run as TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class World:
    n_targets: torch.Tensor  # [G] long
    target_pos: torch.Tensor  # [G, T, 2] float32
    target_mask: torch.Tensor  # [G, T] bool
    n_robots: int
    res: float
    discover_radius: float
    hide_nodes: bool
    n_node_feat: int
    nearby_density: int
    frac_active: float
    horizon: int
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def t(self) -> int:
        return self.target_mask.shape[1]

    @property
    def max_edges(self) -> int:
        return (self.t + self.n_robots) * N_ACTIONS

    @property
    def n_tail(self) -> int:
        return 2 * N_ACTIONS * self.n_robots

    @property
    def device(self) -> torch.device:
        return self.target_pos.device

    def k_active(self, g: torch.Tensor) -> torch.Tensor:
        return torch.floor(self.n_targets[g].double() * self.frac_active).long()


def _chunks(b: int):
    return [slice(i, min(i + CHUNK, b)) for i in range(0, b, CHUNK)]


# ------------------------------------------------------------------ graph


def neighbor_table(world: World) -> torch.Tensor:
    """``[G, T, A]`` long: each node's motion options, the receivers of its
    motion edges in ascending order, padded with the node itself."""
    if "options" not in world._cache:
        r, t = world.n_robots, world.t
        own = torch.arange(t, device=world.device)[:, None].expand(t, N_ACTIONS)
        out = []
        for s, rr, _ in zip(*motion_edges(world)):
            real = s >= 0
            s, rr = s[real] - r, rr[real] - r  # by sender, receivers ascending
            slot = torch.arange(s.shape[0], device=s.device) - torch.searchsorted(s, s)
            if s.shape[0] and int(slot.max()) >= N_ACTIONS:
                raise ValueError(f"a node has more than {N_ACTIONS} motion options")
            table = own.clone()
            table[s, slot] = rr
            out.append(table)
        world._cache["options"] = torch.stack(out)
    return world._cache["options"]


def hops(world: World) -> torch.Tensor:
    """``[G, T, T]`` int32 hop distances by breadth-first search over the
    motion options (a large number where unreachable)."""
    if "hops" not in world._cache:
        far = torch.iinfo(torch.int32).max
        out = []
        for g, nbr in enumerate(neighbor_table(world)):  # [T, A]
            mask = world.target_mask[g]
            reach = torch.eye(world.t, dtype=torch.bool, device=world.device) & mask[:, None]
            h = torch.where(reach, 0, far).to(torch.int32)
            level = 0
            while True:
                level += 1
                new = reach[:, nbr].any(dim=2) & ~reach & mask[None, :] & mask[:, None]
                if not bool(new.any()):
                    break
                h = torch.where(new, level, h)
                reach |= new
            out.append(h)
        world._cache["hops"] = torch.stack(out)
    return world._cache["hops"]


def start_levels(world: World) -> torch.Tensor:
    """``[G, T]``: for each centre, the hop level whose full BFS levels hold
    the start region's ``min(n_targets, R * nearby_density)`` nodes."""
    if "levels" not in world._cache:
        h = hops(world).float()
        h = torch.where(world.target_mask[:, None, :], h, math.inf)
        want = world.n_targets.clamp(max=world.n_robots * world.nearby_density)
        world._cache["levels"] = torch.stack([
            h[g].kthvalue(int(want[g]), dim=1).values for g in range(h.shape[0])])
    return world._cache["levels"]


def motion_edges(world: World, low: Optional[torch.dtype] = None):
    """``(senders, receivers, lengths)``, each ``[G, E - n_tail]``: the motion
    edges in row-major order in global ids (robots first), -1 and 0 beyond
    their count; lengths from the positions (in ``low`` where given)."""
    key = ("motion", low)
    if key not in world._cache:
        room = world.max_edges - world.n_tail
        r = world.n_robots
        out_s, out_r, out_d = [], [], []
        for g in range(world.n_targets.shape[0]):
            pos = world.target_pos[g]
            mask = world.target_mask[g]
            d = _dist(pos[:, None, :], pos[None, :, :])
            adj = (d > 0) & (d <= MOTION_RADIUS * world.res) & mask[:, None] & mask[None, :]
            s_idx, r_idx = adj.nonzero(as_tuple=True)  # row-major
            if s_idx.shape[0] > room:
                raise ValueError(f"{s_idx.shape[0]} motion edges exceed the buffer's {room}")
            length = d[s_idx, r_idx] if low is None else _dist(
                pos[s_idx].to(low), pos[r_idx].to(low)).float()
            n = s_idx.shape[0]
            s = torch.full((room,), -1, dtype=torch.long, device=world.device)
            rr = torch.full((room,), -1, dtype=torch.long, device=world.device)
            dd = torch.zeros(room, device=world.device)
            s[:n], rr[:n], dd[:n] = s_idx + r, r_idx + r, length
            out_s.append(s)
            out_r.append(rr)
            out_d.append(dd)
        world._cache[key] = (torch.stack(out_s), torch.stack(out_r), torch.stack(out_d))
    return world._cache[key]


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


# ------------------------------------------------------------------ dynamics


def discover(world: World, g: torch.Tensor, loc: torch.Tensor,
             low: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[B, T]`` bool: targets within ``discover_radius`` of some robot,
    at a distance above 0."""
    out = []
    for c in _chunks(g.shape[0]):
        pos = world.target_pos[g[c]]  # [b, T, 2]
        rp = pos.gather(1, loc[c, :, None].expand(-1, -1, 2))  # [b, R, 2]
        if low is not None:
            pos, rp = pos.to(low), rp.to(low)
        d = _dist(rp[:, :, None, :], pos[:, None, :, :])  # [b, R, T]
        seen = ((d > 0) & (d <= world.discover_radius)).any(dim=1)
        out.append(seen & world.target_mask[g[c]])
    return torch.cat(out)


def arrive(world: World, state: State, loc: torch.Tensor,
           low: Optional[torch.dtype] = None):
    """The robots now at ``loc``: ``(visited, discovered, reward)``, the
    reward the targets newly visited."""
    g = state["graph"]
    mask = world.target_mask[g]
    hit = torch.zeros_like(mask).scatter(1, loc, True)
    reward = (hit & (state["visited"] < 1.0) & mask).sum(dim=1).float()
    visited = torch.where(hit, 1.0, state["visited"])
    discovered = state["discovered"]
    if world.hide_nodes:
        discovered = torch.where(discover(world, g, loc, low), 1.0, discovered)
    return visited, discovered, reward


def greedy(world: World, state: State):
    """``(action [B,R] long, determined [B,R] bool, allowed [B,R,A] bool)``
    of the greedy expert: where determined, ``allowed`` marks the options
    one hop closer to the nearest target and ``action`` is the first of
    them; elsewhere the action is 0, every option is allowed, and the
    expert's action is uniform."""
    h, options = hops(world), neighbor_table(world)
    slots = torch.arange(N_ACTIONS, device=world.device)
    acts, dets, allows = [], [], []
    for c in _chunks(state["graph"].shape[0]):
        g, loc = state["graph"][c], state["robot_loc"][c]
        blocked = (state["visited"][c] >= 1.0) | ~world.target_mask[g]
        if world.hide_nodes:
            blocked = blocked | (state["discovered"][c] <= 0.0)
        rows = h[g[:, None], loc].float()  # [b, R, T]
        rows = torch.where(blocked[:, None, :] | (rows > world.horizon), MAX_COST, rows)
        target = rows.argmin(dim=2)  # the first index among ties
        cost = rows.gather(2, target[..., None]).squeeze(2)
        nbr = options[g[:, None], loc]  # [b, R, A]
        closer = h[g[:, None, None], nbr, target[..., None]].float() == cost[..., None] - 1.0
        det = (cost < MAX_COST) & closer.any(dim=2)
        act = torch.where(closer, slots, N_ACTIONS).min(dim=2).values
        acts.append(torch.where(det, act, 0))
        dets.append(det)
        allows.append(closer | ~det[..., None])
    return torch.cat(acts), torch.cat(dets), torch.cat(allows)


def resolve(cur: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Upstream's two passes over ``[B, R]``: robots that stay claim their
    node; then robot by robot, a move to a node already in the result is
    refused and the robot stays."""
    out = torch.where(chosen == cur, cur, -1)
    for i in range(cur.shape[1]):
        taken = (out == chosen[:, i:i + 1]).any(dim=1)
        out[:, i] = torch.where(out[:, i] >= 0, out[:, i],
                                torch.where(taken, cur[:, i], chosen[:, i]))
    return out


def step(world: World, state: State, action: torch.Tensor,
         low: Optional[torch.dtype] = None):
    """``(state, reward)`` after ``action [B,R]`` (clamped to the options)."""
    g, cur = state["graph"], state["robot_loc"]
    nbr = neighbor_table(world)[g[:, None], cur]
    a = action.long().clamp(0, N_ACTIONS - 1)
    loc = resolve(cur, nbr.gather(2, a[..., None]).squeeze(2))
    visited, discovered, reward = arrive(world, state, loc, low)
    return {"graph": g, "robot_loc": loc, "visited": visited, "discovered": discovered,
            "episode_reward": state["episode_reward"] + reward,
            "time": state["time"] + 1}, reward


def reset(generator: torch.Generator, world: World, n_envs: int,
          low: Optional[torch.dtype] = None) -> State:
    """Fresh worlds: a graph, a uniform centre, R distinct robots drawn from
    its start region, ``floor(T * frac_active)`` targets unvisited; then the
    robots arrive where they stand."""
    dev = world.device
    g = torch.randint(0, world.n_targets.shape[0], (n_envs,), generator=generator, device=dev)
    n = world.n_targets[g]
    centre = (torch.rand(n_envs, generator=generator, device=dev, dtype=torch.float64)
              * n).floor().long()
    mask = world.target_mask[g]
    level = start_levels(world)[g, centre]
    region = (hops(world)[g, centre] <= level[:, None]) & mask
    loc = torch.multinomial(region.float(), world.n_robots, replacement=False,
                            generator=generator)
    score = torch.where(mask, torch.rand(mask.shape, generator=generator, device=dev), math.inf)
    rank = score.argsort(dim=1).argsort(dim=1)
    visited = torch.where(rank < world.k_active(g)[:, None], 0.0, 1.0)
    state = {"graph": g, "robot_loc": loc, "visited": visited,
             "discovered": torch.zeros_like(visited),
             "episode_reward": torch.zeros(n_envs, device=dev),
             "time": torch.zeros(n_envs, dtype=torch.long, device=dev)}
    visited, discovered, reward = arrive(world, state, loc, low)
    return {**state, "visited": visited, "discovered": discovered, "episode_reward": reward,
            "time": state["time"] + 1}


# ------------------------------------------------------------------ observation


def observe(world: World, state: State, low: Optional[torch.dtype] = None) -> State:
    """The padded observation graph of ``state``: ``nodes [B, R+T, F]``,
    ``edges [B, E, 1]``, ``senders`` and ``receivers [B, E]`` (-1 unused)."""
    g, loc = state["graph"], state["robot_loc"]
    b, r = loc.shape
    t, a = world.t, N_ACTIONS
    dev = loc.device
    # action edges: each robot's motion options, padded with self loops
    nbr = neighbor_table(world)[g[:, None], loc]  # [B, R, A]
    pos = world.target_pos[g]
    p_loc = pos.gather(1, loc[..., None].expand(-1, -1, 2))
    p_nbr = pos.gather(1, nbr.reshape(b, r * a, 1).expand(-1, -1, 2)).reshape(b, r, a, 2)
    if low is not None:
        p_loc, p_nbr = p_loc.to(low), p_nbr.to(low)
    length = (_dist(p_nbr, p_loc[:, :, None, :]).float() / world.res).reshape(b, r * a)
    robots = torch.arange(r, device=dev).repeat_interleave(a).expand(b, r * a)
    nodes_g = (nbr + r).reshape(b, r * a)
    ms, mr, md = (x[g] for x in motion_edges(world, low))
    senders = torch.cat([ms, nodes_g, robots], dim=1)
    receivers = torch.cat([mr, robots, nodes_g], dim=1)
    edges = torch.cat([md, length, length], dim=1)[..., None]
    # node features: robot, landmark, not visited (and the frontier)
    mask = world.target_mask[g].float()
    ones, zeros = torch.ones(b, r, device=dev), torch.zeros(b, r, device=dev)
    cols = [torch.cat([ones, torch.zeros(b, t, device=dev)], dim=1),
            torch.cat([zeros, mask], dim=1),
            torch.cat([zeros, (1.0 - state["visited"]) * mask], dim=1)]
    if world.hide_nodes:
        known = torch.cat([ones, state["discovered"]], dim=1)  # robots always known
        cols = [c * known for c in cols]
        k_s = torch.where(senders >= 0, known.gather(1, senders.clamp(min=0)), 0.0)
        k_r = torch.where(receivers >= 0, known.gather(1, receivers.clamp(min=0)), 0.0)
        into = (k_s <= 0) & (k_r > 0)
        frontier = torch.zeros(b, r + t, device=dev).scatter_reduce(
            1, receivers.clamp(min=0), into.float(), "amax")
        tail = torch.arange(senders.shape[1], device=dev) >= world.max_edges - world.n_tail
        senders = torch.where(((k_s > 0) & (k_r > 0)) | tail, senders, -1)
        cols.append(frontier)
    while len(cols) < world.n_node_feat:
        cols.append(torch.zeros(b, r + t, device=dev))
    return {"nodes": torch.stack(cols[:world.n_node_feat], dim=2), "edges": edges,
            "senders": senders, "receivers": receivers}


# ------------------------------------------------------------------ resets


def reset_violations(world: World, state: State) -> torch.Tensor:
    """``[B]`` long: the ways each state is not a draw the reset can make:
    a graph out of range; robots off the real targets, on a shared node, or
    outside every start region; visited entries not 0/1, a robot's node
    unvisited, or unvisited targets plus those the robots visited on arrival
    not ``floor(T * frac_active)``; discovered not exactly what the robots
    see; time not 1."""
    g, loc = state["graph"].long(), state["robot_loc"].long()
    bad = ((g < 0) | (g >= world.n_targets.shape[0])).long()
    g = g.clamp(0, world.n_targets.shape[0] - 1)
    n = world.n_targets[g]
    off = ((loc < 0) | (loc >= n[:, None])).any(dim=1)
    loc = loc.clamp(min=0) % n[:, None]
    srt = loc.sort(dim=1).values
    shared = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    h = hops(world)
    levels = start_levels(world)
    outside = []
    for i in range(loc.shape[0]):
        reach = h[g[i]][:, loc[i]].max(dim=1).values  # [T]: the farthest robot
        ok = (reach <= levels[g[i]]) & world.target_mask[g[i]]
        outside.append(~ok.any())
    outside = torch.stack(outside) if outside else off
    v, mask = state["visited"], world.target_mask[g]
    not01 = ((v != 0.0) & (v != 1.0)).any(dim=1)
    unvisited_robot = (v.gather(1, loc) != 1.0).any(dim=1)
    active = ((v == 0.0) & mask).sum(dim=1) + state["episode_reward"].round().long()
    wrong_active = active != world.k_active(g)
    wrong_seen = torch.zeros_like(off)
    if world.hide_nodes:
        seen = discover(world, g, loc).float()
        wrong_seen = (state["discovered"] != seen).any(dim=1)
    wrong_time = state["time"].long() != 1
    for x in (off, shared, outside, not01, unvisited_robot, wrong_active, wrong_seen,
              wrong_time):
        bad = bad + x.long()
    return bad


def overlapping_pairs(graph: torch.Tensor, loc: torch.Tensor):
    """``(overlapping, pairs)`` over the disjoint pairs of envs (0, 1),
    (2, 3), ...: a pair overlaps where both are on one graph and some node
    holds a robot of each."""
    p = loc.shape[0] // 2
    a, b = loc[0:2 * p:2], loc[1:2 * p:2]
    same = graph[0:2 * p:2] == graph[1:2 * p:2]
    share = (a[:, :, None] == b[:, None, :]).flatten(1).any(dim=1)
    return int((same & share).sum()), p
