"""Coverage / exploration graph MDPs in PyTorch, batched (counterpart of
``gym_flock_tpu/envs/coverage.py``).

N robots walk on a road-lattice or occupancy-map graph, each choosing one of
``n_actions=4`` padded motion edges per step; the reward is the number of
newly visited targets.  The graphs are preprocessed on the host into a bank
(``envs.coverage_graph``): a dict of tensors with a leading graph axis, on
one device.  Every state tensor leads with the batch of envs B; a step is
gathers over the bank, the conflict resolution and masked writes.

The observation is the reference's padded graph buffer (coverage.py:353-354):
``nodes [B, max_nodes, n_node_feat]``, ``edges [B, max_edges, 1]``,
``senders``/``receivers [B, max_edges]`` (-1 = unused), ``step [B, 1, 1]``.

Routes.  The JAX package has several equivalent routes for the greedy
expert's cost rows and for the hide-nodes discovery masks, most of them
one-hot matrix products that work around slow gathers on the TPU; its tests
pin them bitwise equal to the gather formulations.  The port keeps only the
gather formulations: the greedy expert's packed min runs on K5
(``ops.rowmin``) for every bank that carries ``cost_pack_ok`` and
``cost_rows_pad``, and discovery scatters per-node reach lists.

Flag modes (reference coverage.py:41-46; no registered id sets them):
``revisit_nodes`` (a visited target reverts with p = 0.005 a step),
``comm_edges`` (robot-robot edges within ``comm_radius`` at the buffer's
tail), ``last_edge_feature`` (a flag column on the tail edge into each
robot from its pre-move node) and ``pos_delta`` (the JAX package's repaired
``[flag?, dx, dy, dist]`` edge layout).

Banks are memoized in the process and cached on disk, keyed on their
configuration (``default_coverage_bank``).

Spans (``utils.profiling.span``, recorded only while a profiler runs):
``gft.cov.reset`` (``reset_env``), ``gft.cov.step`` (``step_env``),
``gft.cov.conflict`` (conflict resolution, inside a step: K7 on the card,
the fixed point and its host reads on the CPU), ``gft.cov.obs`` (the
observation and reward, inside a reset or a step) and ``gft.cov.expert``
(the greedy expert, K5 included).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import os
import time
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from gym_flock_tpu_torch.core.env import Env, EnvState
from gym_flock_tpu_torch.core.spaces import Box, DictSpace, MultiDiscrete
from gym_flock_tpu_torch.envs import coverage_graph as cg
from gym_flock_tpu_torch.ops.conflicts import resolve_conflicts, resolve_conflicts_reference
from gym_flock_tpu_torch.ops.pairwise import nodes_within_radius
from gym_flock_tpu_torch.ops.rowmin import MULT, pad_cost_rows, packed_greedy_min
from gym_flock_tpu_torch.utils.profiling import span

__all__ = [
    "CoverageParams",
    "CoverageState",
    "CoverageEnv",
    "default_coverage_bank",
    "coverage_factory",
    "prepare_bank",
]

MAX_COST = 1000.0
DELTA = 5.5
REVISIT_P = 0.005  # a visited target's chance to revert a step (coverage.py:246-247)


# =============================================================================
# Params / State
# =============================================================================


@dataclasses.dataclass(frozen=True)
class CoverageParams:
    """Configuration and the graph bank; defaults mirror reference
    coverage.py:34-85.

    The JAX package's route switches ``expert_mm``, ``hide_mm`` and
    ``expert_rowmin`` are left out: the port has one route each (the row
    gather through K5, and the reach-list discovery).
    """

    n_robots: int = 6
    max_nodes: int = 500
    n_actions: int = 4
    n_node_feat: int = 3
    episode_length: int = 75
    max_steps: int = 75
    hide_nodes: bool = False
    collision_checks: bool = True
    revisit_nodes: bool = False
    nearby_starts: bool = True
    nearby_density: int = 5
    comm_edges: bool = False
    last_edge_feature: bool = False
    pos_delta: bool = False
    # largest motion/action edge length in the bank (set by the factory)
    max_neighbor_dist: Optional[float] = None
    frac_active_targets: float = 0.5
    res: float = DELTA
    discover_radius: float = 4.0 * DELTA
    comm_radius: float = 100.0  # robot-robot comm range (coverage.py:135)
    # dict of stacked tensors on one device (coverage_graph.build_graph_bank)
    bank: Any = None

    @property
    def max_targets(self) -> int:
        return self.max_nodes - self.n_robots

    @property
    def max_edges(self) -> int:
        return self.max_nodes * self.n_actions

    @property
    def n_action_edges(self) -> int:
        # the bidirectional action edges at the buffer's tail
        return 2 * self.n_actions * self.n_robots

    @property
    def n_comm_edges(self) -> int:
        # robot-robot comm edge slots (R*(R-1) pairs, masked when out of range)
        return self.n_robots * (self.n_robots - 1) if self.comm_edges else 0

    @property
    def n_edge_feat(self) -> int:
        # [dist] or [last_edge_flag, dist]; pos_delta: [flag?, dx, dy, dist]
        base = 3 if self.pos_delta else 1
        return base + (1 if self.last_edge_feature else 0)

    @property
    def device(self) -> torch.device:
        return self.bank["n_targets"].device


@dataclasses.dataclass(frozen=True)
class CoverageState(EnvState):
    graph: torch.Tensor  # [B] int32 bank index
    robot_loc: torch.Tensor  # [B, R] int32 target index of each robot
    visited: torch.Tensor  # [B, max_targets] float32 (1 = visited)
    discovered: torch.Tensor  # [B, max_targets] float32 (hide_nodes mode)
    episode_reward: torch.Tensor  # [B] float32
    last_loc: torch.Tensor  # [B, R] int32 pre-move location; -1 after reset


def _spanned(name: str):
    """Run the decorated function inside the span ``name`` (a no-op without
    a profiler, ``utils.profiling.span``)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def _safe_gather(vec: torch.Tensor, idx: torch.Tensor, fill=0.0) -> torch.Tensor:
    """``vec[b, idx[b, j]]`` with idx == -1 mapping to ``fill``."""
    safe = idx.long().clamp(0, vec.shape[1] - 1)
    return torch.where(idx >= 0, vec.gather(1, safe), fill)


@_spanned("gft.cov.conflict")
def _resolve_conflicts(cur: torch.Tensor, chosen: torch.Tensor, collision_checks: bool):
    """Movement conflict resolution over ``[B, R]``: the reference's
    two-pass sequential procedure (coverage.py:186-201).  Returns
    ``(next_locs, rounds)``, ``rounds`` the host-read rounds taken.

    Pass 1 lets every robot whose choice is its current node claim it; pass
    2 walks robots in index order: robot i moves to ``chosen[i]`` unless
    that value already appears in the partially filled result, else it
    stays at ``cur[i]``.  On the card K7 (``ops.conflicts``) runs the two
    passes in one launch with no host read (``rounds`` 0); on the CPU the
    JAX package's vectorized fixed point, one host read a round.
    """
    if not collision_checks:
        return chosen, 0
    if cur.device.type == "cpu":
        return resolve_conflicts_reference(cur, chosen)
    ids = (t.to(torch.int32).contiguous() for t in (cur, chosen))
    return resolve_conflicts(*ids), 0


def revisit_flips(generator: torch.Generator, n_envs: int, n_targets: int) -> torch.Tensor:
    """``[B, T]`` bool draw of the ``revisit_nodes`` mode: True where a
    target reverts to unvisited this step (p = ``REVISIT_P``, ``u < p`` as
    ``jax.random.bernoulli``)."""
    u = torch.rand(n_envs, n_targets, generator=generator, device=generator.device)
    return u < REVISIT_P


def _comm_pairs(r: int, device):
    """The R*(R-1) off-diagonal robot pairs ``(i, j)`` in row-major order
    (``np.nonzero`` of an off-diagonal mask)."""
    ii = torch.arange(r, device=device).repeat_interleave(max(r - 1, 0))
    jj = torch.arange(r * (r - 1), device=device) % max(r - 1, 1)
    return ii, torch.where(jj >= ii, jj + 1, jj)


def _same_device(a: torch.device, b: torch.device) -> bool:
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda":
        cur = torch.cuda.current_device()
        return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)
    return True


def _check_generator(generator: torch.Generator, params: CoverageParams) -> None:
    if not _same_device(generator.device, params.device):
        raise ValueError(
            f"the generator is on {generator.device} but the bank on {params.device}"
        )


# =============================================================================
# Env
# =============================================================================


class CoverageEnv(Env[CoverageParams, CoverageState]):
    """Graph-coverage MDP over a pre-built graph bank.

    ``conflict_rounds`` counts the host-read rounds of the conflict fixed
    point taken by every ``step_env`` of this instance (one host sync each):
    on the CPU only, since the card resolves a step in one K7 launch.
    """

    conflict_rounds: int = 0

    def default_params(self, device="cuda") -> CoverageParams:
        """Coverage-v0's defaults with the default bank on ``device`` (the
        card unless the caller asks for the host; without a card it
        raises)."""
        return CoverageParams(bank=prepare_bank(default_coverage_bank(device=device)))

    # ------------------------------------------------------------------ reset

    @_spanned("gft.cov.reset")
    def reset_env(self, generator: torch.Generator, params: CoverageParams, n_envs: int):
        """Fresh envs (coverage.py:364-419): a random bank graph, robots
        drawn without replacement from a start region of full BFS levels
        around a random center (reference get_n_nearest), and the
        ``floor(n_targets * frac_active_targets)`` lowest-scored targets
        unvisited."""
        _check_generator(generator, params)
        bank, dev = params.bank, generator.device
        r, t = params.n_robots, params.max_targets
        n_graphs = bank["n_targets"].shape[0]
        g = torch.randint(0, n_graphs, (n_envs,), generator=generator, device=dev,
                          dtype=torch.int32)
        gl = g.long()
        n_targets = bank["n_targets"][gl]
        mask = bank["target_mask"][gl]
        if params.nearby_starts:
            u = torch.rand(n_envs, generator=generator, device=dev, dtype=torch.float64)
            center = (u * n_targets).floor().long()
            # uncapped hops: graph_cost saturates at the horizon
            d = torch.where(mask, bank["graph_hops"][gl, center], math.inf)
            want = n_targets.clamp(max=r * params.nearby_density).long()
            level = d.sort(dim=1).values.gather(1, (want - 1)[:, None])
            start_region = (d <= level) & mask
        else:
            start_region = mask
        drawn = torch.multinomial(start_region.float(), r, replacement=False,
                                  generator=generator)
        # with fewer than R weighted nodes (R above a small graph's target
        # count), jax.random.choice's Gumbel top-k fills the rest with the
        # unweighted nodes of lowest index; torch leaves that fill to
        # topk's tie order, so it is taken here from a stable argsort
        n_weighted = start_region.sum(dim=1, keepdim=True)
        unweighted = torch.argsort(start_region.to(torch.uint8), dim=1, stable=True)
        j = torch.arange(r, device=dev)
        fill = unweighted.gather(1, (j - n_weighted).clamp(min=0))
        robot_loc = torch.where(j < n_weighted, drawn, fill).to(torch.int32)
        k_active = torch.floor(n_targets * params.frac_active_targets).to(torch.int32)
        scores = torch.where(mask, torch.rand(n_envs, t, generator=generator, device=dev),
                             math.inf)
        rank = scores.argsort(dim=1, stable=True).argsort(dim=1)
        visited = torch.where(rank < k_active[:, None], 0.0, 1.0)
        state = CoverageState(
            time=torch.zeros(n_envs, dtype=torch.int32, device=dev),
            graph=g,
            robot_loc=robot_loc,
            visited=visited,
            discovered=torch.zeros_like(visited),
            episode_reward=torch.zeros(n_envs, device=dev),
            last_loc=torch.full((n_envs, r), -1, dtype=torch.int32, device=dev),
        )
        obs, _, _, state = self._obs_reward(state, params)
        return state, obs

    # ------------------------------------------------------------------- step

    @_spanned("gft.cov.step")
    def step_env(self, generator, state: CoverageState, action, params: CoverageParams,
                 flip: Optional[torch.Tensor] = None):
        """Apply ``action [B, R]`` (or ``[B, R, 1]``; out-of-range entries
        clamp to the nearest action index).  The dynamics are deterministic;
        ``generator`` feeds only the ``revisit_nodes`` draw
        (:func:`revisit_flips`), which a ``None`` generator skips and
        ``flip [B, T]`` replaces."""
        if generator is not None:
            _check_generator(generator, params)
        b, r = state.robot_loc.shape
        action = torch.as_tensor(action, device=state.robot_loc.device).reshape(b, r)
        cur = state.robot_loc
        nbr = params.bank["neighbor_table"][state.graph.long()[:, None], cur.long()]
        a_sel = action.long().clamp(0, params.n_actions - 1)
        chosen = nbr.gather(2, a_sel[..., None]).squeeze(2)
        next_locs, rounds = _resolve_conflicts(cur, chosen, params.collision_checks)
        self.conflict_rounds += rounds
        state = dataclasses.replace(state, robot_loc=next_locs.to(torch.int32), last_loc=cur)
        obs, reward, done, state = self._obs_reward(state, params, generator, flip)
        return state, obs, reward, done, {}

    # ----------------------------------------------------------- obs / reward

    def _discover(self, params: CoverageParams, gl, cur, mask):
        """``[B, T]`` targets within ``discover_radius`` of some robot (d > 0)."""
        bank = params.bank
        b, r = cur.shape
        t = params.max_targets
        key = cg.reach_key(params.discover_radius)
        if key in bank:
            lists = bank[key][gl[:, None], cur].reshape(b, -1).long()  # [B, R*K]
            lists = torch.where(lists >= 0, lists, t)  # pads hit a spare column
            seen = torch.zeros(b, t + 1, device=cur.device).scatter_(1, lists, 1.0)
            seen = seen[:, :t] > 0
        else:
            tp = bank["target_pos"][gl]  # [B, T, 2]
            robot_pos = tp.gather(1, cur[..., None].expand(b, r, 2))
            all_pos = torch.cat([robot_pos, tp], dim=1)
            seen = nodes_within_radius(params.discover_radius, robot_pos, all_pos)[:, r:]
        return seen & mask

    @_spanned("gft.cov.obs")
    def _obs_reward(self, state: CoverageState, params: CoverageParams,
                    generator: Optional[torch.Generator] = None,
                    flip: Optional[torch.Tensor] = None):
        """Observation graph + reward (reference _get_obs_reward,
        coverage.py:234-364); returns ``(obs, reward, done, state)``.

        Under ``revisit_nodes`` each visited target reverts where ``flip``
        (``[B, T]`` bool) holds, drawn from ``generator`` when not given; a
        reset passes neither, as the JAX package passes no key there."""
        bank = params.bank
        r, t, a, e = params.n_robots, params.max_targets, params.n_actions, params.max_edges
        b = state.graph.shape[0]
        dev = state.robot_loc.device
        gl = state.graph.long()
        mask = bank["target_mask"][gl]
        maskf = mask.float()
        n_targets = bank["n_targets"][gl]
        cur = state.robot_loc.long()

        visited = state.visited
        if params.revisit_nodes and (flip is not None or generator is not None):
            if flip is None:
                flip = revisit_flips(generator, b, t)
            visited = torch.where(flip & mask, 0.0, visited)

        # ---- action edges (reference get_action_edges, coverage.py:206-232),
        # doubled (coverage.py:259-261) and written at the buffer tail with
        # senders = action_edges[1] (coverage.py:282-283)
        nbr = bank["neighbor_table"][gl[:, None], cur]  # [B, R, A]
        nbr_dist = bank["neighbor_dist"][gl[:, None], cur]
        robots = torch.arange(r, dtype=torch.int32, device=dev).repeat_interleave(a)
        robots = robots.expand(b, r * a)
        nodes_g = (nbr + r).reshape(b, r * a)
        dist = nbr_dist.reshape(b, r * a)
        tail_senders = torch.cat([nodes_g, robots], dim=1)
        tail_receivers = torch.cat([robots, nodes_g], dim=1)
        tail_dist = torch.cat([dist, dist], dim=1) / params.res  # (:292)
        n_action = tail_senders.shape[1]

        if params.pos_delta or params.comm_edges:
            tp = bank["target_pos"][gl]  # [B, T, 2]
            robot_pos = tp.gather(1, cur[..., None].expand(b, r, 2))  # [B, R, 2]
        if params.pos_delta:
            # the repaired USE_POS_DELTA: pos[sender] - pos[receiver] of each
            # action edge, negated on the reversed duplicates
            nbr_pos = tp.gather(1, nbr.reshape(b, r * a, 1).long().expand(b, r * a, 2))
            nd = nbr_pos - robot_pos.repeat_interleave(a, dim=1)
            tail_diff = torch.cat([nd, -nd], dim=1) / params.res

        # ---- robot-robot comm edges (COMM_EDGES, coverage.py:271-280): the
        # R*(R-1) off-diagonal pairs in row-major order, those in range
        # compacted stably to the front of the comm block
        if params.comm_edges:
            ii, jj = _comm_pairs(r, dev)
            dmat = torch.sqrt(((robot_pos[:, :, None, :] - robot_pos[:, None, :, :]) ** 2)
                              .sum(dim=-1))
            dvals = dmat[:, ii, jj]  # [B, R*(R-1)]
            valid = (dvals > 0) & (dvals <= params.comm_radius)
            n_comm = valid.sum(dim=1)
            order = torch.where(valid, 0, 1).argsort(dim=1, stable=True)
            slot = torch.arange(ii.shape[0], device=dev)[None, :] < n_comm[:, None]
            comm_senders = torch.where(slot, ii[order], -1).to(torch.int32)
            comm_receivers = torch.where(slot, jj[order], -1).to(torch.int32)
            comm_dist = torch.where(slot, dvals.gather(1, order), 0.0) / params.res
            tail_senders = torch.cat([tail_senders, comm_senders], dim=1)
            tail_receivers = torch.cat([tail_receivers, comm_receivers], dim=1)
            tail_dist = torch.cat([tail_dist, comm_dist], dim=1)
            if params.pos_delta:
                cd = (robot_pos[:, ii] - robot_pos[:, jj]).gather(
                    1, order[..., None].expand(b, ii.shape[0], 2))
                tail_diff = torch.cat([tail_diff, torch.where(slot[..., None], cd, 0.0)
                                       / params.res], dim=1)
            # the block sits flush at the buffer's end: its start moves with
            # each env's comm-edge count
            tail_start = e - (n_action + n_comm)  # [B]

        # ---- last-edge flag (LAST_EDGE_FEATURE, coverage.py:296-308): tail
        # edge k is flagged where it points INTO robot i from i's pre-move
        # node (all zeros after a reset)
        if params.last_edge_feature:
            last_g = torch.where(state.last_loc >= 0, state.last_loc + r, -2)
            safe_recv = tail_receivers.long().clamp(0, r - 1)
            last_flag = ((tail_receivers < r)
                         & (tail_senders == last_g.gather(1, safe_recv))).float()

        # ---- visited update + reward (coverage.py:265-266, 357-359)
        old_sum = (visited * maskf).sum(dim=1)
        visited = visited.scatter(1, cur, 1.0)
        new_sum = (visited * maskf).sum(dim=1)
        reward = new_sum - old_sum

        # ---- buffers: motion edges first, raw distances (coverage.py:592
        # does NOT normalize by res), the tail edges at the end
        n_tail = tail_senders.shape[1]
        flag_layout = params.comm_edges or params.pos_delta or params.last_edge_feature

        def motion_diff(ms, mr):
            # pos[sender] - pos[receiver] of the motion edges, 0 on pads
            sp = tp.gather(1, (ms.long() - r).clamp(0, t - 1)[..., None].expand(*ms.shape, 2))
            rp = tp.gather(1, (mr.long() - r).clamp(0, t - 1)[..., None].expand(*mr.shape, 2))
            return torch.where((ms >= 0)[..., None], sp - rp, 0.0)

        if not flag_layout:
            motion = e - n_tail
            senders = torch.cat([bank["motion_senders"][gl][:, :motion], tail_senders], dim=1)
            receivers = torch.cat([bank["motion_receivers"][gl][:, :motion], tail_receivers],
                                  dim=1)
            edge_feat = torch.cat([bank["motion_dists"][gl][:, :motion], tail_dist],
                                  dim=1)[..., None]
        else:
            if not params.comm_edges:
                tail_start = torch.full((b,), e - n_tail, device=dev)
            # [motion | tail] gathered by a per-env index: position p holds
            # motion row p before tail_start and tail row p - tail_start
            # after it.  Under comm_edges, rows between the motion block and
            # the tail are -1 and zero-featured (the reference leaves stale
            # rows there).
            pad = e - bank["motion_senders"].shape[1]
            neg = torch.full((b, pad), -1, dtype=torch.int32, device=dev)
            zpad = torch.zeros(b, pad, device=dev)
            motion_s = torch.cat([bank["motion_senders"][gl], neg], dim=1)
            motion_r = torch.cat([bank["motion_receivers"][gl], neg], dim=1)
            motion_d = torch.cat([bank["motion_dists"][gl], zpad], dim=1)
            p = torch.arange(e, device=dev)[None, :]
            is_tail = p >= tail_start[:, None]
            idx = torch.where(is_tail, p - tail_start[:, None] + e, p)

            def place(motion_col, tail_col):
                return torch.cat([motion_col, tail_col], dim=1).gather(1, idx)

            senders = place(motion_s, tail_senders)
            receivers = place(motion_r, tail_receivers)
            dist_col = place(motion_d, tail_dist)
            zeros_e = torch.zeros(b, e, device=dev)
            if params.pos_delta:
                mdiff = motion_diff(motion_s, motion_r)
                cols = [place(mdiff[..., 0], tail_diff[..., 0]),
                        place(mdiff[..., 1], tail_diff[..., 1]), dist_col]
                if params.last_edge_feature:
                    cols = [place(zeros_e, last_flag)] + cols
                edge_feat = torch.stack(cols, dim=2)
            elif params.last_edge_feature:
                # the tail's dist moves to column 1 while motion rows keep
                # theirs in column 0 (a reference quirk)
                flag_col = place(zeros_e, last_flag)
                edge_feat = torch.stack([torch.where(is_tail, flag_col, dist_col),
                                         torch.where(is_tail, dist_col, 0.0)], dim=2)
            else:
                edge_feat = dist_col[..., None]

        # ---- node features (coverage.py:319-329)
        zeros_r = torch.zeros(b, r, device=dev)
        ones_r = torch.ones(b, r, device=dev)
        cols = [
            torch.cat([ones_r, torch.zeros(b, t, device=dev)], dim=1),  # robot
            torch.cat([zeros_r, maskf], dim=1),  # landmark
            torch.cat([zeros_r, (1.0 - visited) * maskf], dim=1),  # not visited
        ]
        discovered = state.discovered
        out_senders = senders
        if params.hide_nodes:
            # ---- discovery + frontier (coverage.py:334-346)
            seen = self._discover(params, gl, cur, mask)
            discovered = torch.maximum(discovered, seen.float())
            disc_all = torch.cat([ones_r, discovered], dim=1)  # robots always discovered
            cols = [c * disc_all for c in cols]
            d_send = _safe_gather(disc_all, senders)
            d_recv = _safe_gather(disc_all, receivers)
            frontier_mask = (1.0 - d_send) * d_recv > 0.0
            frontier = torch.zeros(b, r + t, device=dev).scatter_reduce(
                1, receivers.long().clamp(0, r + t - 1), frontier_mask.float(), "amax"
            )
            seen_edges = d_send * d_recv
            # tail (action and comm) edges are always visible (:343)
            if flag_layout:
                seen_edges = torch.where(is_tail, 1.0, seen_edges)
            else:
                seen_edges[:, e - n_tail:] = 1.0
            if params.n_node_feat >= 4:
                cols.append(frontier)
            out_senders = torch.where(seen_edges > 0, senders, -1)
        if params.n_node_feat >= 4 and len(cols) < 4:
            cols.append(torch.zeros(b, r + t, device=dev))
        nodes = torch.stack(cols[: params.n_node_feat], dim=2)

        # ---- step counter & done (coverage.py:351-357): the obs carries the
        # pre-increment counter, so time is already 1 after a reset
        step = state.time.to(torch.float32).reshape(b, 1, 1)
        time = state.time + 1
        done = (time == params.episode_length) | (new_sum >= n_targets)
        obs = {
            "nodes": nodes,
            "edges": edge_feat,
            "senders": out_senders.to(torch.int32),
            "receivers": receivers.to(torch.int32),
            "step": step,
        }
        state = dataclasses.replace(
            state, time=time, visited=visited, discovered=discovered,
            episode_reward=state.episode_reward + reward,
        )
        return obs, reward, done, state

    # ------------------------------------------------------------- controller

    @_spanned("gft.cov.expert")
    def controller(
        self,
        state: CoverageState,
        params: CoverageParams,
        generator: Optional[torch.Generator] = None,
        rand_u: Optional[torch.Tensor] = None,
    ):
        """Greedy nearest-unvisited expert (reference coverage.py:800-826,
        859-871): the closest unblocked target by hop cost, then one step
        toward it along the predecessor matrix.  ``[B, R, 1]`` int32.

        A robot with no reachable target (or already on it) takes a uniform
        random action, drawn from ``generator`` (seed 0 when None, as the
        JAX package's default key), or taken from ``rand_u [B, R]`` when
        given.
        """
        bank = params.bank
        r, t = params.n_robots, params.max_targets
        b = state.graph.shape[0]
        gl = state.graph.long()
        cur = state.robot_loc.long()
        blocked = (state.visited >= 1.0) | ~bank["target_mask"][gl]
        if params.hide_nodes:
            blocked = blocked | (state.discovered <= 0.0)
        if "cost_pack_ok" in bank and "cost_rows_pad" in bank:
            # K5: min over t of where(blocked, 1024, cost)*8192 + t
            rowidx = (state.graph[:, None] * t + state.robot_loc).to(torch.int32)
            m = packed_greedy_min(rowidx.contiguous(), blocked.contiguous(),
                                  bank["cost_rows_pad"])
            greedy_loc = torch.remainder(m, MULT).to(torch.int32)
            unreachable = (m - greedy_loc) / MULT >= MAX_COST
        else:
            rows = bank["graph_cost"][gl[:, None], cur]  # [B, R, T]
            rows = torch.where(blocked[:, None, :], MAX_COST, rows)
            greedy_loc = rows.argmin(dim=2)
            unreachable = rows.gather(2, greedy_loc[..., None]).squeeze(2) >= MAX_COST
        next_step = bank["graph_prev"][gl[:, None], greedy_loc.long(), cur]  # [B, R]
        bad = unreachable | (next_step == -1)
        # the action index: the first slot of the robot's neighbor row that
        # holds next_step (argmax returns the first maximum)
        nbr = bank["neighbor_table"][gl[:, None], cur]  # [B, R, A]
        u = (nbr == next_step[..., None]).to(torch.int32).argmax(dim=2).to(torch.int32)
        if rand_u is None:
            if generator is None:
                generator = torch.Generator(device=params.device).manual_seed(0)
            _check_generator(generator, params)
            rand_u = torch.randint(0, params.n_actions, (b, r), generator=generator,
                                   device=generator.device, dtype=torch.int32)
        u = torch.where(bad, torch.as_tensor(rand_u, dtype=torch.int32, device=u.device), u)
        return u.reshape(b, r, 1)

    # ---------------------------------------------------------------- spaces

    def observation_space(self, params: CoverageParams):
        e = params.max_edges
        return DictSpace({
            "nodes": Box(-math.inf, math.inf, (params.max_nodes, params.n_node_feat)),
            "edges": Box(-math.inf, math.inf, (e, params.n_edge_feat)),
            "senders": Box(-1, params.max_nodes, (e,), torch.int32),
            "receivers": Box(-1, params.max_nodes, (e,), torch.int32),
            "step": Box(0, params.episode_length, (1, 1)),
        })

    def action_space(self, params: CoverageParams):
        return MultiDiscrete((params.n_actions,) * params.n_robots)


# =============================================================================
# Banks & factories
# =============================================================================

# in-process memo of built banks: config -> CPU bank, (config, device) -> bank
_bank_cache: Dict[tuple, Any] = {}
CACHE_ENV = "GYM_FLOCK_TPU_TORCH_CACHE"
# where the last bank that missed the process memo came from ("disk" or
# "build") and the seconds of its read, build and write to the disk cache
last_bank_timing: Dict[str, Any] = {}


@functools.lru_cache(maxsize=None)
def _builder_digest() -> str:
    """Hash of the bank builder's source (this module and
    ``coverage_graph``): it keys the disk cache's file names, so a change
    to the build never reads a bank built before it.  The file schema,
    BANK_SCHEMA, is the JAX package's and changes only with it."""
    h = hashlib.sha1()
    for mod in (__file__, cg.__file__):
        h.update(Path(mod).read_bytes())
    return h.hexdigest()


def bank_cache_dir() -> Path:
    """The disk cache's directory: ``$GYM_FLOCK_TPU_TORCH_CACHE``, else
    ``~/.cache/gym_flock_tpu_torch`` (never the JAX package's directory,
    whose banks carry its own operand layouts)."""
    default = Path.home() / ".cache" / "gym_flock_tpu_torch"
    return Path(os.environ.get(CACHE_ENV, default))


def _cached_bank(cache_key, build):
    """The CPU bank of ``cache_key``: from the disk cache when a readable
    file of the current schema is there, else ``build()``, written to the
    cache through a temp file and a rename.  A corrupt or stale file is
    rebuilt; a cache directory that cannot be written leaves the bank in
    the process memo only."""
    digest = hashlib.sha1(repr((_builder_digest(),) + cache_key).encode()).hexdigest()[:16]
    path = bank_cache_dir() / f"bank_{digest}.npz"
    last_bank_timing.clear()
    t0 = time.perf_counter()
    if path.exists():
        try:
            bank = prepare_bank(cg.load_graph_bank(str(path), device="cpu"))
            last_bank_timing.update(source="disk", read_seconds=time.perf_counter() - t0)
            return bank
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            pass  # corrupt or stale: rebuild
    t0 = time.perf_counter()
    bank = build()
    t1 = time.perf_counter()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        cg.save_graph_bank(str(path), cg.strip_operands(bank))
    except OSError:
        pass  # read-only filesystem: the process memo only
    last_bank_timing.update(source="build", build_seconds=t1 - t0,
                            write_seconds=time.perf_counter() - t1)
    return bank


def default_coverage_bank(
    n_graphs: int = 8,
    n_robots: int = 6,
    max_nodes: Optional[int] = 500,
    horizon: int = 10,
    seed: int = 0,
    kind: str = "coverage",
    device="cuda",
    **map_kwargs,
):
    """Build (and memoize) a bank of coverage graphs on ``device`` (default
    the card; pass ``"cpu"`` for the host; without a card it raises).

    ``kind='coverage'`` draws Coverage-v0 road-lattice maps; ``kind=
    'occupancy'`` draws sub-windows of an occupancy map (CoverageARL,
    coverage_arl.py:64-82), or with ``full_map=True`` takes the whole map's
    largest component.  Oversized maps (> max_targets) are redrawn.
    ``max_nodes=None`` (full maps only) sizes the bank to the map.  The
    bank carries K5's operand ``cost_rows_pad`` whenever it carries
    ``cost_pack_ok`` and ``graph_cost_mm``.

    Built banks are memoized in the process and cached on disk under
    :func:`bank_cache_dir` (the real ExploreFull bank takes tens of seconds
    to build), keyed on the configuration, the builder's source and, for a
    map file, its content hash.  ``last_bank_timing`` says where the last
    bank that missed the memo came from and how long that took.
    """
    keyed_kwargs = dict(map_kwargs)
    if isinstance(keyed_kwargs.get("path"), str):
        # key by map-file CONTENT, not path
        with open(keyed_kwargs["path"], "rb") as f:
            keyed_kwargs["path"] = (keyed_kwargs["path"], hashlib.sha1(f.read()).hexdigest())
    cache_key = (n_graphs, n_robots, max_nodes, horizon, seed, kind,
                 tuple(sorted(keyed_kwargs.items())))
    dev = torch.device(device)
    if (cache_key, dev) in _bank_cache:
        return _bank_cache[(cache_key, dev)]
    if cache_key not in _bank_cache:
        _bank_cache[cache_key] = _cached_bank(cache_key, lambda: _build_bank(
            n_graphs, n_robots, max_nodes, horizon, seed, kind, dict(map_kwargs)))
    bank = {k: v.to(dev) for k, v in _bank_cache[cache_key].items()}
    _bank_cache[(cache_key, dev)] = bank
    return bank


def _build_bank(n_graphs, n_robots, max_nodes, horizon, seed, kind, map_kwargs):
    """The CPU bank of :func:`default_coverage_bank` (its docstring)."""
    rng = np.random.RandomState(seed)
    res = map_kwargs.pop("res", DELTA if kind == "coverage" else 5.0)
    motion_radius = res * 1.2
    min_graph_size = map_kwargs.pop("min_graph_size", 200 if kind == "occupancy" else 2)
    full_map = map_kwargs.pop("full_map", False)
    if full_map and kind != "occupancy":
        raise ValueError("full_map=True is only meaningful for kind='occupancy'")
    if max_nodes is None and not full_map:
        raise ValueError("max_nodes=None (fit-to-map) requires full_map=True")
    max_targets = None if max_nodes is None else max_nodes - n_robots

    specs = []
    if kind == "occupancy":
        # trim to the map's largest connected component BEFORE windowing
        # (coverage_arl.py:50-55)
        all_targets = cg._largest_component(
            cg.targets_from_occupancy(rng=rng, **map_kwargs), motion_radius
        )
        if full_map:
            targets = all_targets
            if targets.shape[0] < min_graph_size:
                raise ValueError(
                    f"full map's largest component has {targets.shape[0]} "
                    f"targets < min_graph_size={min_graph_size}"
                )
            if max_targets is None:  # pad_nodes=False: fit to the map
                max_targets = targets.shape[0]
            specs.append(
                cg.build_graph_spec(targets, max_targets, n_robots, motion_radius, horizon)
            )
        else:
            min_xy = all_targets.min(axis=0)
            max_xy = all_targets.max(axis=0)
            sub = (max_xy - min_xy) / 3.0  # num_subgraphs=3 (coverage_arl.py:18)
            while len(specs) < n_graphs:
                start = rng.uniform(low=min_xy, high=max_xy - sub)
                end = start + sub
                sel = np.all((all_targets >= start) & (all_targets < end), axis=1)
                targets = all_targets[sel]
                if targets.shape[0] < min_graph_size:
                    continue
                targets = cg._largest_component(targets, motion_radius)
                if not (min_graph_size <= targets.shape[0] <= max_targets):
                    continue
                specs.append(
                    cg.build_graph_spec(targets, max_targets, n_robots, motion_radius, horizon)
                )
    else:
        while len(specs) < n_graphs:
            targets = cg.generate_coverage_targets(rng, res=res, **map_kwargs)
            if not (min_graph_size <= targets.shape[0] <= max_targets):
                continue
            specs.append(
                cg.build_graph_spec(targets, max_targets, n_robots, motion_radius, horizon)
            )
    bank = cg.build_graph_bank(specs, "cpu")
    if "cost_pack_ok" in bank and "graph_cost_mm" in bank:
        bank["cost_rows_pad"] = pad_cost_rows(bank["graph_cost_mm"])
    return bank


def prepare_bank(bank: dict, hide_nodes: bool = False,
                 discover_radius: float = CoverageParams.discover_radius) -> dict:
    """The env's own shallow copy of ``bank`` with the port's operands:
    K5's ``cost_rows_pad`` (when the bank carries ``cost_pack_ok`` and
    ``graph_cost_mm``) and, under ``hide_nodes``, the reach lists of
    ``discover_radius``."""
    bank = dict(bank)
    if "cost_rows_pad" not in bank and "cost_pack_ok" in bank and "graph_cost_mm" in bank:
        bank["cost_rows_pad"] = pad_cost_rows(bank["graph_cost_mm"])
    if hide_nodes and cg.reach_key(discover_radius) not in bank:
        bank.update(cg.disc_reach_lists(bank, discover_radius))
    return bank


def coverage_factory(variant: str):
    """Factory for registry entries.  Variants mirror the reference configs:

    * coverage      — Coverage-v0 (coverage.py:82-85)
    * arl           — CoverageARL-v0/-v1 (coverage_arl.py:17-19)
    * full          — CoverageFull-v0 (coverage_full.py:14-17)
    * explore       — ExploreEnv-v0/-v1 (coverage_explore.py:10)
    * explore_full  — ExploreFullEnv-v0 (coverage_explore_full.py:13-17)

    ``device`` (default ``"cuda"``; pass ``"cpu"`` to run on the host)
    places the bank, and with it every tensor the env makes; an explicit
    ``bank=`` keeps its own device.  The occupancy variants accept ``real_map``:
    ``None`` (default) uses the real ARL facility map when
    ``envs.maps.find_reference_map`` finds one, ``False`` forces the
    procedural map, ``True`` requires the real map, a string is a path to a
    ``grid_slice``-style occupancy ``.npy``.  On the real map the full-map
    variants size the node budget to the map (the reference's
    ``pad_nodes=False``): ExploreFullEnv-v0 is a 5,759-node world.
    """

    def factory(n_graphs: int = 8, bank_seed: int = 0, device=None, **kwargs):
        env = CoverageEnv()
        real_map = kwargs.pop("real_map", None)
        if real_map not in (None, False) and variant == "coverage":
            raise ValueError(
                "real_map applies to the occupancy variants only; Coverage-v0 "
                "uses road-lattice maps (reference coverage.py:516-527)"
            )
        if variant == "coverage":
            cfg = dict(n_robots=6, max_nodes=500, episode_length=75, max_steps=75,
                       n_node_feat=3, hide_nodes=False, res=DELTA)
            bank_kind, horizon, peri = "coverage", 10, None
        elif variant == "arl":
            cfg = dict(n_robots=4, max_nodes=1000, episode_length=50, max_steps=100000,
                       n_node_feat=3, hide_nodes=False, res=5.0)
            bank_kind, horizon, peri = "occupancy", -1, 2.0
        elif variant == "full":
            cfg = dict(n_robots=10, max_nodes=1500, episode_length=10000, max_steps=100000,
                       n_node_feat=3, hide_nodes=False, res=5.0)
            bank_kind, horizon, peri = "occupancy", 19, 2.0
        elif variant == "explore":
            cfg = dict(n_robots=4, max_nodes=1000, episode_length=50, max_steps=100000,
                       n_node_feat=4, hide_nodes=True, res=5.0)
            bank_kind, horizon, peri = "occupancy", 19, 2.0
        elif variant == "explore_full":
            cfg = dict(n_robots=100, max_nodes=1500, episode_length=50, max_steps=100000,
                       n_node_feat=4, hide_nodes=True, res=5.0)
            # reference PERIMETER_DELTA=12.0 (coverage_explore_full.py:4); the
            # procedural map is scaled down to keep near the 1500-node budget
            bank_kind, horizon, peri = "occupancy", 19, 12.0
        else:
            raise ValueError(variant)
        user_max_nodes = "max_nodes" in kwargs
        cfg.update(kwargs)
        bank = cfg.pop("bank", None)
        if bank is not None and real_map not in (None, False):
            raise ValueError(
                "real_map cannot be combined with an explicit bank=; the bank "
                "already defines the world"
            )
        if bank is None:
            map_path = None
            if bank_kind == "occupancy":
                if isinstance(real_map, str):
                    map_path = real_map
                elif real_map is not False:
                    from gym_flock_tpu_torch.envs.maps import find_reference_map

                    map_path = find_reference_map(10)
                    if real_map is True and map_path is None:
                        raise FileNotFoundError(
                            "real_map=True but no grid_slice10.npy found; set "
                            "$GYM_FLOCK_TPU_MAPS (see gym_flock_tpu_torch.envs.maps)"
                        )
            full_map = variant in ("full", "explore_full")
            fit_nodes = full_map and map_path is not None and not user_max_nodes
            bank = default_coverage_bank(
                n_graphs=1 if full_map else n_graphs,
                n_robots=cfg["n_robots"],
                max_nodes=None if fit_nodes else cfg["max_nodes"],
                horizon=horizon,
                seed=bank_seed,
                kind=bank_kind,
                device="cuda" if device is None else device,
                res=cfg["res"],
                full_map=full_map,
                **({"perimeter_delta": peri} if peri is not None else {}),
                **({"path": map_path, "downsample_rate": 10}
                   if map_path is not None else {}),
                **({"map_shape": (48, 42)}
                   if variant == "explore_full" and map_path is None else {}),
            )
            if fit_nodes:
                cfg["max_nodes"] = int(bank["target_mask"].shape[1]) + cfg["n_robots"]
        elif device is not None and not _same_device(bank["n_targets"].device, device):
            raise ValueError(f"bank= lies on {bank['n_targets'].device}, not on {device}")
        disc_r = cfg.get("discover_radius", CoverageParams.discover_radius)
        if cfg.get("hide_nodes") and not cfg.get("comm_edges"):
            # as the JAX factory sets it (its discovery-mask route's bound):
            # neighbor_dist rows pad with self-loops at dist 0, so the plain
            # max is the longest motion/action edge
            cfg.setdefault("max_neighbor_dist", float(bank["neighbor_dist"].max()))
        bank = prepare_bank(bank, cfg.get("hide_nodes", False), disc_r)
        params = CoverageParams(bank=bank, **cfg)
        if params.comm_edges:
            # the comm slots shrink the motion-edge region below what
            # build_graph_spec checked (the reference asserts 'Increase
            # MAX_EDGES' at run time, coverage.py:288)
            max_motion = int(bank["n_motion_edges"].max())
            room = params.max_edges - params.n_action_edges - params.n_comm_edges
            if max_motion > room:
                raise ValueError(
                    f"comm_edges=True reserves {params.n_comm_edges} tail slots "
                    f"but a bank graph has {max_motion} motion edges > {room}; "
                    "raise max_nodes"
                )
        return env, params

    return factory
