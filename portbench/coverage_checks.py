"""The comparisons that decide ``correct`` in the coverage cells: the
program's collects against the plain coverage reference
(``reference/coverage.py``), each reduced to one number that grows with the
error.

An episode is replayed step by step from the program's own states, with the
program's own actions, so that each output is judged at the very state the
program had and an error does not compound: at each step the reference
observes the program's state (against the kept sample), takes its greedy
choice there (against the kept label) and steps with the program's label
(against the program's next state and reward).  The start of the chain, the
reset, is judged by itself: its states must be draws the reset can make,
and the share of pairs of worlds whose robots share a node must match the
reference's own resets.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.checks import accept_z
from portbench.reference import coverage as ref

STATE_KEYS = ("robot_loc", "visited", "discovered")
OBS_IDS = ("senders", "receivers")
OBS_FEATURES = ("nodes", "edges")


def _count(t: torch.Tensor) -> float:
    return float(t.sum())


def _rel_max(p: torch.Tensor, r: torch.Tensor) -> float:
    """max |p - r| / (1 + |r|); NaN counts as infinitely large."""
    if p.numel() == 0:
        return 0.0
    gap = (p.double() - r.double()).abs() / (1.0 + r.double().abs())
    return float(torch.nan_to_num(gap, nan=math.inf).max())


def episode_gaps(world: ref.World, states: List[dict], rewards: List[torch.Tensor],
                 samples: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Gaps of ``n`` steps of ``k`` worlds.

    ``states`` holds the ``n + 1`` states the program had (the reset's, then
    each step's), each a dict of ``[k, ...]`` tensors with ``graph``;
    ``rewards`` the ``n`` rewards ``[k]``; ``samples`` the kept samples
    ``[k, n, ...]`` (``nodes``, ``edges``, ``senders``, ``receivers``,
    ``label``).

    The gaps: ``label_gap`` the labels out of ``[0, 4)`` or, where the
    reference's greedy choice is determined, not among the options it
    allows (one hop closer to the nearest target); ``state_gap``
    the entries of ``robot_loc``, ``visited`` and ``discovered`` unequal to
    the reference's step; ``ids_gap`` the sender and receiver ids unequal;
    ``feature_gap`` the node and edge features' |p - r| / (1 + |r|);
    ``reward_gap`` the largest |p - r| of the reward."""
    g = {"label_gap": 0.0, "state_gap": 0.0, "ids_gap": 0.0, "feature_gap": 0.0,
         "reward_gap": 0.0}
    n = samples["label"].shape[1]
    for t in range(n):
        st = _state(states[t])
        obs = ref.observe(world, st)
        for k in OBS_IDS:
            g["ids_gap"] += _count(samples[k][:, t].long() != obs[k])
        for k in OBS_FEATURES:
            want = obs[k]
            g["feature_gap"] = max(g["feature_gap"],
                                   _rel_max(samples[k][:, t].reshape(want.shape), want))
        label = samples["label"][:, t].long()
        _, _, allowed = ref.greedy(world, st)
        out = (label < 0) | (label >= ref.N_ACTIONS)
        chosen = allowed.gather(2, label.clamp(0, ref.N_ACTIONS - 1)[..., None]).squeeze(2)
        g["label_gap"] += _count(out | ~chosen)
        nxt, reward = ref.step(world, st, label)
        got = _state(states[t + 1])
        for k in STATE_KEYS:
            g["state_gap"] += _count(got[k] != nxt[k])
        gap = (rewards[t].double() - reward.double()).abs()
        g["reward_gap"] = max(g["reward_gap"], float(torch.nan_to_num(gap, nan=math.inf).max()))
    return g


def _state(s: dict) -> dict:
    """A recorded state in the reference's types."""
    return {"graph": s["graph"].long(), "robot_loc": s["robot_loc"].long(),
            "visited": s["visited"].float(), "discovered": s["discovered"].float(),
            "episode_reward": s.get("episode_reward", torch.zeros_like(s["graph"],
                                                                       dtype=torch.float32)),
            "time": s.get("time", torch.zeros_like(s["graph"]))}


def reset_numbers(world: ref.World, starts: List[dict], batches: List[tuple], ref_envs: int,
                  seed: int) -> Dict[str, float]:
    """The program's resets judged by themselves.  ``reset_support``: kept
    start states that no draw of the reset can give (``ref.reset_violations``).
    ``reset_overlap_z``: the share of disjoint pairs of worlds whose robots
    share a node, over whole batches ``[(graph [B], robot_loc [B,R]), ...]``,
    against the reference's own reset of ``ref_envs`` worlds drawn from
    ``seed``."""
    if not starts or not batches:
        return {"reset_support": math.inf, "reset_overlap_z": math.inf}
    support = sum(_count(ref.reset_violations(world, _state(s)) > 0) for s in starts)
    hit = total = 0
    for graph, loc in batches:
        h, p = ref.overlapping_pairs(graph.long(), loc.long())
        hit, total = hit + h, total + p
    gen = torch.Generator(device=world.device).manual_seed(seed)
    own = ref.reset(gen, world, ref_envs)
    ref_hit, ref_total = ref.overlapping_pairs(own["graph"], own["robot_loc"])
    return {"reset_support": float(support),
            "reset_overlap_z": accept_z(hit, total, ref_hit, ref_total)}
