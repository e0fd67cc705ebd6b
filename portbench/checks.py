"""The comparisons that decide ``correct``: the program's outputs against
the plain reference (``reference/``), each reduced to one number that grows
with the error.

The trajectory check follows the program step by step: from the state the
program started a call from, the reference takes each step with the
program's own action, so that each of the program's outputs is judged
against the reference at the very state the program had, and an error does
not compound over the steps.  The start of that chain (the reset) is judged
by itself: its states must be draws the reset can make, a reset that stops
drawing early must return only swarms the reference accepts, and the share
of them that pass the acceptance test must match the reference's own
reset.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference import flocking as ref

# the share by which the reset's acceptance test is eased where a swarm is
# judged as rejected: rounding cannot move a swarm across it
ACCEPT_SLACK = 1e-4


def _max(t: torch.Tensor) -> float:
    """The largest entry; NaN counts as infinitely large."""
    if t.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(t.double(), nan=math.inf).max())


def chunk_gaps(world: ref.World, x_in: torch.Tensor, u: torch.Tensor, values: torch.Tensor,
               network: torch.Tensor, reward: torch.Tensor, x_out: torch.Tensor,
               dense_network: bool) -> Dict[str, float]:
    """Gaps of one run of ``n`` steps of swarms ``x_in [k,N,4]``.

    ``u [k,n,N,2]`` is the action taken at each step; ``values [k,n,N,6]``,
    ``network`` (``[k,n,N,N]`` mean-pooled, or the degree ``[k,n,N]``) and
    ``reward [k,n]`` are the observation and reward after each step, and
    ``x_out`` the state after the last step.

    The gaps: ``u_gap`` and ``values_gap`` as the error over the magnitude
    of the terms summed (the scale of float32 rounding in any order);
    ``network_gap`` as |p - r| / (1 + |r|); ``reward_gap`` over 1 + the mean
    squared velocity; ``state_gap`` as |p - r| / (1 + |r|)."""
    g = {"u_gap": 0.0, "values_gap": 0.0, "network_gap": 0.0, "reward_gap": 0.0,
         "state_gap": 0.0}
    x = x_in.float()
    p = ref.pair_pass(x, world)
    for t in range(u.shape[1]):
        u_r, scale = ref.expert_action(x, p, world)
        g["u_gap"] = max(g["u_gap"], _max((u[:, t].double() - u_r).abs() / scale))
        x = ref.integrate(x, u[:, t].float(), world)
        p = ref.pair_pass(x, world)
        g["values_gap"] = max(g["values_gap"], _max(
            (values[:, t].double() - p["values"]).abs() / p["values_scale"]))
        want = ref.mean_pooled(x, world) if dense_network else p["degree"]
        g["network_gap"] = max(g["network_gap"], _max(
            (network[:, t].double() - want).abs() / (1.0 + want.abs())))
        r, scale = ref.reward(x)
        g["reward_gap"] = max(g["reward_gap"], _max((reward[:, t].double() - r).abs() / scale))
    g["state_gap"] = _max((x_out.double() - x.double()).abs() / (1.0 + x.double().abs()))
    return g


def accept_z(accepted: int, total: int, ref_accepted: int, ref_total: int) -> float:
    """|z| of the difference of two accepted shares (pooled variance, with a
    floor of one event in the pooled count so that 0 against 0 reads 0)."""
    if total == 0 or ref_total == 0:
        return math.inf
    f = (accepted + ref_accepted) / (total + ref_total)
    var = max(f * (1.0 - f), 1.0 / (total + ref_total)) * (1.0 / total + 1.0 / ref_total)
    return abs(accepted / total - ref_accepted / ref_total) / math.sqrt(var)


def reset_numbers(world: ref.World, resets: List[Tuple[torch.Tensor, int]], ref_envs: int,
                  seed: int) -> Dict[str, float]:
    """The program's resets ``[(x [B,N,4], draws), ...]`` judged by
    themselves.  ``reset_support``: entries of the states that no draw can
    give.  ``reset_verdict``: resets that stopped drawing before
    ``max_reset_tries`` (every swarm accepted, by the program's test) although
    the reference clearly rejects one of the swarms they return.
    ``reset_accept_z``: the accepted share of the program's states against
    the reference's own reset of ``ref_envs`` swarms drawn from ``seed``."""
    if not resets:
        return {"reset_support": math.inf, "reset_verdict": math.inf,
                "reset_accept_z": math.inf}
    support = sum(ref.out_of_support(x, world) for x, _ in resets)
    verdict = sum(int(draws < world.max_reset_tries and not bool(
        ref.accepted(x.float(), world, slack=ACCEPT_SLACK).all())) for x, draws in resets)
    acc = sum(int(ref.accepted(x.float(), world).sum()) for x, _ in resets)
    total = sum(x.shape[0] for x, _ in resets)
    gen = torch.Generator(device=resets[0][0].device).manual_seed(seed)
    _, ok, _ = ref.reset(gen, world, ref_envs)
    return {"reset_support": float(support), "reset_verdict": float(verdict),
            "reset_accept_z": accept_z(acc, total, int(ok.sum()), ok.numel())}


def merge(into: Dict[str, float], new: Dict[str, float]) -> Dict[str, float]:
    for k, v in new.items():
        into[k] = max(into.get(k, 0.0), v)
    return into
