"""Rollout loops over a batch of envs (counterpart of
``gym_flock_tpu/parallel/rollout.py``; no device mesh yet).

Every env function is already batched, so the episode loop is a Python loop
over steps and the batch is the leading dimension of every tensor.
Trajectories are ``[n_envs, n_steps, ...]``.
"""
from __future__ import annotations

from typing import Optional

import torch

from gym_flock_tpu_torch.core.env import Env, step_autoreset

__all__ = ["rollout", "batch_rollout", "batch_expert_rollout"]


def _resolve_policy(env: Env, policy):
    """policy: 'expert' | 'random' | callable(generator, state, obs, params) -> action."""
    if policy == "expert":
        return lambda generator, state, obs, params: env.controller(
            state, params, generator=generator
        )
    if policy == "random":

        def random_policy(generator, state, obs, params):
            return env.action_space(params).sample(generator, (state.time.shape[0],))

        return random_policy
    if callable(policy):
        return policy
    raise ValueError(f"Unknown policy {policy!r}")


def rollout(
    env: Env,
    params,
    generator: torch.Generator,
    n_steps: int,
    policy="expert",
    auto_reset: bool = True,
    init_state=None,
    init_obs=None,
    keep_obs: bool = True,
    n_envs: int = 1,
):
    """Roll a batch of envs ``n_steps`` under ``policy``; returns
    ``(state, traj)``.

    Starts from ``(init_state, init_obs)`` when given, else from a reset of
    ``n_envs`` envs.  ``traj`` maps ``obs`` (unless ``keep_obs=False``),
    ``action``, ``reward`` and ``done`` to per-step values stacked on
    dimension 1 (tuple and dict observations leaf by leaf).  The expert
    policy draws its random choices from ``generator``.
    """
    policy_fn = _resolve_policy(env, policy)
    if init_state is None:
        state, obs = env.reset_env(generator, params, n_envs)
    else:
        state, obs = init_state, init_obs
    steps = {"obs": [], "action": [], "reward": [], "done": []}
    for _ in range(n_steps):
        action = policy_fn(generator, state, obs, params)
        if keep_obs:
            steps["obs"].append(obs)
        if auto_reset:
            state, obs2, reward, done, _ = step_autoreset(
                env, generator, state, action, params
            )
        else:
            state, obs2, reward, done, _ = env.step_env(generator, state, action, params)
        steps["action"].append(action)
        steps["reward"].append(reward)
        steps["done"].append(done)
        obs = obs2

    def stack(seq):
        if isinstance(seq[0], tuple):
            return tuple(stack(list(parts)) for parts in zip(*seq))
        if isinstance(seq[0], dict):
            return {k: stack([s[k] for s in seq]) for k in seq[0]}
        return torch.stack(seq, dim=1)

    traj = {k: stack(v) for k, v in steps.items() if v}
    return state, traj


def batch_rollout(
    env: Env,
    params,
    generator: torch.Generator,
    n_envs: int,
    n_steps: int,
    policy="expert",
    auto_reset: bool = True,
    keep_obs: bool = True,
):
    """:func:`rollout` of ``n_envs`` fresh envs; leaves ``[n_envs, n_steps, ...]``."""
    return rollout(
        env, params, generator, n_steps, policy=policy, auto_reset=auto_reset,
        keep_obs=keep_obs, n_envs=n_envs,
    )


def batch_expert_rollout(
    env,
    params,
    generator: torch.Generator,
    n_envs: int,
    n_steps: int,
    centralized: Optional[bool] = None,
    init_state=None,
):
    """Batched FUSED expert rollout: one pairwise pass per env step.

    The expert-data generator of the flocking family: ``env.expert_rollout``
    from ``n_envs`` fresh resets, or from ``init_state`` when given.
    Returns ``(final_states, traj)`` with ``traj`` mapping ``u / values /
    network / reward`` to ``[n_envs, n_steps, ...]`` tensors: ``u`` at step
    t is the expert label for the observation produced at step t-1.
    """
    if init_state is None:
        state, _ = env.reset_env(generator, params, n_envs)
    else:
        state = init_state
    return env.expert_rollout(
        state, params, n_steps, centralized=centralized, generator=generator
    )
