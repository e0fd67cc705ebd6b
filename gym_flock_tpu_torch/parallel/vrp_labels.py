"""VRP expert labels for coverage imitation learning (counterpart of
``gym_flock_tpu/parallel/vrp_labels.py``).

The card rolls out batched coverage episodes under the greedy behaviour
policy (K5 once a step) while the host solves each visited state's VRP on
a thread pool: ``ctypes`` releases the GIL around the C++ solver, so the
threads run in parallel.  The result is a batch in the layout
``CoverageImitationTrainer.update_from_batch`` consumes, labelled by the
better expert.

Each state is labelled on its own (a fresh solve, ``horizon=-1``); the
route cache of ``CoverageVRPPolicy`` matters only when the VRP expert
drives the episode itself.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from gym_flock_tpu_torch.envs.coverage import CoverageEnv, CoverageParams
from gym_flock_tpu_torch.experts.coverage_vrp import CoverageVRPPolicy, _host
from gym_flock_tpu_torch.parallel.train_coverage import STATE_KEYS, greedy_rollout

__all__ = ["collect_vrp_labeled_batch", "vrp_label_states"]


def vrp_label_states(
    params: CoverageParams,
    states: dict,
    mode: str = "or_default",
    workers: Optional[int] = None,
    last_accept: bool = False,
    rot: int = 0,
) -> np.ndarray:
    """VRP expert actions ``[n, R]`` int32 for a flat batch of coverage
    states: ``states`` maps ``graph [n]``, ``robot_loc [n, R]``,
    ``visited [n, T]``, ``discovered [n, T]`` and ``time [n]`` to arrays or
    tensors.  With ``workers > 1`` the solves run on that many threads;
    the labels do not depend on it.
    """
    host = {k: _host(v) for k, v in states.items()}
    n = host["graph"].shape[0]
    # the bank tables the policy reads, off the card once: per state they
    # would cross again, [T, T] tables each time
    bank = dict(params.bank)
    for k in ("n_targets", "graph_cost", "graph_prev", "neighbor_table"):
        bank[k] = _host(params.bank[k])
    params_host = dataclasses.replace(params, bank=bank)

    def one(i: int) -> np.ndarray:
        policy = CoverageVRPPolicy(params_host, horizon=-1, mode=mode,
                                   last_accept=last_accept, rot=rot)
        return policy(SimpleNamespace(**{k: v[i] for k, v in host.items()})).reshape(-1)

    if workers is not None and workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            labels = list(pool.map(one, range(n)))
    else:
        labels = [one(i) for i in range(n)]
    return np.stack(labels).astype(np.int32)


def collect_vrp_labeled_batch(
    env: CoverageEnv,
    params: CoverageParams,
    generator: torch.Generator,
    n_envs: int,
    n_steps: int,
    mode: str = "or_default",
    workers: Optional[int] = None,
):
    """Greedy rollouts on the card, VRP labels on the host: the batch dict
    (``[n_envs * n_steps, ...]``) whose ``label`` is the VRP expert's action
    at each visited state (the pre-step state the observation shows)."""
    batch = greedy_rollout(env, params, generator, n_envs, n_steps, keep_state=True)
    states = {k: batch.pop(k) for k in STATE_KEYS}
    labels = vrp_label_states(params, states, mode=mode, workers=workers)
    batch["label"] = torch.from_numpy(labels).to(batch["nodes"].device)
    return batch
