"""Carry parameters and states across from the JAX package.

These are the "weights" of an env engine: the tests start both packages
from identical parameters and states through them.  Nothing here imports
JAX; ``params_from_jax`` reads the fields of any object that has them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_flock_tpu_torch.envs.flocking import FlockingParams, FlockingState, _state_from_x

__all__ = ["params_from_jax", "state_from_numpy"]


def _plain(value):
    if isinstance(value, (bool, int, float)):
        return value
    return float(np.asarray(value))


def params_from_jax(jax_params) -> FlockingParams:
    """The port's :class:`FlockingParams` from a ``gym_flock_tpu``
    ``FlockingParams``, field by field (fields the port does not have yet
    are dropped)."""
    return FlockingParams(**{
        f.name: _plain(getattr(jax_params, f.name))
        for f in dataclasses.fields(FlockingParams)
    })


def state_from_numpy(x, params: FlockingParams, device) -> FlockingState:
    """A batched :class:`FlockingState` from a ``[B, N, 4]`` array, built as
    ``init_state`` builds it (``gym_flock_tpu/envs/flocking.py:645-657``)."""
    x = np.asarray(x)
    if x.ndim != 3 or x.shape[1:] != (params.n_agents, 4):
        raise ValueError(f"x must be [B, {params.n_agents}, 4], got {x.shape}")
    t = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)
    return _state_from_x(t)
