"""Carry parameters, states and model weights across from the JAX package.

The tests start both packages from identical env parameters and states,
and identical GNN weights (:func:`gnn_params_from_flax`), through them:
``*_params_from_jax`` and ``*_state_from_numpy`` for each env family, and
the LQR system and mapping lattice with the params that hold them.
Nothing here imports JAX; the functions read the fields of any object that
has them, and arrays through ``numpy.asarray``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_flock_tpu_torch.envs.coverage import CoverageParams, CoverageState, prepare_bank
from gym_flock_tpu_torch.envs.coverage_graph import strip_operands
from gym_flock_tpu_torch.envs.flocking import FlockingParams, FlockingState, _state_from_x
from gym_flock_tpu_torch.envs.flocking_multi import FlockingMultiParams, FlockingMultiState
from gym_flock_tpu_torch.envs.formation import FormationParams, FormationState
from gym_flock_tpu_torch.envs.lqr import LQRParams, LQRState, LQRSystem, riccati_gain
from gym_flock_tpu_torch.envs.mapping import MappingParams, MappingState
from gym_flock_tpu_torch.envs.shepherding import ShepherdingParams, ShepherdingState

__all__ = [
    "params_from_jax", "state_from_numpy", "coverage_params_from_jax",
    "coverage_state_from_numpy", "gnn_params_from_flax", "edge_graph_net_params_from_flax",
    "shepherding_params_from_jax", "shepherding_state_from_numpy",
    "formation_params_from_jax", "formation_state_from_numpy",
    "lqr_params_from_jax", "lqr_state_from_numpy",
    "mapping_params_from_jax", "mapping_state_from_numpy",
    "flocking_multi_params_from_jax", "flocking_multi_state_from_numpy",
]


def _plain(value):
    if value is None or isinstance(value, (bool, int, float)):
        return value
    return float(np.asarray(value))


def _fields_from_jax(cls, jax_params, **tensors):
    """``cls`` from the JAX package's params of the same family, field by
    field (fields the port does not have are dropped), the fields named in
    ``tensors`` given as they are."""
    return cls(**{
        f.name: tensors[f.name] if f.name in tensors else _plain(getattr(jax_params, f.name))
        for f in dataclasses.fields(cls)
    })


def params_from_jax(jax_params) -> FlockingParams:
    """The port's :class:`FlockingParams` from a ``gym_flock_tpu``
    ``FlockingParams``."""
    return _fields_from_jax(FlockingParams, jax_params)


def state_from_numpy(x, params: FlockingParams, device) -> FlockingState:
    """A batched :class:`FlockingState` from a ``[B, N, 4]`` array, built as
    ``init_state`` builds it (``gym_flock_tpu/envs/flocking.py:645-657``)."""
    x = np.asarray(x)
    if x.ndim != 3 or x.shape[1:] != (params.n_agents, 4):
        raise ValueError(f"x must be [B, {params.n_agents}, 4], got {x.shape}")
    t = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)
    return _state_from_x(t)


def _batch(state, name: str, device, dtype) -> torch.Tensor:
    return _tensor(getattr(state, name), device).to(dtype)


def _time(b: int, device) -> torch.Tensor:
    return torch.zeros(b, dtype=torch.int32, device=device)


def shepherding_params_from_jax(jax_params) -> ShepherdingParams:
    return _fields_from_jax(ShepherdingParams, jax_params)


def shepherding_state_from_numpy(x, device) -> ShepherdingState:
    """A :class:`ShepherdingState` from a ``[B, n_agents, 3]`` array."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)
    return ShepherdingState(time=_time(x.shape[0], device), x=x)


def formation_params_from_jax(jax_params) -> FormationParams:
    return _fields_from_jax(FormationParams, jax_params)


def formation_state_from_numpy(x, device) -> FormationState:
    """A :class:`FormationState` from a ``[B, n, 4]`` array."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)
    return FormationState(time=_time(x.shape[0], device), x=x)


def lqr_params_from_jax(jax_params, device) -> LQRParams:
    """The port's :class:`LQRParams` with the JAX package's system on
    ``device`` (its gain recomputed where the JAX system has none)."""
    js = jax_params.system
    mats = {k: _tensor(getattr(js, k), device).to(torch.float32)
            for k in ("a_net", "a_sys", "b_sys", "q_sys", "r_sys", "std_dev")}
    k_gain = (riccati_gain(mats["a_sys"], mats["b_sys"], mats["q_sys"], mats["r_sys"])
              if js.k_gain is None else _tensor(js.k_gain, device).to(torch.float32))
    return _fields_from_jax(LQRParams, jax_params, system=LQRSystem(k_gain=k_gain, **mats))


def lqr_state_from_numpy(x, device) -> LQRState:
    """An :class:`LQRState` from a ``[B, n, 1]`` array."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)
    return LQRState(time=_time(x.shape[0], device), x=x)


def mapping_params_from_jax(jax_params, device) -> MappingParams:
    """The port's :class:`MappingParams` with the JAX params' target lattice
    on ``device``."""
    target_x = _tensor(jax_params.target_x, device).to(torch.float32)
    return _fields_from_jax(MappingParams, jax_params, target_x=target_x)


def mapping_state_from_numpy(state, device) -> MappingState:
    """A batched :class:`MappingState` from an object holding the fields of
    one, each stacked over the batch (e.g. a ``jax.vmap``-ed reset's state)."""
    return MappingState(
        time=_batch(state, "time", device, torch.int32),
        x=_batch(state, "x", device, torch.float32),
        unobserved=_batch(state, "unobserved", device, torch.bool),
        last_obs_target=_batch(state, "last_obs_target", device, torch.float32),
    )


def flocking_multi_params_from_jax(jax_params) -> FlockingMultiParams:
    return _fields_from_jax(FlockingMultiParams, jax_params)


def flocking_multi_state_from_numpy(state, device) -> FlockingMultiState:
    """A batched :class:`FlockingMultiState` from an object holding the
    fields of one, each stacked over the batch."""
    return FlockingMultiState(
        time=_batch(state, "time", device, torch.int32),
        **{name: _batch(state, name, device, torch.float32)
           for name in ("x", "x_agg", "init_vel", "mean_vel")},
    )


def _tensor(value, device) -> torch.Tensor:
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":  # numpy's bf16 is not a torch dtype
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: jax arrays are read-only


def coverage_params_from_jax(jax_params, device="cpu") -> CoverageParams:
    """The port's :class:`CoverageParams` from a ``gym_flock_tpu``
    ``CoverageParams``: its fields and bank arrays, then the port's own
    operands (``envs.coverage.prepare_bank``) in place of the JAX package's
    one-hot ones."""
    fields = {
        f.name: _plain(getattr(jax_params, f.name))
        for f in dataclasses.fields(CoverageParams) if f.name != "bank"
    }
    bank = {k: _tensor(v, device) for k, v in strip_operands(jax_params.bank).items()}
    bank = prepare_bank(bank, fields["hide_nodes"], fields["discover_radius"])
    return CoverageParams(bank=bank, **fields)


def coverage_state_from_numpy(state, device="cpu") -> CoverageState:
    """A batched :class:`CoverageState` from an object holding the fields of
    one, each stacked over the batch (e.g. a ``jax.vmap``-ed reset's
    state)."""
    dtypes = {"time": torch.int32, "graph": torch.int32, "robot_loc": torch.int32,
              "visited": torch.float32, "discovered": torch.float32,
              "episode_reward": torch.float32, "last_loc": torch.int32}
    return CoverageState(**{
        name: _tensor(getattr(state, name), device).to(dtype)
        for name, dtype in dtypes.items()
    })


def gnn_params_from_flax(variables, model: torch.nn.Module) -> torch.nn.Module:
    """Load a flax ``AggregationGNN``/``LargeAggregationGNN``'s variables
    into the port's ``model`` of the same widths, in place, and return it.

    ``params/_MLP_0/Dense_i/{kernel [in, out], bias [out]}`` map to
    ``model.mlp.layers[i]`` as ``weight = kernel.T`` and ``bias``.
    """
    _load_mlp(variables["params"]["_MLP_0"], model.mlp, "_MLP_0")
    return model


def edge_graph_net_params_from_flax(variables, model: torch.nn.Module) -> torch.nn.Module:
    """Load a flax ``EdgeGraphNet``'s variables into the port's ``model`` of
    the same widths and rounds, in place, and return it.

    flax names the compact MLPs in creation order: ``_MLP_0`` the node
    encoder, ``_MLP_1`` the edge encoder, ``_MLP_{2+2r}`` round r's message
    MLP and ``_MLP_{3+2r}`` its node MLP, ``_MLP_{2+2*rounds}`` the logit
    head (``model.mlps()`` lists the port's in that order).  Raises on any
    count or shape mismatch.
    """
    params = variables["params"]
    mlps = model.mlps()
    if len(params) != len(mlps):
        raise ValueError(f"flax EdgeGraphNet has {len(params)} MLPs, the model {len(mlps)}")
    for i, mlp in enumerate(mlps):
        _load_mlp(params[f"_MLP_{i}"], mlp, f"_MLP_{i}")
    return model


def _load_mlp(dense, mlp, name: str) -> None:
    """``Dense_i/{kernel [in, out], bias [out]}`` into ``mlp.layers[i]`` as
    ``weight = kernel.T`` and ``bias``."""
    layers = mlp.layers
    if len(dense) != len(layers):
        raise ValueError(f"flax {name} has {len(dense)} Dense layers, the model {len(layers)}")
    with torch.no_grad():
        for i, layer in enumerate(layers):
            kernel = np.asarray(dense[f"Dense_{i}"]["kernel"], np.float32)
            bias = np.asarray(dense[f"Dense_{i}"]["bias"], np.float32)
            if kernel.T.shape != tuple(layer.weight.shape) or bias.shape != tuple(layer.bias.shape):
                raise ValueError(f"{name}/Dense_{i}: kernel {kernel.shape} does not fit a "
                                 f"weight {tuple(layer.weight.shape)}")
            layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
            layer.bias.copy_(torch.from_numpy(bias.copy()))
