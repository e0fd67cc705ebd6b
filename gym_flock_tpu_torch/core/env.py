"""Batched environment protocol (counterpart of ``gym_flock_tpu/core/env.py``).

An :class:`Env` is a namespace of functions over a frozen-dataclass state
whose tensors carry the batch of environments as their leading dimension:

    state, obs                = env.reset(generator, params, n_envs=1)
    state, obs, r, done, info = env.step(generator, state, action, params)
    action                    = env.expert(state, params, generator)

``reward`` is ``[B]`` and ``done`` a ``[B]`` bool tensor.  Randomness comes
from an explicit ``torch.Generator``; every tensor an env creates lies on
that generator's device.  ``reset``/``step``/``expert`` are the JAX
package's user entry points; PyTorch runs eagerly, so they call
``reset_env``/``step_env``/``controller``, which subclasses implement,
with nothing compiled.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Generic, Tuple, TypeVar

import torch

from gym_flock_tpu_torch.core.spaces import Space
from gym_flock_tpu_torch.utils.profiling import host_bool, span

TParams = TypeVar("TParams")
TState = TypeVar("TState")
Obs = Any
Action = Any

__all__ = ["Env", "EnvState", "EnvTransition", "step_autoreset"]


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Base for env states: every state carries the step counter."""

    time: torch.Tensor  # int32 [B], steps since reset


@dataclasses.dataclass(frozen=True)
class EnvTransition:
    """One (s, a, r, s') record, with JAX's fields.  The port's
    ``parallel.rollout.rollout`` returns its trajectory as a dict of the
    same names, ``info`` left out."""

    obs: Any
    action: Any
    reward: torch.Tensor
    done: torch.Tensor
    info: Dict[str, Any]


class Env(Generic[TParams, TState]):
    """Abstract batched environment; subclasses implement the methods."""

    def default_params(self) -> TParams:
        raise NotImplementedError

    def reset_env(
        self, generator: torch.Generator, params: TParams, n_envs: int
    ) -> Tuple[TState, Obs]:
        raise NotImplementedError

    def step_env(
        self, generator: torch.Generator, state: TState, action: Action,
        params: TParams,
    ) -> Tuple[TState, Obs, torch.Tensor, torch.Tensor, Dict[str, Any]]:
        raise NotImplementedError

    def controller(
        self, state: TState, params: TParams,
        generator: torch.Generator | None = None,
    ) -> Action:
        """Expert action (reference ``env.controller()``).  ``generator``
        feeds the random choices of experts that make any; deterministic
        experts ignore it."""
        raise NotImplementedError

    def observation_space(self, params: TParams) -> Space:
        raise NotImplementedError

    def action_space(self, params: TParams) -> Space:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    # ---------------------------------------------------------- entry points

    def reset(self, generator: torch.Generator, params: TParams,
              n_envs: int = 1) -> Tuple[TState, Obs]:
        return self.reset_env(generator, params, n_envs)

    def step(
        self, generator: torch.Generator, state: TState, action: Action, params: TParams,
    ) -> Tuple[TState, Obs, torch.Tensor, torch.Tensor, Dict[str, Any]]:
        return self.step_env(generator, state, action, params)

    def expert(self, state: TState, params: TParams,
               generator: torch.Generator | None = None) -> Action:
        """The expert action with the controller's default options."""
        return self.controller(state, params, generator)


def _rejection_reset(draw, accept, max_tries: int,
                     all_accepted=lambda ok: host_bool(ok.all())):
    """``(x, tries)``: ``draw()`` proposes a batch ``[B, N, 4]`` and
    ``accept(x)`` its ``[B]`` acceptance, together in one span
    ``gft.reset.draw``.  An env keeps its first accepted draw; the loop ends
    when ``all_accepted(ok)`` (a host read) or after ``max_tries`` draws, an
    env never accepted keeping its LAST draw, as the JAX ``while_loop``."""
    with span("gft.reset.draw"):
        x = draw()
        ok = accept(x)
    tries = 1
    while tries < max_tries and not all_accepted(ok):
        with span("gft.reset.draw"):
            x_new = draw()
            ok_new = accept(x_new)
        x = torch.where(ok[:, None, None], x, x_new)
        ok = ok | ok_new
        tries += 1
    return x, tries


def _select(done: torch.Tensor, a, b):
    """``b`` where ``done`` else ``a``, over tensors, tuples, dicts and
    dataclasses whose tensors lead with the batch dimension."""
    if isinstance(a, torch.Tensor):
        mask = done.reshape(done.shape + (1,) * (a.dim() - 1))
        return torch.where(mask, b, a)
    if isinstance(a, tuple):
        return tuple(_select(done, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return {k: _select(done, v, b[k]) for k, v in a.items()}
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _select(done, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)
        })
    raise TypeError(f"cannot select over {type(a).__name__}")


def step_autoreset(
    env: Env, generator: torch.Generator, state: TState, action: Action,
    params: TParams,
):
    """Step and, where ``done``, replace the state with a fresh reset.

    The terminal observation is returned in ``info['terminal_obs']``; ``obs``
    is the post-reset observation where ``done``.  The batch is reset (and
    the generator advanced) only on steps where some env is done.
    """
    st, obs_step, reward, done, info = env.step_env(generator, state, action, params)
    new_state, new_obs = st, obs_step
    if host_bool(done.any()):
        st_reset, obs_reset = env.reset_env(generator, params, done.shape[0])
        new_state = _select(done, st, st_reset)
        new_obs = _select(done, obs_step, obs_reset)
    info = dict(info)
    info["terminal_obs"] = obs_step
    return new_state, new_obs, reward, done, info
