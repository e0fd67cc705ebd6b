"""Observation/action space descriptions (counterpart of
``gym_flock_tpu/core/spaces.py``: ``Box``, ``Discrete``, ``MultiDiscrete``
and ``DictSpace``).

Spaces are descriptions: shape, dtype and bounds, plus ``sample`` from an
explicit ``torch.Generator`` and ``contains``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence, Tuple

import torch

__all__ = ["Space", "Box", "Discrete", "MultiDiscrete", "DictSpace", "flatten_space"]


class Space:
    """Base class for all spaces."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def sample(self, generator: torch.Generator, batch: Tuple[int, ...] = ()):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Box(Space):
    """Continuous box in R^n with scalar bounds (gym.spaces.Box semantics)."""

    low: float
    high: float
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32

    def sample(self, generator: torch.Generator, batch: Tuple[int, ...] = ()):
        """Uniform draw of shape ``batch + shape`` on the generator's device;
        an infinite bound samples from [-1, 1] on that side."""
        low = self.low if math.isfinite(self.low) else -1.0
        high = self.high if math.isfinite(self.high) else 1.0
        u = torch.rand(
            tuple(batch) + tuple(self.shape), generator=generator,
            device=generator.device, dtype=self.dtype,
        )
        return low + (high - low) * u

    def contains(self, x) -> bool:
        x = torch.as_tensor(x)
        return tuple(x.shape) == tuple(self.shape) and bool(
            torch.all(x >= self.low) and torch.all(x <= self.high)
        )


@dataclasses.dataclass(frozen=True)
class Discrete(Space):
    """{0, 1, ..., n-1}."""

    n: int
    dtype: torch.dtype = torch.int32

    @property
    def shape(self) -> Tuple[int, ...]:  # type: ignore[override]
        return ()

    def sample(self, generator: torch.Generator, batch: Tuple[int, ...] = ()):
        return torch.randint(
            0, self.n, tuple(batch), generator=generator, device=generator.device,
            dtype=self.dtype,
        )

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n


@dataclasses.dataclass(frozen=True)
class MultiDiscrete(Space):
    """Cartesian product of discrete spaces with per-dim cardinality ``nvec``
    (``MultiDiscrete([n_actions] * n_robots)`` of the coverage envs).  A
    tuple of equal-length tuples gives a 2-D space (gymnasium's batched
    ``MultiDiscrete``, ``[n, len(row)]``)."""

    nvec: Tuple
    dtype: torch.dtype = torch.int32

    @property
    def shape(self) -> Tuple[int, ...]:  # type: ignore[override]
        return tuple(torch.tensor(self.nvec).shape)

    def sample(self, generator: torch.Generator, batch: Tuple[int, ...] = ()):
        """``[*batch, *shape]``, each entry uniform over ``[0, its nvec)``."""
        dev = generator.device
        u = torch.rand(tuple(batch) + self.shape, generator=generator, device=dev,
                       dtype=torch.float64)
        nvec = torch.tensor(self.nvec, dtype=torch.float64, device=dev)
        return (u * nvec).floor().to(self.dtype)

    def contains(self, x) -> bool:
        x = torch.as_tensor(x)
        nvec = torch.tensor(self.nvec)
        return tuple(x.shape) == self.shape and bool(
            torch.all(x >= 0) and torch.all(x < nvec)
        )


@dataclasses.dataclass(frozen=True)
class DictSpace(Space):
    """Ordered mapping of named sub-spaces (gym.spaces.Dict analog)."""

    spaces: Mapping[str, Space]

    @property
    def shape(self):  # type: ignore[override]
        return {k: s.shape for k, s in self.spaces.items()}

    def sample(self, generator: torch.Generator, batch: Tuple[int, ...] = ()):
        return {k: s.sample(generator, batch) for k, s in self.spaces.items()}

    def contains(self, x) -> bool:
        return isinstance(x, Mapping) and all(
            k in x and s.contains(x[k]) for k, s in self.spaces.items()
        )

    def keys(self) -> Sequence[str]:
        return list(self.spaces.keys())


def flatten_space(space: Space) -> int:
    """The number of scalars in a flattened sample of ``space``, as gym's
    FlattenDictWrapper flattens it (reference test.py:33)."""
    if isinstance(space, DictSpace):
        return sum(flatten_space(s) for s in space.spaces.values())
    if isinstance(space, Box):
        return math.prod(space.shape)
    if isinstance(space, MultiDiscrete):
        return len(space.nvec)
    if isinstance(space, Discrete):
        return 1
    raise TypeError(f"Cannot flatten {space!r}")
