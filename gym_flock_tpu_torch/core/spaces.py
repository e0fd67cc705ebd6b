"""Observation/action space descriptions (counterpart of
``gym_flock_tpu/core/spaces.py``; only ``Space`` and ``Box`` so far).

Spaces are descriptions: shape, dtype and bounds, plus ``sample`` from an
explicit ``torch.Generator`` and ``contains``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

__all__ = ["Space", "Box"]


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
