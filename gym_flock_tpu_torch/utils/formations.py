"""Initial-formation generators and the AirSim settings parser, host
NumPy (a copy of ``gym_flock_tpu/utils/formations.py``; reference
flocking/utils.py:6-77).

The flocking variants' deterministic resets read the generators (``grid``
for FlockingObstacle-v0 and FlockingTwoFlocks-v0); the AirSim bridges read
``grid`` and :func:`parse_settings`.
"""
from __future__ import annotations

import json
import re
from typing import Tuple

import numpy as np

__all__ = ["circle_helper", "circle", "grid", "twoflocks", "parse_settings"]


def circle_helper(n: int, dist: float) -> Tuple[np.ndarray, np.ndarray]:
    """Points on a circle with inter-agent spacing ``dist`` and inward-ish
    velocities (reference utils.py:6-10)."""
    r = dist * n / 2 / np.pi
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False).reshape((n, 1))
    pos = r * np.hstack((np.cos(angles), np.sin(angles)))
    vel = -0.5 * np.hstack((np.cos(angles), -0.5 * np.sin(angles)))
    return pos, vel


def circle(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """One circle for n <= 20, two concentric rings beyond (utils.py:13-20)."""
    if n <= 20:
        return circle_helper(n, 0.5)
    smalln = int(n * 2.0 / 5.0)
    c1, v1 = circle_helper(smalln, 0.5)
    c2, v2 = circle_helper(n - smalln, 0.5)
    return np.vstack((c1, c2)), np.vstack((v1, v2))


def grid(n: int, side: int = 5) -> np.ndarray:
    """``[n, 2]`` 0.8-spaced centered grid, ``side`` points a row
    (utils.py:23-30).  Where ``n`` is not a multiple of ``side`` (the
    reference crashes there) the enclosing grid is built and its first
    ``n`` points kept."""
    rows = -(-n // side)  # enough rows to cover n
    xs = np.arange(0, side) - side / 2.0
    ys = np.arange(0, rows) - rows / 2.0
    xs, ys = np.meshgrid(xs, ys)
    pts = 0.8 * np.hstack((xs.reshape((-1, 1)), ys.reshape((-1, 1))))
    return pts[:n]


def twoflocks(n: int, delta: float = 6, side=None) -> Tuple[np.ndarray, np.ndarray]:
    """Two opposing grids delta apart with colliding velocities (utils.py:33-50)."""
    half_n = int(n / 2)
    grid1 = grid(half_n) if side is None else grid(half_n, side)
    grid2 = grid1.copy() + np.array([[0, delta / 2]])
    grid1 = grid1 + np.array([[0, -delta / 2]])
    vels1 = np.tile(np.array([[0.0, delta]]), (half_n, 1))
    vels2 = np.tile(np.array([[0.0, -delta]]), (half_n, 1))
    return np.vstack((grid1, grid2)), np.vstack((vels1, vels2))


def parse_settings(fname: str) -> Tuple[list, np.ndarray]:
    """Vehicle names and home offsets ``[n, 3]`` from an AirSim
    settings.json.

    First the reference's line regex (utils.py:67-77): the ``"X": ..,
    "Y": .., "Z": ..`` triple on ONE line, and every ``"Name": {`` key but
    "Vehicles" (non-vehicle object keys included, as the reference).  Where
    that finds no homes, or not one per name (pretty-printed settings put
    one coordinate a line), the ``Vehicles`` section is parsed as JSON
    (insertion order, a missing coordinate 0).
    """
    names, homes = [], []
    with open(fname) as f:
        for line in f:
            names.extend(n for n in re.findall(r"\"(.+?)\": {", line) if n != "Vehicles")
            p = re.findall(
                r'"X": ([-+]?\d*\.*\d+), "Y": ([-+]?\d*\.*\d+), "Z": ([-+]?\d*\.*\d+)',
                line,
            )
            if p:
                homes.append(np.array([float(v) for v in p[0]]).reshape((1, 3)))
    if homes and len(homes) == len(names):
        return names, np.concatenate(homes, axis=0)
    with open(fname) as f:
        vehicles = json.load(f).get("Vehicles", {})
    names = list(vehicles)
    if not names:
        raise ValueError(f"no Vehicles found in {fname}")
    homes = np.array(
        [[float(v.get(k, 0.0)) for k in ("X", "Y", "Z")] for v in vehicles.values()]
    )
    return names, homes
