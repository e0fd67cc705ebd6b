"""Discovery of the real ARL occupancy maps (counterpart of
``gym_flock_tpu/envs/maps.py``).

The maps are data files, ``grid_sliceN.npy`` (N the downsample rate).  The
repository bundles byte-identical copies of the reference's under
``gym_flock_tpu/data/maps/``; the port reads them from there as files.

Search order (first hit wins):

1. ``$GYM_FLOCK_TPU_MAPS``: a directory holding ``grid_sliceN.npy``.  Set it
   to ``off`` / ``none`` / ``0`` / ``false`` to disable discovery entirely, so
   that the occupancy envs build procedural maps (the test suite does this).
2. The bundled copies, ``gym_flock_tpu/data/maps/`` beside this package.
3. An installed ``gym_flock`` package: its ``envs/spatial/maps/``.
4. ``$GYM_FLOCK_REFERENCE``: a gym-flock source checkout.

The JAX module also searches a fixed checkout path; the port does not: point
``$GYM_FLOCK_REFERENCE`` at a checkout instead.  The JAX module's one-time
warning when a bundled copy shadows a different file further down the list
is not ported yet.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

__all__ = ["find_reference_map", "reference_map_dirs"]

_DISABLED = ("off", "none", "0", "false")
BUNDLED = Path(__file__).resolve().parents[2] / "gym_flock_tpu" / "data" / "maps"


def reference_map_dirs() -> List[Path]:
    """Candidate directories that may hold ``grid_sliceN.npy``, in search
    order (no filesystem access)."""
    env_dir = os.environ.get("GYM_FLOCK_TPU_MAPS", "")
    if env_dir.strip().lower() in _DISABLED:
        return []
    dirs = [Path(env_dir)] if env_dir else []
    dirs.append(BUNDLED)
    try:
        import importlib.util

        spec = importlib.util.find_spec("gym_flock")
        if spec is not None and spec.submodule_search_locations:
            for loc in spec.submodule_search_locations:
                dirs.append(Path(loc) / "envs" / "spatial" / "maps")
    except (ImportError, ValueError):  # pragma: no cover
        pass
    ref = os.environ.get("GYM_FLOCK_REFERENCE")
    if ref:
        dirs.append(Path(ref) / "gym_flock" / "envs" / "spatial" / "maps")
    return dirs


def find_reference_map(downsample_rate: int = 10) -> Optional[str]:
    """The path of ``grid_slice{downsample_rate}.npy``, or ``None``.

    ``downsample_rate=10`` is what every reference occupancy env uses.
    """
    name = f"grid_slice{downsample_rate}.npy"
    for d in reference_map_dirs():
        p = d / name
        try:
            if p.is_file():
                return str(p)
        except OSError:  # pragma: no cover
            continue
    return None
