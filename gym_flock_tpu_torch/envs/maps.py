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
``$GYM_FLOCK_REFERENCE`` at a checkout instead.  A hit that shadows a
different file of the same name further down the list warns once a name.
"""
from __future__ import annotations

import hashlib
import os
import warnings
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
    dirs = reference_map_dirs()
    for i, d in enumerate(dirs):
        p = d / name
        try:
            if p.is_file():
                _warn_if_shadowing(p, name, dirs[i + 1:])
                return str(p)
        except OSError:  # pragma: no cover
            continue
    return None


_warned_shadow: set = set()


def _warn_if_shadowing(hit: Path, name: str, lower_dirs: List[Path]) -> None:
    """Warn once for ``name`` when a lower-priority directory holds a
    different ``grid_sliceN.npy`` than the one selected (a custom map in a
    checkout would otherwise lose silently to the bundled copy); copies
    with the same content stay silent."""
    if name in _warned_shadow:
        return
    try:
        hit_digest = hashlib.sha256(hit.read_bytes()).hexdigest()
    except OSError:  # pragma: no cover
        return
    for d in lower_dirs:
        q = d / name
        try:
            if q.is_file() and hashlib.sha256(q.read_bytes()).hexdigest() != hit_digest:
                _warned_shadow.add(name)
                warnings.warn(
                    f"{hit} shadows a different {name} at {q}; set "
                    "$GYM_FLOCK_TPU_MAPS to that directory to use it instead",
                    stacklevel=3,
                )
                return
        except OSError:  # pragma: no cover
            continue
    _warned_shadow.add(name)
