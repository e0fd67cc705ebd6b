"""ctypes bindings and first-use build of the native VRP solver
(counterpart of ``gym_flock_tpu/experts/vrp/__init__.py``).

The reference hands its expert's routing problem to OR-Tools' C++ solver
through SWIG (reference vrp_solver.py:78-134).  ``vrp_solver.cc`` here is
a byte-for-byte copy of the JAX package's self-contained solver.  At first
use it is compiled with ``g++ -O3 -shared -fPIC -std=c++17`` into
``build/gym_flock_tpu_torch/`` beside the package, under a name that carries
a hash of the source, and loaded with ``ctypes``.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from gym_flock_tpu_torch.ops._build import BUILD_DIR

__all__ = ["solve_vrp_raw", "library_path", "native_available"]

SOURCE = Path(__file__).resolve().parent / "vrp_solver.cc"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()  # first-use build and load against thread-pooled callers


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libvrp_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then a rename: a concurrent builder (another thread's
    # or another process's first use) never loads a half-written library
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.{threading.get_ident()}.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"cannot run the C++ compiler for the VRP solver: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the VRP solver failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            argtypes = [
                ctypes.POINTER(ctypes.c_double),  # time_matrix
                ctypes.POINTER(ctypes.c_double),  # penalties
                ctypes.c_int,  # n_nodes
                ctypes.c_int,  # num_vehicles
                ctypes.POINTER(ctypes.c_int),  # init_loc
                ctypes.c_double,  # max_route_time
                ctypes.POINTER(ctypes.c_int32),  # out
                ctypes.c_int,  # max_len
            ]
            for name, extra in (
                ("vrp_solve", []),
                ("vrp_solve_cheapest_arc", []),
                ("vrp_solve_or_default", []),
                ("vrp_solve_or_default_stats", [ctypes.POINTER(ctypes.c_longlong)]),
                ("vrp_solve_or_default_rot", [ctypes.c_int, ctypes.c_int]),
            ):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes + extra
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the solver library builds (at first use) and loads here."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def solve_vrp_raw(
    time_matrix: np.ndarray,
    penalties: np.ndarray,
    init_loc: np.ndarray,
    max_route_time: float,
    mode: str = "or_default",
    collect_stats: bool = False,
    rot: int = 0,
    last_accept: bool = False,
) -> List[List[int]]:
    """Solve the depot-augmented VRP; returns each vehicle's node sequence
    (1-based ids of the depot-augmented matrix, depot excluded).

    ``mode``: ``"or_default"`` (default; the reference pipeline:
    PATH_CHEAPEST_ARC construction, then OR-Tools' default first-accept
    greedy descent), ``"improve"`` (constructions with 2-opt / relocate /
    or-opt improvement) or ``"cheapest_arc"`` (the construction alone).

    ``collect_stats`` (``or_default`` only) returns ``(routes, {"descent_steps",
    "ambiguous_steps"})``; ``rot`` / ``last_accept`` (``or_default`` only)
    perturb the descent's enumeration order.  See the JAX package's
    ``solve_vrp_raw`` for their meaning.
    """
    perturbed = bool(rot) or last_accept
    if (collect_stats or perturbed) and mode != "or_default":
        raise ValueError(
            "collect_stats/rot/last_accept are only meaningful for mode='or_default'")
    if collect_stats and perturbed:
        raise ValueError("collect_stats and rot/last_accept are mutually exclusive")
    lib = _load()
    if mode == "cheapest_arc":
        fn = lib.vrp_solve_cheapest_arc
    elif mode == "or_default":
        fn = (lib.vrp_solve_or_default_stats if collect_stats
              else lib.vrp_solve_or_default_rot if perturbed
              else lib.vrp_solve_or_default)
    elif mode == "improve":
        fn = lib.vrp_solve
    else:
        raise ValueError(f"unknown VRP mode {mode!r}")
    tm = np.ascontiguousarray(time_matrix, dtype=np.float64)
    pen = np.ascontiguousarray(penalties, dtype=np.float64)
    init = np.ascontiguousarray(init_loc, dtype=np.int32)
    n, num_vehicles = tm.shape[0], len(init)
    if tm.shape != (n, n) or pen.shape != (n,):
        raise ValueError(f"time_matrix {tm.shape} and penalties {pen.shape} do not match")
    max_len = n + 2
    out = np.full((num_vehicles, max_len), -1, dtype=np.int32)
    stats = np.zeros((2,), dtype=np.int64)
    args = [
        tm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pen.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int(n),
        ctypes.c_int(num_vehicles),
        init.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ctypes.c_double(max_route_time),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(max_len),
    ]
    if collect_stats:
        args.append(stats.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    elif perturbed:
        args.extend([ctypes.c_int(rot), ctypes.c_int(int(last_accept))])
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"vrp_solve failed with code {rc}")
    routes = [[int(v) for v in row[row >= 0]] for row in out]
    if mode in ("cheapest_arc", "or_default"):
        routes = _assign_to_robots(routes, [int(i) for i in init])
    if collect_stats:
        return routes, {"descent_steps": int(stats[0]), "ambiguous_steps": int(stats[1])}
    return routes


def _assign_to_robots(routes: List[List[int]], init_list: List[int]) -> List[List[int]]:
    """The construction's vehicle v claims the lowest-indexed unclaimed init
    location, not necessarily its own; as the reference does
    (vrp_solver.py:144-146), give each route to the robot whose init
    location is its first stop.  (``"improve"`` pins vehicle v to its own.)"""
    assigned: List[List[int]] = [[] for _ in init_list]
    taken = [False] * len(init_list)
    for route in routes:
        if not route:
            continue
        for r_i, loc in enumerate(init_list):
            if loc == route[0] and not taken[r_i]:
                assigned[r_i] = route
                taken[r_i] = True
                break
    return assigned
