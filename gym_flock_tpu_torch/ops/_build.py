"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``gym_flock_tpu_torch/csrc/*.cu`` to an object, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``.  The library goes into
``build/gym_flock_tpu_torch/`` beside the package, under a name that carries
a hash of the sources and the flags, so that a stale library is never
loaded.  The build happens at first use, in the process that needs it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "LINK_FLAGS", "build", "load", "library_path"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "gym_flock_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # IEEE division for 1/r2; FMA stays allowed, r2 is formed with
    # __fmul_rn/__fadd_rn in the source.  Never --use_fast_math.
    "-prec-div=true",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)

_lib = None
build_log = ""  # compiler output of the build that produced the library


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libgft_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the CUDA toolkit is needed to build the gym_flock_tpu_torch kernels"
    )


def build() -> Path:
    """Compile the kernels unless the library for these sources exists;
    returns its path."""
    global build_log
    out = library_path()
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [s for s in _sources() if s.suffix == ".cu"]
    # compile into a private directory and link to a private name, then
    # rename: concurrent builders never load a half-written library
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    tmp = work / out.name
    try:
        procs = []
        for src in cu:
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            text = p.communicate()[0]
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(f"{src.name} ({p.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n" + "".join(logs))
        r = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stdout}{r.stderr}")
        build_log = "".join(logs) + r.stdout + r.stderr
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load():
    """The loaded kernel library (built at first use), with ``argtypes`` and
    ``restype`` set on every entry point."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gft_block_sums.argtypes = [p, p, p, i, i, i, i, i, f, f, i, p]
        lib.gft_block_sums.restype = ctypes.c_int
        lib.gft_block_sums_grid.argtypes = [i, i, i, p]
        lib.gft_block_sums_grid.restype = None
        lib.gft_rowmin.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.gft_rowmin.restype = ctypes.c_int
        lib.gft_sparse_sums.argtypes = [p, p, p, i, i, i, f, f, i, p]
        lib.gft_sparse_sums.restype = ctypes.c_int
        lib.gft_sparse_sums_grid.argtypes = [i, i, i, p]
        lib.gft_sparse_sums_grid.restype = None
        lib.gft_adj_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, p]
        lib.gft_adj_matmul.restype = ctypes.c_int
        lib.gft_adj_matmul_grid.argtypes = [i, i, i, p]
        lib.gft_adj_matmul_grid.restype = None
        lib.gft_sparse_adj.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
        lib.gft_sparse_adj.restype = ctypes.c_int
        lib.gft_sparse_adj_grid.argtypes = [i, i, i, p]
        lib.gft_sparse_adj_grid.restype = None
        ll = ctypes.c_longlong
        lib.gft_dense_pass.argtypes = [p, p, i, i, f, f, i, i, p, ll, p, ll, p, i, p]
        lib.gft_dense_pass.restype = ctypes.c_int
        lib.gft_dense_pass_max_agents.argtypes = []
        lib.gft_dense_pass_max_agents.restype = ctypes.c_int
        lib.gft_resolve_conflicts.argtypes = [p, p, p, i, i, p]
        lib.gft_resolve_conflicts.restype = ctypes.c_int
        lib.gft_step_tail.argtypes = [p, p, p, p, p, ctypes.POINTER(ll), p, i, i, f, f, f, p, ll,
                                      p, ll, p, i, p]
        lib.gft_step_tail.restype = ctypes.c_int
        _lib = lib
    return _lib
