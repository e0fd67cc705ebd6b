#!/usr/bin/env python3
"""K2 and K4 (the GNN aggregation kernels) on one NVIDIA GPU: the current
design against the previous one and against a variant that reads H through
the read-only cache.

Run from the repository root with one visible card:

    python3 tools/probe_adj_kernels.py [--parent DIR] [--check-only] [--out FILE]

``--parent`` names an unpacked checkout of the commit whose
``gym_flock_tpu_torch/csrc/adj_matmul.cu`` and ``sparse_adj.cu`` are the
previous design (``git archive <commit> | tar -x -C build/parent``).  It
prints, and writes to ``--out`` (default ``build/probe/probe_adj.json``):

1. the card's name and power limit, and each kernel's registers and spills
   (``-Xptxas -v``);
2. the f32->f64 conversions (``F2F.F64.F32``) in each instance's SASS
   (``cuobjdump -sass``): F a hit in the body and none in the test pass
   means exactly F in the instance;
3. the new kernels against their plain versions at the main path's shapes
   (degree exact, max |k - p| / (1 + |p|) < 1e-6);
4. with ``--parent``: direct launches of the previous and the new design,
   and of the new one against its variant that reads H through the
   read-only cache (``tools/adj_h_cached.cu``), in turns old, new, new,
   old (medians of 7 CUDA-event timings after a warm-up), then
   ``chip_smoke.py``'s phases 14 and 15 with the previous and the new
   kernels behind the wrappers, in the same turns.  K1 and K3, whose pair
   loop K2 and K4 now share, are timed against the previous commit's too,
   and K1's and K4's wrappers against direct launches (the host's share of
   a call).

``--check-only`` stops after 3.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PROBE_DIR = ROOT / "build" / "probe"


def nvcc_library(name: str, sources, include=()):
    """Builds ``sources`` into ``build/probe/<name>.so`` with the library's
    flags; returns the loaded library and the compiler's register lines."""
    from gym_flock_tpu_torch.ops import _build

    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    out = PROBE_DIR / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.LINK_FLAGS,
           *(f"-I{d}" for d in include), "-o", str(out), *map(str, sources)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(out)), register_lines(r.stdout + r.stderr)


def register_lines(log: str):
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def f2f_counts(library: Path) -> dict:
    """``{kernel instance: F2F.F64.F32 count}`` for K2's and K4's instances."""
    from gym_flock_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and "F2F.F64.F32" in line:
            counts[name] += 1
    names = list(counts)
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(counts), capture_output=True,
                               text=True, check=True).stdout.split("\n")
    return {d: counts[n] for n, d in zip(counts, names)
            if "adj_matmul_kernel" in d or "sparse_adj_kernel" in d}


def operands(device: str = "cuda"):
    """The main path's operands: K2's (FlockingLarge-v0 draws, B=16, N=4096,
    F=6) and phase 12(b)'s tile at F=16; K4's sorted operands and
    aggregation tables at N=65,536, B=1 and N=16,384, B=16 (bench metric
    4's state), F=6."""
    import torch

    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    x = cs.draw_swarms(16, 4096, device, cs.SEED + 4096)
    xb = cs.draw_swarms(3, 1300, device, cs.SEED + 1300)
    k2_cases = {
        "B=16,N=4096,F=6": (x, x, torch.randn(16, 4096, 6, generator=gen, device=device), 0, 0),
        "(b) B=3,1000x700,F=16": (xb[:, :1000].contiguous(), xb[:, 600:].contiguous(),
                                  torch.randn(3, 700, 16, generator=gen, device=device), 0, 600),
    }
    cr = torch.sqrt(torch.tensor(cs.CR2, dtype=torch.float32, device=device))
    k4_cases = {}
    for b, n in ((1, 65536), (16, 16384)):
        xs_ = cs.bench_state(b, n, cs.SEED + b, device)
        perm = sf.hilbert_order(xs_, cr)
        xs = sf.permute(xs_, perm)
        table, overflow = sf.block_pair_table(xs, cr, 16)
        assert not bool(overflow.any())
        k4_cases[f"B={b},N={n},F=6"] = (xs, torch.randn(b, n, 6, generator=gen, device=device),
                                        table)
    return k2_cases, k4_cases


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def direct_k2(lib, fn: str, xr, xc, h, ro, co, old: bool, cr2=cs.CR2):
    """One direct launch of a K2 entry point (previous or current C
    signature) into fresh outputs."""
    import torch

    b, m, _ = xr.shape
    k, f = xc.shape[1], h.shape[-1]
    out = torch.empty(b, m, f, device=xr.device)
    deg = torch.empty(b, m, device=xr.device)
    if old:
        rc = getattr(lib, fn)(xr.data_ptr(), xr.shape[-1], xc.data_ptr(), xc.shape[-1],
                              h.data_ptr(), out.data_ptr(), deg.data_ptr(), b, m, k, f, ro, co,
                              ctypes.c_float(cr2), ctypes.c_void_p(stream()))
    else:
        rc = getattr(lib, fn)(xr.data_ptr(), xc.data_ptr(), h.data_ptr(), out.data_ptr(),
                              deg.data_ptr(), b, m, k, f, ro, co, ctypes.c_float(cr2),
                              ctypes.c_void_p(stream()))
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")
    return out, deg


def direct_k4(lib, xs, hs, table, cr2=cs.CR2):
    import torch

    b, n, _ = xs.shape
    f = hs.shape[-1]
    out = torch.empty(b, n, f, device=xs.device)
    deg = torch.empty(b, n, device=xs.device)
    rc = lib.gft_sparse_adj(xs.data_ptr(), hs.data_ptr(), table.data_ptr(), out.data_ptr(),
                            deg.data_ptr(), b, n, table.shape[-1], f, ctypes.c_float(cr2),
                            ctypes.c_void_p(stream()))
    if rc != 0:
        raise RuntimeError(f"gft_sparse_adj failed: CUDA error {rc}")
    return out, deg


def direct_k1(lib, x, channels: str, cr: float = 0.9):
    import torch

    b, n, _ = x.shape
    out = torch.empty(b, n, 16, device=x.device)
    rc = lib.gft_block_sums(x.data_ptr(), x.data_ptr(), out.data_ptr(), b, n, n, 0, 0,
                            ctypes.c_float(cr), ctypes.c_float(cr * cr), int(channels == "full"),
                            ctypes.c_void_p(stream()))
    if rc != 0:
        raise RuntimeError(f"gft_block_sums failed: CUDA error {rc}")
    return out


def direct_k3(lib, xs, table, cr: float = 0.9):
    import torch

    b, n, _ = xs.shape
    out = torch.empty(b, n, 16, device=xs.device)
    rc = lib.gft_sparse_sums(xs.data_ptr(), table.data_ptr(), out.data_ptr(), b, n,
                             table.shape[-1], ctypes.c_float(cr), ctypes.c_float(cr * cr), 0,
                             ctypes.c_void_p(stream()))
    if rc != 0:
        raise RuntimeError(f"gft_sparse_sums failed: CUDA error {rc}")
    return out


def pair_kernels(old, new, err) -> dict:
    """K1 and K3 of the previous commit and of this tree, in turns, on phase
    3's and phase 9's main-path operands; each pair of results equal."""
    import torch

    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    times = {}
    for b, n, channels in ((16, 4096, "core"), (4, 4096, "full")):
        x = cs.draw_swarms(b, n, "cuda", cs.SEED + n)
        first = functools.partial(direct_k1, old, x, channels)
        second = functools.partial(direct_k1, new, x, channels)
        if not torch.equal(first(), second()):
            raise AssertionError(f"K1 {channels} B={b} differs from the previous design")
        times[f"K1 {channels} B={b},N={n}"] = in_turns(first, second)
    for b, n in ((1, 65536), (16, 16384)):
        x = cs.bench_state(b, n, cs.SEED + b, "cuda")
        vs = sf.verlet_build(x, 0.9, 0.9)
        xs = sf.permute(x, vs.perm)
        first = functools.partial(direct_k3, old, xs, vs.table)
        second = functools.partial(direct_k3, new, xs, vs.table)
        if not torch.equal(first(), second()):
            raise AssertionError(f"K3 B={b} differs from the previous design")
        times[f"K3 core B={b},N={n}"] = in_turns(first, second)
    return times


def wrapper_costs(new, k4_cases) -> dict:
    """The wrapper against a direct launch of the same kernel, in turns."""
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    x = cs.draw_swarms(4, 4096, "cuda", cs.SEED + 4096)
    times = {"K1 full B=4,N=4096": in_turns(
        functools.partial(direct_k1, new, x, "full"),
        lambda: k1.flocking_sums_block(x, x, 0, 0, 0.9, 0.81, channels="full"),
        ("direct", "wrapper"))}
    xs, hs, table = k4_cases["B=1,N=65536,F=6"]
    times["K4 B=1,N=65536,F=6"] = in_turns(
        functools.partial(direct_k4, new, xs, hs, table),
        functools.partial(sf.sparse_adj_sorted, xs, hs, table, cs.CR2), ("direct", "wrapper"))
    return times


def set_argtypes(lib, names):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = {
        "old_k2": [p, i, p, i, p, p, p, i, i, i, i, i, i, f, p],
        "new_k2": [p, p, p, p, p, i, i, i, i, i, i, f, p],
        "k4": [p, p, p, p, p, i, i, i, i, f, p],
        "k1": [p, p, p, i, i, i, i, i, f, f, i, p],
        "k3": [p, p, p, i, i, i, f, f, i, p],
    }
    for fn, kind in names.items():
        getattr(lib, fn).argtypes = sig[kind]
        getattr(lib, fn).restype = ctypes.c_int


@contextlib.contextmanager
def previous_kernels(old):
    """The wrappers' launches go to the previous design's library ``old``,
    counted as the wrappers count them."""
    import torch

    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    def k2_launch(xr, xc, h, row_offset, col_offset, comm_radius2, backward):
        out, deg = direct_k2(old, "gft_adj_matmul", xr, xc, h.to(torch.float32).contiguous(),
                             int(row_offset), int(col_offset), True, float(comm_radius2))
        k2.launches += k2.launches_for(h.shape[-1])
        k2.backward_launches += k2.launches_for(h.shape[-1]) if backward else 0
        return out.to(h.dtype), deg

    def k4_launch(xs, hs, table, comm_radius2, backward):
        out, deg = direct_k4(old, xs, hs.to(torch.float32).contiguous(), table,
                             float(comm_radius2))
        sf.adj_launches += k2.launches_for(hs.shape[-1])
        sf.adj_backward_launches += k2.launches_for(hs.shape[-1]) if backward else 0
        return out.to(hs.dtype), deg

    saved = k2._launch, sf._launch_adj
    k2._launch, sf._launch_adj = k2_launch, k4_launch
    try:
        yield
    finally:
        k2._launch, sf._launch_adj = saved


def in_turns(first, second, names=("old", "new")) -> dict:
    """``{name: [ms, ms]}``: ``first()`` and ``second()`` timed in turns
    first, second, second, first."""
    times = {n: [] for n in names}
    for n, fn in zip((0, 1, 1, 0), (first, second, second, first)):
        times[names[n]].append(cs.time_ms(fn))
    return times


def check(err, got, want):
    out, deg = got
    w_out, w_deg = want
    cs._sync()
    cs.compare_deg(deg, w_deg)
    return err.check(out, w_out)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="unpacked checkout of the previous design")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--out", type=Path, default=PROBE_DIR / "probe_adj.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_adj_kernels: no GPU", file=sys.stderr)
        return 1
    from gym_flock_tpu_torch.ops import _build
    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"card": smi}
    new = _build.load()
    result["new_registers"] = register_lines(_build.build_log)
    result["new_f2f_f64_f32"] = f2f_counts(_build.library_path())
    print(json.dumps({"card": smi, "f2f": result["new_f2f_f64_f32"]}))

    k2_cases, k4_cases = operands()
    err = cs.AdjErrors()
    for name, (xr, xc, h, ro, co) in k2_cases.items():
        check(err, k2.adjacency_matmul_block(xr, xc, h, ro, co, cs.CR2),
              k2.adjacency_matmul_block_reference(xr, xc, h, ro, co, cs.CR2))
    for name, (xs, hs, table) in k4_cases.items():
        check(err, sf.sparse_adj_sorted(xs, hs, table, cs.CR2),
              sf.sparse_adj_sorted_reference(xs, hs, table, cs.CR2))
    result["new_vs_plain"] = {"max_rel": err.rel, "max_abs": err.abs}
    print(json.dumps({"new_vs_plain": result["new_vs_plain"]}))
    if args.check_only or args.parent is None:
        return write(result, args.out)

    csrc = args.parent / "gym_flock_tpu_torch" / "csrc"
    old, old_regs = nvcc_library("previous", [csrc / name for name in (
        "adj_matmul.cu", "sparse_adj.cu", "block_sums.cu", "sparse_sums.cu")])
    cached, cached_regs = nvcc_library("adj_h_cached", [ROOT / "tools" / "adj_h_cached.cu"],
                                       include=[_build.CSRC])
    set_argtypes(old, {"gft_adj_matmul": "old_k2", "gft_sparse_adj": "k4",
                       "gft_block_sums": "k1", "gft_sparse_sums": "k3"})
    set_argtypes(cached, {"probe_adj_cached": "new_k2"})
    result["previous_registers"], result["cached_registers"] = old_regs, cached_regs

    kernels = {}
    for name, (xr, xc, h, ro, co) in k2_cases.items():
        first = functools.partial(direct_k2, old, "gft_adj_matmul", xr, xc, h, ro, co, True)
        second = functools.partial(direct_k2, new, "gft_adj_matmul", xr, xc, h, ro, co, False)
        check(err, first(), second())
        kernels[f"K2 {name}"] = in_turns(first, second)
    xr, xc, h, ro, co = k2_cases["B=16,N=4096,F=6"]
    first = functools.partial(direct_k2, cached, "probe_adj_cached", xr, xc, h, ro, co, False)
    second = functools.partial(direct_k2, new, "gft_adj_matmul", xr, xc, h, ro, co, False)
    check(err, first(), second())
    kernels["K2 B=16,N=4096,F=6 H placement"] = in_turns(first, second, ("cached", "staged"))
    for name, (xs, hs, table) in k4_cases.items():
        first = functools.partial(direct_k4, old, xs, hs, table)
        second = functools.partial(direct_k4, new, xs, hs, table)
        check(err, first(), second())
        kernels[f"K4 {name}"] = in_turns(first, second)
    kernels.update(pair_kernels(old, new, err))
    kernels.update({f"{k} wrapper": v for k, v in wrapper_costs(new, k4_cases).items()})
    result["kernels_ms"] = kernels
    print(json.dumps({"kernels_ms": kernels}))

    phases = {"phase 14 update_seconds": [], "phase 14 k2_aggregation_ms": [],
              "phase 15 update_seconds_each": []}
    for design in ("old", "new", "new", "old"):
        with (previous_kernels(old) if design == "old" else contextlib.nullcontext()):
            t14 = cs.phase_large_train("cuda", n_envs=4, n_steps=4, n_updates=5)
            t15 = cs.phase_sparse_train("cuda", n_agents=65536, n_steps=4, n_updates=3)
        phases["phase 14 update_seconds"].append((design, t14["update_seconds"]))
        phases["phase 14 k2_aggregation_ms"].append((design, t14["k2_aggregation_ms"]))
        phases["phase 15 update_seconds_each"].append((design, t15["update_seconds_each"]))
    result["phases"] = phases
    result["errors_vs_each_other"] = {"max_rel": err.rel, "max_abs": err.abs}
    print(json.dumps({"phases": phases}))
    return write(result, args.out)


def write(result, out: Path) -> int:
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
