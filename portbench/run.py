#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the checks, each number compared beside
its limit, as the last lines of standard error, and one JSON object as the
last line of standard output (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, ``checks`` last).
Exits non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), and where the JAX package or JAX was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# top-level module names (compared whole) that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "gym_flock_tpu")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches at fixed paths inside the checkout, so that only a checkout's
    # first run fills them: the kernels' (the port builds its library into
    # build/gym_flock_tpu_torch/ itself) and Python's bytecode, which an
    # environment that sets PYTHONDONTWRITEBYTECODE would otherwise have
    # every run compile anew from the sources of torch and the port
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
    sys.pycache_prefix = str(REPO / "build" / "pycache")
    sys.dont_write_bytecode = False
    sys.path.insert(0, str(REPO))
    import torch

    from portbench import harness

    bench = harness.benchmark()
    cell = harness.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_process=T_PROCESS, bench=bench)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
