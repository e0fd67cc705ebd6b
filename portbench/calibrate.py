#!/usr/bin/env python3
"""Readings that a cell's limits are set from, in one process on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 12 --control 3 \
        --faults 3 --seconds 4 --out chiprun_out/calibrate/<name>.json

Runs the cell at its own size with short windows: the program on
``--seeds`` seeds (the lower readings: the largest of each number), the
control (the plain reference in the program's place, one precision below
float32) and each fault the cell's driver plants, on ``--control`` and
``--faults`` further seeds (the upper readings: the smallest of each
number).  Prints one JSON object and writes it to ``--out``.  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--only", default="", help="comma-separated subset: program,control,<fault>")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    w = harness.workload(bench, args.workload)
    traffic = harness.load_json(harness.traffic_file(w["traffic"], w["config"]))
    faults = harness.driver(traffic["driver"]).FAULTS
    plan = [("program", None, args.seeds), ("control", None, args.control)]
    plan += [("program", f, args.faults) for f in faults]
    only = set(filter(None, args.only.split(",")))
    seed = args.first_seed
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0), "runs": []}
    for system, fault, n in plan:
        if only and (fault or system) not in only:
            continue
        for _ in range(n):
            t0 = time.perf_counter()
            try:
                r = harness.run_cell(args.workload, seed, args.seconds, False, bench=bench,
                                     system=system, fault=fault)
                numbers = r["run"]["numbers"]
                entry = {"system": system, "fault": fault, "seed": seed,
                         "correct": r["correct"], "numbers": numbers, "run": r["run"]}
            except Exception as e:  # a control or fault that crashes has failed
                entry = {"system": system, "fault": fault, "seed": seed, "correct": False,
                         "error": f"{type(e).__name__}: {e}"[:400]}
            entry["seconds"] = time.perf_counter() - t0
            out["runs"].append(entry)
            print(json.dumps(entry), flush=True)
            seed += 1
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
