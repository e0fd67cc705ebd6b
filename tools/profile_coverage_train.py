#!/usr/bin/env python3
"""Where a coverage imitation train step spends its time on one GPU.

Builds ``chip_smoke.py`` phase 17's workload (CoverageARL-v0 on the real ARL
facility map, ``EdgeGraphNet(latent=64, rounds=6)``, batches of 8 envs x 16
steps), takes three warm-up train steps, then traces one collect and one
update with ``torch.profiler`` and prints, for each: the host-clock time
(around ``torch.cuda.synchronize()``), the device time (the sum of the
kernels' own times), the device's idle share of the window, the number of
kernel launches, and the kernels that take the most device time.  Prints
one JSON object and writes it to ``--out``; needs a card.

    python3 tools/profile_coverage_train.py --out chiprun_out/profile_coverage_train.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TOP = 12


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def traced(fn) -> dict:
    """Run ``fn`` once under the profiler; its time split."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    # no kernel in the trace: the profiler saw no device time here, which
    # is "not measured", not an idle card
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 if kernels else None
    top = sorted(kernels, key=_device_us, reverse=True)[:TOP]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:90], "count": e.count, "device_ms": _device_us(e) / 1e3}
                    for e in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_coverage_train: no CUDA device; this measurement needs a GPU",
              file=sys.stderr)
        return 1
    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.models import EdgeGraphNet
    from gym_flock_tpu_torch.parallel import CoverageImitationTrainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    env, params = gft.make("CoverageARL-v0", n_graphs=8, bank_seed=0, device="cuda",
                           real_map=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer = CoverageImitationTrainer(
        env, params, model=EdgeGraphNet(64, 6, generator=gen, device="cuda"), device="cuda")
    trainer.init(gen)
    for _ in range(3):
        trainer.train_step(gen, 8, 16)
    batch = trainer.collect(gen, 8, 16)
    torch.cuda.reset_peak_memory_stats()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": card,
              "torch": torch.__version__,
              "collect": traced(lambda: trainer.collect(gen, 8, 16)),
              "update": traced(lambda: trainer.update(batch)),
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
