#!/usr/bin/env python3
"""Where the gym facades of ``chip_smoke.py`` phase 27 spend a step on one
GPU.

``make_legacy`` on FlockingRelative-v0, Coverage-v0 (greedy) and
CoverageARL-v0 (real map, greedy): after a reset and a warm-up, 50
``controller()``/``step()`` pairs traced with ``torch.profiler``.
``make_gymnasium_vector`` at B=8192 on FlockingRelative-v0 and Coverage-v0:
a step traced, then the next one: for the flocking id
(``max_episode_steps=2``) the step that autoresets the whole batch.  Each window reports the
host-clock time (around ``torch.cuda.synchronize()``), the device time (the
kernels' and copies' own times), the device's idle share, the launches,
the host synchronisations (``cudaStreamSynchronize`` /
``cudaDeviceSynchronize`` calls), the device-to-host copies' time and the
kernels that take the most device time.  Prints one JSON object and writes
it to ``--out``; needs a card.

    python3 tools/profile_facades.py --out profile_facades.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools.profile_coverage_train import TOP, _device_us  # noqa: E402

PAIRS = 50
VECTOR_ENVS = 8192


def traced(fn, per: int) -> dict:
    """Run ``fn`` once under the profiler; its time split, each count and
    time also divided by ``per`` (the pairs or steps in the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(_device_us(e) for e in device) / 1e3 if device else None
    copies = [e for e in device if "DtoH" in e.key or "Device -> " in e.key]
    syncs = sum(e.count for e in events if e.key in ("cudaStreamSynchronize",
                                                     "cudaDeviceSynchronize"))
    top = sorted(device, key=_device_us, reverse=True)[:TOP]
    return {"wall_ms": wall_ms, "per": per, "wall_ms_each": wall_ms / per,
            "device_ms": device_ms,
            "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
            "launches_each": sum(e.count for e in device) / per,
            "syncs_each": syncs / per,
            "dtoh_ms_each": sum(_device_us(e) for e in copies) / 1e3 / per,
            "top": [{"name": e.key[:90], "count": e.count, "device_ms": _device_us(e) / 1e3}
                    for e in top]}


def profile_legacy(env_id: str, **kwargs) -> dict:
    from gym_flock_tpu_torch.compat import make_legacy

    env = make_legacy(env_id, device="cuda", **kwargs)
    greedy = {"greedy": True} if env_id.startswith("Coverage") else {}
    env.seed(0)
    env.reset()

    def pairs():
        for _ in range(PAIRS):
            env.step(env.controller(**greedy))

    pairs()  # warm-up
    return {"pairs": traced(pairs, PAIRS), "reset": traced(env.reset, 1)}


def profile_vector(env_id: str, **kwargs) -> dict:
    from gym_flock_tpu_torch.compat import make_gymnasium_vector

    venv = make_gymnasium_vector(env_id, num_envs=VECTOR_ENVS, device="cuda", **kwargs)
    venv.reset(seed=0)
    for _ in range(2):  # warm-up, through an autoreset where the limit is 2
        venv.step(venv.controller())
    venv.reset(seed=1)
    u = venv.controller()
    out = {"B": VECTOR_ENVS, "step": traced(lambda: venv.step(u), 1)}
    u = venv.controller()
    if kwargs.get("max_episode_steps") == 2:
        out["autoreset_step"] = traced(lambda: venv.step(u), 1)
    else:
        out["second_step"] = traced(lambda: venv.step(u), 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_facades: no CUDA device; this measurement needs a GPU",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": card,
              "torch": torch.__version__,
              "legacy": {"FlockingRelative-v0": profile_legacy("FlockingRelative-v0"),
                         "Coverage-v0": profile_legacy("Coverage-v0"),
                         "CoverageARL-v0": profile_legacy("CoverageARL-v0", real_map=True)},
              "vector": {"FlockingRelative-v0": profile_vector("FlockingRelative-v0",
                                                               max_episode_steps=2),
                         "Coverage-v0": profile_vector("Coverage-v0")}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
