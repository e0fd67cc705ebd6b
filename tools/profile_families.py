#!/usr/bin/env python3
"""Where the env families of ``chip_smoke.py`` phases 21-25 spend a step on
one GPU.

For each family at the phase's batch size (FlockingLeader-v0 stands for the
four B=1024 flocking variants, MappingVel-v0 for the three small mapping
ids): a reset and a warm-up of the same steps, then the reset and 4 steps
traced with ``torch.profiler``, each reported as the host-clock time
(around ``torch.cuda.synchronize()``), the device time (the sum of the
kernels' own times), the device's idle share of the window, the kernel
launches and the kernels that take the most device time.  Prints one JSON
object and writes it to ``--out``; needs a card.

    python3 tools/profile_families.py --out chiprun_out/profile_families.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools.profile_coverage_train import traced  # noqa: E402

STEPS = 4
# (id, batch, make() keywords, policy): "fused" is the flocking expert
# rollout, "expert" the env's controller, "random" its action space
FAMILIES = (
    ("Flocking-v0", 8192, {}, "fused"),
    ("FlockingLeader-v0", 1024, {}, "fused"),
    ("Shepherding-v0", 4096, {}, "expert"),
    ("FormationFlying-v0", 8192, {}, "random"),
    ("LQR-v0", 4096, {"device": "cuda"}, "expert"),
    ("Mapping-v0", 128, {"device": "cuda"}, "expert"),
    ("MappingVel-v0", 1024, {"device": "cuda"}, "expert"),
    ("FlockingMulti-v0", 4096, {}, "expert"),
)


def profile_family(env_id: str, n_envs: int, kwargs: dict, policy: str) -> dict:
    import torch

    import gym_flock_tpu_torch as gft

    env, params = gft.make(env_id, **kwargs)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def reset():
        return env.reset_env(gen, params, n_envs)[0]

    def steps(state):
        if policy == "fused":
            return env.expert_rollout(state, params, STEPS, generator=gen)[0]
        for _ in range(STEPS):
            if policy == "random":
                action = env.action_space(params).sample(gen, (n_envs,))
            else:
                action = env.controller(state, params)
            state = env.step_env(gen, state, action, params)[0]
        return state

    steps(reset())  # warm-up: first calls, allocator
    state = reset()
    out = {"B": n_envs, "policy": policy, "reset": traced(reset),
           "steps": traced(lambda: steps(state))}
    out["steps"]["wall_ms_a_step"] = out["steps"]["wall_ms"] / STEPS
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_families: no CUDA device; this measurement needs a GPU",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": card,
              "torch": torch.__version__, "steps_traced": STEPS,
              "families": {env_id: profile_family(env_id, b, kw, policy)
                           for env_id, b, kw, policy in FAMILIES}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
