#!/usr/bin/env python3
"""Training quality of the PyTorch port's coverage pipelines on one GPU.

Trains a policy once and reports how close it comes to the expert on a
held-out bank, the same pipelines, worlds and widths as
``benchmarks/train_quality.py`` (the JAX package's):

  bc_greedy  CoverageImitationTrainer, EdgeGraphNet(latent=64, rounds=6),
             800 iterations of 8 envs x 16 steps, Adam 1e-3;
  dagger     CoverageDaggerTrainer, the same model, capacity 4096, 28
             iterations of 8 envs x 16 steps, 32 grad steps of batch 128.

The world is CoverageARL-v0 on the real ARL facility map: a training bank
of 8 sub-windows (``bank_seed=0``) and a held-out bank of 8 others
(``bank_seed=1234``).  Each trained policy is evaluated on both banks at
64 envs x 50 steps (accuracy on the greedy expert's labels, policy and
expert episode reward over the same resets, their ratio), beside the
reward of uniform random actions.  Prints one JSON object and writes it to
``--out``.  It needs a card and exits non-zero without one.

    python3 tools/train_quality_torch.py all --out chiprun_out/train_quality_torch.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

EVAL_ENVS, EVAL_STEPS, EVAL_SEED = 64, 50, 99


def coverage_world(device: str):
    import gym_flock_tpu_torch as gft

    env, params = gft.make("CoverageARL-v0", n_graphs=8, bank_seed=0, device=device,
                           real_map=True)
    _, eval_params = gft.make("CoverageARL-v0", n_graphs=8, bank_seed=1234, device=device,
                              real_map=True)
    return env, params, eval_params


def random_reward(env, params, device: str) -> float:
    """Mean episode reward of uniform random actions (the floor)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(EVAL_SEED)
    state, _ = env.reset_env(gen, params, EVAL_ENVS)
    total = torch.zeros(EVAL_ENVS, device=device)
    for _ in range(EVAL_STEPS):
        u = torch.randint(0, params.n_actions, (EVAL_ENVS, params.n_robots), generator=gen,
                          device=device, dtype=torch.int32)
        state, _, r, _, _ = env.step_env(None, state, u, params)
        total += r
    return float(total.mean())


def report(trainer, env, params, eval_params, device: str) -> dict:
    import torch

    out = {}
    for name, p in (("train_bank", params), ("heldout_bank", eval_params)):
        m = trainer.evaluate(torch.Generator(device=device).manual_seed(EVAL_SEED), p,
                             n_envs=EVAL_ENVS, n_steps=EVAL_STEPS)
        out[name] = {**m, "random_reward": random_reward(env, p, device)}
    return out


def run_bc_greedy(device: str, n_iters: int = 800) -> dict:
    import torch

    from gym_flock_tpu_torch.models import EdgeGraphNet
    from gym_flock_tpu_torch.parallel import CoverageImitationTrainer

    env, params, eval_params = coverage_world(device)
    gen = torch.Generator(device=device).manual_seed(0)
    trainer = CoverageImitationTrainer(
        env, params, model=EdgeGraphNet(64, 6, generator=gen, device=device),
        learning_rate=1e-3, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.fit(gen, n_iters=n_iters, n_envs=8, n_steps=16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"pipeline": "coverage BC, greedy expert labels (EdgeGraphNet 64x6)",
            "train": {"n_iters": n_iters, "samples_per_iter": 128, "loss_first": losses[0],
                      "loss_last10": sum(losses[-10:]) / len(losses[-10:]), "seconds": seconds},
            **report(trainer, env, params, eval_params, device)}


def run_dagger(device: str, n_iters: int = 28) -> dict:
    import torch

    from gym_flock_tpu_torch.models import EdgeGraphNet
    from gym_flock_tpu_torch.parallel import CoverageDaggerTrainer

    env, params, eval_params = coverage_world(device)
    gen = torch.Generator(device=device).manual_seed(0)
    trainer = CoverageDaggerTrainer(
        env, params, model=EdgeGraphNet(64, 6, generator=gen, device=device),
        capacity=4096, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.fit(gen, n_iters=n_iters, n_envs=8, n_steps=16, n_grad_steps=32,
                         batch_size=128)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"pipeline": "coverage DAGGER (mixture rollouts, rolling buffer)",
            "train": {"n_iters": n_iters, "beta_decay": trainer.beta_decay,
                      "loss_first": losses[0], "loss_last": losses[-1], "seconds": seconds},
            **report(trainer.inner, env, params, eval_params, device)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pipeline", choices=["bc_greedy", "dagger", "all"])
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_quality_torch: no CUDA device; this measurement needs a GPU",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": card,
              "torch": torch.__version__}
    runs = {"bc_greedy": run_bc_greedy, "dagger": run_dagger}
    for name in (runs if args.pipeline == "all" else [args.pipeline]):
        result[name] = runs[name]("cuda")
        print(name, json.dumps(result[name]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
