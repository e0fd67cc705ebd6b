"""Flocking demo driver on the PyTorch port: the reference's README loop,
plus a batched mode (counterpart of ``examples/run_flocking.py``).

The single-env mode is the reference's interactive loop (README.md:18-30)
through ``make_legacy``, whose controller looks ahead; ``--batch`` rolls
thousands of envs at once.  Runs on the GPU unless ``--cpu`` is given.

    python examples/torch_run_flocking.py --cpu -n 200 --render
    python examples/torch_run_flocking.py --batch 4096 --steps 64
"""
import argparse
import sys
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="FlockingRelative-v0")
    p.add_argument("-n", "--steps", type=int, default=200)
    p.add_argument("--agents", type=int, default=100)
    p.add_argument("-r", "--render", action="store_true")
    p.add_argument("--batch", type=int, default=0, help="batched rollout mode")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"

    import torch

    if args.batch:
        from gym_flock_tpu_torch.compat.gym_api import make_on
        from gym_flock_tpu_torch.parallel import batch_rollout

        env, params = make_on(args.env, device, n_agents=args.agents)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        t0 = timeit.default_timer()
        _, traj = batch_rollout(env, params, gen, n_envs=args.batch, n_steps=args.steps,
                                policy="expert", keep_obs=False)
        mean_r = float(traj["reward"].mean())  # a fetch: the device has finished
        dt = timeit.default_timer() - t0
        n = args.batch * args.steps
        print(f"{args.env}: {n} env-steps in {dt:.2f}s ({n/dt:,.0f} steps/s), "
              f"mean reward {mean_r:.3f}")
        return

    from gym_flock_tpu_torch.compat import make_legacy

    env = make_legacy(args.env, device=device, n_agents=args.agents)
    env.seed(args.seed)
    env.reset()
    total = 0.0
    t0 = timeit.default_timer()
    for _ in range(args.steps):
        u = env.controller()
        _, reward, _, _ = env.step(u)
        total += reward
        if args.render:
            env.render()
    dt = timeit.default_timer() - t0
    print(f"{args.env}: {args.steps} steps, cumulative reward {total:.2f}, "
          f"{args.steps/dt:,.1f} steps/s (single stream)")
    env.close()


if __name__ == "__main__":
    main()
