"""Shepherding demo driver on the PyTorch port: the reference's
shepherding/test.py:1-38 (counterpart of ``examples/run_shepherding.py``).

The reference loop: reset, drive the line-of-sight expert until done,
render each step, print the episode reward.  ``--batch`` rolls many
episodes at once.  Runs on the GPU unless ``--cpu`` is given.

    python examples/torch_run_shepherding.py --cpu -N 3 --render
    python examples/torch_run_shepherding.py --batch 1024 --steps 100
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-N", "--episodes", type=int, default=10)
    p.add_argument("--steps", type=int, default=200, help="per-episode cap")
    p.add_argument("-r", "--render", action="store_true")
    p.add_argument("--batch", type=int, default=0, help="batched rollout mode")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"

    import torch

    from gym_flock_tpu_torch.compat.gym_api import fetch, first, make_on

    env, params = make_on("Shepherding-v0", device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    if args.batch:
        from gym_flock_tpu_torch.parallel import batch_rollout

        _, traj = batch_rollout(env, params, gen, n_envs=args.batch, n_steps=args.steps,
                                policy="expert", keep_obs=False)
        rewards = traj["reward"].sum(dim=-1)
        print(f"{args.batch} episodes x {args.steps} steps: "
              f"mean reward {float(rewards.mean()):.2f} +- {float(rewards.std(correction=0)):.2f}")
        return

    renderer = None
    if args.render:
        from gym_flock_tpu_torch.render.plot import get_renderer

        renderer = get_renderer("Shepherding-v0", env, params)
    for _ in range(args.episodes):
        state, _ = env.reset(gen, params)
        episode_reward = 0.0
        for _ in range(args.steps):
            u = env.expert(state, params, gen)
            state, _, reward, done, _ = env.step(gen, state, u, params)
            episode_reward += float(reward[0])
            if renderer is not None:
                renderer.draw(first(fetch(state)))
            if bool(done[0]):
                break
        print(episode_reward)
    if renderer is not None:
        renderer.close()


if __name__ == "__main__":
    main()
