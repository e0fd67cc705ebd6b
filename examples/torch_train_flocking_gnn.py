"""Train a flocking GNN by imitation on the PyTorch port (counterpart of
``examples/train_flocking_gnn.py``).

The reference generates expert data for an external learner repo
(README.md:28); here collection and training run together on the GPU
(``--cpu`` runs them on the host).

    python examples/torch_train_flocking_gnn.py --iters 30            # BC
    python examples/torch_train_flocking_gnn.py --dagger              # DAGGER
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--agents", type=int, default=50)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--envs", type=int, default=8)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--dagger", action="store_true")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"

    import torch

    from gym_flock_tpu_torch.compat.gym_api import make_on
    from gym_flock_tpu_torch.parallel import save_checkpoint

    env, params = make_on("FlockingRelative-v0", device, n_agents=args.agents)
    gen = torch.Generator(device=device).manual_seed(0)
    if args.dagger:
        from gym_flock_tpu_torch.parallel import DaggerTrainer

        tr = DaggerTrainer(env, params, device=device)
        losses = tr.fit(gen, n_iters=args.iters, n_envs=args.envs, n_steps=args.steps)
        print(f"DAGGER: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
        r = tr.evaluate(torch.Generator(device=device).manual_seed(1))
        print(f"closed-loop mean reward: {r:.2f}")
    else:
        from gym_flock_tpu_torch.parallel import FlockingImitationTrainer

        tr = FlockingImitationTrainer(env, params, device=device)
        losses = tr.fit(gen, n_iters=args.iters, n_envs=args.envs, n_steps=args.steps)
        print(f"BC: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    if args.checkpoint:
        save_checkpoint(args.checkpoint, tr.model, tr.optimizer, len(losses), gen)
        print(f"saved {args.checkpoint}")


if __name__ == "__main__":
    main()
