"""Train an EdgeGraphNet coverage policy on the PyTorch port, BC or
DAGGER (counterpart of ``examples/train_coverage_gnn.py``).

The workload of the reference's companion learning repo (reference
README.md:29-30 points coverage learning at katetolstaya/graph_rl):
greedy-expert (or beta-mixture) rollouts on the GPU (K5,
``csrc/rowmin.cu``), padded observation graphs, action-edge
cross-entropy.  ``--cpu`` runs on the host.

    python examples/torch_train_coverage_gnn.py --iters 20
    python examples/torch_train_coverage_gnn.py --dagger --iters 10
    python examples/torch_train_coverage_gnn.py --vrp-labels --workers 4

``--vrp-labels`` labels the states the greedy rollout visits with the VRP
expert, solved on a pool of host threads.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="Coverage-v0")
    p.add_argument("--graphs", type=int, default=4)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--envs", type=int, default=8)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--dagger", action="store_true",
                   help="DAGGER beta-mixture aggregation instead of plain BC")
    p.add_argument("--vrp-labels", action="store_true",
                   help="label rollout states with the host-parallel VRP expert "
                        "instead of the greedy expert")
    p.add_argument("--workers", type=int, default=4,
                   help="CPU labeling threads for --vrp-labels")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"

    import torch

    from gym_flock_tpu_torch.compat.gym_api import make_on

    env, params = make_on(args.env, device, n_graphs=args.graphs)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    if args.vrp_labels:
        from gym_flock_tpu_torch.parallel import (
            CoverageImitationTrainer,
            collect_vrp_labeled_batch,
        )

        trainer = CoverageImitationTrainer(env, params, learning_rate=args.lr, device=device)
        trainer.init(gen)
        losses = []
        for _ in range(args.iters):
            batch = collect_vrp_labeled_batch(env, params, gen, n_envs=args.envs,
                                              n_steps=args.steps, workers=args.workers)
            losses.append(float(trainer.update_from_batch(batch)))
        print("VRP-label BC losses:", [round(v, 4) for v in losses])
    elif args.dagger:
        from gym_flock_tpu_torch.parallel import CoverageDaggerTrainer

        trainer = CoverageDaggerTrainer(env, params, learning_rate=args.lr, device=device)
        losses = trainer.fit(gen, n_iters=args.iters, n_envs=args.envs, n_steps=args.steps)
        print("DAGGER losses:", [round(v, 4) for v in losses])
    else:
        from gym_flock_tpu_torch.parallel import CoverageImitationTrainer

        trainer = CoverageImitationTrainer(env, params, learning_rate=args.lr, device=device)
        losses = trainer.fit(gen, n_iters=args.iters, n_envs=args.envs, n_steps=args.steps)
        print("BC losses:", [round(float(v), 4) for v in losses])


if __name__ == "__main__":
    main()
