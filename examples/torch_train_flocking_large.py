"""Train a GNN policy on a LARGE swarm on the PyTorch port, with no dense
adjacency anywhere (counterpart of ``examples/train_flocking_large.py``).

``models.LargeAggregationGNN`` learns by imitation on ``FlockingLarge-v0``:
the env's features and the Turner expert run on K1 (``csrc/block_sums.cu``)
and the GNN's K-hop aggregation, forward and backward, on K2
(``csrc/adj_matmul.cu``), in O(N) memory.  Runs on the GPU unless
``--cpu`` is given (then on the kernels' plain versions).

    python examples/torch_train_flocking_large.py --agents 2048
    python examples/torch_train_flocking_large.py --cpu --agents 64     # smoke
    python examples/torch_train_flocking_large.py --agents 64 --shard-agents

``--shard-agents`` splits the agent axis over the ranks of a process group
(``parallel.agent_shard``): under ``torchrun`` one rank a card, from the
environment's rendezvous; alone, a group of one.
"""
import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--agents", type=int, default=2048)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--envs", type=int, default=4)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--shard-agents", action="store_true",
                   help="split the agent axis over the ranks of a process group")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"

    import torch
    import torch.distributed as dist

    from gym_flock_tpu_torch.compat.gym_api import make_on
    from gym_flock_tpu_torch.parallel import LargeFlockingImitationTrainer, save_checkpoint
    from gym_flock_tpu_torch.parallel import distributed as tdist
    from gym_flock_tpu_torch.parallel.train import collect_large_flocking_batch

    env, params = make_on("FlockingLarge-v0", device, n_agents=args.agents)
    trainer = LargeFlockingImitationTrainer(env, params, device=device)
    trainer.init(torch.Generator(device=device).manual_seed(1))
    gen = torch.Generator(device=device).manual_seed(0)
    with tempfile.TemporaryDirectory() as store:
        if args.shard_agents:
            backend = "gloo" if args.cpu else "nccl"
            if "WORLD_SIZE" in os.environ:
                tdist.initialize(backend)
            else:
                tdist.initialize(backend, f"file://{store}/rendezvous", 1, 0)
            if args.agents % dist.get_world_size():
                raise SystemExit(f"--agents {args.agents} does not split over "
                                 f"{dist.get_world_size()} ranks")
            step = trainer.make_agent_sharded_train_step()
            print(f"agent axis sharded over {dist.get_world_size()} ranks")
        try:
            for i in range(args.iters):
                t0 = time.perf_counter()
                if args.shard_agents:
                    batch = collect_large_flocking_batch(env, params, gen, args.envs, args.steps)
                    loss = float(step(batch))
                else:
                    loss = float(trainer.train_step(gen, args.envs, args.steps))
                print(f"iter {i:3d}  loss {loss:.4f}  "
                      f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()

    if args.checkpoint:
        save_checkpoint(args.checkpoint, trainer.model, trainer.optimizer, args.iters, gen)
        print(f"saved {args.checkpoint}")


if __name__ == "__main__":
    main()
