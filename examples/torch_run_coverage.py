"""CLI episode driver on the PyTorch port: the reference's root test.py
(counterpart of ``examples/run_coverage.py``).

Same flags (reference test.py:7-15): -g/--greedy, -e/--expert (VRP),
-x/--explore, -r/--render, -f/--full, -n episodes; prints each episode's
reward, the mean and std, and the elapsed wall-clock (test.py:72-88).  The
env is ``make_legacy``'s, so the greedy loop runs on the lookahead queue.
Runs on the GPU unless ``--cpu`` is given.

Run from the repo root:  python examples/torch_run_coverage.py -g -n 5
"""
import argparse
import sys
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np


def main():
    parser = argparse.ArgumentParser(description="gym_flock_tpu_torch episode driver")
    parser.add_argument("-g", "--greedy", dest="greedy", action="store_true")
    parser.add_argument("-e", "--expert", dest="expert", action="store_true")
    parser.add_argument("-x", "--explore", dest="explore", action="store_true")
    parser.add_argument("-r", "--render", dest="render", action="store_true")
    parser.add_argument("-f", "--full", dest="full", action="store_true")
    parser.add_argument("-n", "--n", nargs="?", const=100, type=int, default=10)
    parser.add_argument("--cpu", action="store_true", help="run on the host")
    parser.add_argument(
        "--strict-expert", dest="strict_expert", action="store_true",
        help="the reference's expert-failure semantics: the VRP expert raises "
        "AssertionError on an infeasible solution (reference "
        "vrp_solver.py:144-146) and the driver restarts the episode "
        "(reference test.py:53-59)")
    args = parser.parse_args()

    from gym_flock_tpu_torch.compat import FlattenDictWrapper, make_legacy

    if args.full:
        env_name = "ExploreFullEnv-v0" if args.explore else "CoverageFull-v0"
    else:
        env_name = "ExploreEnv-v0" if args.explore else "CoverageARL-v0"

    env = make_legacy(env_name, device="cpu" if args.cpu else "cuda")
    env = FlattenDictWrapper(env, dict_keys=env.keys)

    start_time = timeit.default_timer()
    rewards = []
    for _ in range(args.n):
        env.reset()
        episode_reward = 0.0
        done = False
        while not done:
            if args.expert:
                if args.strict_expert:
                    try:
                        action = env.controller(random=False, greedy=False, strict=True)
                    except AssertionError:
                        # reference test.py:53-59: an infeasible expert
                        # solution restarts the episode
                        env.reset()
                        episode_reward = 0.0
                        continue
                else:
                    action = env.controller(random=False, greedy=False)
            elif args.greedy:
                action = env.controller(random=False, greedy=True)
            else:
                action = env.controller(random=True)
            _, reward, done, _ = env.step(action)
            episode_reward += reward
            if args.render:
                env.render()
        print(episode_reward)
        rewards.append(episode_reward)

    elapsed = timeit.default_timer() - start_time
    print("Expert" if args.expert else ("Greedy" if args.greedy else "Random"))
    print(env_name)
    print("Reward over {} episodes: mean = {:.1f}, std = {:.1f}".format(
        args.n, float(np.mean(rewards)), float(np.std(rewards))))
    print("Elapsed time: " + str(elapsed))
    env.close()


if __name__ == "__main__":
    main()
