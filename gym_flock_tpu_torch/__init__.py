"""gym_flock_tpu_torch: the PyTorch/CUDA port of ``gym_flock_tpu``.

Batched swarm environments on one NVIDIA GPU, and imitation training of
GNN policies on them: every tensor leads with the batch of envs, randomness
comes from explicit ``torch.Generator``s, and the hot passes (flocking
pairwise sums, their cell-list form, the greedy coverage expert, the GNN's
dense and cell-list aggregation) run on CUDA kernels written for Hopper
(``csrc/*.cu``, built with ``nvcc`` at first use).  On CPU tensors the same
functions run their plain PyTorch versions.

    import torch
    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.parallel import LargeFlockingImitationTrainer, batch_expert_rollout

    env, params = gft.make("FlockingRelative-v0")
    gen = torch.Generator(device="cuda").manual_seed(0)
    final, traj = batch_expert_rollout(env, params, gen, n_envs=1024, n_steps=8)

    env, params = gft.make("FlockingLarge-v0")
    trainer = LargeFlockingImitationTrainer(env, params, device="cuda")
    losses = trainer.fit(gen, n_iters=10, n_envs=4, n_steps=4)
"""
from gym_flock_tpu_torch.core.registry import make, register, registry
from gym_flock_tpu_torch import _register_all  # noqa: F401  (populates registry)

__version__ = "1.0.0"  # the distribution's version (pyproject.toml)

__all__ = ["make", "register", "registry", "__version__"]
