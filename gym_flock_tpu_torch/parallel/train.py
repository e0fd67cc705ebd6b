"""Imitation training of the flocking GNN policies (counterpart of
``gym_flock_tpu/parallel/train.py``: the flocking trainers, their
data-parallel and agent-sharded train steps over ``torch.distributed``, and
the checkpoints).

A train step collects a fresh batch of expert data, then takes one update:
the MSE of the policy's actions to the Turner expert's, its gradients, and
one step of Adam as optax's ``adam`` takes it (``eps`` outside the
bias-corrected square root, which ``torch.optim.Adam`` shares).

Randomness comes from one explicit ``torch.Generator``, on the device the
env and the model run on: the weights' initialisation, then the resets of
every collected batch.  A checkpoint keeps the model's and the optimizer's
state, the step and the generator's state, so that a run resumed from it
takes the same draws as the run that never stopped.  The format is the
port's own (``torch.save``); it does not read the JAX package's flax
msgpack checkpoints.
"""
from __future__ import annotations

import copy
import functools
import os
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from gym_flock_tpu_torch.models.gnn import AggregationGNN, LargeAggregationGNN
from gym_flock_tpu_torch.parallel.distributed import local_shard_size, rank_generator
from gym_flock_tpu_torch.parallel.rollout import rollout

__all__ = [
    "FlockingImitationTrainer",
    "LargeFlockingImitationTrainer",
    "collect_flocking_batch",
    "collect_large_flocking_batch",
    "save_checkpoint",
    "restore_checkpoint",
    "make_dp_train_step",
    "all_reduce_mean",
]


def _flat(v: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + v.shape[2:])


def collect_flocking_batch(env, params, generator: torch.Generator, n_envs: int, n_steps: int):
    """Expert rollouts of ``n_envs`` fresh envs keeping ``(features,
    adjacency, expert action)``, each ``[n_envs * n_steps, ...]``: a flat
    supervised dataset (the adjacency is the env's ``network``, mean-pooled
    by default)."""
    _, traj = rollout(env, params, generator, n_steps, policy="expert", keep_obs=True,
                      n_envs=n_envs)
    feats, adj = traj["obs"]
    return _flat(feats), _flat(adj), _flat(traj["action"])


def collect_large_flocking_batch(env, params, generator: torch.Generator, n_envs: int,
                                 n_steps: int, init_state=None):
    """Expert rollouts on ``FlockingLarge-v0`` or ``FlockingSparse-v0``
    keeping ``(x, features, expert action)``, each ``[n_envs * n_steps,
    ...]``; no adjacency exists, the large GNN rebuilds the neighbourhoods
    from ``x``.

    Starts from ``n_envs`` fresh resets, or from ``init_state`` when given.
    One fused pass a step (K1, or K3 with its Verlet table) gives both the
    observation's values and the expert's sums, so no second pairwise pass
    runs.
    """
    if init_state is None:
        init_state, _ = env.reset_env(generator, params, n_envs)
    x = init_state.x
    carry = env._fused_carry_init(x, params)
    xs, feats, acts = [], [], []
    for _ in range(n_steps):
        (values, _, s_gx, s_gy, s_dvx, s_dvy), carry = env._fused_pass_carry(
            x, params, params.centralized, carry)
        u = env._rollout_action(torch.stack((-s_gx - s_dvx, -s_dvy - s_gy), dim=-1), params)
        xs.append(x)
        feats.append(values)
        acts.append(u)
        x = env._rollout_integrate(x, u, params, generator)
    return tuple(_flat(torch.stack(v, dim=1)) for v in (xs, feats, acts))


def save_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    step: int = 0, generator: Optional[torch.Generator] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the model's and the optimizer's ``state_dict``, ``step``, the
    generator's state and ``extra`` (tensors and ints, e.g. a replay buffer
    and its cursor) to ``path``: to a temporary file first, then
    ``os.replace``, so that a crash mid-write never leaves a torn file."""
    blob = {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "step": int(step),
        "generator": None if generator is None else generator.get_state(),
        "extra": dict(extra or {}),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       generator: Optional[torch.Generator] = None,
                       extra: Optional[Dict[str, Any]] = None) -> int:
    """Load a :func:`save_checkpoint` file into ``model``, ``optimizer``,
    (when both have one) ``generator`` and (when given) the dict ``extra``,
    in place; returns the step.  ``extra``'s tensors come back on the CPU."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(blob["model"])
    optimizer.load_state_dict(blob["optimizer"])
    if generator is not None and blob["generator"] is not None:
        generator.set_state(blob["generator"])
    if extra is not None:
        extra.update(blob.get("extra", {}))
    return blob["step"]


def all_reduce_mean(tensors, group=None) -> None:
    """Replace each tensor by its mean over the ranks of ``group``, in place,
    with one all-reduce of their concatenation."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def make_dp_train_step(trainer, local_loss_fn: Callable[[torch.Generator], torch.Tensor],
                       group=None) -> Callable[[torch.Generator], torch.Tensor]:
    """The data-parallel train step of ``trainer`` (anything with ``model``,
    ``optimizer`` and ``step``) over the ranks of ``group``.

    ``step(generator)`` calls ``local_loss_fn(rank_generator)``, this rank's
    loss on its own collect, backpropagates it, averages the gradients and
    the loss over the group (one all-reduce each) and takes one optimizer
    step, the same on every rank.  Returns the averaged loss.  Shared by the
    flocking and coverage trainers.
    """

    def step(generator: torch.Generator) -> torch.Tensor:
        local = rank_generator(generator, group)
        trainer.optimizer.zero_grad(set_to_none=True)
        return _averaged_update(trainer, local_loss_fn(local), group)

    return step


def _averaged_update(trainer, loss: torch.Tensor, group) -> torch.Tensor:
    """Backpropagate this rank's ``loss``, average the gradients and the loss
    over ``group`` and take the optimizer step; returns the averaged loss."""
    loss.backward()
    all_reduce_mean([p.grad for p in trainer.model.parameters() if p.grad is not None], group)
    loss = loss.detach().clone()
    all_reduce_mean([loss], group)
    trainer.optimizer.step()
    trainer.step += 1
    return loss


class _ImitationTrainer:
    """Adam on the MSE to the expert; subclasses say how a batch is collected
    and how the model reads it."""

    def __init__(self, env, env_params, model: torch.nn.Module, learning_rate: float, device):
        self.env = env
        self.env_params = env_params
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.learning_rate = learning_rate
        self.optimizer = self._adam()
        self.step = 0

    def _adam(self) -> torch.optim.Adam:
        return torch.optim.Adam(self.model.parameters(), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)

    def init(self, generator: torch.Generator) -> None:
        """flax's initialisation of the weights from ``generator``, a fresh
        Adam state and step 0."""
        self.model.reset_parameters(generator)
        self.optimizer = self._adam()
        self.step = 0

    def loss_fn(self, *batch) -> torch.Tensor:
        """MSE to the expert's actions, the mean over every element."""
        *inputs, actions = batch
        return torch.mean((self.model(*inputs) - actions) ** 2)

    def _batch_loss(self, batch) -> torch.Tensor:
        return self.loss_fn(*batch)

    def update(self, batch) -> torch.Tensor:
        """One Adam step on ``batch``; returns the loss before the step."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._batch_loss(batch)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def collect(self, generator: torch.Generator, n_envs: int, n_steps: int):
        raise NotImplementedError

    def train_step(self, generator: torch.Generator, n_envs: int, n_steps: int) -> torch.Tensor:
        """Collect a fresh expert batch from ``generator``, then :meth:`update`."""
        return self.update(self.collect(generator, n_envs, n_steps))

    def fit(self, generator: torch.Generator, n_iters: int, n_envs: int, n_steps: int,
            ckpt_path: Optional[str] = None, ckpt_every: int = 0,
            resume: bool = True) -> List[float]:
        """Train from :meth:`init` for ``n_iters`` steps; returns the losses of
        the steps this call took.

        With ``ckpt_path`` the state is saved every ``ckpt_every`` steps and
        at the end; when ``resume`` and the file exists, the run continues
        from the saved step with the saved generator state, so interrupt and
        resume reproduce the run that never stopped.
        """
        return self._fit(generator, n_iters, n_envs, n_steps, ckpt_path, ckpt_every, resume)

    def _fit(self, generator, n_iters, n_envs, n_steps, ckpt_path, ckpt_every, resume,
             after_step: Optional[Callable[[int], None]] = None) -> List[float]:
        """:meth:`fit`'s loop; ``after_step(step)`` runs after each step's
        checkpoint."""
        self.init(generator)
        if ckpt_path and resume and os.path.exists(ckpt_path):
            self.step = restore_checkpoint(ckpt_path, self.model, self.optimizer, generator)
        losses = []
        for i in range(self.step, n_iters):
            losses.append(float(self.train_step(generator, n_envs, n_steps)))
            done = i + 1 == n_iters
            if ckpt_path and (done or (ckpt_every and (i + 1) % ckpt_every == 0)):
                save_checkpoint(ckpt_path, self.model, self.optimizer, self.step, generator)
            if after_step is not None:
                after_step(i + 1)
        return losses


class FlockingImitationTrainer(_ImitationTrainer):
    """Behaviour cloning of the Turner expert on ``FlockingRelative-v0`` with
    :class:`AggregationGNN` over ``(features, adjacency)`` batches."""

    def __init__(self, env, env_params, model: Optional[AggregationGNN] = None,
                 learning_rate: float = 1e-3, device="cuda"):
        super().__init__(env, env_params, model or AggregationGNN(), learning_rate, device)

    def collect(self, generator, n_envs, n_steps):
        return collect_flocking_batch(self.env, self.env_params, generator, n_envs, n_steps)

    def make_sharded_train_step(self, group=None, n_envs: int = 16, n_steps: int = 8):
        """The data-parallel train step over ``group``: each rank collects
        ``n_envs / world`` envs of ``n_steps`` steps; ``step(generator) ->
        loss`` (:func:`make_dp_train_step`)."""
        local_envs = local_shard_size(n_envs, group)

        def local_loss(generator):
            return self._batch_loss(self.collect(generator, local_envs, n_steps))

        return make_dp_train_step(self, local_loss, group)


class LargeFlockingImitationTrainer(_ImitationTrainer):
    """Behaviour cloning at swarm sizes where no dense adjacency fits:
    :class:`LargeAggregationGNN` over ``(x, features)`` batches, its
    aggregation on K2 (or K4 through ``aggregate_fn``)."""

    def __init__(self, env, env_params, model: Optional[LargeAggregationGNN] = None,
                 learning_rate: float = 1e-3, device="cuda"):
        model = model or LargeAggregationGNN(comm_radius2=float(env_params.comm_radius2))
        super().__init__(env, env_params, model, learning_rate, device)

    def collect(self, generator, n_envs, n_steps):
        return collect_large_flocking_batch(self.env, self.env_params, generator, n_envs,
                                            n_steps)

    def make_agent_sharded_train_step(self, group=None, mode: str = "ring"):
        """The train step with the AGENT axis split over ``group``, for
        swarms past one card.

        ``step((xs, feats, acts)) -> loss`` takes the whole ``[B, N, ...]``
        batch on every rank and keeps this rank's block of ``N / world``
        agents.  The model (the trainer's own weights) aggregates through
        ``parallel.agent_shard.khop_aggregate_sharded`` in ``mode``; the
        loss is this rank's mean (equal blocks, so the mean of the ranks'
        means is the whole batch's), and the gradients and the loss are
        averaged over the group before the Adam step.
        """
        from gym_flock_tpu_torch.parallel.agent_shard import khop_aggregate_sharded

        model = self.model
        sharded = copy.copy(model)  # the same parameter tensors, its own aggregate_fn
        sharded.aggregate_fn = functools.partial(
            khop_aggregate_sharded, comm_radius2=float(self.env_params.comm_radius2),
            k_hops=model.k_hops, group=group, mode=mode)
        rank = dist.get_rank(group)

        def step(batch) -> torch.Tensor:
            m = local_shard_size(batch[0].shape[1], group)
            xs, feats, acts = (b[:, rank * m:(rank + 1) * m] for b in batch)
            self.optimizer.zero_grad(set_to_none=True)
            return _averaged_update(self, torch.mean((sharded(xs, feats) - acts) ** 2), group)

        return step
