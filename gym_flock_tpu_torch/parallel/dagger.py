"""DAGGER (dataset aggregation) imitation of the flocking expert
(counterpart of ``gym_flock_tpu/parallel/dagger.py``, with its
data-parallel iteration over ``torch.distributed``).

Roll out under a mixture of expert and learner actions, label every
visited state with the Turner expert, aggregate into a rolling buffer, and
train on the aggregate: the learner's own state distribution enters the
dataset, which plain behaviour cloning never sees.

The buffer stores raw states ``x [CAP, N, 4]`` and expert labels ``[CAP,
N, 2]``; the loss recomputes features and adjacency from ``x``.  The
resets run K1 once a draw (their acceptance test); the aggregation is the
dense ``AggregationGNN``, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import torch

from gym_flock_tpu_torch.envs.flocking import (
    FlockingRelativeEnv,
    _instant_cost,
    flocking_features,
    turner_controller,
)
from gym_flock_tpu_torch.models.gnn import AggregationGNN
from gym_flock_tpu_torch.parallel.distributed import local_shard_size, rank_generator
from gym_flock_tpu_torch.parallel.train import (
    LearningRate,
    _ImitationTrainer,
    all_reduce_mean,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["DaggerTrainer", "DaggerState", "make_sharded_iteration"]


@dataclasses.dataclass
class DaggerState:
    """The replay buffer and its cursor.  The JAX NamedTuple also carries
    the weights and the optimizer state; in the port they are the trainer's
    ``model`` and ``optimizer``, as in every port trainer.  ``write_pos``
    and ``filled`` are host ints (they do not depend on the data)."""

    buffer_x: torch.Tensor  # [CAP, N, 4]
    buffer_label: torch.Tensor  # [CAP, N, 2]
    write_pos: int = 0
    filled: int = 0


class DaggerTrainer(_ImitationTrainer):
    """DAGGER on ``FlockingRelative-v0`` with :class:`AggregationGNN` on the
    port's ``flocking_features`` (mean-pooled per ``params.mean_pooling``)
    and the Turner expert; Adam as the other trainers set it, at a float
    learning rate or a schedule ``step -> float``."""

    def __init__(self, env: FlockingRelativeEnv, env_params,
                 model: Optional[AggregationGNN] = None, learning_rate: LearningRate = 1e-3,
                 capacity: int = 4096, beta_decay: float = 0.7, device="cuda"):
        super().__init__(env, env_params, model or AggregationGNN(), learning_rate, device)
        self.capacity = capacity
        self.beta_decay = beta_decay
        self.state: Optional[DaggerState] = None

    def init(self, generator: torch.Generator) -> None:
        """flax's initialisation of the weights, a fresh Adam, an empty
        buffer."""
        super().init(generator)
        n, cap = self.env_params.n_agents, self.capacity
        self.state = DaggerState(torch.zeros(cap, n, 4, device=self.device),
                                 torch.zeros(cap, n, 2, device=self.device))

    def _policy_action(self, x: torch.Tensor) -> torch.Tensor:
        values, adj, adj_mean, _ = flocking_features(x, self.env_params.comm_radius2)
        return self.model(values, adj_mean if self.env_params.mean_pooling else adj)

    def _loss(self, xs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """MSE of the policy's actions at states ``xs`` to ``labels``."""
        return torch.mean((self._policy_action(xs) - labels) ** 2)

    def _batch_loss(self, batch) -> torch.Tensor:
        return self._loss(*batch)

    def collect(self, generator: torch.Generator, beta: float, n_envs: int, n_steps: int):
        """Mixture rollouts from ``n_envs`` fresh resets: each env step flips
        its own Bernoulli(beta) coin between the expert's and the learner's
        action.  Returns the visited states and the expert's labels, each
        ``[n_envs * n_steps, N, .]``."""
        env, p = self.env, self.env_params
        state, _ = env.reset_env(generator, p, n_envs)
        x = state.x
        xs, labels = [], []
        for _ in range(n_steps):
            expert_u = turner_controller(x, p)
            with torch.no_grad():
                learner_u = self._policy_action(x)
            use_expert = torch.rand(n_envs, generator=generator, device=generator.device) < beta
            u = torch.where(use_expert[:, None, None], expert_u, learner_u)
            xs.append(x)
            labels.append(expert_u)
            x = env._rollout_integrate(x, u, p, generator)
        return (torch.stack(xs, dim=1).flatten(0, 1), torch.stack(labels, dim=1).flatten(0, 1))

    def iteration(self, generator: torch.Generator, beta: float, n_envs: int = 8,
                  n_steps: int = 16, n_grad_steps: int = 4) -> torch.Tensor:
        """Collect under the beta-mixture, aggregate, train on minibatches of
        ``min(256, capacity)`` from the filled part; returns the mean loss."""
        s, cap = self.state, self.capacity
        n_new = n_envs * n_steps
        # one write with repeated slots would pair one sample's state with
        # another's label
        if n_new > cap:
            raise ValueError(f"n_envs*n_steps={n_new} exceeds buffer capacity={cap}; "
                             f"raise capacity or collect less per iteration")
        xs, labels = self.collect(generator, beta, n_envs, n_steps)
        idx = (s.write_pos + torch.arange(n_new, device=self.device)) % cap
        s.buffer_x[idx] = xs
        s.buffer_label[idx] = labels
        s.write_pos = (s.write_pos + n_new) % cap
        s.filled = min(s.filled + n_new, cap)
        losses = []
        for _ in range(n_grad_steps):
            bi = torch.randint(0, s.filled, (min(256, cap),), generator=generator,
                               device=generator.device)
            losses.append(self.update((s.buffer_x[bi], s.buffer_label[bi])))
        return torch.stack(losses).mean()

    def fit(self, generator: torch.Generator, n_iters: int = 10,
            ckpt_path: Optional[str] = None, ckpt_every: int = 0, resume: bool = True,
            **kwargs) -> List[float]:
        """``beta_k = beta_decay**k`` (beta_0 = 1: the expert alone), from
        :meth:`init`; returns the mean loss of each iteration this call ran.

        ``ckpt_path`` / ``ckpt_every`` / ``resume`` save and restore the
        whole state (weights, optimizer, buffer, cursor, iteration and
        generator), so a resumed run replays the schedule and the draws of
        the run that never stopped.
        """
        self.init(generator)
        start = 0
        if ckpt_path and resume and os.path.exists(ckpt_path):
            extra = {}
            self.step = restore_checkpoint(ckpt_path, self.model, self.optimizer, generator,
                                           extra)
            start = int(extra["iteration"])
            self.state = DaggerState(extra["buffer_x"].to(self.device),
                                     extra["buffer_label"].to(self.device),
                                     int(extra["write_pos"]), int(extra["filled"]))
        losses = []
        for k in range(start, n_iters):
            losses.append(float(self.iteration(generator, self.beta_decay ** k, **kwargs)))
            if ckpt_path and (k + 1 == n_iters or (ckpt_every and (k + 1) % ckpt_every == 0)):
                save_checkpoint(ckpt_path, self.model, self.optimizer, self.step, generator,
                                extra={**dataclasses.asdict(self.state), "iteration": k + 1})
        return losses

    @torch.no_grad()
    def evaluate(self, generator: torch.Generator, n_envs: int = 8, n_steps: int = 50) -> float:
        """Mean reward of the learner in closed loop (no expert)."""
        env, p = self.env, self.env_params
        state, _ = env.reset_env(generator, p, n_envs)
        x = state.x
        total = torch.zeros((), device=x.device)
        for _ in range(n_steps):
            x = env._rollout_integrate(x, self._policy_action(x), p, generator)
            total += _instant_cost(x).mean()
        return float(total / n_steps)


def make_sharded_iteration(trainer: DaggerTrainer, group=None, n_envs: int = 16,
                           n_steps: int = 16, n_grad_steps: int = 4):
    """The data-parallel DAGGER iteration over the ranks of ``group``.

    Each rank holds its own buffer of ``capacity / world`` samples and
    collects ``n_envs / world`` envs; it runs one local
    :meth:`DaggerTrainer.iteration` (``n_grad_steps`` Adam steps on its own
    minibatches), then the weights and Adam's moment estimates are averaged
    over the group, so that every rank leaves the iteration with the same
    model.  Adam's ``step`` counts are equal on every rank and are left
    alone, as JAX leaves its integer leaves.

    Returns ``(step, init)``: ``init(generator)`` gives this rank the
    weights drawn from ``generator`` (the same on every rank), a fresh Adam
    and an empty local buffer; ``step(generator, beta) -> loss`` runs one
    iteration and returns the loss averaged over the group.  ``trainer``'s
    ``model`` and ``optimizer`` are the ones trained, at ``trainer``'s
    learning rate or schedule (read at the count of local updates, equal on
    every rank).
    """
    local_envs = local_shard_size(n_envs, group)
    local = DaggerTrainer(trainer.env, trainer.env_params, trainer.model,
                          learning_rate=trainer.learning_rate,
                          capacity=local_shard_size(trainer.capacity, group),
                          beta_decay=trainer.beta_decay, device=trainer.device)

    def init(generator: torch.Generator) -> None:
        local.init(generator)
        trainer.optimizer, trainer.state, trainer.step = local.optimizer, local.state, 0

    def step(generator: torch.Generator, beta: float) -> torch.Tensor:
        loss = local.iteration(rank_generator(generator, group), beta, n_envs=local_envs,
                               n_steps=n_steps, n_grad_steps=n_grad_steps)
        floats = [p.data for p in local.model.parameters()]
        for state in local.optimizer.state.values():
            floats += [v for k, v in state.items() if k != "step"]
        all_reduce_mean(floats, group)
        loss = loss.detach().clone()
        all_reduce_mean([loss], group)
        trainer.step = local.step
        return loss

    return step, init
