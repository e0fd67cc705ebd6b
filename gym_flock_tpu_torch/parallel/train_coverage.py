"""Imitation training of the coverage policy (counterpart of
``gym_flock_tpu/parallel/train_coverage.py``, with its data-parallel train
step over ``torch.distributed``).

    greedy-expert rollouts (K5 once a step) -> (padded obs graphs, labels)
    -> EdgeGraphNet message passing -> per-robot action logits
    -> cross-entropy to the expert's action -> one Adam step

A robot's action logits come straight from the observation's edges: the
buffer tail's first ``R*A`` entries are robot i's A motion candidates in
action order (node->robot edges), so a policy that scores edges gives the
``[R, A]`` action distribution by a slice.

Batches are dicts of ``nodes``, ``edges``, ``senders``, ``receivers`` and
``label`` (int32 ``[., R]``), flattened to ``[n_envs * n_steps, ...]`` env
by env, the JAX package's layout; the observation's ``step`` is left out.
Randomness comes from one ``torch.Generator`` on the bank's device.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from gym_flock_tpu_torch.envs.coverage import CoverageEnv, CoverageParams
from gym_flock_tpu_torch.models.gnn import EdgeGraphNet
from gym_flock_tpu_torch.parallel.distributed import local_shard_size
from gym_flock_tpu_torch.parallel.train import _flat, _ImitationTrainer, make_dp_train_step

__all__ = [
    "CoverageImitationTrainer",
    "CoverageDaggerTrainer",
    "collect_coverage_batch",
    "action_edge_logits",
    "make_sharded_train_step",
]

SAMPLE_KEYS = ("nodes", "edges", "senders", "receivers")
STATE_KEYS = ("graph", "robot_loc", "visited", "discovered", "time")
_EVAL_CHUNK = 512  # graphs a forward pass in evaluate()


def action_edge_logits(edge_logits: torch.Tensor, params: CoverageParams) -> torch.Tensor:
    """Per-robot action logits ``[..., R, A]`` from per-edge logits
    ``[..., E, 1]``: robot i's candidates sit at tail offset ``E - n_tail +
    i*A + a`` (the node->robot half of the action edges)."""
    r, a = params.n_robots, params.n_actions
    start = params.max_edges - (params.n_action_edges + params.n_comm_edges)
    return edge_logits[..., start:start + r * a, 0].reshape(*edge_logits.shape[:-2], r, a)


def greedy_rollout(env: CoverageEnv, params: CoverageParams, generator: torch.Generator,
                   n_envs: int, n_steps: int, keep_state: bool = False):
    """``n_envs`` fresh resets, then ``n_steps`` rounds of the greedy expert
    (K5) and ``step_env``.  Returns the batch dict (module docstring) and,
    with ``keep_state``, the pre-step state fields ``STATE_KEYS`` too."""
    state, obs = env.reset_env(generator, params, n_envs)
    steps = []
    for _ in range(n_steps):
        u = env.controller(state, params, generator=generator)
        sample = {k: obs[k] for k in SAMPLE_KEYS}
        sample["label"] = u.reshape(n_envs, -1)
        if keep_state:
            sample.update({k: getattr(state, k) for k in STATE_KEYS})
        steps.append(sample)
        state, obs, _, _, _ = env.step_env(generator, state, u, params)
    return _stack_steps(steps)


def _stack_steps(steps):
    """Per-step dicts of ``[n_envs, ...]`` -> one dict of ``[n_envs * n_steps,
    ...]``, env by env."""
    return {k: _flat(torch.stack([s[k] for s in steps], dim=1)) for k in steps[0]}


def collect_coverage_batch(env: CoverageEnv, params: CoverageParams,
                           generator: torch.Generator, n_envs: int, n_steps: int):
    """Greedy-expert rollouts keeping (obs graph, expert action) pairs, each
    ``[n_envs * n_steps, ...]``."""
    return greedy_rollout(env, params, generator, n_envs, n_steps)


def _graph(sample):
    """The model's input: padded ids 0, the mask from the senders alone (an
    edge hidden by ``hide_nodes`` keeps a real receiver)."""
    mask = sample["senders"] != -1
    return {
        "nodes": sample["nodes"],
        "edges": sample["edges"],
        "senders": torch.where(mask, sample["senders"], 0),
        "receivers": torch.where(mask, sample["receivers"], 0),
        "edge_mask": mask,
    }


class CoverageImitationTrainer(_ImitationTrainer):
    """Behaviour cloning of the greedy coverage expert into an
    :class:`EdgeGraphNet` (default ``latent=32, rounds=2``, as the JAX
    package's)."""

    def __init__(self, env: CoverageEnv, env_params: CoverageParams,
                 model: Optional[EdgeGraphNet] = None, learning_rate: float = 1e-3,
                 device="cuda"):
        model = model or EdgeGraphNet(latent=32, rounds=2, n_node_feat=env_params.n_node_feat,
                                      n_edge_feat=env_params.n_edge_feat)
        super().__init__(env, env_params, model, learning_rate, device)

    def logits(self, sample, params: Optional[CoverageParams] = None) -> torch.Tensor:
        """``[B, R, A]`` action logits of the model on a batch of obs graphs."""
        _, edge_logits = self.model(_graph(sample))
        return action_edge_logits(edge_logits, params or self.env_params)

    def loss_fn(self, batch) -> torch.Tensor:
        """The mean over robots of the cross-entropy to the integer labels,
        then the mean over the batch."""
        logits = self.logits(batch)
        ce = F.cross_entropy(logits.flatten(0, 1), batch["label"].long().flatten(),
                             reduction="none")
        return ce.reshape(logits.shape[:2]).mean(dim=1).mean()

    def _batch_loss(self, batch) -> torch.Tensor:
        return self.loss_fn(batch)

    @torch.no_grad()
    def accuracy(self, batch, params: Optional[CoverageParams] = None) -> torch.Tensor:
        """The share of robot actions whose argmax logit is the label."""
        n = batch["label"].shape[0]
        hits = sum(
            (self.logits({k: v[i:i + _EVAL_CHUNK] for k, v in batch.items()}, params)
             .argmax(dim=-1) == batch["label"][i:i + _EVAL_CHUNK]).sum()
            for i in range(0, n, _EVAL_CHUNK))
        return hits / batch["label"].numel()

    def collect(self, generator, n_envs, n_steps):
        return collect_coverage_batch(self.env, self.env_params, generator, n_envs, n_steps)

    def update_from_batch(self, batch) -> torch.Tensor:
        """One Adam step on an externally collected batch, e.g. the VRP
        labels of ``parallel.vrp_labels`` (the same dict layout)."""
        return self.update(batch)

    def fit(self, generator: torch.Generator, n_iters: int = 20, n_envs: int = 4,
            n_steps: int = 8, eval_params: Optional[CoverageParams] = None,
            eval_every: int = 0, ckpt_path: Optional[str] = None, ckpt_every: int = 0,
            resume: bool = True):
        """Train as ``FlockingImitationTrainer.fit`` does (checkpoints and
        resume included); with ``eval_params`` and ``eval_every``, also
        :meth:`evaluate` on that (held-out) bank every ``eval_every`` steps
        and return ``(losses, evals)``.

        An evaluation after step s draws from its own generator, seeded with
        s, so evaluating leaves the training stream, and a resume, as they
        would be without it (the JAX package splits its training key).
        """
        if not (eval_every and eval_params is not None):
            return self._fit(generator, n_iters, n_envs, n_steps, ckpt_path, ckpt_every, resume)
        evals: List[dict] = []

        def after_step(step: int) -> None:
            if step % eval_every == 0:
                gen = torch.Generator(device=eval_params.device).manual_seed(step)
                evals.append({"iter": step, **self.evaluate(gen, eval_params)})

        losses = self._fit(generator, n_iters, n_envs, n_steps, ckpt_path, ckpt_every, resume,
                           after_step=after_step)
        return losses, evals

    @torch.no_grad()
    def episode_reward(self, state, obs, params: CoverageParams, n_steps: int,
                       expert_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[B]`` summed reward of ``n_steps`` from ``(state, obs)``: the
        model's argmax actions, or the greedy expert's when
        ``expert_generator`` is given (its random draws)."""
        total = torch.zeros(state.graph.shape[0], device=state.graph.device)
        for _ in range(n_steps):
            if expert_generator is None:
                action = self.logits(obs, params).argmax(dim=-1).to(torch.int32)
            else:
                action = self.env.controller(state, params, generator=expert_generator)
            state, obs, reward, _, _ = self.env.step_env(None, state, action, params)
            total += reward
        return total

    @torch.no_grad()
    def evaluate(self, generator: torch.Generator, env_params: Optional[CoverageParams] = None,
                 n_envs: int = 4, n_steps: int = 8) -> dict:
        """Generalisation report on a (held-out) bank: accuracy on the
        expert's labels of a fresh batch, and the mean episode reward of the
        model's argmax policy and of the greedy expert from the same resets,
        with their ratio."""
        p = env_params or self.env_params
        acc = self.accuracy(collect_coverage_batch(self.env, p, generator, n_envs, n_steps), p)
        state, obs = self.env.reset_env(generator, p, n_envs)
        pol = float(self.episode_reward(state, obs, p, n_steps).mean())
        exp = float(self.episode_reward(state, obs, p, n_steps, expert_generator=generator).mean())
        return {
            "accuracy": float(acc),
            "policy_reward": pol,
            "expert_reward": exp,
            "reward_ratio": pol / exp if exp != 0 else float("nan"),
        }


def make_sharded_train_step(trainer: CoverageImitationTrainer, group=None, n_envs: int = 16,
                            n_steps: int = 8):
    """The data-parallel coverage BC step over the ranks of ``group``: each
    rank collects ``n_envs / world`` greedy-expert envs of ``n_steps`` steps
    (K5 once a step); ``step(generator) -> loss``
    (``parallel.train.make_dp_train_step``)."""
    local_envs = local_shard_size(n_envs, group)

    def local_loss(generator):
        return trainer.loss_fn(collect_coverage_batch(trainer.env, trainer.env_params,
                                                      generator, local_envs, n_steps))

    return make_dp_train_step(trainer, local_loss, group)


class CoverageDaggerTrainer:
    """DAGGER for the coverage policy: dataset aggregation on the card.

    Per :meth:`iteration`: rollouts where each env step flips its own
    Bernoulli(beta) coin between the greedy expert (K5) and the learner's
    argmax; every visited obs graph, labelled with the EXPERT's action,
    written into a rolling buffer of ``capacity`` samples; then
    ``n_grad_steps`` Adam steps on minibatches drawn with replacement from
    the filled part.  ``write_pos`` and ``filled`` are host ints: they do
    not depend on the data, and device scalars would cost a sync a step.
    """

    def __init__(self, env: CoverageEnv, env_params: CoverageParams,
                 model: Optional[EdgeGraphNet] = None, learning_rate: float = 1e-3,
                 capacity: int = 1024, beta_decay: float = 0.7, device="cuda"):
        self.inner = CoverageImitationTrainer(env, env_params, model, learning_rate, device)
        self.env = env
        self.env_params = env_params
        self.model = self.inner.model
        self.device = self.inner.device
        self.capacity = capacity
        self.beta_decay = beta_decay
        self.buffer = None
        self.write_pos = 0
        self.filled = 0

    def init(self, generator: torch.Generator) -> None:
        """The inner trainer's :meth:`init`, and an empty buffer."""
        self.inner.init(generator)
        p, cap, dev = self.env_params, self.capacity, self.device
        self.buffer = {
            "nodes": torch.zeros(cap, p.max_nodes, p.n_node_feat, device=dev),
            "edges": torch.zeros(cap, p.max_edges, p.n_edge_feat, device=dev),
            "senders": torch.full((cap, p.max_edges), -1, dtype=torch.int32, device=dev),
            "receivers": torch.full((cap, p.max_edges), -1, dtype=torch.int32, device=dev),
            "label": torch.zeros(cap, p.n_robots, dtype=torch.int32, device=dev),
        }
        self.write_pos = 0
        self.filled = 0

    def collect(self, generator: torch.Generator, beta: float, n_envs: int, n_steps: int):
        """Mixture rollouts from ``n_envs`` fresh resets; the batch dict with
        the expert's labels."""
        env, p = self.env, self.env_params
        state, obs = env.reset_env(generator, p, n_envs)
        steps = []
        for _ in range(n_steps):
            u_exp = env.controller(state, p, generator=generator).reshape(n_envs, -1)
            with torch.no_grad():
                u_learn = self.inner.logits(obs).argmax(dim=-1).to(torch.int32)
            use_expert = torch.rand(n_envs, generator=generator, device=generator.device) < beta
            u = torch.where(use_expert[:, None], u_exp, u_learn)
            steps.append({**{k: obs[k] for k in SAMPLE_KEYS}, "label": u_exp})
            state, obs, _, _, _ = env.step_env(generator, state, u, p)
        return _stack_steps(steps)

    def iteration(self, generator: torch.Generator, beta: float, n_envs: int = 8,
                  n_steps: int = 16, n_grad_steps: int = 4,
                  batch_size: int = 128) -> torch.Tensor:
        """Collect under the beta-mixture, aggregate, train; returns the
        mean loss of the grad steps."""
        n_new, cap = n_envs * n_steps, self.capacity
        # one write with repeated slots would pair one sample's graph with
        # another's label
        if n_new > cap:
            raise ValueError(f"n_envs*n_steps={n_new} exceeds buffer capacity={cap}; "
                             f"raise capacity or collect less per iteration")
        traj = self.collect(generator, beta, n_envs, n_steps)
        idx = (self.write_pos + torch.arange(n_new, device=self.device)) % cap
        for k, buf in self.buffer.items():
            buf[idx] = traj[k].to(buf.dtype)
        self.write_pos = (self.write_pos + n_new) % cap
        self.filled = min(self.filled + n_new, cap)
        losses = []
        for _ in range(n_grad_steps):
            bi = torch.randint(0, self.filled, (min(batch_size, cap),), generator=generator,
                               device=generator.device)
            losses.append(self.inner.update({k: v[bi] for k, v in self.buffer.items()}))
        return torch.stack(losses).mean()

    def fit(self, generator: torch.Generator, n_iters: int = 10, **kwargs) -> List[float]:
        """``beta_k = beta_decay**k`` (beta_0 = 1: the expert alone), from
        :meth:`init`; returns each iteration's mean loss."""
        self.init(generator)
        return [float(self.iteration(generator, self.beta_decay ** k, **kwargs))
                for k in range(n_iters)]
