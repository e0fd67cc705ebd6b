"""The behaviour-cloning generator: a closed loop of iterations of the
coverage imitation trainer, as users training the coverage GNN on the
greedy expert run it (``CoverageImitationTrainer.fit``, one client).

Parameters (``traffic/<mix>/<config>.json``): a call is one iteration,
``trainer.collect(generator, n_envs, steps_per_call)`` (a reset of
``n_envs`` worlds, then ``steps_per_call`` greedy-expert steps with the
observation graphs and labels kept), then ``trainer.update(batch)`` (one
Adam step on the mean cross-entropy of the batch's action-edge logits):
``train_step``'s two halves, called one after the other so that a CUDA
event marks the boundary between them.  The call ends when the update is
queued (the harness synchronises).  The model is the configuration's
``model`` block through ``EdgeGraphNet``, its weights drawn from the seed;
the optimizer is the trainer's Adam, held to the ``optimizer`` block.  The
set-up warms up one whole iteration.

For the check, ``checked_calls`` calls are kept by a reservoir drawn from
the seed: the batch, the weights and Adam's state before the update, the
loss, the gradients and the weights after it (``bc_checks``), and, for
``checked_envs`` of the batch's worlds, the states the program had at each
step, for the collect's replay (``coverage_checks``); the reference resets
``reference_reset_envs`` worlds of its own.

The collect's checks are the explore cell's (``coverage_checks``) on the
kept worlds, but for ``reset_overlap_z``, which is reported and not judged:
two kept batches of 8 worlds give it no power against a reset drawn from
the wrong region, and ``explore_full_arl.expert_collect`` judges the same
reset on 512 worlds a batch.

The control is the reference's update (``reference/edge_graph_net.py``,
every dense layer in bfloat16) in the program's place, on the program's
collect.  The faults, planted in the program: ``round_dropped`` (the last
round of message passing skipped), ``half_batch`` (the loss over the first
half of the samples), ``update_skipped`` (no Adam step), ``grad_dropped``
(the logit head's last weight handed to Adam with a zero gradient: one
layer's gradient wrong, every other right), ``state_unchanged`` (the
explore cell's fault of the env's step, which hands back the state it was
given, under the trainer's collect) and ``tf32`` (the program's products
in TF32: a control of the program's own).
"""
from __future__ import annotations

import os
import random
from pathlib import Path

import torch

from portbench import bc_checks, coverage_checks, coverage_systems
from portbench.reference import edge_graph_net as ref_net
from portbench.systems import derived_seed

BANK_CACHE = Path(__file__).resolve().parents[2] / "build" / "coverage_banks"

# faults of the env, planted under the collect by ``coverage_systems.program``
ENV_FAULTS = ("state_unchanged",)
FAULTS = ("round_dropped", "half_batch", "update_skipped", "grad_dropped", *ENV_FAULTS, "tf32")


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


class ControlTrainer:
    """The reference's update in the program's place: its loss and
    gradients with every dense layer in bfloat16, its Adam written out, on
    copies of the program's first weights; the collect is the program's."""

    low = torch.bfloat16

    def __init__(self, trainer, n_robots: int, n_actions: int, optimizer: dict):
        self.collect = trainer.collect
        self.params = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
        self.state: dict = {}
        self.r, self.a, self.opt = n_robots, n_actions, optimizer

    def update(self, batch) -> torch.Tensor:
        o = self.opt
        loss, grads = ref_net.loss_and_grads(self.params, batch, self.r, self.a, self.low)
        kept = bc_checks.before(self.params, self.state)
        steps = {k: float(s) for k, s in kept["step"].items()}
        w, m, v = ref_net.adam(self.params, grads, kept["exp_avg"], kept["exp_avg_sq"], steps,
                               o["lr"], tuple(o["betas"]), o["eps"])
        for k, p in self.params.items():
            p.copy_(w[k])
            p.grad = grads[k]
            self.state[p] = {"step": torch.tensor(steps[k] + 1.0), "exp_avg": m[k].float(),
                             "exp_avg_sq": v[k].float()}
        return loss


def plant(trainer, fault: str) -> None:
    """Plant ``fault`` in the program's trainer (``tf32``, a setting of the
    process, is the cell's to set)."""
    if fault == "round_dropped":
        latent = trainer.model.latent
        # the last round hands on its edge and node features unchanged
        trainer.model.message_mlps[-1].forward = lambda x: x[..., :latent]
        trainer.model.node_mlps[-1].forward = lambda x: x[..., :latent]
    elif fault == "half_batch":
        inner = trainer._batch_loss
        trainer._batch_loss = lambda batch: inner(
            {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    elif fault == "update_skipped":
        trainer.adam_step = lambda: None
    elif fault == "grad_dropped":
        inner_step, weight = trainer.adam_step, trainer.model.logit_head.layers[1].weight

        def adam_step():
            weight.grad.zero_()
            inner_step()

        trainer.adam_step = adam_step
    else:
        raise ValueError(f"unknown fault {fault!r}")


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 system: str = "program", fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.system_name, self.fault = system, fault
        self.b = int(traffic["n_envs"])
        self.steps = int(traffic["steps_per_call"])
        self.rng = random.Random(seed)
        self.kept, self.calls = [], 0
        self.events = []  # (three CUDA events, traced) of each call of the window
        self.rows_at_start = None

    # ---------------------------------------------------------------- set-up

    def setup(self) -> None:
        from gym_flock_tpu_torch.models.gnn import EdgeGraphNet
        from gym_flock_tpu_torch.parallel.train_coverage import CoverageImitationTrainer

        os.environ.setdefault("GYM_FLOCK_TPU_TORCH_CACHE", str(BANK_CACHE))
        program = coverage_systems.program(
            self.cfg, self.device, self.fault if self.fault in ENV_FAULTS else None)
        params = program.params
        self.world = coverage_systems.world_of(params, self.cfg["world"]["horizon"])
        gaps = coverage_systems.deployment_gaps(self.cfg, params, self.world)
        m, o = self.cfg["model"], self.cfg["optimizer"]
        for name, got in (("n_node_feat", params.n_node_feat),
                          ("n_edge_feat", params.n_edge_feat)):
            if m[name] != got:
                gaps.append(f"model {name}: the env has {got}, the configuration {m[name]}")
        gen = torch.Generator(device=self.device).manual_seed(derived_seed(self.seed, 3))
        model = EdgeGraphNet(m["latent"], m["rounds"], n_node_feat=params.n_node_feat,
                             n_edge_feat=params.n_edge_feat, generator=gen, device=self.device)
        trainer = CoverageImitationTrainer(program.env, params, model=model,
                                           learning_rate=o["lr"], device=self.device)
        group = trainer.optimizer.param_groups[0]
        if (group["lr"], tuple(group["betas"]), group["eps"]) != (
                o["lr"], tuple(o["betas"]), o["eps"]):
            gaps.append(f"optimizer: the trainer's Adam has lr {group['lr']}, betas "
                        f"{group['betas']}, eps {group['eps']}, the configuration {o}")
        if gaps:
            raise ValueError("the cell is not the configuration's deployment: "
                             + "; ".join(gaps))
        self.r, self.a = params.n_robots, params.n_actions
        self.program = program
        if self.system_name == "program":
            self.trainer = trainer
            if self.fault == "tf32":
                _tf32(True)
            elif self.fault is not None and self.fault not in ENV_FAULTS:
                plant(trainer, self.fault)
        else:
            self.trainer = ControlTrainer(trainer, self.r, self.a, o)
        self.gen = torch.Generator(device=self.device).manual_seed(derived_seed(self.seed))
        # warm up every shape the window uses: a whole iteration, kept
        self._iteration(torch.arange(min(2, self.b), device=self.device))

    def _named(self):
        t = self.trainer
        if isinstance(t, ControlTrainer):
            return t.params, t.state
        return dict(t.model.named_parameters()), t.optimizer.state

    def _iteration(self, keep):
        """One call's work: the collect, then the update; with ``keep``
        (world indices) what the check needs."""
        cuda = self.device.startswith("cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
        self.program.rec = coverage_systems._Recorder(keep)
        if cuda:
            ev[0].record()
        with torch.profiler.record_function("portbench.collect"):
            batch = self.trainer.collect(self.gen, self.b, self.steps)
        if cuda:
            ev[1].record()
        entry = None
        if keep is not None:
            entry = {"batch": batch, "keep": keep, "rec": self.program.rec.out(),
                     **bc_checks.before(*self._named())}
        with torch.profiler.record_function("portbench.update"):
            loss = self.trainer.update(batch)
        if cuda:
            ev[2].record()
        if entry is not None:
            entry.update(bc_checks.after(self._named()[0], loss))
        return ev, entry

    # ---------------------------------------------------------------- window

    def call(self) -> dict:
        if self.rows_at_start is None:
            self.rows_at_start = self._message_rows()
        k = int(self.traffic["checked_calls"])
        i = self.calls
        slot = i if i < k else self.rng.randrange(i + 1)
        keep = None
        if slot < k:
            idx = sorted(self.rng.sample(range(self.b), int(self.traffic["checked_envs"])))
            keep = torch.tensor(idx, device=self.device)
        ev, entry = self._iteration(keep)
        if ev is not None:
            self.events.append((ev, self.tracing))
        if entry is not None:
            if i < k:
                self.kept.append(entry)
            else:
                self.kept[slot] = entry
        self.calls += 1
        return {"steps": float(self.steps), "agent_steps": float(self.b * self.r * self.steps),
                "calls": 1.0}

    # ---------------------------------------------------------------- check

    def release(self) -> None:
        """Free the program before the reference runs (the world's tables
        stay: they are the reference's data), and turn TF32 off again."""
        self.trainer = self.program = None
        _tf32(False)

    def check(self) -> dict:
        numbers: dict = {}
        if self.kept:  # the kept calls' worlds side by side
            recs = [e["rec"] for e in self.kept]
            states = [{k: torch.cat([r["states"][t][k] for r in recs]) for k in s}
                      for t, s in enumerate(recs[0]["states"])]
            rewards = [torch.cat([r["rewards"][t] for r in recs])
                       for t in range(len(recs[0]["rewards"]))]
            samples = {}
            for e in self.kept:
                rows = (e["keep"][:, None] * self.steps
                        + torch.arange(self.steps, device=e["keep"].device)).flatten()
                for name, v in e["batch"].items():
                    samples.setdefault(name, []).append(v.index_select(0, rows).reshape(
                        (e["keep"].shape[0], self.steps) + tuple(v.shape[1:])))
            samples = {k: torch.cat(v) for k, v in samples.items()}
            numbers.update(coverage_checks.episode_gaps(self.world, states, rewards, samples))
        numbers.update(coverage_checks.reset_numbers(
            self.world, [e["rec"]["states"][0] for e in self.kept],
            [e["rec"]["batch"] for e in self.kept], int(self.traffic["reference_reset_envs"]),
            derived_seed(self.seed, 2)))
        o = self.cfg["optimizer"]
        numbers.update(bc_checks.update_gaps(self.kept, self.r, self.a, o["lr"],
                                             tuple(o["betas"]), o["eps"]))
        return numbers

    # ---------------------------------------------------------------- readers

    def _message_rows(self):
        """The model's count of message rows, where the program has one."""
        return getattr(getattr(self.trainer, "model", None), "message_rows", None)

    def message_rows_per_call(self):
        """Message rows the update's forward pass ran a call of the window."""
        now = self._message_rows()
        if now is None or self.rows_at_start is None or not self.calls:
            return None
        return (now - self.rows_at_start) / self.calls

    def half_ms(self, half: str):
        """Each untraced call's device milliseconds of ``half``
        (``"collect"`` or ``"update"``), between the call's CUDA events;
        ``None`` without a card."""
        i = ("collect", "update").index(half)
        ms = [ev[i].elapsed_time(ev[i + 1]) for ev, traced in self.events if not traced]
        return ms or None
