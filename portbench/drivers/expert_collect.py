"""The expert-collect generator: a closed loop of whole-episode greedy-expert
collects over one batch of coverage worlds, as users gathering imitation
data for the coverage policy run it (the coverage trainer's collect).

Parameters (``traffic/<mix>/<config>.json``): ``n_envs`` worlds, each call
one whole episode of ``steps_per_call`` steps (by default the
configuration's ``episode_length``): a reset of every world inside the
call, then each step the expert's label and the observation graph kept;
the call ends when the batch is on the device (the harness synchronises).
For the check, ``checked_calls`` calls are kept by a reservoir drawn from
the seed, ``checked_envs`` of their worlds each, with the states the
program had at each step and the whole batch's robots at the reset; the
reference resets ``reference_reset_envs`` worlds of its own.  For the
readers the cell counts the env's conflict rounds from the window's first
call.

Before the set-up makes the env, the bank's disk cache is pointed into
the checkout's ``build/`` (unless ``GYM_FLOCK_TPU_TORCH_CACHE`` is set),
so that only a checkout's first run builds the world's tables.  The set-up
then holds the env to the deployment the configuration's ``world`` block
states (``coverage_systems.deployment_gaps``) and raises where it is not.
"""
from __future__ import annotations

import os
import random
from pathlib import Path

import torch

from portbench import coverage_checks, coverage_systems
from portbench.systems import derived_seed

BANK_CACHE = Path(__file__).resolve().parents[2] / "build" / "coverage_banks"

FAULTS = coverage_systems.FAULTS


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 system: str = "program", fault=None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.system_name, self.fault = system, fault
        self.b = int(traffic["n_envs"])
        self.steps = int(traffic.get("steps_per_call", cfg["params"]["episode_length"]))
        self.rng = random.Random(seed)
        self.kept, self.calls = [], 0
        self.rounds_at_start = None

    # ---------------------------------------------------------------- set-up

    def setup(self) -> None:
        os.environ.setdefault("GYM_FLOCK_TPU_TORCH_CACHE", str(BANK_CACHE))
        program = coverage_systems.program(
            self.cfg, self.device, self.fault if self.system_name == "program" else None)
        params = program.params
        self.world = coverage_systems.world_of(params, self.cfg["world"]["horizon"])
        gaps = coverage_systems.deployment_gaps(self.cfg, params, self.world)
        if gaps:
            raise ValueError("the env is not the configuration's deployment: "
                             + "; ".join(gaps))
        self.r, self.t = params.n_robots, params.max_targets
        self.g = int(params.bank["n_targets"].shape[0])
        self.system = (program if self.system_name == "program"
                       else coverage_systems.ControlCollect(self.world))
        self.gen = torch.Generator(device=self.device).manual_seed(derived_seed(self.seed))
        # warm up every shape the window uses: a whole collect, kept
        keep = torch.arange(min(2, self.b), device=self.device)
        self.system.collect(self.gen, self.b, self.steps, keep)

    # ---------------------------------------------------------------- window

    def call(self) -> dict:
        if self.rounds_at_start is None:
            self.rounds_at_start = self.system.conflict_rounds()
        k = int(self.traffic.get("checked_calls", 4))
        i = self.calls
        slot = i if i < k else self.rng.randrange(i + 1)
        keep = None
        if slot < k:
            idx = sorted(self.rng.sample(range(self.b), int(self.traffic["checked_envs"])))
            keep = torch.tensor(idx, device=self.device)
        with torch.profiler.record_function("portbench.collect"):
            batch, rec = self.system.collect(self.gen, self.b, self.steps, keep)
        if keep is not None:
            rows = (keep[:, None] * self.steps
                    + torch.arange(self.steps, device=keep.device)).flatten()
            samples = {name: v.index_select(0, rows).reshape(
                (keep.shape[0], self.steps) + tuple(v.shape[1:])) for name, v in batch.items()}
            entry = {"samples": samples, **rec}
            if i < k:
                self.kept.append(entry)
            else:
                self.kept[slot] = entry
        del batch
        self.calls += 1
        return {"steps": float(self.steps),
                "agent_steps": float(self.b * self.r * self.steps), "resets": 1.0}

    # ---------------------------------------------------------------- check

    def release(self) -> None:
        """Free the program before the reference runs (the world's tables
        stay: they are the reference's data)."""
        self.system = None

    def check(self) -> dict:
        numbers: dict = {}
        if self.kept:  # the kept calls' worlds side by side
            first = self.kept[0]
            states = [{k: torch.cat([e["states"][t][k] for e in self.kept]) for k in s}
                      for t, s in enumerate(first["states"])]
            rewards = [torch.cat([e["rewards"][t] for e in self.kept])
                       for t in range(len(first["rewards"]))]
            samples = {k: torch.cat([e["samples"][k] for e in self.kept])
                       for k in first["samples"]}
            numbers.update(coverage_checks.episode_gaps(self.world, states, rewards, samples))
        numbers.update(coverage_checks.reset_numbers(
            self.world, [e["states"][0] for e in self.kept], [e["batch"] for e in self.kept],
            int(self.traffic["reference_reset_envs"]), derived_seed(self.seed, 2)))
        return numbers

    # ---------------------------------------------------------------- readers

    def conflict_rounds(self):
        """The env's conflict rounds since the window's first call."""
        if self.system is None or self.rounds_at_start is None:
            return None
        now = self.system.conflict_rounds()
        return None if now is None else now - self.rounds_at_start
