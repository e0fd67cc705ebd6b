"""The expert-rollout generator: a closed loop of fused Turner-expert
rollouts of one batch of swarms, as users generating expert data run it.

Parameters (``traffic/<mix>/<config>.json``): ``n_envs`` swarms, calls of
``steps_per_call`` steps of ``batch_expert_rollout(..., init_state=...)``;
the state carries from call to call.  An episode lasts ``episode_steps``
(by default the configuration's ``max_steps``): the call that reaches it
stops there, and the next call begins with ``reset_env``, timed inside that
call.  The first episode
starts from states the benchmark draws from the seed, ``first_reset_after``
calls before its end, so that every window holds a reset early on.  For
the check, ``checked_calls`` calls are kept by a reservoir drawn from the
seed, ``checked_envs`` of their swarms each, and ``checked_resets`` resets
whole with the draws each made; the reference resets
``reference_reset_envs`` swarms of its own.  For the readers the cell
counts each reset's draws and host seconds, and, with ``trace_states``,
keeps for each call that runs under the profiler its start state and the
passes of the pair sums it makes: one at the start, one a step, and one
more for the observation of a reset it begins with.
"""
from __future__ import annotations

import random
import time

import torch

from portbench import checks, systems
from portbench.reference import flocking as ref

FAULTS = ("state_unchanged", "half_batch", "answer_altered", *systems.RESET_FAULTS)


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 system: str = "program", fault=None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.system_name, self.fault = system, fault
        self.world = ref.World.from_params(cfg["params"])
        self.b = int(traffic["n_envs"])
        self.chunk = int(traffic["steps_per_call"])
        self.episode = int(traffic.get("episode_steps", cfg["params"]["max_steps"]))
        self.dense = cfg["observation"] == "dense"
        self.rng = random.Random(seed)
        self.kept, self.kept_resets, self.calls, self.n_resets = [], [], 0, 0
        self.reset_draws, self.reset_s = [], []
        # set by the harness before each call: whether it runs under the
        # profiler; with ``trace_states``, each such call's start state (in
        # a buffer made before the profiler starts, so that keeping them
        # asks the allocator for nothing inside the trace) and its passes
        self.tracing, self.traced, self.trace_buf = False, [], None

    # ---------------------------------------------------------------- set-up

    def setup(self) -> None:
        sys_cls = systems.ProgramRollout if self.system_name == "program" else systems.ControlRollout
        self.system = sys_cls(self.cfg, self.device)
        if self.fault is not None:
            systems.break_rollout(self.system, self.fault)
        gen_bench = torch.Generator(device=self.device).manual_seed(self.seed)
        x0 = ref.draw(gen_bench, self.world, self.b)
        self.gen = torch.Generator(device=self.device).manual_seed(systems.derived_seed(self.seed))
        # warm up every shape the window uses: the reset, a full call, and
        # the call that ends an episode where the chunk does not divide it
        state = self.system.init_state(x0.clone())
        state = self.system.rollout(self.gen, state, self.chunk)[0]
        short = self.episode % self.chunk
        if short:
            self.system.rollout(self.gen, state, short)
        x_in = self.system.reset(self.gen, self.b)[0]
        final, traj = self.system.rollout(self.gen, x_in, self.chunk)
        self._keep_call(self.system.state_x(x_in), final, traj, self.chunk)
        self.kept.clear()
        self.state = self.system.init_state(x0)
        first = int(self.traffic.get("first_reset_after", 4))
        self.t_ep = max(0, self.episode - first * self.chunk)

    # ---------------------------------------------------------------- window

    def call(self) -> dict:
        reset = self.t_ep >= self.episode
        if reset:
            t0 = time.perf_counter()
            with torch.profiler.record_function("portbench.reset"):
                self.state, draws = self.system.reset(self.gen, self.b)
            self.reset_s.append((time.perf_counter() - t0, self.tracing))
            self.reset_draws.append(draws)
            self.t_ep = 0
            self._keep_reset(self.system.state_x(self.state), draws)
        n = min(self.chunk, self.episode - self.t_ep)
        x_in = self.system.state_x(self.state)
        if self.tracing and self.trace_buf is not None:
            kept = self.trace_buf[len(self.traced)]
            kept.copy_(x_in)
            self.traced.append((kept, n + 1 + reset))
        with torch.profiler.record_function("portbench.rollout"):
            final, traj = self.system.rollout(self.gen, self.state, n)
        self._keep_call(x_in, final, traj, n)
        self.state = final
        self.t_ep += n
        self.calls += 1
        return {"steps": float(n), "agent_steps": float(self.b * self.world.n_agents * n),
                "resets": float(reset)}

    def before_trace(self) -> None:
        if self.traffic.get("trace_states"):
            x = self.system.state_x(self.state)
            self.trace_buf = x.new_empty((int(self.traffic["trace_calls"]),) + tuple(x.shape))

    def _keep_reset(self, x, draws: int) -> None:
        k = int(self.traffic.get("checked_resets", 2))
        self.n_resets += 1
        if len(self.kept_resets) < k:
            self.kept_resets.append((x, draws))
        else:
            j = self.rng.randrange(self.n_resets)
            if j < k:
                self.kept_resets[j] = (x, draws)

    def _keep_call(self, x_in, final, traj, n) -> None:
        k = int(self.traffic.get("checked_calls", 4))
        i = self.calls
        slot = i if i < k else self.rng.randrange(i + 1)
        if slot >= k:
            return
        idx = torch.tensor(sorted(self.rng.sample(range(self.b), int(self.traffic["checked_envs"]))),
                           device=x_in.device)
        keep = {"x_in": x_in.index_select(0, idx),
                "x_out": self.system.state_x(final).index_select(0, idx),
                **{k2: v.index_select(0, idx) for k2, v in traj.items()}}
        if i < k:
            self.kept.append(keep)
        else:
            self.kept[slot] = keep

    # ---------------------------------------------------------------- check

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.state = None
        self.system = None
        self.traced, self.trace_buf = [], None

    def check(self) -> dict:
        numbers: dict = {}
        for k in self.kept:
            checks.merge(numbers, checks.chunk_gaps(
                self.world, k["x_in"], k["u"], k["values"], k["network"], k["reward"],
                k["x_out"], self.dense))
        numbers.update(checks.reset_numbers(
            self.world, self.kept_resets, int(self.traffic["reference_reset_envs"]),
            systems.derived_seed(self.seed, 2)))
        return numbers

    # ---------------------------------------------------------------- readers

    def live_state(self):
        return self.system.state_x(self.state) if self.state is not None else None

