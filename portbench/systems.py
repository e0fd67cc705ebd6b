"""The system under test, behind the few entries the window drives, and the
control that stands in its place.

``ProgramRollout`` reaches the port only through its public entry points:
``gym_flock_tpu_torch.make``, ``env.init_state``, ``env.reset_env`` (with
its counter ``env.last_reset_tries``) and ``batch_expert_rollout``.
``ControlRollout`` is the plain reference in the program's place, one
precision below the configuration's float32: its pair terms in bfloat16.
``break_rollout`` plants the faults that the comparison has to catch.
"""
from __future__ import annotations

import dataclasses
import torch

from portbench.reference import flocking as ref

_MASK63 = (1 << 63) - 1


def derived_seed(seed: int, stream: int = 1) -> int:
    """A second seed for another stream of the same run."""
    return (seed * 1_000_003 + 7919 * stream) & _MASK63


# ------------------------------------------------------------------ rollouts


class ProgramRollout:
    def __init__(self, cfg: dict, device: str):
        import gym_flock_tpu_torch as gft
        from gym_flock_tpu_torch.parallel import batch_expert_rollout

        self.env, self.params = gft.make(cfg["env_id"], **cfg["params"])
        self._rollout = batch_expert_rollout

    def init_state(self, x):
        return self.env.init_state(x, self.params)

    def reset(self, generator, n_envs):
        """``(state, draws)``: the reset's state and the draws it made."""
        state = self.env.reset_env(generator, self.params, n_envs)[0]
        return state, int(self.env.last_reset_tries)

    def rollout(self, generator, state, n_steps):
        return self._rollout(self.env, self.params, generator, state.x.shape[0], n_steps,
                             init_state=state)

    @staticmethod
    def state_x(state):
        return state.x

    @staticmethod
    def with_x(state, x):
        return dataclasses.replace(state, x=x)


class ControlRollout:
    """The reference's rollout with its pair terms in bfloat16."""

    def __init__(self, cfg: dict, device: str):
        self.world = ref.World.from_params(cfg["params"])
        self.dense = cfg["observation"] == "dense"

    def init_state(self, x):
        return x

    def reset(self, generator, n_envs):
        x, _, tries = ref.reset(generator, self.world, n_envs, term_dtype=torch.bfloat16)
        return x, tries

    def rollout(self, generator, x, n_steps):
        low = torch.bfloat16
        p = ref.pair_pass(x, self.world, low)
        steps = []
        for _ in range(n_steps):
            u = ref.expert_action(x, p, self.world)[0].float()
            x = ref.integrate(x, u, self.world)
            p = ref.pair_pass(x, self.world, low)
            network = ref.mean_pooled(x, self.world, low) if self.dense else p["degree"]
            steps.append({"u": u, "values": p["values"].float(), "network": network.float(),
                          "reward": ref.reward(x.to(low))[0].float()})
        return x, {k: torch.stack([s[k] for s in steps], dim=1) for k in steps[0]}

    @staticmethod
    def state_x(state):
        return state

    @staticmethod
    def with_x(state, x):
        return x


RESET_FAULTS = ("reset_first_draw", "reset_wide")


def break_reset(owner, attr: str, fault: str) -> None:
    """Plant a reset fault in the program's reset, ``owner.<attr>``:
    ``reset_first_draw`` (every swarm keeps its first draw, no rejection),
    ``reset_wide`` (the positions spread half as wide again as drawn)."""
    inner = getattr(owner, attr)

    def broken(generator, params, n_envs):
        if fault == "reset_first_draw":
            return inner(generator, dataclasses.replace(params, max_reset_tries=1), n_envs)
        state, obs = inner(generator, params, n_envs)
        x = state.x.clone()
        x[..., :2] *= 1.5
        return dataclasses.replace(state, x=x), obs

    setattr(owner, attr, broken)


def break_rollout(system, fault: str) -> None:
    """Plant ``fault`` under ``system.rollout``: ``state_unchanged`` (the
    call hands back the state it was given), ``half_batch`` (the second half
    of the swarms left out: their outputs are the first half's, their state
    unchanged), ``answer_altered`` (every expert action off by 0.01), or one
    of ``RESET_FAULTS`` under its resets."""
    if fault in RESET_FAULTS:
        break_reset(system.env, "reset_env", fault)
        return
    inner = system.rollout

    def broken(generator, state, n_steps):
        final, traj = inner(generator, state, n_steps)
        if fault == "state_unchanged":
            return state, traj
        if fault == "half_batch":
            x_in, x_out = system.state_x(state), system.state_x(final)
            b = x_in.shape[0]
            h = b - b // 2
            traj = {k: torch.cat((v[:h], v[:b - h]), dim=0) for k, v in traj.items()}
            return system.with_x(final, torch.cat((x_out[:h], x_in[h:]), dim=0)), traj
        if fault == "answer_altered":
            return final, {**traj, "u": traj["u"] + 0.01}
        raise ValueError(f"unknown fault {fault!r}")

    system.rollout = broken
