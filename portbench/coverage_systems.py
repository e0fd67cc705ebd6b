"""The coverage system under test, the control that stands in its place, and
the faults the comparison has to catch.

``ProgramCollect`` reaches the port only through its public entry points:
``gym_flock_tpu_torch.make`` and ``parallel.train_coverage.
collect_coverage_batch``, the collect of the coverage imitation trainer (a
reset of every world, then each step the greedy expert, K5, and
``step_env``).  For the check it records, for the worlds it is asked to
keep, the state each ``reset_env`` and ``step_env`` of the env returns and
each step's reward, and the robots of the whole batch at the reset.
``ControlCollect`` is the plain reference in the program's place, its
discovery distances and edge features in bfloat16.  ``break_env`` and
``break_collect`` plant the faults.  ``world_of`` hands the reference the
map the env was made on, and ``deployment_gaps`` holds the env to the
deployment its configuration states.

A collect returns ``(batch, record)``: the batch dict of ``[B * n, ...]``
samples, world by world (``nodes``, ``edges``, ``senders``, ``receivers``,
``label``), and, where worlds were kept, ``{"states": [n + 1 dicts of
[k, ...]], "rewards": [n tensors [k]], "batch": (graph [B], robot_loc
[B, R])}``, else ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from portbench.reference import coverage as ref

RESET_FAULTS = ("reset_first_draw", "reset_wide")
ENV_FAULTS = ("state_unchanged", *RESET_FAULTS)
FAULTS = ("state_unchanged", "half_batch", "answer_altered", *RESET_FAULTS)


def world_of(params, horizon: int) -> ref.World:
    """The reference's data: the map the env was made on (target positions
    and mask) and the env's numbers; the greedy expert's ``horizon`` is the
    configuration's, since the env keeps it only in its tables."""
    bank = params.bank
    return ref.World(
        n_targets=bank["n_targets"].long(), target_pos=bank["target_pos"].float(),
        target_mask=bank["target_mask"], n_robots=params.n_robots, res=float(params.res),
        discover_radius=float(params.discover_radius), hide_nodes=bool(params.hide_nodes),
        n_node_feat=params.n_node_feat, nearby_density=params.nearby_density,
        frac_active=float(params.frac_active_targets), horizon=int(horizon))


# the configuration's ``world`` entries the env states as numbers
PARAM_ENTRIES = ("n_actions", "discover_radius", "nearby_starts", "nearby_density",
                 "frac_active_targets", "collision_checks")
# the entries only the real map gives: the node budget fitted to it, and the
# targets that the map and ``perimeter_delta`` make
MAP_ENTRIES = ("max_nodes", "n_targets", "max_edges")


def deployment_gaps(cfg: dict, params, world: ref.World) -> list:
    """The ways the env made from ``cfg`` is not the deployment its
    ``world`` block states (an empty list where it is).

    The env's numbers are read off ``params``; on the real map, the node
    budget, the edge budget and the targets (what the map file and
    ``perimeter_delta`` give) off ``params`` and the bank.  The horizon the
    env keeps only in its hop-cost table, built by ``horizon + 1``
    relaxation sweeps: those costs are the hop distances for every pair
    within ``horizon + 1`` hops, and a pair that no sweep reached holds
    ``MAX_COST``.  Where the map has such pairs, the nearest of them lies
    ``horizon + 2`` hops apart (a straight path against the sweeps' order
    gains one hop a sweep)."""
    stated = cfg.get("world", {})
    gaps = []

    def expect(name, got):
        if name in stated and got != stated[name]:
            gaps.append(f"{name}: the env has {got}, the configuration {stated[name]}")

    for name in PARAM_ENTRIES:
        expect(name, getattr(params, name))
    if cfg["params"].get("real_map") is True:
        expect("max_nodes", params.max_nodes)
        expect("max_edges", params.max_edges)
        expect("n_targets", int(params.bank["n_targets"][0]))  # the map is one graph
    if "horizon" in stated:
        h = ref.hops(world)
        cost = params.bank["graph_cost"]
        pair = world.target_mask[:, :, None] & world.target_mask[:, None, :]
        near = pair & (h <= world.horizon + 1)
        if bool((cost[near] != h[near].float()).any()):
            gaps.append(f"horizon: the env's hop costs differ from the hop distances "
                        f"within {world.horizon + 1} hops")
        far = pair & (cost >= ref.MAX_COST) & (h < torch.iinfo(torch.int32).max)
        if bool(far.any()) and int(h[far].min()) != world.horizon + 2:
            gaps.append(f"horizon: the env's hop costs stop at {int(h[far].min()) - 2}, the "
                        f"configuration {world.horizon}")
    return gaps


def _pick(state, idx, keys):
    return {k: getattr(state, k).index_select(0, idx) for k in keys}


class _Recorder:
    """What a collect hands the check: the kept worlds' states and rewards,
    and the whole batch's robots at the reset."""

    def __init__(self, idx: Optional[torch.Tensor]):
        self.idx = idx
        self.states, self.rewards, self.batch = [], [], None

    def reset(self, state) -> None:
        if self.idx is None:
            return
        self.batch = (state.graph.clone(), state.robot_loc.clone())
        self.states.append(_pick(state, self.idx, ("graph", "robot_loc", "visited",
                                                   "discovered", "episode_reward", "time")))

    def step(self, state, reward) -> None:
        if self.idx is None:
            return
        self.states.append(_pick(state, self.idx, ("graph", "robot_loc", "visited",
                                                   "discovered", "episode_reward", "time")))
        self.rewards.append(reward.index_select(0, self.idx))

    def out(self):
        if self.idx is None:
            return None
        return {"states": self.states, "rewards": self.rewards, "batch": self.batch}


class ProgramCollect:
    def __init__(self, env, params):
        from gym_flock_tpu_torch.parallel.train_coverage import collect_coverage_batch

        self.env, self.params = env, params
        self._collect = collect_coverage_batch
        self.rec = _Recorder(None)
        inner_reset, inner_step = env.reset_env, env.step_env

        def reset_env(generator, params, n_envs):
            state, obs = inner_reset(generator, params, n_envs)
            self.rec.reset(state)
            return state, obs

        def step_env(generator, state, action, params, flip=None):
            out = inner_step(generator, state, action, params, flip)
            self.rec.step(out[0], out[2])
            return out

        env.reset_env, env.step_env = reset_env, step_env

    def collect(self, generator, n_envs: int, n_steps: int, keep=None):
        self.rec = _Recorder(keep)
        batch = self._collect(self.env, self.params, generator, n_envs, n_steps)
        return batch, self.rec.out()

    def conflict_rounds(self) -> int:
        return int(self.env.conflict_rounds)


def program(cfg: dict, device: str, fault: Optional[str] = None) -> ProgramCollect:
    """The configuration through ``gft.make``, with ``fault`` planted under
    it where given."""
    import gym_flock_tpu_torch as gft

    env, params = gft.make(cfg["env_id"], device=device, **cfg["params"])
    if fault in ENV_FAULTS:
        break_env(env, fault)
    system = ProgramCollect(env, params)
    if fault is not None and fault not in ENV_FAULTS:
        break_collect(system, fault)
    return system


class ControlCollect:
    """The reference's collect, its discovery distances and edge features in
    bfloat16."""

    low = torch.bfloat16

    def __init__(self, world: ref.World):
        self.world = world

    def collect(self, generator, n_envs: int, n_steps: int, keep=None):
        w, low = self.world, self.low
        st = ref.reset(generator, w, n_envs, low)
        rec = _Recorder(keep)
        if keep is not None:
            rec.batch = (st["graph"].clone(), st["robot_loc"].clone())
            rec.states.append({k: v.index_select(0, keep) for k, v in st.items()})
        steps = []
        for _ in range(n_steps):
            act, det, _ = ref.greedy(w, st)
            rand = torch.randint(0, ref.N_ACTIONS, act.shape, generator=generator,
                                 device=act.device)
            label = torch.where(det, act, rand)
            steps.append({**ref.observe(w, st, low), "label": label.to(torch.int32)})
            st, reward = ref.step(w, st, label, low)
            if keep is not None:
                rec.states.append({k: v.index_select(0, keep) for k, v in st.items()})
                rec.rewards.append(reward.index_select(0, keep))
        batch = {k: torch.stack([s[k] for s in steps], dim=1).flatten(0, 1) for k in steps[0]}
        return batch, rec.out()

    def conflict_rounds(self):
        return None


def break_env(env, fault: str) -> None:
    """Plant ``fault`` in the env's own methods: ``state_unchanged`` (each
    step hands back the state it was given), ``reset_wide`` (robots drawn
    from the whole map, not a start region) or ``reset_first_draw`` (every
    world keeps the batch's first draw)."""
    if fault == "state_unchanged":
        inner_step = env.step_env

        def step_env(generator, state, action, params, flip=None):
            _, obs, reward, done, info = inner_step(generator, state, action, params, flip)
            return state, obs, reward, done, info

        env.step_env = step_env
        return
    if fault not in RESET_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    inner_reset = env.reset_env

    def reset_env(generator, params, n_envs):
        if fault == "reset_wide":
            return inner_reset(generator, dataclasses.replace(params, nearby_starts=False),
                               n_envs)
        state, obs = inner_reset(generator, params, n_envs)
        first = {f.name: getattr(state, f.name)[:1].expand_as(getattr(state, f.name))
                 .contiguous() for f in dataclasses.fields(state)}
        return (dataclasses.replace(state, **first),
                {k: v[:1].expand_as(v).contiguous() for k, v in obs.items()})

    env.reset_env = reset_env


def break_collect(system: ProgramCollect, fault: str) -> None:
    """Plant ``fault`` under the program's collect: ``half_batch`` (the
    second half of the worlds left out: their samples are the first half's,
    their states the reset's) or ``answer_altered`` (robot 0's label one
    action off in every sample)."""
    inner = system.collect

    def collect(generator, n_envs, n_steps, keep=None):
        batch, rec = inner(generator, n_envs, n_steps, keep)
        if fault == "answer_altered":
            label = batch["label"].clone()
            label[:, 0] = (label[:, 0] + 1) % ref.N_ACTIONS
            return {**batch, "label": label}, rec
        if fault == "half_batch":
            h = n_envs - n_envs // 2
            rows = n_steps * h
            batch = {k: torch.cat((v[:rows], v[:v.shape[0] - rows]), dim=0)
                     for k, v in batch.items()}
            if rec is not None:
                late = keep >= h
                for s in rec["states"][1:]:
                    for k in ("robot_loc", "visited", "discovered"):
                        s[k] = torch.where(late.view(-1, *([1] * (s[k].dim() - 1))),
                                           rec["states"][0][k], s[k])
                rec["rewards"] = [torch.where(late, 0.0, r) for r in rec["rewards"]]
            return batch, rec
        raise ValueError(f"unknown fault {fault!r}")

    system.collect = collect
