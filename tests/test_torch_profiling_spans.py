"""The env paths' own instrumentation (``gym_flock_tpu_torch.utils.profiling``):
the spans ``gft.reset``, ``gft.reset.draw``, ``gft.sync``, ``gft.step`` and
``gft.pair_pass``, and the counter ``profiling.syncs`` of host reads of
device values.

Without a profiler a span never reaches ``record_function``; under one the
spans nest as the flocking reset and fused rollout run them; the counter
counts each host decision on a device value exactly once.  All on the CPU.
"""
import dataclasses
import json

import pytest
import torch

import gym_flock_tpu_torch as gft
from gym_flock_tpu_torch.core.env import step_autoreset
from gym_flock_tpu_torch.utils import profiling

torch.set_num_threads(2)

B = 3
STEPS = 4
ENVS = {"FlockingRelative-v0": 20, "FlockingLarge-v0": 64}


def make(env_id, **kw):
    return gft.make(env_id, n_agents=ENVS[env_id], **kw)


def reset(env, params, seed=0):
    return env.reset_env(torch.Generator().manual_seed(seed), params, B)


def rollout(env, params, state, n_steps=STEPS):
    return env.expert_rollout(state, params, n_steps)


def spans(prof, tmp_path):
    """``{name: [(start, end), ...]}`` of the ``gft.`` spans in the trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and name.startswith("gft."):
            s = float(e["ts"])
            out.setdefault(name, []).append((s, s + float(e["dur"])))
    return out


def inside(inner, outers):
    return any(s <= inner[0] and inner[1] <= e for s, e in outers)


def test_a_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("gft.step") is profiling.span("gft.reset")
    for env_id in ENVS:
        env, params = make(env_id)
        state, _ = reset(env, params)
        final, traj = rollout(env, params, state)
        assert traj["u"].shape[:2] == (B, STEPS)
    assert profiling.host_bool(torch.ones(2, dtype=torch.bool).all())


@pytest.mark.parametrize("env_id", sorted(ENVS))
def test_the_spans_nest_under_the_profiler(env_id, tmp_path):
    env, params = make(env_id, max_reset_tries=5)
    state, _ = reset(env, params)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.span("gft.step") is not profiling.span("gft.step")
        state, _ = reset(env, params, seed=1)
        rollout(env, params, state)
    got = spans(prof, tmp_path)
    tries = env.last_reset_tries
    assert len(got["gft.reset"]) == 1
    assert len(got["gft.reset.draw"]) == tries
    assert len(got.get("gft.sync", [])) == (tries if tries < 5 else 4)
    for name in ("gft.reset.draw", "gft.sync"):
        assert all(inside(i, got["gft.reset"]) for i in got.get(name, []))
    assert len(got["gft.step"]) == STEPS
    passes = got["gft.pair_pass"]
    assert len(passes) == STEPS + 1
    first = min(passes)
    assert not inside(first, got["gft.step"]) and not inside(first, got["gft.reset"])
    assert all(inside(p, got["gft.step"]) for p in passes if p != first)
    # each step holds exactly one pass
    assert all(sum(s <= p[0] and p[1] <= e for p in passes) == 1 for s, e in got["gft.step"])


@pytest.mark.parametrize("env_id", sorted(ENVS))
def test_a_reset_that_never_accepts_syncs_once_a_draw_but_the_last(env_id):
    env, params = make(env_id, max_reset_tries=6, min_dist_thresh=1e9)
    before = profiling.syncs
    reset(env, params)
    assert env.last_reset_tries == 6
    assert profiling.syncs - before == 6 - 1


@pytest.mark.parametrize("env_id", sorted(ENVS))
def test_the_fused_rollout_never_syncs(env_id):
    env, params = make(env_id)
    state, _ = reset(env, params)
    before = profiling.syncs
    final, traj = rollout(env, params, state, n_steps=6)
    assert profiling.syncs == before
    assert torch.isfinite(final.x).all() and torch.isfinite(traj["reward"]).all()


def test_step_autoreset_syncs_once_a_step_while_no_episode_ends():
    env, params = make("FlockingRelative-v0", max_steps=100)
    state, _ = reset(env, params)
    g = torch.Generator().manual_seed(3)
    u = torch.zeros(B, ENVS["FlockingRelative-v0"], 2)
    before = profiling.syncs
    for i in range(5):
        state, _, _, done, _ = step_autoreset(env, g, state, u, params)
        assert not done.any()
        assert profiling.syncs - before == i + 1


def test_step_autoreset_counts_the_resets_syncs_when_an_episode_ends():
    env, params = make("FlockingRelative-v0", max_steps=1, max_reset_tries=3,
                       min_dist_thresh=1e9)
    state, _ = reset(env, params)
    u = torch.zeros(B, ENVS["FlockingRelative-v0"], 2)
    before = profiling.syncs
    state, _, _, done, _ = step_autoreset(env, torch.Generator().manual_seed(4), state, u, params)
    assert done.all() and int(state.time.max()) == 0
    assert profiling.syncs - before == 1 + (3 - 1)


def test_the_sparse_rollout_counts_its_verlet_checks():
    env, params = gft.make("FlockingSparse-v0", n_agents=128)
    x = reset(env, dataclasses.replace(params, min_dist_thresh=0.0))[0].x[:1]
    state = env.init_state(x, params)
    before = profiling.syncs
    env.expert_rollout(state, params, 3)
    # one displacement check a step at least, besides the first build
    assert profiling.syncs - before >= 3


@pytest.mark.parametrize("value", [True, False])
def test_host_bool_reads_the_value_and_counts_one(value):
    before = profiling.syncs
    assert profiling.host_bool(torch.tensor(value)) is value
    assert profiling.syncs - before == 1
