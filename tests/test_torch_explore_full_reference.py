"""The port's ExploreFullEnv-v0 collect against the benchmark's plain
coverage reference (``portbench/reference/coverage.py``), on the CPU at a
small size: the procedural map (``GYM_FLOCK_TPU_MAPS=off``), R=100, B=4,
10 steps.

The reference replays the collect (the benchmark's program, recording every
world) step by step from the port's own states with the port's own labels:
each observation graph, label, next state and reward must agree (ids,
states and rewards exactly; labels among the options one hop closer to the
nearest target, exactly where one is; float features within 1e-5 of
1 + |ref|, the rounding of lengths taken from float32 positions).  The conflict fixed point is held to upstream's sequential two
passes on hand-made cases; the coverage spans are recorded under a profiler
and add no host read; the reference loads nothing of either package.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gym_flock_tpu_torch as gft
from gym_flock_tpu_torch.envs import coverage as cov
from gym_flock_tpu_torch.parallel.train_coverage import collect_coverage_batch
from gym_flock_tpu_torch.utils import profiling
from portbench import coverage_systems
from portbench.reference import coverage as ref

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
B, STEPS = 4, 10
HORIZON = 19  # ExploreFullEnv-v0's (coverage_explore_full.py)
FEATURE_TOL = 1e-5
SPANS = ("gft.cov.reset", "gft.cov.step", "gft.cov.conflict", "gft.cov.obs", "gft.cov.expert")


@pytest.fixture(scope="module")
def world():
    env, params = gft.make("ExploreFullEnv-v0", device="cpu")
    assert params.n_robots == 100 and params.hide_nodes and params.n_node_feat == 4
    # the benchmark's program: the port's collect, recording every world
    system = coverage_systems.ProgramCollect(env, params)
    return env, params, coverage_systems.world_of(params, HORIZON), system


def as_ref(state):
    return {"graph": state["graph"].long(), "robot_loc": state["robot_loc"].long(),
            "visited": state["visited"], "discovered": state["discovered"],
            "episode_reward": state["episode_reward"], "time": state["time"].long()}


@pytest.mark.parametrize("seed", [0, 7])
def test_the_collect_equals_the_reference_step_by_step(world, seed):
    _, _, w, system = world
    batch, rec = system.collect(torch.Generator().manual_seed(seed), B, STEPS,
                                keep=torch.arange(B))
    states, rewards = rec["states"], rec["rewards"]
    assert len(states) == STEPS + 1 and len(rewards) == STEPS
    samples = {k: v.reshape((B, STEPS) + tuple(v.shape[1:])) for k, v in batch.items()}
    assert not bool(ref.reset_violations(w, as_ref(states[0])).any())
    determined = exact = 0
    for t in range(STEPS):
        st = as_ref(states[t])
        obs = ref.observe(w, st)
        for k in ("senders", "receivers"):
            assert torch.equal(samples[k][:, t].long(), obs[k]), (t, k)
        for k in ("nodes", "edges"):
            gap = (samples[k][:, t] - obs[k]).abs() / (1.0 + obs[k].abs())
            assert float(gap.max()) <= FEATURE_TOL, (t, k)
        label = samples["label"][:, t].long()
        act, det, allowed = ref.greedy(w, st)
        assert bool(((label >= 0) & (label < ref.N_ACTIONS)).all()), t
        assert bool(allowed.gather(2, label[..., None]).all()), t
        one = det & (allowed.sum(dim=2) == 1)
        assert torch.equal(label[one], act[one]), t
        determined += int(det.sum())
        exact += int(one.sum())
        nxt, reward = ref.step(w, st, label)
        got = as_ref(states[t + 1])
        for k in ("robot_loc", "visited", "discovered", "episode_reward", "time"):
            assert torch.equal(got[k], nxt[k].to(got[k].dtype)), (t, k)
        assert torch.equal(rewards[t], reward), t
    assert exact > 0
    assert determined > B * 100 * STEPS // 2  # the expert mostly has a target
    assert sum(float(r.sum()) for r in rewards) > 0


CONFLICTS = {
    # two robots choose one node: the lower index takes it, the other stays
    "two_on_one": ([[0, 1]], [[5, 5]], [[5, 1]]),
    # a chain of three, each onto the next one's node, the head moving on
    "chain_moving": ([[1, 2, 3]], [[2, 3, 4]], [[2, 3, 4]]),
    # a chain of three whose head stays: its node is claimed first, so the
    # middle robot stays and the tail still moves (upstream's two passes)
    "chain_blocked": ([[1, 2, 3]], [[2, 3, 3]], [[2, 2, 3]]),
    # the same chain in the other index order: the middle robot stays
    # before the tail is reached, so the tail finds its node taken too
    "chain_reversed": ([[3, 2, 1]], [[3, 3, 2]], [[3, 2, 1]]),
}


@pytest.mark.parametrize("case", sorted(CONFLICTS))
def test_hand_made_conflicts_resolve_as_upstreams_two_passes(case):
    cur, chosen, want = (torch.tensor(x) for x in CONFLICTS[case])
    got, rounds = cov._resolve_conflicts(cur, chosen, True)
    assert got.tolist() == want.tolist() == ref.resolve(cur, chosen).tolist()
    assert rounds >= 1


def test_random_conflicts_resolve_as_upstreams_two_passes():
    g = torch.Generator().manual_seed(3)
    cur = torch.stack([torch.randperm(40, generator=g)[:30] for _ in range(64)])
    chosen = torch.where(torch.rand(cur.shape, generator=g) < 0.3, cur,
                         torch.randint(0, 40, cur.shape, generator=g))
    got, _ = cov._resolve_conflicts(cur, chosen, True)
    assert torch.equal(got, ref.resolve(cur, chosen))


def test_a_collect_records_every_coverage_span(world, tmp_path):
    env, params, _, _ = world
    collect_coverage_batch(env, params, torch.Generator().manual_seed(1), B, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        collect_coverage_batch(env, params, torch.Generator().manual_seed(1), B, 2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [str(e.get("name")) for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X"]
    count = {s: names.count(s) for s in SPANS}
    assert count == {"gft.cov.reset": 1, "gft.cov.step": 2, "gft.cov.conflict": 2,
                     "gft.cov.obs": 3, "gft.cov.expert": 2}


def test_without_a_profiler_the_spans_add_no_host_read(world, monkeypatch):
    """Each step reads the host once a conflict round and once more to end
    the fixed point; nothing else in a collect reads it."""
    env, params, _, _ = world

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    syncs, rounds = profiling.syncs, env.conflict_rounds
    collect_coverage_batch(env, params, torch.Generator().manual_seed(2), B, STEPS)
    assert env.conflict_rounds > rounds
    assert profiling.syncs - syncs == (env.conflict_rounds - rounds) + STEPS


def test_the_reference_loads_nothing_of_either_package():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.coverage; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gym_flock_tpu_torch', 'gym_flock_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
