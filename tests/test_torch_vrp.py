"""The port's VRP expert against the JAX package's on the CPU: the solver
(``experts/vrp``, the same C++ source built by the port into ``build/``),
the coverage VRP policy, and the VRP labels of coverage states.

Tolerances: routes, actions and labels are integers and must be equal;
``create_vrp_problem``'s matrices equal bit for bit.
"""
import functools
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from gym_flock_tpu.experts import coverage_vrp as jcv
from gym_flock_tpu.experts import vrp as jvrp
from gym_flock_tpu.parallel import vrp_labels as jlabels
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.experts import coverage_vrp as tcv
from gym_flock_tpu_torch.experts import vrp as tvrp
from gym_flock_tpu_torch.models import EdgeGraphNet
from gym_flock_tpu_torch.parallel import train_coverage as tc
from gym_flock_tpu_torch.parallel import vrp_labels as tlabels
from tests.test_torch_coverage_env import B, _envs, _keys

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
MODES = [("or_default", {}), ("or_default", {"collect_stats": True}),
         ("or_default", {"rot": 2}), ("or_default", {"last_accept": True}),
         ("or_default", {"rot": 1, "last_accept": True}), ("improve", {}),
         ("cheapest_arc", {})]
STATE_FIELDS = ("graph", "robot_loc", "visited", "discovered", "time")


def _random_instance(seed, n=11, n_vehicles=3, budget=40.0):
    """A depot-augmented problem: symmetric integer costs, the depot's row
    100000 except at the start nodes, 60% of the nodes penalised."""
    rng = np.random.RandomState(seed)
    c = np.triu(rng.randint(1, 20, size=(n, n)).astype(float), 1)
    tm = c + c.T
    tm[0, :] = 100000.0
    tm[:, 0] = 0.0
    init = rng.choice(np.arange(1, n), size=n_vehicles, replace=False).astype(np.int32)
    tm[0, init] = 0.0
    pen = np.where(rng.rand(n) < 0.6, 500.0, 0.0)
    pen[0] = 0.0
    return tm, pen, init, budget


def test_solver_source_is_the_jax_packages_byte_for_byte():
    port = REPO / "gym_flock_tpu_torch" / "experts" / "vrp" / "vrp_solver.cc"
    assert port.read_bytes() == (REPO / "gym_flock_tpu" / "experts" / "vrp" /
                                 "vrp_solver.cc").read_bytes()


def test_library_is_built_into_the_ports_build_directory():
    tvrp.solve_vrp_raw(*_random_instance(0))
    lib = tvrp.library_path()
    assert lib.is_file() and lib.parent == REPO / "build" / "gym_flock_tpu_torch"
    assert not lib.is_relative_to(REPO / "gym_flock_tpu")


@pytest.mark.parametrize("cxx", ["/nonexistent/c++", "false"])
def test_a_failed_build_raises(cxx, tmp_path, monkeypatch):
    """No compiler, or one that fails: the build raises, and leaves no
    library behind."""
    monkeypatch.setattr(tvrp, "library_path", lambda: tmp_path / "libvrp_test.so")
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="VRP solver"):
        tvrp._build()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("mode,kw", MODES)
@pytest.mark.parametrize("seed", range(4))
def test_routes_equal_jax_on_seeded_problems(mode, kw, seed):
    tm, pen, init, budget = _random_instance(seed, n_vehicles=2 + seed % 2)
    assert tvrp.solve_vrp_raw(tm, pen, init, budget, mode=mode, **kw) == \
        jvrp.solve_vrp_raw(tm, pen, init, budget, mode=mode, **kw)


def test_mode_errors_are_jaxs():
    tm, pen, init, budget = _random_instance(0)
    for kw in ({"mode": "nope"}, {"mode": "improve", "rot": 1},
               {"mode": "cheapest_arc", "collect_stats": True},
               {"collect_stats": True, "last_accept": True}):
        with pytest.raises(ValueError):
            jvrp.solve_vrp_raw(tm, pen, init, budget, **kw)
        with pytest.raises(ValueError):
            tvrp.solve_vrp_raw(tm, pen, init, budget, **kw)


@functools.lru_cache(maxsize=None)
def _jax_states(env_id, kw, n_steps=3, seed=11):
    """States of a JAX greedy rollout, B envs x ``n_steps``, as numpy."""
    _, _, _, _, jfn = _envs(env_id, kw)
    js, _ = jfn["reset"](_keys(seed))
    out = []
    for t in range(n_steps):
        keys = _keys(seed, t + 1)
        out.append({f: np.asarray(getattr(js, f)) for f in STATE_FIELDS})
        js, _, _, _, _ = jfn["step"](keys, js, jfn["controller"](js, keys))
    return {f: np.concatenate([o[f] for o in out]) for f in STATE_FIELDS}


@pytest.mark.parametrize("env_id,kw", [("Coverage-v0", (("n_graphs", 2),)),
                                       ("ExploreEnv-v0", (("n_graphs", 2),))])
def test_routes_equal_jax_on_real_bank_graphs(env_id, kw):
    """``create_vrp_problem`` on the bank's graphs and rollout states (the
    label distribution; ExploreEnv-v0 adds its discovered masks), then
    every mode."""
    _, jp, _, tp, _ = _envs(env_id, kw)
    states = _jax_states(env_id, kw)
    for i in (0, 2 * B - 1):
        g = int(states["graph"][i])
        n_t = int(np.asarray(jp.bank["n_targets"][g]))
        disc = states["discovered"][i] if jp.hide_nodes else None
        args = (states["visited"][i], disc, states["robot_loc"][i], n_t)
        want = jcv.create_vrp_problem(np.asarray(jp.bank["graph_cost"][g]), *args)
        got = tcv.create_vrp_problem(tp.bank["graph_cost"][g].numpy(), *args)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        tm, pen, init = want
        for mode, mkw in MODES:
            assert tvrp.solve_vrp_raw(tm, pen, init, float(jp.episode_length), mode=mode,
                                      **mkw) == \
                jvrp.solve_vrp_raw(tm, pen, init, float(jp.episode_length), mode=mode, **mkw)


@pytest.mark.parametrize("env_id,kw,horizon", [("Coverage-v0", (("n_graphs", 2),), -1),
                                               ("ExploreEnv-v0", (("n_graphs", 2),), 6)])
def test_coverage_vrp_policy_equals_jax_over_an_episode(env_id, kw, horizon):
    """Both packages' envs from the same state, each driven by its own VRP
    policy for a whole episode: the same actions and states every step
    (a rolling horizon re-solves each step)."""
    jenv, jp, tenv, tp, jfn = _envs(env_id, kw)
    js, _ = jfn["reset"](_keys(13))
    js = jax.tree.map(lambda v: v[0], js)
    ts = convert.coverage_state_from_numpy(jax.tree.map(lambda v: np.asarray(v)[None], js))
    jpol = jcv.CoverageVRPPolicy(jp, horizon=horizon)
    tpol = tcv.CoverageVRPPolicy(tp, horizon=horizon)
    step = jax.jit(lambda s, u: jenv.step_env(jax.random.key(0), s, u, jp))
    for t in range(jp.episode_length):
        ju = np.asarray(jpol(js))
        tu = tpol(SimpleNamespace(**{f: getattr(ts, f)[0] for f in STATE_FIELDS}))
        np.testing.assert_array_equal(tu, ju, err_msg=f"t={t}")
        assert tu.dtype == np.int32 and tu.shape == (tp.n_robots, 1)
        js, _, _, jd, _ = step(js, ju)
        ts, _, _, td, _ = tenv.step_env(None, ts, torch.from_numpy(tu)[None], tp)
        np.testing.assert_array_equal(ts.robot_loc[0].numpy(), np.asarray(js.robot_loc))
        np.testing.assert_array_equal(ts.visited[0].numpy(), np.asarray(js.visited))
        assert bool(td[0]) == bool(jd)
        if bool(jd):
            break


def test_vrp_label_states_equal_jax_on_any_number_of_workers():
    env_id, kw = "Coverage-v0", (("n_graphs", 2),)
    _, jp, _, tp, _ = _envs(env_id, kw)
    states = _jax_states(env_id, kw)
    want = jlabels.vrp_label_states(jp, states, workers=1)
    one = tlabels.vrp_label_states(tp, states, workers=1)
    two = tlabels.vrp_label_states(tp, {k: torch.from_numpy(v) for k, v in states.items()},
                                   workers=2)
    assert one.dtype == np.int32 and one.shape == (len(states["graph"]), tp.n_robots)
    np.testing.assert_array_equal(one, want)
    np.testing.assert_array_equal(two, want)


def test_collect_vrp_labeled_batch_labels_the_greedy_rollouts_states():
    """The port's batch: the greedy rollout's observations, labelled by the
    VRP expert on the pre-step states (threads or not), in range, and a
    batch the trainer takes."""
    _, _, tenv, tp, _ = _envs("Coverage-v0", (("n_graphs", 2),))
    n_envs, n_steps = 2, 3
    batch = tlabels.collect_vrp_labeled_batch(tenv, tp, torch.Generator().manual_seed(5),
                                              n_envs, n_steps, workers=2)
    assert set(batch) == {"nodes", "edges", "senders", "receivers", "label"}
    labels = batch["label"]
    assert labels.dtype == torch.int32 and labels.shape == (n_envs * n_steps, tp.n_robots)
    assert bool(((labels >= 0) & (labels < tp.n_actions)).all())
    ref = tc.greedy_rollout(tenv, tp, torch.Generator().manual_seed(5), n_envs, n_steps,
                            keep_state=True)
    for k in ("nodes", "edges", "senders", "receivers"):
        assert torch.equal(batch[k], ref[k])
    np.testing.assert_array_equal(
        labels.numpy(), tlabels.vrp_label_states(tp, {k: ref[k] for k in STATE_FIELDS},
                                                 workers=1))
    trainer = tc.CoverageImitationTrainer(tenv, tp, model=EdgeGraphNet(16, 2), device="cpu")
    loss = trainer.update_from_batch(batch)
    assert np.isfinite(float(loss)) and float(trainer.update_from_batch(batch)) != float(loss)
