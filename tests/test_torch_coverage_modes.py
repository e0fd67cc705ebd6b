"""The port's coverage flag modes, obstacle and legacy layouts, bank
save/load and disk cache, and the maps shadow warning, against the JAX
package (procedural maps: the suite sets GYM_FLOCK_TPU_MAPS=off).

Flag modes (``revisit_nodes``, ``pos_delta``, ``comm_edges``,
``last_edge_feature``) are held to JAX's ``_obs_reward`` and ``step_env``
from the same states, carried over by ``convert.coverage_state_from_numpy``.
Tolerances: integers and bools exactly (senders, receivers, nodes, masks,
rewards); float edge features atol 1e-6.  JAX's and torch's random streams
differ, so the revisit draw is held by an injected flip mask (JAX's own
draw for the key) and, for the port's draw, by its invariants.
"""
import dataclasses
import functools
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.envs import coverage_graph as jcg
from gym_flock_tpu.envs import maps as jmaps
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs import coverage as tcov
from gym_flock_tpu_torch.envs import coverage_graph as tcg
from gym_flock_tpu_torch.envs import maps as tmaps

torch.set_num_threads(2)

FEAT_ATOL = 1e-6
B = 3
FLAG_CASES = [
    ("Coverage-v0", ("revisit_nodes",)),
    ("Coverage-v0", ("pos_delta",)),
    ("Coverage-v0", ("comm_edges",)),
    ("Coverage-v0", ("last_edge_feature",)),
    ("Coverage-v0", ("comm_edges", "pos_delta", "last_edge_feature")),
    ("Coverage-v0", ("pos_delta", "last_edge_feature")),
    ("Coverage-v0", ("comm_edges", "last_edge_feature")),
    # a short comm range: envs hold different comm-edge counts, so the
    # tail block starts at a different offset in each
    ("Coverage-v0", ("comm_edges", "pos_delta", "comm_radius=12.0")),
    ("ExploreEnv-v0", ("comm_edges", "pos_delta", "last_edge_feature")),
    ("ExploreEnv-v0", ("pos_delta", "last_edge_feature")),
]
STATE_FIELDS = ("time", "graph", "robot_loc", "visited", "discovered", "episode_reward",
                "last_loc")


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


@functools.lru_cache(maxsize=None)
def _envs(env_id, flags):
    """Both packages' env and params with ``flags`` on, and JAX's functions
    vmapped over the batch."""
    kw = dict(n_graphs=2)
    for f in flags:
        name, _, value = f.partition("=")
        kw[name] = float(value) if value else True
    jenv, jp = gft_jax.make(env_id, **kw)
    tenv, tp = gft.make(env_id, device="cpu", **kw)
    jfn = {
        "reset": jax.jit(jax.vmap(lambda k: jenv.reset_env(k, jp))),
        "controller": jax.jit(jax.vmap(lambda s, k: jenv.controller(s, jp, key=k))),
        "step": jax.jit(jax.vmap(lambda k, s, u: jenv.step_env(k, s, u, jp))),
        "obs": jax.jit(jax.vmap(lambda s: jenv._obs_reward(s, jp))),
        "obs_key": jax.jit(jax.vmap(lambda s, k: jenv._obs_reward(s, jp, key=k))),
        # the flip mask JAX's step draws from its obs key (coverage.py:449-471)
        "flip": jax.jit(jax.vmap(lambda k: jax.random.bernoulli(
            jax.random.split(k)[1], 0.005, (jp.max_targets,)))),
        "flip_obs": jax.jit(jax.vmap(lambda k: jax.random.bernoulli(
            k, 0.005, (jp.max_targets,)))),
    }
    return jenv, jp, tenv, tp, jfn


def _keys(seed, t=0):
    return jax.vmap(lambda k: jax.random.fold_in(k, t))(jax.random.split(jax.random.key(seed), B))


def _assert_obs_equal(tobs, jobs, msg=""):
    assert set(tobs) == set(jobs)
    for k in ("senders", "receivers"):
        assert tobs[k].dtype == torch.int32
        np.testing.assert_array_equal(tobs[k].numpy(), np.asarray(jobs[k]), err_msg=msg + k)
    for k in ("nodes", "edges", "step"):
        assert tobs[k].dtype == torch.float32
        assert tobs[k].shape == np.asarray(jobs[k]).shape, msg + k
        np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]), rtol=0, atol=FEAT_ATOL,
                                   err_msg=msg + k)
    np.testing.assert_array_equal(tobs["nodes"].numpy(), np.asarray(jobs["nodes"]))


def _assert_state_equal(ts, js, msg=""):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=msg + f)


def _stepped_state(jfn, seed):
    """A JAX state after a reset and one greedy step (``last_loc`` set)."""
    js, _ = jfn["reset"](_keys(seed))
    keys = _keys(seed, 1)
    js, _, _, _, _ = jfn["step"](keys, js, jfn["controller"](js, keys))
    return js


@pytest.mark.parametrize("env_id,flags", FLAG_CASES)
def test_params_equal_jax(env_id, flags):
    jenv, jp, tenv, tp, jfn = _envs(env_id, flags)
    for f in ("n_robots", "max_nodes", "n_node_feat", "hide_nodes", "comm_edges", "pos_delta",
              "last_edge_feature", "revisit_nodes", "res", "comm_radius", "max_neighbor_dist"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert (tp.n_edge_feat, tp.n_comm_edges, tp.max_edges) == (
        jp.n_edge_feat, jp.n_comm_edges, jp.max_edges)
    sp = tenv.observation_space(tp).spaces["edges"]
    assert sp.shape == jenv.observation_space(jp).spaces["edges"].shape


@pytest.mark.parametrize("env_id,flags", FLAG_CASES)
def test_obs_reward_matches_jax(env_id, flags):
    """``_obs_reward(state, params)`` of both packages (JAX's with no key, so
    no revisit draw) from a stepped state: the mode's edge layout, the
    comm block's per-env offset and the last-edge flags."""
    jenv, jp, tenv, tp, jfn = _envs(env_id, flags)
    js = _stepped_state(jfn, 1)
    ts = convert.coverage_state_from_numpy(js)
    _assert_state_equal(ts, js)
    jobs, jr, jd, js2 = jfn["obs"](js)
    tobs, tr, td, ts2 = tenv._obs_reward(ts, tp)
    _assert_obs_equal(tobs, jobs)
    _assert_state_equal(ts2, js2)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tobs["edges"].shape == (B, tp.max_edges, tp.n_edge_feat)
    if tp.comm_radius < 100.0:
        # the tail starts at E - (2*A*R + n_comm): another offset in each env
        s, r = tobs["senders"], tobs["receivers"]
        n_comm = ((s >= 0) & (s < tp.n_robots) & (r >= 0) & (r < tp.n_robots)).sum(1)
        assert len(set(n_comm.tolist())) > 1 and (n_comm < tp.n_comm_edges).all()


@pytest.mark.parametrize("env_id,flags", FLAG_CASES)
def test_steps_match_jax_with_jax_flips(env_id, flags):
    """Three steps of both packages from the same state: greedy actions on
    JAX's side, the port stepped with them and with the flip mask JAX's
    step drew for its key (``revisit_nodes``)."""
    jenv, jp, tenv, tp, jfn = _envs(env_id, flags)
    js, _ = jfn["reset"](_keys(2))
    ts = convert.coverage_state_from_numpy(js)
    for t in range(3):
        keys = _keys(2, t + 1)
        ju = jfn["controller"](js, keys)
        js, jobs, jr, jd, _ = jfn["step"](keys, js, ju)
        flip = torch.from_numpy(np.array(jfn["flip"](keys))) if tp.revisit_nodes else None
        ts, tobs, tr, td, _ = tenv.step_env(None, ts, torch.from_numpy(np.array(ju)), tp,
                                            flip=flip)
        msg = f"t={t} "
        _assert_obs_equal(tobs, jobs, msg)
        _assert_state_equal(ts, js, msg)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=msg)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=msg)


def test_revisit_flip_arithmetic_matches_jax():
    """A state with every target visited and JAX's draw for the key
    injected: the reverted targets, the reward and the observation equal
    JAX's ``_obs_reward(state, params, key)``, and some target reverted."""
    jenv, jp, tenv, tp, jfn = _envs("Coverage-v0", ("revisit_nodes",))
    js = _stepped_state(jfn, 3)
    js = js.replace(visited=jnp.ones_like(js.visited))
    keys = _keys(3, 7)
    jobs, jr, jd, js2 = jfn["obs_key"](js, keys)
    flip = torch.from_numpy(np.array(jfn["flip_obs"](keys)))
    ts = convert.coverage_state_from_numpy(js)
    tobs, tr, td, ts2 = tenv._obs_reward(ts, tp, flip=flip)
    _assert_obs_equal(tobs, jobs)
    _assert_state_equal(ts2, js2)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert (ts2.visited == 0).any()


def test_revisit_draw_invariants():
    """The port's own draw (a generator on the host): targets revert only
    where masked and visited, robots' nodes stay visited, a reset draws
    nothing, and the flip rate is 0.005 within 5 sigma."""
    _, _, tenv, tp, _ = _envs("Coverage-v0", ("revisit_nodes",))
    gen = torch.Generator().manual_seed(0)
    n = 256
    state, _ = tenv.reset_env(gen, tp, n)
    # the reset draws no flips: the same reset as with the mode off, and the
    # generator left where that one leaves it
    off = torch.Generator().manual_seed(0)
    state_off, _ = tenv.reset_env(off, dataclasses.replace(tp, revisit_nodes=False), n)
    assert torch.equal(state.visited, state_off.visited)
    assert torch.equal(gen.get_state(), off.get_state())
    mask = tp.bank["target_mask"][state.graph.long()]
    n_draws = n_flips = 0
    for _ in range(8):
        before = state.visited
        u = tenv.controller(state, tp, gen)
        g_state = gen.get_state()
        state, _, _, _, _ = tenv.step_env(gen, state, u, tp)
        replay = torch.Generator()
        replay.set_state(g_state)
        flip = tcov.revisit_flips(replay, n, tp.max_targets)
        want = torch.where(flip & mask, 0.0, before).scatter(1, state.robot_loc.long(), 1.0)
        assert torch.equal(state.visited, want)
        reverted = (before == 1) & (state.visited == 0)
        assert not (reverted & ~(mask & flip)).any()
        n_draws += flip.numel()
        n_flips += int(flip.sum())
    p = tcov.REVISIT_P
    assert abs(n_flips - n_draws * p) < 5 * (n_draws * p * (1 - p)) ** 0.5


def test_revisit_step_without_generator_draws_nothing():
    _, _, tenv, tp, _ = _envs("Coverage-v0", ("revisit_nodes",))
    gen = torch.Generator().manual_seed(1)
    state, _ = tenv.reset_env(gen, tp, 4)
    state = type(state)(**{**state.__dict__, "visited": torch.ones_like(state.visited)})
    u = tenv.controller(state, tp, gen)
    state2, _, reward, _, _ = tenv.step_env(None, state, u, tp)
    assert torch.equal(state2.visited, state.visited) and (reward == 0).all()


def test_comm_edges_room_raises_as_jax():
    """ExploreFullEnv-v0 (R=100) needs R*(R-1) = 9,900 comm slots: both
    factories refuse it with the same message instead of overflowing."""
    with pytest.raises(ValueError) as jerr:
        gft_jax.make("ExploreFullEnv-v0", comm_edges=True)
    with pytest.raises(ValueError) as terr:
        gft.make("ExploreFullEnv-v0", comm_edges=True, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "reserves 9900 tail slots" in str(terr.value)


def test_flag_modes_default_to_the_card():
    """``make`` with every flag on builds on the card by default: without
    one it raises rather than falling back to the host."""
    kw = dict(n_graphs=1, comm_edges=True, pos_delta=True, last_edge_feature=True,
              revisit_nodes=True)
    if torch.cuda.is_available():
        assert gft.make("Coverage-v0", **kw)[1].device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        gft.make("Coverage-v0", **kw)


# --------------------------------------------------------------------------
# obstacle and legacy layouts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fn,args", [
    ("gen_square", (40, 10.0, 8.0)),
    ("gen_square", (7, 3.0, 3.0)),
    ("gen_grid", (49, 1.5)),
    ("gen_grid", (50, 2.0)),
    ("gen_sparse_grid", (60, 10.0, 12.0, 2.0, 3.0)),
    ("gen_sparse_grid", (13, 4.0, 4.0, 1.0, 1.0)),
])
def test_layouts_equal_jax(fn, args):
    got, want = getattr(tcg, fn)(*args), getattr(jcg, fn)(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_obstacles_equal_jax():
    ranges = [(-5.0, -2.0), (1.0, 3.0)]
    obstacles = tcg.gen_obstacle_grid(ranges)
    assert obstacles == jcg.gen_obstacle_grid(ranges)
    pts = np.random.RandomState(0).uniform(-6, 6, size=(400, 2))
    got = tcg.reject_collisions(pts, obstacles)
    np.testing.assert_array_equal(got, jcg.reject_collisions(pts, obstacles))
    assert 0 < got.shape[0] < pts.shape[0]
    assert tcg.reject_collisions(pts, None) is pts
    for p in pts[:50]:
        assert tcg.in_obstacle(obstacles, *p) == jcg.in_obstacle(obstacles, *p)


# --------------------------------------------------------------------------
# bank save / load and the disk cache
# --------------------------------------------------------------------------


def _assert_params_equal(a, b):
    for f in ("n_robots", "max_nodes", "hide_nodes", "res", "discover_radius",
              "max_neighbor_dist", "comm_edges"):
        assert getattr(a, f) == getattr(b, f), f
    assert set(a.bank) == set(b.bank)
    for k in a.bank:
        assert a.bank[k].dtype == b.bank[k].dtype, k
        assert torch.equal(a.bank[k], b.bank[k]), k


@pytest.mark.parametrize("env_id", ["Coverage-v0", "ExploreEnv-v0"])
def test_bank_saved_by_jax_loads_as_the_port_params(env_id, tmp_path):
    """JAX's ``save_graph_bank`` of its params' bank (with its one-hot
    operands), loaded by the port and prepared, gives the params that
    ``convert.coverage_params_from_jax`` gives."""
    _, jp = gft_jax.make(env_id, n_graphs=2)
    path = str(tmp_path / "bank.npz")
    jcg.save_graph_bank(path, jp.bank)
    loaded = tcg.load_graph_bank(path, device="cpu")
    assert loaded["graph_cost_mm"].dtype == torch.bfloat16
    bank = tcov.prepare_bank(tcg.strip_operands(loaded), jp.hide_nodes, jp.discover_radius)
    want = convert.coverage_params_from_jax(jp, device="cpu")
    _assert_params_equal(dataclasses.replace(want, bank=bank), want)


def test_port_bank_round_trips_and_jax_reads_it(tmp_path):
    _, tp = gft.make("ExploreEnv-v0", n_graphs=2, device="cpu")
    path = str(tmp_path / "bank.npz")
    tcg.save_graph_bank(path, tp.bank)
    loaded = tcg.load_graph_bank(path)
    assert set(loaded) == set(tp.bank)
    for k, v in tp.bank.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
    jbank = jcg.load_graph_bank(path)
    for k in ("graph_cost", "graph_prev", "neighbor_table", "target_mask", "graph_cost_mm"):
        np.testing.assert_array_equal(np.asarray(jbank[k], np.float32),
                                      tp.bank[k].float().numpy(), err_msg=k)


def test_schema_mismatch_raises(tmp_path):
    _, tp = gft.make("Coverage-v0", n_graphs=1, device="cpu")
    path = tmp_path / "bank.npz"
    tcg.save_graph_bank(str(path), tp.bank)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["__bank_schema__"] = np.asarray(tcg.BANK_SCHEMA + 1)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="schema"):
        tcg.load_graph_bank(str(path))
    del arrays["__bank_schema__"]
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="__bank_schema__"):
        tcg.load_graph_bank(str(path))


# a bank that builds in well under a second: one small road-lattice map
_SMALL = dict(n_graphs=1, n_robots=2, max_nodes=700, horizon=2, seed=5, device="cpu",
              xmax=60.0, ymax=60.0)


def test_second_bank_comes_from_disk(monkeypatch, tmp_path):
    """With the process memo cleared and the builder patched to raise, the
    second ``default_coverage_bank`` call reads the disk cache; the bank is
    the one built, K5's operand rebuilt beside it."""
    monkeypatch.setenv(tcov.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(tcov, "_bank_cache", {})
    built = tcov.default_coverage_bank(**_SMALL)
    files = list(tmp_path.glob("bank_*.npz"))
    assert len(files) == 1
    timing = tcov.last_bank_timing
    assert timing["source"] == "build"
    assert timing["build_seconds"] > 0 and timing["write_seconds"] > 0
    monkeypatch.setattr(tcov, "_bank_cache", {})

    def refuse(*args, **kwargs):
        raise AssertionError("the builder ran: the disk cache was not read")

    monkeypatch.setattr(tcov, "_build_bank", refuse)
    loaded = tcov.default_coverage_bank(**_SMALL)
    assert tcov.last_bank_timing["source"] == "disk"
    assert set(loaded) == set(built) and "cost_rows_pad" in loaded
    for k, v in built.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k


def test_a_changed_builder_misses_the_cache(monkeypatch, tmp_path):
    """The cache's file names hash the builder's source: after a change to
    it, a bank built before is not read and the builder runs again."""
    monkeypatch.setenv(tcov.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(tcov, "_bank_cache", {})
    tcov.default_coverage_bank(**_SMALL)
    monkeypatch.setattr(tcov, "_bank_cache", {})
    monkeypatch.setattr(tcov, "_builder_digest", lambda: "another builder")
    tcov.default_coverage_bank(**_SMALL)
    assert tcov.last_bank_timing["source"] == "build"
    assert len(list(tmp_path.glob("bank_*.npz"))) == 2


def test_corrupt_cache_file_is_rebuilt(monkeypatch, tmp_path):
    monkeypatch.setenv(tcov.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(tcov, "_bank_cache", {})
    built = tcov.default_coverage_bank(**_SMALL)
    (path,) = tmp_path.glob("bank_*.npz")
    path.write_bytes(b"not a zip file")
    monkeypatch.setattr(tcov, "_bank_cache", {})
    again = tcov.default_coverage_bank(**_SMALL)
    assert torch.equal(again["graph_cost"], built["graph_cost"])
    assert tcg.load_graph_bank(str(path))["graph_cost"].shape == built["graph_cost"].shape


def test_unwritable_cache_keeps_the_memo(monkeypatch, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("a file where the cache directory would be")
    monkeypatch.setenv(tcov.CACHE_ENV, str(blocker / "cache"))
    monkeypatch.setattr(tcov, "_bank_cache", {})
    bank = tcov.default_coverage_bank(**_SMALL)
    assert tcov.default_coverage_bank(**_SMALL) is bank
    assert not (blocker / "cache").exists()


def test_cache_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(tcov.CACHE_ENV, raising=False)
    assert tcov.bank_cache_dir().name == "gym_flock_tpu_torch"
    monkeypatch.setenv("GYM_FLOCK_TPU_CACHE", "/elsewhere")
    assert tcov.bank_cache_dir().name == "gym_flock_tpu_torch"


# --------------------------------------------------------------------------
# the maps shadow warning
# --------------------------------------------------------------------------


def _shadow_dirs(tmp_path, same: bool):
    hit, lower = tmp_path / "hit", tmp_path / "lower"
    hit.mkdir()
    lower.mkdir()
    np.save(hit / "grid_slice10.npy", np.ones((4, 4), dtype=bool))
    np.save(lower / "grid_slice10.npy", np.ones((4, 4), dtype=bool) if same
            else np.zeros((4, 4), dtype=bool))
    return hit, lower


@pytest.mark.parametrize("same", [False, True])
def test_shadow_warning_where_jax_warns(monkeypatch, tmp_path, same):
    """A hit whose lower-priority copy differs warns once, in both
    packages; an identical copy stays silent."""
    hit, lower = _shadow_dirs(tmp_path, same)
    found = {}
    for mod in (tmaps, jmaps):
        monkeypatch.setattr(mod, "_warned_shadow", set())
        monkeypatch.setattr(mod, "reference_map_dirs", lambda: [hit, lower])
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            assert mod.find_reference_map(10) == str(hit / "grid_slice10.npy")
            mod.find_reference_map(10)
        found[mod] = [str(w.message) for w in rec]
    assert found[tmaps] == found[jmaps]
    assert len(found[tmaps]) == (0 if same else 1)
