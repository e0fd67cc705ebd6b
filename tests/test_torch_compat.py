"""The port's gym-facing entry points (``compat``: the legacy gym 0.11
facade, the Gymnasium single and vector facades), its renderer and its
profiling helpers, on the host (``device="cpu"``).

Held to the port's own env functions from the same generator state (every
array exactly: the facades only batch, cast and fetch), and to the JAX
package's facades where their values do not depend on the random stream:
observation and action shapes, spaces, ``_done_semantics`` for every id,
``FlattenDictWrapper``'s order, ``params_from_cfg``, ``load_cfg_section``
and ``update_state`` (exactly).
"""
import dataclasses

import matplotlib

matplotlib.use("Agg")

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.compat import gym_api as jgym
from gym_flock_tpu.compat import gymnasium_api as jgymnasium
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.compat import (
    FlattenDictWrapper,
    GymnasiumEnv,
    batch_space,
    load_cfg_section,
    make_gymnasium,
    make_gymnasium_vector,
    make_legacy,
)
from gym_flock_tpu_torch.compat.gym_api import fetch, first
from gym_flock_tpu_torch.compat.gymnasium_api import _done_semantics
from gym_flock_tpu_torch.core.spaces import Box, DictSpace, Discrete, MultiDiscrete
from gym_flock_tpu_torch.utils import profiling

torch.set_num_threads(2)

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


def _tree_equal(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b)
        for f in dataclasses.fields(a):
            _tree_equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _shapes(space):
    if hasattr(space, "spaces"):
        return {k: _shapes(v) for k, v in space.spaces.items()}
    return tuple(space.shape)


# --------------------------------------------------------------------------
# the legacy facade
# --------------------------------------------------------------------------


@pytest.mark.parametrize("env_id,kw", [("FlockingRelative-v0", dict(n_agents=20)),
                                       ("Coverage-v0", dict(n_graphs=2)),
                                       ("Shepherding-v0", {}),
                                       ("Mapping-v0", dict(n_agents=8))])
def test_legacy_steps_equal_the_env_functions(env_id, kw):
    """seed/reset/controller/step of the facade equal ``reset_env``,
    ``controller`` and ``step_env`` on a batch of one from a generator
    seeded alike; NumPy out, without the batch axis."""
    legacy = make_legacy(env_id, **CPU, **kw)
    env, params = legacy.env, legacy.params
    legacy.seed(5)
    gen = torch.Generator().manual_seed(5)
    obs = legacy.reset()
    state, want = env.reset_env(gen, params, 1)
    _tree_equal(obs, first(fetch(want)))
    for _ in range(3):
        u = legacy.controller() if env_id != "Coverage-v0" else legacy.controller(greedy=True)
        want_u = env.controller(state, params, gen)
        _tree_equal(u, first(fetch(want_u)))
        obs, r, d, info = legacy.step(u)
        state, want, wr, wd, _ = env.step_env(gen, state, want_u, params)
        _tree_equal(obs, first(fetch(want)))
        assert isinstance(r, float) and isinstance(d, bool) and info == {}
        assert r == float(wr[0]) and d == bool(wd[0])
    _tree_equal(fetch(legacy.state), fetch(state))


@pytest.mark.parametrize("env_id,kw", [("FlockingRelative-v0", dict(n_agents=20)),
                                       ("Coverage-v0", dict(n_graphs=1)),
                                       ("FormationFlying-v0", {}),
                                       ("LQR-v0", {})])
def test_legacy_shapes_and_spaces_equal_jax(env_id, kw):
    jl = jgym.make_legacy(env_id, **kw)
    tl = make_legacy(env_id, **CPU, **kw)
    jl.seed(0)
    tl.seed(0)
    jobs, tobs = jl.reset(), tl.reset()
    assert jax.tree.map(np.shape, jobs) == jax.tree.map(np.shape, tobs)
    jdt = jax.tree.map(lambda x: np.asarray(x).dtype, jobs)
    assert jdt == jax.tree.map(lambda x: x.dtype, tobs)
    ju = jl.controller(greedy=True) if env_id == "Coverage-v0" else jl.controller()
    tu = tl.controller(greedy=True) if env_id == "Coverage-v0" else tl.controller()
    assert np.shape(ju) == np.shape(tu)
    assert _shapes(tl.observation_space) == _shapes(jl.observation_space)
    assert _shapes(tl.action_space) == _shapes(jl.action_space)
    assert tl.keys == jl.keys


def test_legacy_takes_numpy_int64_and_float64_actions():
    cov = make_legacy("Coverage-v0", **CPU, n_graphs=1)
    cov.reset()
    obs, _, _, _ = cov.step(np.zeros((6, 1), dtype=np.int64))
    assert cov.state.robot_loc.dtype == torch.int32
    flock = make_legacy("FlockingRelative-v0", **CPU, n_agents=10)
    flock.reset()
    flock.step(np.zeros((10, 2), dtype=np.float64))
    assert flock.state.x.dtype == torch.float32


def test_coverage_random_and_vrp_controllers():
    env = make_legacy("Coverage-v0", **CPU, n_graphs=1)
    env.seed(1)
    env.reset()
    a = env.controller(random=True)
    assert a.shape == (6, 1) and ((0 <= a) & (a < 4)).all()
    total = 0.0
    for _ in range(4):
        a = env.controller(random=False, greedy=False)
        assert a.shape == (6, 1)
        _, r, _, _ = env.step(a)
        total += r
    assert total >= 0
    obs, r, d = env.observe()
    assert set(obs) == set(env.keys) and r == 0.0


def test_flatten_dict_wrapper_order_equals_jax():
    """The port's wrapper flattens the JAX facade's observation exactly as
    JAX's wrapper does, and its own observation to the reference layout."""
    jl = jgym.make_legacy("Coverage-v0", n_graphs=1)
    jl.seed(0)
    jobs = jl.reset()
    tl = make_legacy("Coverage-v0", **CPU, n_graphs=1)
    np.testing.assert_array_equal(FlattenDictWrapper(tl)._flatten(jobs),
                                  jgym.FlattenDictWrapper(jl)._flatten(jobs))
    flat = FlattenDictWrapper(tl, dict_keys=tl.keys).reset()
    assert flat.shape == (500 * 3 + 2000 * 3 + 1,) and flat.dtype == np.float32
    assert FlattenDictWrapper(tl).params is tl.params
    with pytest.raises(AttributeError):
        FlattenDictWrapper(tl)._nothing


def test_params_from_cfg_and_load_cfg_section_equal_jax(tmp_path):
    cfg = tmp_path / "flock.cfg"
    cfg.write_text("[flock]\ncomm_radius = 1.5\nn_agents = 40\nv_max = 3.0\ndt = 0.05\n"
                   "[other]\nx = 1\n")
    section = load_cfg_section(str(cfg))
    assert section == jgym.load_cfg_section(str(cfg))
    assert load_cfg_section(str(cfg), "other") == jgym.load_cfg_section(str(cfg), "other")
    with pytest.raises(FileNotFoundError):
        load_cfg_section(str(tmp_path / "missing.cfg"))
    jl = jgym.make_legacy("FlockingRelative-v0")
    tl = make_legacy("FlockingRelative-v0", **CPU)
    jp, tp = jl.params_from_cfg(section), tl.params_from_cfg(section)
    for f in ("comm_radius", "n_agents", "v_max", "dt", "r_max_eff", "comm_radius2"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tl.reset()[0].shape == (40, 6)


def test_update_state_snaps_as_jax():
    """From JAX's state carried over, noisy positions (some halfway between
    nodes) snap to the same nodes on the bank's device."""
    jl = jgym.make_legacy("Coverage-v0", n_graphs=1)
    jl.seed(2)
    jl.reset()
    tl = make_legacy("Coverage-v0", **CPU, n_graphs=1)
    tl.reset()
    tl._state = convert.coverage_state_from_numpy(
        jax.tree.map(lambda x: np.asarray(x)[None], jl.state))
    g = int(jl.state.graph)
    pos = np.asarray(jl.params.bank["target_pos"][g])
    mask = np.asarray(jl.params.bank["target_mask"][g])
    rng = np.random.RandomState(0)
    idx = rng.choice(np.nonzero(mask)[0], size=6, replace=False)
    noisy = pos[idx] + rng.uniform(-2.0, 2.0, size=(6, 2))
    noisy[0] = 0.5 * (pos[idx[0]] + pos[idx[1]])  # a tie
    jl.update_state(noisy)
    tl.update_state(noisy)
    np.testing.assert_array_equal(tl.state.robot_loc[0].numpy(), np.asarray(jl.state.robot_loc))
    assert tl.state.robot_loc.dtype == torch.int32
    with pytest.raises(TypeError):
        make_legacy("FlockingRelative-v0", **CPU, n_agents=5).update_state(noisy)


def test_step_before_reset_raises():
    with pytest.raises(RuntimeError, match="reset"):
        make_legacy("FlockingRelative-v0", **CPU, n_agents=5).step(np.zeros((5, 2)))


def test_entry_points_default_to_the_card():
    """Every facade defaults to ``device="cuda"``; without a card each
    raises instead of running on the host."""
    if torch.cuda.is_available():
        assert make_legacy("FlockingRelative-v0", n_agents=8).device.type == "cuda"
        return
    for make in (make_legacy, make_gymnasium):
        with pytest.raises(RuntimeError, match="cuda"):
            make("FlockingRelative-v0", n_agents=8)
    with pytest.raises(RuntimeError, match="cuda"):
        make_gymnasium_vector("FlockingRelative-v0", num_envs=2, n_agents=8)
    with pytest.raises(RuntimeError, match="cuda"):
        make_legacy("Coverage-v0", n_graphs=1)


@pytest.mark.parametrize("env_id", ["FlockingRelative-v0", "Coverage-v0"])
def test_render_rgb_array_frame(env_id):
    env = make_gymnasium(env_id, render_mode="rgb_array", **CPU,
                         **(dict(n_agents=8) if env_id.startswith("Flocking") else
                            dict(n_graphs=1)))
    env.reset(seed=0)
    frame = env.render()
    assert frame.ndim == 3 and frame.shape[2] == 3 and frame.dtype == np.uint8
    assert frame.shape[0] > 10 and frame.shape[1] > 10
    env.close()
    assert make_gymnasium("FlockingRelative-v0", **CPU, n_agents=8).render() is None


def test_frame_writer(tmp_path):
    from gym_flock_tpu_torch.render.plot import FrameWriter, get_renderer

    env = make_legacy("FlockingRelative-v0", **CPU, n_agents=10)
    env.seed(0)
    env.reset()
    writer = FrameWriter(get_renderer(env.env_id, env.env, env.params), str(tmp_path))
    for _ in range(2):
        env.step(env.controller())
        writer.capture(first(fetch(env.state)))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["frame_0000.png", "frame_0001.png"]
    writer.renderer.close()


# --------------------------------------------------------------------------
# the Gymnasium single-env facade
# --------------------------------------------------------------------------


def test_done_semantics_equal_jax_for_every_id():
    assert set(gft.registry) == set(gft_jax.registry)
    for env_id in gft_jax.registry:
        assert _done_semantics(env_id) == jgymnasium._done_semantics(env_id), env_id


def test_gymnasium_step_equals_the_env_functions():
    env = make_gymnasium("FlockingRelative-v0", **CPU, n_agents=12)
    obs, info = env.reset(seed=7)
    assert info == {}
    inner = env.unwrapped
    gen = torch.Generator().manual_seed(7)
    state, want = inner.env.reset_env(gen, inner.params, 1)
    _tree_equal(obs, first(fetch(want)))
    u = env.controller()
    obs, r, term, trunc, info = env.step(u)
    state, want, wr, _, _ = inner.env.step_env(gen, state, torch.from_numpy(u)[None],
                                               inner.params)
    _tree_equal(obs, first(fetch(want)))
    assert r == float(wr[0]) and (term, trunc) == (False, False) and info == {}


def test_gymnasium_terminated_truncated_split():
    # time-driven: the env's own limit and the registration's are truncation
    env = make_gymnasium("FlockingRelative-v0", **CPU, n_agents=10, max_steps=3,
                         max_episode_steps=10)
    env.reset(seed=0)
    flags = [env.step(env.controller())[2:4] for _ in range(3)]
    assert flags == [(False, False), (False, False), (False, True)]
    with pytest.raises(RuntimeError, match="reset"):
        env.step(env.controller())
    env.reset()
    assert env.step(env.controller())[2:4] == (False, False)
    # coverage: the env's done is terminal
    cov = make_gymnasium("Coverage-v0", **CPU, n_graphs=1, max_episode_steps=0,
                         episode_length=3)
    assert cov.max_episode_steps is None
    cov.reset(seed=1)
    flags = [cov.step(cov.controller(greedy=True))[2:4] for _ in range(2)]
    assert flags == [(False, False), (True, False)]
    # mapping (mixed): time is truncation, all observed is terminal
    zero_u = np.zeros((8, 2), dtype=np.float32)
    m = make_gymnasium("Mapping-v0", **CPU, n_agents=8, max_steps=3)
    m.reset(seed=0)
    flags = [m.step(zero_u)[2:4] for _ in range(3)]
    assert flags[-1] == (False, True)
    m2 = make_gymnasium("Mapping-v0", **CPU, n_agents=8, max_steps=100, obs_rad=1e6)
    m2.reset(seed=0)
    assert m2.step(zero_u)[2:4] == (True, False)
    # the registration's limit
    assert make_gymnasium("FlockingRelative-v0", **CPU, n_agents=4).max_episode_steps == 1000


def test_gymnasium_seeding_and_passthroughs():
    a = make_gymnasium("FlockingRelative-v0", **CPU, n_agents=10)
    b = make_gymnasium("FlockingRelative-v0", **CPU, n_agents=10)
    oa, _ = a.reset()
    ob, _ = b.reset()
    assert not np.array_equal(oa[0], ob[0])  # fresh entropy each
    oa2, _ = a.reset()
    assert not np.array_equal(oa[0], oa2[0])  # the stream goes on
    a.reset(seed=3)
    b.reset(seed=3)
    np.testing.assert_array_equal(a.step(a.controller())[0][0], b.step(b.controller())[0][0])
    assert isinstance(a, GymnasiumEnv) and a.params.n_agents == 10
    assert a.keys[0] == "nodes" and a.observation_space is not None
    with pytest.raises(AttributeError):
        a.__getattr__("_missing")


# --------------------------------------------------------------------------
# the Gymnasium vector facade
# --------------------------------------------------------------------------


def test_vector_first_step_equals_step_env():
    """A vector step equals ``step_env`` from the same state and generator
    state; controller() equals the env's controller from it."""
    venv = make_gymnasium_vector("FlockingRelative-v0", num_envs=5, **CPU, n_agents=12)
    obs, _ = venv.reset(seed=4)
    state0 = venv.state
    g0 = venv._gen.get_state()
    u = venv.controller()
    replay = torch.Generator()
    replay.set_state(g0)
    env, params = venv._env, venv.params
    _tree_equal(u, fetch(env.controller(state0, params, replay)))
    g1 = venv._gen.get_state()
    obs, rew, term, trunc, infos = venv.step(u)
    replay.set_state(g1)
    _, want, wr, _, _ = env.step_env(replay, state0, torch.from_numpy(u), params)
    _tree_equal(obs, fetch(want))
    np.testing.assert_array_equal(rew, wr.numpy())
    assert term.dtype == bool and not term.any() and not trunc.any() and infos == {}
    assert obs[0].shape == (5, 12, 6) and u.shape == (5, 12, 2)


def test_vector_same_step_autoreset_masks_and_whole_batch_reset():
    """Envs finishing at different steps: the masks equal term | trunc, the
    finished rows hold the new episode's first observation and their final
    one in ``final_observation``; the other rows go on.  The new episodes
    are rows of ONE batch reset from the generator after the step (the
    whole-batch reset, a deviation from JAX's per-env reset)."""
    B = 6
    venv = make_gymnasium_vector("Coverage-v0", num_envs=B, **CPU, n_graphs=2,
                                 max_episode_steps=4)
    env, params = venv._env, venv.params
    venv.reset(seed=1)
    # stagger the episodes: envs 0-2 are two steps further on
    venv._elapsed = torch.tensor([2, 2, 2, 0, 0, 0], dtype=torch.int32)
    finished = 0
    for t in range(6):
        u = venv.controller()
        state0, g_step = venv.state, venv._gen.get_state()
        obs, rew, term, trunc, infos = venv.step(u)
        replay = torch.Generator()
        replay.set_state(g_step)
        _, step_obs, _, done, _ = env.step_env(replay, state0, torch.from_numpy(u), params)
        mask = term | trunc
        if not mask.any():
            assert infos == {}
            _tree_equal(obs, fetch(step_obs))
            continue
        finished += int(mask.sum())
        np.testing.assert_array_equal(infos["_final_observation"], mask)
        np.testing.assert_array_equal(infos["_final_info"], mask)
        _, reset_obs = env.reset_env(replay, params, B)
        h_step, h_reset = fetch(step_obs), fetch(reset_obs)
        for i in range(B):
            if mask[i]:
                _tree_equal(infos["final_observation"][i], {k: v[i] for k, v in h_step.items()})
                _tree_equal({k: v[i] for k, v in obs.items()},
                            {k: v[i] for k, v in h_reset.items()})
                assert float(obs["step"][i, 0, 0]) == 0.0
            else:
                assert infos["final_observation"][i] is None
                _tree_equal({k: v[i] for k, v in obs.items()},
                            {k: v[i] for k, v in h_step.items()})
        # coverage's own done is terminal, the wrapper's limit truncation
        np.testing.assert_array_equal(term, done.numpy())
    assert finished >= 6


def test_vector_multidiscrete_is_gymnasiums_shape():
    """A deviation kept on purpose: the batched ``MultiDiscrete`` is
    ``[num_envs, len(nvec)]`` (gymnasium's ``batch_space``), where the JAX
    facade flattens it to ``[num_envs * len(nvec)]``."""
    venv = make_gymnasium_vector("Coverage-v0", num_envs=4, **CPU, n_graphs=1)
    space = venv.action_space
    assert isinstance(space, MultiDiscrete) and space.shape == (4, 6)
    from gym_flock_tpu.compat.gymnasium_vector import batch_space as jax_batch_space

    jenv, jp = gft_jax.make("Coverage-v0", n_graphs=1)
    assert jax_batch_space(jenv.action_space(jp), 4).shape == (24,)
    gen = torch.Generator().manual_seed(0)
    sample = space.sample(gen)
    assert sample.shape == (4, 6) and space.contains(sample)
    assert not space.contains(torch.full((4, 6), 4))
    venv.reset(seed=0)
    venv.step(sample.numpy())
    assert batch_space(Discrete(3), 2) == MultiDiscrete((3, 3))
    box = batch_space(Box(-1.0, 1.0, (5, 2)), 3)
    assert box.shape == (3, 5, 2)
    d = batch_space(DictSpace({"a": Box(0.0, 1.0, (2,))}), 7)
    assert d.spaces["a"].shape == (7, 2)


def test_vector_controller_takes_array_options():
    """A deviation kept on purpose: no controller cache, so an array-valued
    option (coverage's ``rand_u``) passes through; JAX's cache keyed on raw
    kwargs cannot hash it."""
    venv = make_gymnasium_vector("Coverage-v0", num_envs=3, **CPU, n_graphs=1)
    venv.reset(seed=0)
    venv._state = dataclasses.replace(venv.state, visited=torch.ones_like(venv.state.visited))
    rand_u = torch.tensor([[0, 1, 2, 3, 0, 1]] * 3, dtype=torch.int32)
    u = venv.controller(rand_u=rand_u)
    assert u.shape == (3, 6, 1)
    np.testing.assert_array_equal(u[..., 0], rand_u.numpy())  # nothing left: all random
    with pytest.raises(TypeError):
        hash(tuple(sorted({"rand_u": np.zeros(3)}.items())))


def test_vector_limits_and_seeded_stream():
    v0 = make_gymnasium_vector("FlockingRelative-v0", num_envs=2, **CPU, n_agents=6,
                               max_episode_steps=0)
    assert v0.max_episode_steps is None
    v2 = make_gymnasium_vector("FlockingRelative-v0", num_envs=2, **CPU, n_agents=6,
                               max_episode_steps=2)
    v2.reset(seed=0)
    flags = [v2.step(v2.controller())[2:4] for _ in range(2)]
    assert not flags[0][1].any() and flags[1][1].all() and not flags[1][0].any()
    a = make_gymnasium_vector("FlockingRelative-v0", num_envs=2, **CPU, n_agents=6)
    b = make_gymnasium_vector("FlockingRelative-v0", num_envs=2, **CPU, n_agents=6)
    a.reset(seed=9)
    b.reset(seed=9)
    np.testing.assert_array_equal(a.reset()[0][0], b.reset()[0][0])
    with pytest.raises(NotImplementedError):
        a.render()


# --------------------------------------------------------------------------
# profiling
# --------------------------------------------------------------------------


def test_profiling_on_the_host(tmp_path):
    env, params = gft.make("FlockingRelative-v0", n_agents=10)
    gen = torch.Generator()

    def run(seed):
        gen.manual_seed(seed)
        state, _ = env.reset_env(gen, params, 2)
        env.expert_rollout(state, params, 4)

    rate = profiling.measure_steps_per_second(run, 4, iters=2, device="cpu")
    assert rate > 0
    with profiling.trace(str(tmp_path)) as prof:
        run(0)
    assert prof is not None and any(tmp_path.iterdir())


@pytest.mark.cuda
def test_profiling_times_with_cuda_events():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    x = torch.zeros(1 << 20, device="cuda")

    def run(seed):
        x.add_(seed)

    assert profiling.measure_steps_per_second(run, 1, iters=3) > 0
