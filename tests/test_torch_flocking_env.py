"""The port's flocking envs against the JAX package's, from identical states.

Both packages start from the same numpy states (``convert.state_from_numpy``
on the port's side, ``init_state`` under ``jax.vmap`` on the JAX side).
Tolerances: adjacency and degree exactly; feature sums
max |port - jax| / (1 + |jax|) < 1e-4; the mean-pooled network atol 1e-6;
the expert action and rewards atol 1e-4; one Euler step's state atol 1e-5
(the same arithmetic, up to XLA's FMA contraction).  Resets draw from
different random streams, so they are held to the acceptance invariants.

Float64 states run on the CPU as the JAX package runs them under
``jax_enable_x64``: the sums, actions and states to 1e-9 (the x64 parity
tests' tolerance; both sum in f64, in other orders), degrees and
acceptance exactly.
"""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.envs import flocking as jfl
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.core.env import step_autoreset
from gym_flock_tpu_torch.core.spaces import Box
from gym_flock_tpu_torch.envs import flocking as tfl
from gym_flock_tpu_torch.parallel import rollout as tro
from gym_flock_tpu_torch.parallel import train as ttr

torch.set_num_threads(2)

SUM_TOL = 1e-4
NETWORK_ATOL = 1e-6
U_ATOL = 1e-4
STATE_ATOL = 1e-5
X64_TOL = 1e-9
N = 48
B = 3


def grid_swarms(b, n, seed):
    """Jittered-grid swarms: spacing 0.45, jitter +-0.1 (no pair closer than
    0.25, several neighbours within the 0.9 radius), velocities in [-1, 1]."""
    rng = np.random.RandomState(seed)
    side = math.ceil(math.sqrt(n))
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    base = 0.45 * np.stack([gx.ravel(), gy.ravel()], axis=1)[:n]
    x = np.empty((b, n, 4), np.float32)
    for i in range(b):
        x[i, :, :2] = base + rng.uniform(-0.1, 0.1, (n, 2))
        x[i, :, 2:] = rng.uniform(-1.0, 1.0, (n, 2))
    return x


def random_swarms(b, n, seed):
    return np.random.RandomState(seed).randn(b, n, 4).astype(np.float32) * 2


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))


def _params(n=N, **kw):
    jp = jfl.FlockingParams(n_agents=n, **kw)
    return jp, convert.params_from_jax(jp)


@pytest.mark.parametrize("maker", [grid_swarms, random_swarms])
def test_flocking_features_matches_jax(maker):
    x = maker(B, N, seed=1)
    jp, tp = _params()
    values, adj, adj_mean, _ = tfl.flocking_features(torch.from_numpy(x), tp.comm_radius2)
    jv, ja, jm, _ = jax.vmap(lambda s: jfl.flocking_features(s, jp.comm_radius2))(
        jnp.asarray(x)
    )
    np.testing.assert_array_equal(adj.numpy(), np.asarray(ja))
    np.testing.assert_allclose(adj_mean.numpy(), np.asarray(jm), rtol=0, atol=NETWORK_ATOL)
    assert _rel(values.numpy(), jv) < SUM_TOL


@pytest.mark.parametrize("centralized", [True, False])
def test_turner_controller_matches_jax(centralized):
    x = random_swarms(B, N, seed=2)
    jp, tp = _params()
    u = tfl.turner_controller(torch.from_numpy(x), tp, centralized)
    ju = jax.vmap(lambda s: jfl.turner_controller(s, jp, centralized))(jnp.asarray(x))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=U_ATOL)


@pytest.mark.parametrize("centralized", [True, False])
def test_flocking_obs_expert_pass_matches_jax(centralized):
    x = random_swarms(B, N, seed=3)
    jp, tp = _params()
    got = tfl.flocking_obs_expert_pass(torch.from_numpy(x), tp, centralized)
    want = jax.vmap(lambda s: jfl.flocking_obs_expert_pass(s, jp, centralized))(
        jnp.asarray(x)
    )
    values, network, *sums = got
    assert _rel(values.numpy(), want[0]) < SUM_TOL
    np.testing.assert_allclose(network.numpy(), np.asarray(want[1]), rtol=0, atol=NETWORK_ATOL)
    for g, w in zip(sums, want[2:]):
        assert _rel(g.numpy(), w) < SUM_TOL


def test_instant_cost_is_the_population_variance():
    x = random_swarms(B, N, seed=4)
    got = tfl._instant_cost(torch.from_numpy(x)).numpy()
    v = x[..., 2:4].astype(np.float64)
    np.testing.assert_allclose(got, -np.var(v, axis=1, ddof=0).sum(-1), rtol=1e-5)
    want = jax.vmap(jfl._instant_cost)(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=U_ATOL)


@pytest.mark.parametrize("env_id", ["FlockingRelative-v0", "FlockingLarge-v0"])
def test_step_env_matches_jax(env_id):
    x = grid_swarms(B, N, seed=5)
    jenv, jp = gft_jax.make(env_id, n_agents=N)
    tenv, tp = gft.make(env_id, n_agents=N)
    assert tp == convert.params_from_jax(jp)
    tstate = convert.state_from_numpy(x, tp, "cpu")
    jstate = jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(x))
    u = tenv.controller(tstate, tp)
    ju = jax.vmap(lambda s: jenv.controller(s, jp))(jstate)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=U_ATOL)

    gen = torch.Generator().manual_seed(0)
    st, obs, r, done, _ = tenv.step_env(gen, tstate, u, tp)
    jst, jobs, jr, jdone, _ = jax.vmap(
        lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp)
    )(jstate, jnp.asarray(u.numpy()))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=0, atol=STATE_ATOL)
    np.testing.assert_array_equal(st.time.numpy(), np.asarray(jst.time))
    assert _rel(obs[0].numpy(), jobs[0]) < SUM_TOL
    if env_id == "FlockingLarge-v0":
        np.testing.assert_array_equal(obs[1].numpy(), np.asarray(jobs[1]))  # degree
    else:
        np.testing.assert_allclose(obs[1].numpy(), np.asarray(jobs[1]), rtol=0, atol=NETWORK_ATOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=U_ATOL)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


@pytest.mark.parametrize("centralized", [True, False])
def test_large_env_obs_and_controller_match_jax(centralized):
    x = random_swarms(B, N, seed=6)
    jenv, jp = gft_jax.make("FlockingLarge-v0", n_agents=N)
    tenv, tp = gft.make("FlockingLarge-v0", n_agents=N)
    tstate = convert.state_from_numpy(x, tp, "cpu")
    jstate = jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(x))
    values, degree = tenv._obs(tstate, tp)
    jvalues, jdegree = jax.vmap(lambda s: jenv._obs(s, jp))(jstate)
    assert _rel(values.numpy(), jvalues) < SUM_TOL
    np.testing.assert_array_equal(degree.numpy(), np.asarray(jdegree))
    u = tenv.controller(tstate, tp, centralized=centralized)
    ju = jax.vmap(lambda s: jenv.controller(s, jp, centralized=centralized))(jstate)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=U_ATOL)


def _wide_view(seed):
    """``x = wide[..., :4]`` of a ``[2, 256, 5]`` array: not contiguous.
    Returns the numpy view and the torch view of the same numbers."""
    wide = random_swarms(2, 256 * 5 // 4, seed).reshape(2, 256, 5)
    view = wide[..., :4]
    xt = torch.from_numpy(wide)[..., :4]
    assert not xt.is_contiguous()
    return view, xt


@pytest.mark.parametrize("centralized", [True, False])
def test_large_env_takes_a_non_contiguous_state(centralized):
    """``init_state`` of a strided view, then the expert and a fused
    rollout, equal to JAX's on the same numbers."""
    view, xt = _wide_view(40)
    jenv, jp = gft_jax.make("FlockingLarge-v0", n_agents=256)
    tenv, tp = gft.make("FlockingLarge-v0", n_agents=256)
    tstate = tenv.init_state(xt, tp)
    jstate = jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(view))
    u = tenv.controller(tstate, tp, centralized=centralized)
    ju = jax.vmap(lambda s: jenv.controller(s, jp, centralized=centralized))(jstate)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=U_ATOL)
    final, traj = tenv.expert_rollout(tstate, tp, 2, centralized=centralized)
    jfinal, jtraj = jax.vmap(lambda s: jenv.expert_rollout(s, jp, 2, centralized=centralized))(
        jstate)
    np.testing.assert_allclose(final.x.numpy(), np.asarray(jfinal.x), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(traj["u"].numpy(), np.asarray(jtraj["u"]), rtol=0, atol=U_ATOL)
    assert _rel(traj["values"].numpy(), jtraj["values"]) < SUM_TOL
    np.testing.assert_array_equal(traj["network"].numpy(), np.asarray(jtraj["network"]))


@pytest.mark.parametrize("centralized", [True, False])
@pytest.mark.parametrize("env_id, n", [("FlockingLarge-v0", 64), ("FlockingSparse-v0", 256)])
def test_controller_is_the_fused_rollouts_first_action(env_id, n, centralized):
    """``controller()`` is the fused pass then the action hook, as each
    step of ``expert_rollout`` is: bit for bit the rollout's first action."""
    tenv, tp = gft.make(env_id, n_agents=n, centralized=centralized)
    state, _ = tenv.reset_env(torch.Generator().manual_seed(0), tp, B)
    _, traj = tenv.expert_rollout(state, tp, 2)
    assert torch.equal(tenv.controller(state, tp), traj["u"][:, 0])


def test_non_contiguous_state_through_the_batch_rollout_and_the_collect():
    """``batch_expert_rollout(init_state=)`` and
    ``collect_large_flocking_batch(init_state=)`` from a strided view give
    the rollout from the contiguous copy, which equals JAX's."""
    view, xt = _wide_view(41)
    jenv, jp = gft_jax.make("FlockingLarge-v0", n_agents=256)
    tenv, tp = gft.make("FlockingLarge-v0", n_agents=256)
    gen = torch.Generator().manual_seed(0)
    final, traj = tro.batch_expert_rollout(tenv, tp, gen, 2, 2, init_state=tenv.init_state(xt, tp))
    jfinal, jtraj = jax.vmap(lambda s: jenv.expert_rollout(s, jp, 2))(
        jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(view)))
    np.testing.assert_allclose(final.x.numpy(), np.asarray(jfinal.x), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(traj["u"].numpy(), np.asarray(jtraj["u"]), rtol=0, atol=U_ATOL)
    xs, feats, acts = ttr.collect_large_flocking_batch(tenv, tp, gen, 2, 2,
                                                       init_state=tenv.init_state(xt, tp))
    want = ttr.collect_large_flocking_batch(tenv, tp, gen, 2, 2,
                                            init_state=tenv.init_state(xt.contiguous(), tp))
    for got, expect in zip((xs, feats, acts), want):
        assert torch.equal(got, expect)
    np.testing.assert_allclose(acts.view(2, 2, 256, 2)[:, 0].numpy(), np.asarray(jtraj["u"])[:, 0],
                               rtol=0, atol=U_ATOL)


@pytest.mark.parametrize("centralized", [True, False])
def test_large_env_runs_float64_as_jax_x64(centralized):
    """``init_state(x.double())``, then the expert, a step and a fused
    rollout, against JAX under x64 on the same f64 numbers."""
    x = random_swarms(2, 256, 42).astype(np.float64)
    tenv, tp = gft.make("FlockingLarge-v0", n_agents=256)
    tstate = tenv.init_state(torch.from_numpy(x), tp)
    u = tenv.controller(tstate, tp, centralized=centralized)
    st, obs, r, _, _ = tenv.step_env(None, tstate, u, tp)
    final, traj = tenv.expert_rollout(tstate, tp, 2, centralized=centralized)
    with jax.enable_x64(True):
        jenv, jp = gft_jax.make("FlockingLarge-v0", n_agents=256)
        jstate = jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(x))
        ju = jax.vmap(lambda s: jenv.controller(s, jp, centralized=centralized))(jstate)
        jst, jobs, jr, _, _ = jax.vmap(lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp))(
            jstate, jnp.asarray(u.numpy()))
        jfinal, jtraj = jax.vmap(
            lambda s: jenv.expert_rollout(s, jp, 2, centralized=centralized))(jstate)
        want = [np.asarray(v) for v in (ju, jst.x, jobs[0], jobs[1], jr, jfinal.x,
                                         jtraj["u"], jtraj["values"], jtraj["network"])]
    got = [v.numpy() for v in (u, st.x, obs[0], obs[1], r, final.x,
                               traj["u"], traj["values"], traj["network"])]
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and w.dtype == np.float64
        assert _rel(g, w) < X64_TOL
    np.testing.assert_array_equal(got[3], want[3])  # degree
    np.testing.assert_array_equal(got[8], want[8])


def test_reset_runs_under_float64_default_dtype_as_jax_x64():
    """``FlockingRelativeEnv().reset_env`` under float64 as the default
    dtype: its K1 acceptance test and observation in float64, equal to
    JAX's under x64 on the accepted state."""
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        env, params = tfl.FlockingRelativeEnv(), tfl.FlockingParams()
        state, obs = env.reset_env(torch.Generator().manual_seed(4), params, 2)
        x = state.x
        accepted = env._reset_accept(x, params).numpy()
    finally:
        torch.set_default_dtype(previous)
    assert x.dtype == torch.float64 and all(o.dtype == torch.float64 for o in obs)
    with jax.enable_x64(True):
        jenv, jp = gft_jax.make("FlockingRelative-v0")
        xj = jnp.asarray(x.numpy())
        want = np.asarray(jax.vmap(lambda a: jenv._reset_accept(a, jp))(xj))
        jobs = jax.vmap(lambda a: jenv._obs(jenv.init_state(a, jp), jp))(xj)
        jvalues, jnetwork = np.asarray(jobs[0]), np.asarray(jobs[1])
    np.testing.assert_array_equal(accepted, want)
    assert jvalues.dtype == np.float64
    assert _rel(obs[0].numpy(), jvalues) < X64_TOL
    np.testing.assert_allclose(obs[1].numpy(), jnetwork, rtol=0, atol=X64_TOL)


def test_get_stats_matches_jax():
    x = grid_swarms(B, N, seed=7)
    jenv, jp = gft_jax.make("FlockingRelative-v0", n_agents=N)
    tenv, tp = gft.make("FlockingRelative-v0", n_agents=N)
    got = tenv.get_stats(convert.state_from_numpy(x, tp, "cpu"))
    jstate = jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(x))
    want = jax.vmap(jenv.get_stats)(jstate)
    for k in ("vel_diffs", "min_dists"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5)


# ------------------------------------------------------------------- resets


@pytest.mark.parametrize("env_id", ["FlockingRelative-v0", "FlockingLarge-v0"])
def test_reset_invariants(env_id):
    n_envs = 8
    tenv, tp = gft.make(env_id, n_agents=N)
    jenv, jp = gft_jax.make(env_id, n_agents=N)
    gen = torch.Generator().manual_seed(11)
    state, obs = tenv.reset_env(gen, tp, n_envs)
    x = state.x
    assert x.shape == (n_envs, N, 4) and x.dtype == torch.float32
    assert state.time.shape == (n_envs,) and not state.time.any()
    assert state.mean_vel.shape == (n_envs, 2) and state.init_vel.shape == (n_envs, N, 2)
    radius = math.sqrt(tp.r_max_eff)
    assert float(torch.linalg.norm(x[..., :2], dim=-1).max()) <= radius * (1 + 1e-6)
    assert float(x[..., 2:].abs().max()) <= 2 * tp.v_max
    assert 1 <= tenv.last_reset_tries <= tp.max_reset_tries
    # the port's K1 acceptance equals JAX's own _reset_accept on every env
    accepted = tenv._reset_accept(x, tp).numpy()
    want = np.asarray(jax.vmap(lambda a: jenv._reset_accept(a, jp))(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(accepted, want)
    assert accepted.any()
    for got, expect in zip(obs, tenv._obs(state, tp)):
        assert torch.equal(got, expect)


def _draws(env, params, seed, n_envs, count):
    gen = torch.Generator().manual_seed(seed)
    return [env._draw(gen, params, n_envs) for _ in range(count)]


def test_reset_keeps_last_draw_after_max_tries():
    tenv, tp = gft.make("FlockingRelative-v0", n_agents=N, max_reset_tries=3,
                        min_dist_thresh=1e9)
    state, _ = tenv.reset_env(torch.Generator().manual_seed(5), tp, 4)
    assert tenv.last_reset_tries == 3
    assert torch.equal(state.x, _draws(tenv, tp, 5, 4, 3)[-1])


class _ScriptedAccept(tfl.FlockingRelativeEnv):
    """Acceptance masks fixed per try, to pin which draw each env keeps."""

    def __init__(self, masks):
        self.masks = list(masks)

    def _reset_accept(self, x, params):
        return torch.tensor(self.masks.pop(0))


def test_reset_keeps_each_envs_first_accepted_draw():
    tp = tfl.FlockingParams(n_agents=N)
    env = _ScriptedAccept([[False, True, False], [True, True, False], [False, False, True]])
    state, _ = env.reset_env(torch.Generator().manual_seed(9), tp, 3)
    assert env.last_reset_tries == 3 and not env.masks
    d = _draws(env, tp, 9, 3, 3)
    assert torch.equal(state.x[0], d[1][0])
    assert torch.equal(state.x[1], d[0][1])
    assert torch.equal(state.x[2], d[2][2])


def test_step_autoreset_resets_only_done_envs():
    tenv, tp = gft.make("FlockingRelative-v0", n_agents=N, max_steps=4)
    state = convert.state_from_numpy(grid_swarms(3, N, seed=8), tp, "cpu")
    state = dataclasses.replace(state, time=torch.tensor([0, 3, 1], dtype=torch.int32))
    u = tenv.controller(state, tp)
    stepped, step_obs, *_ = tenv.step_env(None, state, u, tp)
    new, obs, r, done, info = step_autoreset(tenv, torch.Generator().manual_seed(1), state, u, tp)
    assert done.tolist() == [False, True, False]
    assert new.time.tolist() == [1, 0, 2]
    assert torch.equal(new.x[[0, 2]], stepped.x[[0, 2]])
    assert not torch.equal(new.x[1], stepped.x[1])
    assert torch.equal(info["terminal_obs"][1], step_obs[1])
    assert torch.equal(obs[0][0], step_obs[0][0])


# ------------------------------------------------------------ API surface


def test_registry_makes_the_ported_ids():
    env, params = gft.make("FlockingRelative-v0")
    assert isinstance(env, tfl.FlockingRelativeEnv) and params.n_agents == 100
    assert params.max_steps == 1000
    env, params = gft.make("FlockingLarge-v0")
    assert isinstance(env, tfl.LargeFlockingEnv) and params.n_agents == 4096
    env, params = gft.make("FlockingSparse-v0")
    assert isinstance(env, tfl.SparseFlockingEnv) and params.n_agents == 16384
    assert params.max_steps == 1000 and params.verlet_skin is None


def test_params_from_jax_maps_every_field():
    jp = jfl.FlockingParams(n_agents=17, comm_radius=1.25, max_reset_tries=5, dt=0.02,
                            verlet_skin=0.5)
    tp = convert.params_from_jax(jp)
    for f in dataclasses.fields(tp):
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    assert tp.r_max_eff == pytest.approx(jp.r_max_eff)
    assert tp.comm_radius2 == jp.comm_radius2


def test_box_sample_and_contains():
    tenv, tp = gft.make("FlockingRelative-v0", n_agents=5)
    space = tenv.action_space(tp)
    a = space.sample(torch.Generator().manual_seed(0), (7,))
    assert a.shape == (7, 5, 2) and float(a.abs().max()) <= tp.max_accel
    assert space.contains(a[0]) and not space.contains(a)
    obs_space = tenv.observation_space(tp)
    assert isinstance(obs_space, Box) and obs_space.shape == (5, 6)
    b = obs_space.sample(torch.Generator().manual_seed(0))
    assert b.shape == (5, 6) and float(b.abs().max()) <= 1.0
