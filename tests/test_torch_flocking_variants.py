"""The port's five flocking variants (``Flocking-v0``, ``FlockingLeader-v0``,
``FlockingObstacle-v0``, ``FlockingStochastic-v0``, ``FlockingTwoFlocks-v0``)
against the JAX package's, from identical states.

Tolerances, as ``tests/test_torch_flocking_env.py``: adjacency, neighbour
indices and done flags exactly; feature sums and potentials max |port - jax|
/ (1 + |jax|) < 1e-4; the mean-pooled network atol 1e-6; actions and
rewards atol 1e-4; states atol 1e-5.  The absolute observation (differences
to the 7 nearest, lower index first among equal distances) exactly.  The
drawn resets (Absolute, Leader, Stochastic) come from other random streams
and are held to the acceptance invariants; the deterministic ones
(Obstacle, and TwoFlocks' positions) exactly.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.utils import formations as jformations
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs import flocking as tfl
from gym_flock_tpu_torch.utils import formations as tformations
from tests.test_torch_flocking_env import (
    NETWORK_ATOL, STATE_ATOL, SUM_TOL, U_ATOL, _rel, grid_swarms, random_swarms)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


N = 48
B = 3
VARIANTS = ["Flocking-v0", "FlockingLeader-v0", "FlockingObstacle-v0",
            "FlockingStochastic-v0", "FlockingTwoFlocks-v0"]
DETERMINISTIC = ["Flocking-v0", "FlockingLeader-v0", "FlockingObstacle-v0",
                 "FlockingTwoFlocks-v0"]


def _pair(env_id, x):
    jenv, jp = gft_jax.make(env_id, n_agents=N)
    tenv, tp = gft.make(env_id, n_agents=N)
    assert tp == convert.params_from_jax(jp)
    tstate = convert.state_from_numpy(x, tp, "cpu")
    jstate = jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(x))
    return jenv, jp, jstate, tenv, tp, tstate


def _check_obs(env_id, got, want):
    if env_id == "Flocking-v0":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    else:
        assert _rel(got[0].numpy(), want[0]) < SUM_TOL
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=NETWORK_ATOL)


@pytest.mark.parametrize("env_id", VARIANTS)
def test_variant_obs_matches_jax(env_id):
    x = grid_swarms(B, N, seed=21)
    jenv, jp, jstate, tenv, tp, tstate = _pair(env_id, x)
    _check_obs(env_id, tenv._obs(tstate, tp), jax.vmap(lambda s: jenv._obs(s, jp))(jstate))
    assert tenv.observation_space(tp).shape == jenv.observation_space(jp).shape


@pytest.mark.parametrize("centralized", [True, False])
@pytest.mark.parametrize("env_id", VARIANTS)
def test_variant_controller_matches_jax(env_id, centralized):
    x = random_swarms(B, N, seed=22)
    jenv, jp, jstate, tenv, tp, tstate = _pair(env_id, x)
    u = tenv.controller(tstate, tp, centralized=centralized)
    ju = jax.vmap(lambda s: jenv.controller(s, jp, centralized=centralized))(jstate)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=U_ATOL)


def _check_step(env_id, got, want):
    st, obs, r, done, _ = got
    jst, jobs, jr, jdone, _ = want
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=0, atol=STATE_ATOL)
    np.testing.assert_array_equal(st.time.numpy(), np.asarray(jst.time))
    if env_id == "Flocking-v0":  # the table of a state that differs by rounding
        np.testing.assert_allclose(obs[0].numpy(), np.asarray(jobs[0]), rtol=0, atol=STATE_ATOL)
        np.testing.assert_allclose(obs[1].numpy(), np.asarray(jobs[1]), rtol=0,
                                   atol=NETWORK_ATOL)
    else:
        _check_obs(env_id, obs, jobs)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=U_ATOL)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


@pytest.mark.parametrize("env_id", DETERMINISTIC)
def test_variant_step_env_matches_jax(env_id):
    x = grid_swarms(B, N, seed=23)
    jenv, jp, jstate, tenv, tp, tstate = _pair(env_id, x)
    u = tenv.controller(tstate, tp)
    got = tenv.step_env(None, tstate, u, tp)
    want = jax.vmap(lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp))(
        jstate, jnp.asarray(u.numpy()))
    _check_step(env_id, got, want)
    if env_id in ("FlockingLeader-v0", "FlockingObstacle-v0"):
        frozen = tp.n_leaders if env_id == "FlockingLeader-v0" else tp.n_obstacles
        # frozen agents keep their velocity
        assert torch.equal(got[0].x[:, :frozen, 2:4], tstate.x[:, :frozen, 2:4])


def test_stochastic_step_with_jax_dt():
    """``step_env`` of JAX with one key an env, and ``step_with_dt`` of the
    port fed the dts those keys drew, as a ``[B]`` tensor; then one float
    dt for the whole batch."""
    x = grid_swarms(B, N, seed=24)
    jenv, jp, jstate, tenv, tp, tstate = _pair("FlockingStochastic-v0", x)
    u = tenv.controller(tstate, tp)
    assert float(u.abs().max()) <= tp.stoch_max_accel
    keys = jax.random.split(jax.random.key(3), B)
    want = jax.vmap(lambda k, s, a: jenv.step_env(k, s, a, jp))(keys, jstate,
                                                               jnp.asarray(u.numpy()))
    dts = np.array(jax.vmap(lambda k: jp.dt_mean + jp.dt_sigma * jax.random.normal(k, ()))(
        keys))
    got = tenv.step_with_dt(tstate, u, torch.from_numpy(dts), tp)
    _check_step("FlockingStochastic-v0", got, want)
    want1 = jax.vmap(lambda s, a: jenv.step_with_dt(s, a, 0.11, jp))(jstate,
                                                                      jnp.asarray(u.numpy()))
    _check_step("FlockingStochastic-v0", tenv.step_with_dt(tstate, u, 0.11, tp), want1)


@pytest.mark.parametrize("centralized", [True, False])
@pytest.mark.parametrize("env_id", DETERMINISTIC)
def test_variant_fused_rollout_matches_jax(env_id, centralized):
    x = grid_swarms(B, N, seed=25)
    jenv, jp, jstate, tenv, tp, tstate = _pair(env_id, x)
    final, traj = tenv.expert_rollout(tstate, tp, 4, centralized=centralized)
    jfinal, jtraj = jax.vmap(lambda s: jenv.expert_rollout(s, jp, 4, centralized=centralized))(
        jstate)
    np.testing.assert_allclose(final.x.numpy(), np.asarray(jfinal.x), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(traj["u"].numpy(), np.asarray(jtraj["u"]), rtol=0, atol=U_ATOL)
    np.testing.assert_allclose(traj["reward"].numpy(), np.asarray(jtraj["reward"]), rtol=0,
                               atol=U_ATOL)
    if env_id == "Flocking-v0":
        np.testing.assert_allclose(traj["values"].numpy(), np.asarray(jtraj["values"]), rtol=0,
                                   atol=STATE_ATOL)
    else:
        assert _rel(traj["values"].numpy(), jtraj["values"]) < SUM_TOL
    np.testing.assert_allclose(traj["network"].numpy(), np.asarray(jtraj["network"]), rtol=0,
                               atol=NETWORK_ATOL)


def test_stochastic_rollout_replays_the_step_loop():
    """The fused rollout draws one ``randn(B)`` a step from its generator and
    nothing else: replaying those dts through ``controller`` and
    ``step_with_dt`` from the same seed gives its actions and states."""
    x = grid_swarms(B, N, seed=26)
    tenv, tp = gft.make("FlockingStochastic-v0", n_agents=N)
    state = convert.state_from_numpy(x, tp, "cpu")
    final, traj = tenv.expert_rollout(state, tp, 4, generator=torch.Generator().manual_seed(8))
    replay = torch.Generator().manual_seed(8)
    for t in range(4):
        u = tenv.controller(state, tp)
        np.testing.assert_allclose(traj["u"][:, t].numpy(), u.numpy(), rtol=0, atol=U_ATOL)
        dt = tp.dt_mean + tp.dt_sigma * torch.randn((B,), generator=replay)
        state, obs, r, _, _ = tenv.step_with_dt(state, u, dt, tp)
        np.testing.assert_allclose(traj["reward"][:, t].numpy(), r.numpy(), rtol=0, atol=U_ATOL)
        assert _rel(traj["values"][:, t].numpy(), obs[0].numpy()) < SUM_TOL
    np.testing.assert_allclose(final.x.numpy(), state.x.numpy(), rtol=0, atol=STATE_ATOL)
    # the default generator is a fresh one seeded 0
    again, _ = tenv.expert_rollout(convert.state_from_numpy(x, tp, "cpu"), tp, 2)
    seeded, _ = tenv.expert_rollout(convert.state_from_numpy(x, tp, "cpu"), tp, 2,
                                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.x, seeded.x)


def _check_traj_step(traj, t, ju, jobs, jr, degree):
    """Step ``t`` of the port's trajectory against JAX's action, observation
    and reward of the same step."""
    np.testing.assert_allclose(traj["u"][:, t].numpy(), np.asarray(ju), rtol=0, atol=U_ATOL)
    assert _rel(traj["values"][:, t].numpy(), jobs[0]) < SUM_TOL
    if degree:
        np.testing.assert_array_equal(traj["network"][:, t].numpy(), np.asarray(jobs[1]))
    else:
        np.testing.assert_allclose(traj["network"][:, t].numpy(), np.asarray(jobs[1]), rtol=0,
                                   atol=NETWORK_ATOL)
    np.testing.assert_allclose(traj["reward"][:, t].numpy(), np.asarray(jr), rtol=0, atol=U_ATOL)


@pytest.mark.parametrize("env_id", ["FlockingRelative-v0", "FlockingLeader-v0",
                                    "FlockingLarge-v0"])
def test_preallocated_trajectory_matches_jax_step_by_step(env_id):
    """The rollout's trajectory, allocated before its first step and filled
    slot by slot (the dense pass writes into its slots, the large env's
    outputs are copied), slot for slot JAX's ``expert_rollout`` at B=2 over
    3 steps."""
    x = grid_swarms(2, N, seed=29)
    jenv, jp, jstate, tenv, tp, tstate = _pair(env_id, x)
    final, traj = tenv.expert_rollout(tstate, tp, 3)
    jfinal, jtraj = jax.vmap(lambda s: jenv.expert_rollout(s, jp, 3))(jstate)
    network = (2, 3, N) if env_id == "FlockingLarge-v0" else (2, 3, N, N)
    assert [(k, tuple(v.shape)) for k, v in traj.items()] == [
        ("u", (2, 3, N, 2)), ("values", (2, 3, N, 6)), ("network", network), ("reward", (2, 3))]
    for t in range(3):
        _check_traj_step(traj, t, jtraj["u"][:, t], (jtraj["values"][:, t],
                         jtraj["network"][:, t]), jtraj["reward"][:, t],
                         degree=env_id == "FlockingLarge-v0")
    np.testing.assert_allclose(final.x.numpy(), np.asarray(jfinal.x), rtol=0, atol=STATE_ATOL)


def test_stochastic_preallocated_trajectory_matches_jax_steps_at_its_dts():
    """FlockingStochastic's rollout against JAX's controller and
    ``step_with_dt`` driven by the dts that the rollout's generator drew,
    slot by slot, at B=2 over 3 steps."""
    x = grid_swarms(2, N, seed=30)
    jenv, jp, jstate, tenv, tp, tstate = _pair("FlockingStochastic-v0", x)
    final, traj = tenv.expert_rollout(tstate, tp, 3, generator=torch.Generator().manual_seed(9))
    replay = torch.Generator().manual_seed(9)
    for t in range(3):
        dt = jnp.asarray(tenv._draw_dt(replay, tp, tstate.x).numpy())
        ju = jax.vmap(lambda s: jenv.controller(s, jp))(jstate)
        jstate, jobs, jr, _, _ = jax.vmap(lambda s, a, d: jenv.step_with_dt(s, a, d, jp))(
            jstate, ju, dt)
        _check_traj_step(traj, t, ju, jobs, jr, degree=False)
    np.testing.assert_allclose(final.x.numpy(), np.asarray(jstate.x), rtol=0, atol=STATE_ATOL)


@pytest.mark.parametrize("env_id", ["FlockingRelative-v0", "FlockingObstacle-v0"])
def test_potential_matches_jax(env_id):
    x = grid_swarms(B, N, seed=27)
    jenv, jp, jstate, tenv, tp, tstate = _pair(env_id, x)
    got = tenv.potential(tstate, tp)
    want = jax.vmap(lambda s: jenv.potential(s, jp))(jstate)
    assert got.shape == (B,)
    assert _rel(got.numpy(), want) < SUM_TOL


# ------------------------------------------------------------------- resets


@pytest.mark.parametrize("env_id", ["Flocking-v0", "FlockingLeader-v0", "FlockingStochastic-v0"])
def test_drawn_reset_invariants(env_id):
    """The rejection reset the variants inherit: its K1 acceptance equals
    JAX's own ``_reset_accept`` on every env."""
    jenv, jp = gft_jax.make(env_id, n_agents=N)
    tenv, tp = gft.make(env_id, n_agents=N, max_reset_tries=8)
    state, obs = tenv.reset_env(torch.Generator().manual_seed(12), tp, 6)
    assert state.x.shape == (6, N, 4) and 1 <= tenv.last_reset_tries <= 8
    x = state.x
    if env_id == "FlockingLeader-v0":  # the acceptance ran before the override
        x = torch.cat((x[..., :2], state.init_vel), dim=-1)
    accepted = tenv._reset_accept(x, tp).numpy()
    want = np.asarray(jax.vmap(lambda a: jenv._reset_accept(a, jp))(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(accepted, want)
    assert obs[0].shape == (6,) + tuple(tenv.observation_space(tp).shape)


def test_leader_reset_returns_the_stale_observation():
    """One uniform leader velocity a swarm, in both components; the
    observation, ``mean_vel`` and ``init_vel`` from before that override,
    as the JAX package's reset returns them."""
    tenv, tp = gft.make("FlockingLeader-v0", n_agents=N)
    state, obs = tenv.reset_env(torch.Generator().manual_seed(13), tp, 4)
    lead = state.x[:, :tp.n_leaders, 2:4]
    assert torch.equal(lead, lead[:, :1, :1].expand_as(lead))
    assert float(lead.abs().max()) <= tp.v_max
    assert not torch.equal(lead, state.init_vel[:, :tp.n_leaders])
    drawn = dataclasses.replace(state, x=torch.cat((state.x[..., :2], state.init_vel), dim=-1))
    for got, want in zip(obs, tenv._obs(drawn, tp)):
        assert torch.equal(got, want)
    assert torch.equal(state.mean_vel, state.init_vel.mean(dim=-2))
    assert not torch.equal(obs[0], tenv._obs(state, tp)[0])
    # the JAX reset has the same three properties
    jenv, jp = gft_jax.make("FlockingLeader-v0", n_agents=N)
    jstate, jobs = jenv.reset_env(jax.random.key(1), jp)
    jlead = np.asarray(jstate.x[:jp.n_leaders, 2:4])
    assert np.all(jlead == jlead[0, 0])
    jdrawn = jstate.replace(x=jnp.concatenate((jstate.x[:, :2], jstate.init_vel), axis=1))
    np.testing.assert_array_equal(np.asarray(jobs[0]), np.asarray(jenv._obs(jdrawn, jp)[0]))


def test_obstacle_reset_equals_jax():
    jenv, jp = gft_jax.make("FlockingObstacle-v0", n_agents=N)
    tenv, tp = gft.make("FlockingObstacle-v0", n_agents=N)
    state, obs = tenv.reset_env(torch.Generator().manual_seed(0), tp, 2)
    jstate, jobs = jenv.reset_env(jax.random.key(0), jp)
    assert tenv.last_reset_tries == 0
    for b in range(2):
        np.testing.assert_array_equal(state.x[b].numpy(), np.asarray(jstate.x))
        np.testing.assert_array_equal(state.mean_vel[b].numpy(), np.asarray(jstate.mean_vel))
        np.testing.assert_array_equal(state.init_vel[b].numpy(), np.asarray(jstate.init_vel))
        np.testing.assert_array_equal(obs[1][b].numpy(), np.asarray(jobs[1]))
        assert _rel(obs[0][b].numpy(), jobs[0]) < SUM_TOL


def test_twoflocks_reset_positions_equal_jax():
    jenv, jp = gft_jax.make("FlockingTwoFlocks-v0", n_agents=N)
    tenv, tp = gft.make("FlockingTwoFlocks-v0", n_agents=N)
    state, obs = tenv.reset_env(torch.Generator().manual_seed(5), tp, 4)
    jstate, _ = jenv.reset_env(jax.random.key(5), jp)
    x = state.x
    for b in range(4):
        np.testing.assert_array_equal(x[b, :, :2].numpy(), np.asarray(jstate.x[:, :2]))
    bias = x[..., 2:4] + x[..., 0:2]  # velocity = -grid + one bias a swarm
    np.testing.assert_allclose(bias.numpy(), bias[:, :1].expand_as(bias).numpy(), rtol=0,
                               atol=STATE_ATOL)
    assert float(bias.abs().max()) <= tp.v_bias / 2.0 + STATE_ATOL
    assert not torch.equal(bias[0, 0], bias[1, 0])
    for got, want in zip(obs, tenv._obs(state, tp)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,side", [(48, 5), (50, 5), (100, 10), (4, 2), (7, 3)])
def test_formations_equal_jax(n, side):
    np.testing.assert_array_equal(tformations.grid(n, side), jformations.grid(n, side))
    for got, want in zip(tformations.circle(n), jformations.circle(n)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tformations.twoflocks(n), jformations.twoflocks(n)):
        np.testing.assert_array_equal(got, want)


def test_absolute_neighbours_take_the_lower_index_on_ties():
    """Agents 1 and 2 equally far from agent 0 (and 3, 4 likewise): the
    lower index comes first, as ``jax.lax.top_k`` orders them."""
    x = np.zeros((1, 9, 4), np.float32)
    x[0, :, 0] = [0.0, 1.0, -1.0, 2.0, -2.0, 3.0, -3.0, 4.0, -4.0]
    x[0, :, 2] = np.arange(9)
    jenv, jp = gft_jax.make("Flocking-v0", n_agents=9, n_neighbors=4)
    tenv, tp = gft.make("Flocking-v0", n_agents=9, n_neighbors=4)
    got = tenv._obs(convert.state_from_numpy(x, tp, "cpu"), tp)[0]
    want = jenv._obs(jenv.init_state(jnp.asarray(x[0]), jp), jp)[0]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    # agent 0's neighbours in order: 1, 2, 3, 4 (velocity column = -index)
    assert got[0, 0, 2::4].tolist() == [-1.0, -2.0, -3.0, -4.0]


def test_variant_ids_and_spaces():
    for env_id, cls, steps in [("Flocking-v0", tfl.FlockingAbsoluteEnv, 1000),
                               ("FlockingLeader-v0", tfl.FlockingLeaderEnv, 200),
                               ("FlockingObstacle-v0", tfl.FlockingObstacleEnv, 200),
                               ("FlockingStochastic-v0", tfl.FlockingStochasticEnv, 500),
                               ("FlockingTwoFlocks-v0", tfl.FlockingTwoFlocksEnv, 500)]:
        env, params = gft.make(env_id)
        jenv, jp = gft_jax.make(env_id)
        assert isinstance(env, cls) and params.max_steps == steps
        assert params == convert.params_from_jax(jp)
        assert env.observation_space(params).shape == jenv.observation_space(jp).shape
