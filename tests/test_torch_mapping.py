"""The port's mapping envs (Mapping-v0, MappingVel-v0, MappingDisc-v0,
MappingLocal-v0) against the JAX package's, from identical states.

Tolerances: target and neighbour selection (the observation's difference
tables at one state), the ``unobserved`` mask, the per-agent credit, done
flags and the adjacency exactly; after a step (whose Euler update XLA may
contract into FMAs) states and observations atol 1e-5, rewards atol 1e-4;
the mean-pooled network atol 1e-6.  Resets draw from other random streams:
the port's reset is held to its invariant (the targets within a sensor's
radius are retired at once, with no reward).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.envs import mapping as jmap
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs import mapping as tmap
from tests.test_torch_flocking_env import NETWORK_ATOL, STATE_ATOL, U_ATOL

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


IDS = ["Mapping-v0", "MappingVel-v0", "MappingDisc-v0", "MappingLocal-v0"]
N = 12
B = 4


def _pair(env_id, seed=0, b=B, **kw):
    """Both envs and a JAX reset carried across (``b`` envs)."""
    jenv, jp = gft_jax.make(env_id, **kw)
    tenv, tp = gft.make(env_id, device="cpu", **kw)
    assert dataclasses.replace(tp, target_x=None) == dataclasses.replace(
        convert.mapping_params_from_jax(jp, "cpu"), target_x=None)
    np.testing.assert_array_equal(tp.target_x.numpy(), np.asarray(jp.target_x))
    keys = jax.random.split(jax.random.key(seed), b)
    jstate, jobs = jax.vmap(lambda k: jenv.reset_env(k, jp))(keys)
    return jenv, jp, jstate, jobs, tenv, tp, convert.mapping_state_from_numpy(jstate, "cpu")


def _obs_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=NETWORK_ATOL)
    np.testing.assert_array_equal(got[1].numpy() > 0, np.asarray(want[1]) > 0)


def _helpers_equal(tstate, tp, jstate, jp):
    got = tmap._mapping_helpers(tstate.x, tstate.unobserved, tp)
    want = jax.vmap(lambda x, u: jmap._mapping_helpers(x, u, jp))(jstate.x, jstate.unobserved)
    _obs_equal(got[:2], want[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # obs_target
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))  # newly
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))  # credit
    return got


def _action(env_id, tp, seed):
    rng = np.random.RandomState(seed)
    if env_id == "MappingDisc-v0":
        return rng.randint(0, tp.nearest_targets, (B, tp.n_agents)).astype(np.int32)
    return rng.uniform(-1.5, 1.5, (B, tp.n_agents, 2)).astype(np.float32)


def _step_equal(tenv, tp, tstate, jenv, jp, jstate, action):
    got = tenv.step_env(None, tstate, torch.from_numpy(action), tp)
    want = jax.vmap(lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp))(
        jstate, jnp.asarray(action))
    st, obs, r, done, _ = got
    jst, jobs, jr, jdone, _ = want
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=0, atol=STATE_ATOL)
    np.testing.assert_array_equal(st.unobserved.numpy(), np.asarray(jst.unobserved))
    np.testing.assert_allclose(st.last_obs_target.numpy(), np.asarray(jst.last_obs_target),
                               rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(obs[0].numpy(), np.asarray(jobs[0]), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(obs[1].numpy(), np.asarray(jobs[1]), rtol=0, atol=NETWORK_ATOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=U_ATOL)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(st.time.numpy(), np.asarray(jst.time))
    return got


@pytest.mark.parametrize("env_id", IDS)
def test_obs_controller_and_step_match_jax(env_id):
    jenv, jp, jstate, jobs, tenv, tp, tstate = _pair(env_id, seed=1, n_agents=N)
    _helpers_equal(tstate, tp, jstate, jp)
    u = tenv.controller(tstate, tp)
    ju = jax.vmap(lambda s: jenv.controller(s, jp))(jstate)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    st, *_ = _step_equal(tenv, tp, tstate, jenv, jp, jstate, _action(env_id, tp, 2))
    # a second step from the same state on both sides
    jst = jax.vmap(lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp))(
        jstate, jnp.asarray(_action(env_id, tp, 2)))[0]
    _step_equal(tenv, tp, st, jenv, jp, jst, _action(env_id, tp, 3))
    assert tenv.observation_space(tp).shape == jenv.observation_space(jp).shape
    assert tenv.action_space(tp).shape == jenv.action_space(jp).shape


@pytest.mark.parametrize("env_id", ["Mapping-v0", "MappingVel-v0"])
def test_rows_with_fewer_unobserved_targets_than_slots(env_id):
    """Three unobserved targets left in env 0, none in env 1: the trailing
    slots of the target table are zero, as JAX's."""
    jenv, jp, jstate, _, tenv, tp, tstate = _pair(env_id, seed=4, n_agents=N)
    unob = np.asarray(jstate.unobserved).copy()
    unob[0] = False
    unob[0, [5, 17, 40]] = True
    unob[1] = False
    jstate = jstate.replace(unobserved=jnp.asarray(unob))
    tstate = dataclasses.replace(tstate, unobserved=torch.from_numpy(unob))
    got = _helpers_equal(tstate, tp, jstate, jp)
    kt = tp.nearest_targets
    table = got[2].reshape(B, tp.n_agents, kt, 2)
    assert table[0, :, 3:].abs().sum() == 0 and table[0, :, :3].abs().sum() > 0
    assert table[1].abs().sum() == 0


def test_lattice_ties_pick_the_lower_index():
    """Agents at the centres of lattice cells and on lattice points: four
    (or two) targets at exactly the same distance; the lower index first,
    as JAX's rounds."""
    # a lattice of spacing exactly 1: -5.5, -4.5, ..., 5.5
    jenv, jp, jstate, _, tenv, tp, tstate = _pair("MappingVel-v0", seed=5, n_agents=N,
                                                  px_max=5.5, py_max=5.5)
    grid = np.asarray(jp.target_x)
    assert grid[1, 0] - grid[0, 0] == 1.0
    step = grid[1, 0] - grid[0, 0]
    x = np.asarray(jstate.x).copy()
    x[:, :, 0:2] = grid[:N] + np.float32(step / 2)  # cell centres (x and y halves)
    x[:, 0:3, 1] = grid[0:3, 1]  # on a row of the lattice: two-way x ties
    unob = np.ones(np.asarray(jstate.unobserved).shape, bool)
    jstate = jstate.replace(x=jnp.asarray(x), unobserved=jnp.asarray(unob))
    tstate = dataclasses.replace(tstate, x=torch.from_numpy(x),
                                 unobserved=torch.from_numpy(unob))
    got = _helpers_equal(tstate, tp, jstate, jp)
    r2 = (got[2].reshape(B, N, tp.nearest_targets, 2) ** 2).sum(-1)
    # four corners at exactly 0.5 from a centre inside the lattice (agent 11's
    # cell lies past its last column)
    assert bool((r2[:, 3:11] == 0.5).all())
    assert bool((r2[:, :3, :2] == 0.25).all())  # two lattice points at 0.25 on a row


def test_disc_out_of_range_index_is_the_zero_action():
    jenv, jp, jstate, _, tenv, tp, tstate = _pair("MappingDisc-v0", seed=6, n_agents=N)
    action = _action("MappingDisc-v0", tp, 7)
    action[0, :4] = [-1, tp.nearest_targets, tp.nearest_targets + 3, -5]
    st, *_ = _step_equal(tenv, tp, tstate, jenv, jp, jstate, action)
    assert torch.equal(st.x[0, :4], tstate.x[0, :4])
    zeros = tenv.controller(tstate, tp)
    assert zeros.shape == (B, N, 1) and zeros.dtype == torch.int32 and not zeros.any()


@pytest.mark.parametrize("env_id", ["Mapping-v0", "MappingLocal-v0"])
def test_reset_retires_the_targets_already_in_sight(env_id):
    tenv, tp = gft.make(env_id, device="cpu", n_agents=N)
    state, (values, network) = tenv.reset_env(torch.Generator().manual_seed(2), tp, 6)
    d2 = ((state.x[:, :, None, :2] - tp.target_x[None, None]) ** 2).sum(-1)
    seen = (d2 < tp.obs_rad2).any(dim=1)
    assert torch.equal(state.unobserved, ~seen) and seen.any()
    assert not state.time.any()
    if tp.double_integrator:
        assert float(state.x[..., 2:].abs().max()) <= tp.v_max
    assert float(state.x[..., 0].abs().max()) <= tp.px_max
    # the cached table is the reset pass's, taken before the retirement
    fresh = tmap._mapping_helpers(state.x, torch.ones_like(state.unobserved), tp)
    assert torch.equal(state.last_obs_target, fresh[2])
    assert torch.equal(values, fresh[0]) and torch.equal(network, fresh[1])


def test_done_when_every_target_is_observed_and_at_the_time_limit():
    jenv, jp, jstate, _, tenv, tp, tstate = _pair("Mapping-v0", seed=8, n_agents=N,
                                                  max_steps=5)
    # env 0: one target left, right under agent 0; env 2: at the step limit
    unob = np.zeros(np.asarray(jstate.unobserved).shape, bool)
    unob[1:] = np.asarray(jstate.unobserved)[1:]
    unob[0, 7] = True
    x = np.asarray(jstate.x).copy()
    x[0, 0, :2] = np.asarray(jp.target_x)[7]
    x[0, :, 2:] = 0.0  # nobody moves: the reward is the one target's
    time = np.zeros(B, np.int32)
    time[2] = 4
    jstate = jstate.replace(unobserved=jnp.asarray(unob), x=jnp.asarray(x),
                            time=jnp.asarray(time))
    tstate = dataclasses.replace(tstate, unobserved=torch.from_numpy(unob),
                                 x=torch.from_numpy(x), time=torch.from_numpy(time))
    action = np.zeros((B, N, 2), np.float32)
    _, _, r, done, _ = _step_equal(tenv, tp, tstate, jenv, jp, jstate, action)
    assert done.tolist() == [True, False, True, False]
    assert float(r[0]) == pytest.approx(tp.reward_scale)


def test_default_size_n100_t10000():
    """Mapping-v0 at its default 100 agents over the 10,000-target lattice."""
    jenv, jp, jstate, jobs, tenv, tp, tstate = _pair("Mapping-v0", seed=9, b=2)
    assert tp.n_agents == 100 and tp.target_x.shape == (10000, 2)
    _helpers_equal(tstate, tp, jstate, jp)
    u = tenv.controller(tstate, tp)
    action = u.numpy() * tp.action_scalar / tp.max_accel
    got = tenv.step_env(None, tstate, torch.from_numpy(action), tp)
    want = jax.vmap(lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp))(
        jstate, jnp.asarray(action))
    np.testing.assert_allclose(got[0].x.numpy(), np.asarray(want[0].x), rtol=0, atol=STATE_ATOL)
    np.testing.assert_array_equal(got[0].unobserved.numpy(), np.asarray(want[0].unobserved))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=U_ATOL)


def test_factory_derives_the_lattice_and_arena():
    for env_id, tracks in [("Mapping-v0", False), ("MappingVel-v0", True),
                           ("MappingDisc-v0", True), ("MappingLocal-v0", True)]:
        jenv, jp = gft_jax.make(env_id, n_agents=9)
        tenv, tp = gft.make(env_id, device="cpu", n_agents=9)
        assert tp.px_max == jp.px_max == (9.0 if tracks else 100.0)
        assert tp.target_x.shape == (81, 2) and tp.target_x.dtype == torch.float32
        np.testing.assert_array_equal(tp.target_x.numpy(), np.asarray(jp.target_x))
        assert gft.registry[env_id].max_episode_steps == 1000
    _, tp = gft.make("MappingVel-v0", device="cpu", n_agents=9, px_max=4.0)
    assert tp.px_max == 4.0 and tp.py_max == 9.0
    assert float(tp.target_x[:, 0].max()) == 4.0
    assert tmap.MappingEnv().default_params(device="cpu").target_x.shape == (10000, 2)
