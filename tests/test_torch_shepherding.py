"""The port's Shepherding-v0 against the JAX package's, from identical states.

Tolerances: the expert's line-of-sight branch of every shepherd exactly
(on states whose bearings lie away from the 2- and 5-degree thresholds, as
arctan2 may differ by an ulp between the packages); actions, sheep
velocities and rewards atol 1e-4 (the four branches' actions differ by more
than 0.05); one step's state and observed values atol 1e-5 (the identity
column exactly); the 1/r adjacency's support exactly and its values max
|port - jax| / (1 + |jax|) < 1e-4.  Resets draw from
other random streams and are held to their invariants.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs.shepherding import ShepherdingEnv
from tests.test_torch_flocking_env import STATE_ATOL, SUM_TOL, U_ATOL, _rel

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


S, SHEEP = 10, 20
SHEEP_BRANCH, SHEPHERD_BRANCH, GOAL_BRANCH, NO_BRANCH = 0, 1, 2, 3


def random_states(b, seed):
    """Shepherds and sheep scattered over a 12 x 12 box around the origin,
    random headings: mostly the default arc, some goal and sheep sightings."""
    rng = np.random.RandomState(seed)
    x = np.empty((b, S + SHEEP, 3), np.float32)
    x[..., :2] = rng.uniform(-6.0, 6.0, (b, S + SHEEP, 2))
    x[..., 2] = rng.uniform(-math.pi, math.pi, (b, S + SHEEP))
    return x


def branch_states():
    """Two swarms built to reach every branch of the expert and its skip
    quirk.  Shepherds sit far apart, each heading chosen so that only the
    named target lies in its line of sight, at a bearing of exactly 0 or
    more than 10 degrees away from the threshold.  Returns ``(x, expected
    branches [2, S])``."""
    x = np.zeros((2, S + SHEEP, 3), np.float32)
    # sheep in a tight cluster around (40, 40), nobody looks there by default
    x[:, S:, :2] = 40.0 + np.random.RandomState(0).uniform(-1, 1, (SHEEP, 2))
    x[:, S:, 2] = 0.5
    # shepherds on a ring of radius 25, heading outward and 90 degrees
    # clockwise: no goal, sheep or other shepherd within reach of their sight
    a = np.linspace(0.1, 2 * math.pi + 0.1, S, endpoint=False)
    x[:, :S, 0] = 25.0 * np.cos(a)
    x[:, :S, 1] = 25.0 * np.sin(a)
    x[:, :S, 2] = a - math.pi / 2
    expected = np.full((2, S), NO_BRANCH)
    # swarm 0, shepherd 0: a sheep straight ahead along +x (bearing exactly 0)
    x[0, 0] = (-30.0, 40.5, 0.0)
    x[0, S] = (-20.0, 40.5, 0.0)
    expected[0, 0] = SHEEP_BRANCH
    # shepherd 1 has a zero coordinate (all_nz False) and looks at shepherd 2
    # (all coordinates nonzero): the pair counts
    x[0, 1] = (0.0, -60.0, math.pi / 4)
    x[0, 2] = (7.0, -53.0, 1.0)
    expected[0, 1] = SHEPHERD_BRANCH
    # shepherd 3 (all nonzero) looks at shepherd 4 (all nonzero): the
    # reference skips the pair, so 3 falls through to the default arc
    x[0, 3] = (60.0, -60.0, math.pi / 4)
    x[0, 4] = (67.0, -53.0, 1.0)
    # shepherd 5 points at the goal
    x[0, 5] = (10.0, 10.0, -3 * math.pi / 4)
    expected[0, 5] = GOAL_BRANCH
    # swarm 1, shepherd 6: a sheep 20 degrees off its heading, the goal 30
    # degrees off: the default arc
    x[1, 6] = (-30.0, -30.0, math.pi / 4 + math.radians(30))
    x[1, S] = (-30.0 + 10 * math.cos(math.pi / 4 + math.radians(10)),
               -30.0 + 10 * math.sin(math.pi / 4 + math.radians(10)), 0.5)
    # shepherd 7 looks at the goal, and at a sheep straight behind it: the
    # sheep wins
    x[1, 7] = (-8.0, 0.0, 0.0)
    x[1, S + 1] = (-5.0, 0.0, 0.5)
    expected[1, 7] = SHEEP_BRANCH
    return x, expected


def _pair(x):
    jenv, jp = gft_jax.make("Shepherding-v0")
    tenv, tp = gft.make("Shepherding-v0")
    assert tp == convert.shepherding_params_from_jax(jp)
    tstate = convert.shepherding_state_from_numpy(x, "cpu")
    jstate = jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(x))
    return jenv, jp, jstate, tenv, tp, tstate


def test_expert_reaches_every_branch_and_the_skip_quirk():
    x, expected = branch_states()
    jenv, jp, jstate, tenv, tp, tstate = _pair(x)
    np.testing.assert_array_equal(tenv.los_branches(tstate, tp).numpy(), expected)
    u = tenv.controller(tstate, tp)
    ju = jax.vmap(lambda s: jenv.controller(s, jp))(jstate)
    assert u.shape == (2, S, 2)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=U_ATOL)


def test_shepherd_pair_skip_follows_the_nonzero_flags():
    """The same two shepherds as in ``branch_states``: with both flags True
    the pair is skipped, with shepherd 3's x-coordinate set to 0 it counts."""
    x, _ = branch_states()
    x[0, 3, 0] = 0.0
    x[0, 4, 0] = 7.0
    jenv, jp, jstate, tenv, tp, tstate = _pair(x)
    assert int(tenv.los_branches(tstate, tp)[0, 3]) == SHEPHERD_BRANCH
    ju = jax.vmap(lambda s: jenv.controller(s, jp))(jstate)
    np.testing.assert_allclose(tenv.controller(tstate, tp).numpy(), np.asarray(ju), rtol=0,
                               atol=U_ATOL)


def _clear_of_thresholds(x, margin=1e-4):
    """``[B]``: no bearing difference of the swarm lies within ``margin`` rad
    of 2 or 5 degrees (where an ulp of arctan2 could flip a branch)."""
    sx = x[:, :S]
    targets = np.concatenate([x[:, :, :2], np.zeros((x.shape[0], 1, 2), np.float32)], axis=1)
    d = targets[:, None, :, :] - sx[:, :, None, :2]
    ang = np.arctan2(d[..., 1], d[..., 0]) - sx[:, :, None, 2]
    ang = np.abs(np.arctan2(np.sin(ang), np.cos(ang)))
    near = [np.abs(ang - math.radians(t)).min(axis=(1, 2)) for t in (2.0, 5.0)]
    return (near[0] > margin) & (near[1] > margin)


@pytest.mark.parametrize("seed", [1, 2])
def test_expert_on_random_states_matches_jax(seed):
    x = random_states(64, seed)
    x = x[_clear_of_thresholds(x)]
    assert x.shape[0] >= 48
    jenv, jp, jstate, tenv, tp, tstate = _pair(x)
    u = tenv.controller(tstate, tp)
    ju = jax.vmap(lambda s: jenv.controller(s, jp))(jstate)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=U_ATOL)
    branches = tenv.los_branches(tstate, tp)
    assert set(branches.unique().tolist()) >= {SHEEP_BRANCH, GOAL_BRANCH, NO_BRANCH}


@pytest.mark.parametrize("seed", [3, 4])
def test_step_obs_and_reward_match_jax(seed):
    x = random_states(8, seed)
    x[:4, S:, :2] *= 0.3  # some sheep inside the goal disk
    jenv, jp, jstate, tenv, tp, tstate = _pair(x)
    sheep_u = tenv._sheep_controller(tstate.x, tp)
    jsheep = jax.vmap(lambda a: jenv._sheep_controller(a, jp))(jnp.asarray(x))
    np.testing.assert_allclose(sheep_u.numpy(), np.asarray(jsheep), rtol=0, atol=U_ATOL)
    action = torch.from_numpy(np.random.RandomState(seed).uniform(-2, 2, (8, S, 2))
                              .astype(np.float32))
    st, obs, r, done, _ = tenv.step_env(None, tstate, action, tp)
    jst, jobs, jr, jdone, _ = jax.vmap(
        lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp))(jstate, jnp.asarray(
            action.numpy()))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=0, atol=STATE_ATOL)
    np.testing.assert_array_equal(st.time.numpy(), np.asarray(jst.time))
    np.testing.assert_array_equal(obs[0].numpy()[..., 3], np.asarray(jobs[0])[..., 3])
    np.testing.assert_allclose(obs[0].numpy(), np.asarray(jobs[0]), rtol=0, atol=STATE_ATOL)
    assert _rel(obs[1].numpy(), jobs[1]) < SUM_TOL
    np.testing.assert_array_equal(obs[1].numpy() > 0, np.asarray(jobs[1]) > 0)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=U_ATOL)
    assert float(r[:4].max()) > 0
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_reset_invariants():
    tenv, tp = gft.make("Shepherding-v0")
    state, (values, adj) = tenv.reset_env(torch.Generator().manual_seed(0), tp, 16)
    x = state.x
    assert x.shape == (16, S + SHEEP, 3) and values.shape == (16, S + SHEEP, 4)
    assert adj.shape == (16, S + SHEEP, S + SHEEP)
    gx, gy = tp.goal_offset
    r = torch.sqrt((x[..., 0] - gx) ** 2 + (x[..., 1] - gy) ** 2)
    assert float(r.max()) <= math.sqrt(tp.r_max) * (1 + 1e-6)
    assert not x[..., 2].any() and not state.time.any()
    assert torch.equal(values[..., 3], (torch.arange(S + SHEEP) < S).float().expand(16, -1))
    for got, want in zip((values, adj), tenv._obs(state, tp)):
        assert torch.equal(got, want)


def test_factory_and_spaces_match_jax():
    jenv, jp = gft_jax.make("Shepherding-v0", n_sheep=12)
    tenv, tp = gft.make("Shepherding-v0", n_sheep=12)
    assert isinstance(tenv, ShepherdingEnv) and tp.max_steps == 1000 and tp.n_agents == 22
    assert tp == convert.shepherding_params_from_jax(jp)
    assert tp.goal_offset == pytest.approx(jp.goal_offset)
    assert tenv.observation_space(tp).shape == jenv.observation_space(jp).shape
    assert tenv.action_space(tp).shape == jenv.action_space(jp).shape
