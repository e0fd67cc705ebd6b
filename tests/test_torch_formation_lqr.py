"""The port's FormationFlying-v0 and LQR-v0 against the JAX package's.

Formation: the fixed reset and the connectivity (nearest neighbour of the
goal coordinates, the lower index first among equal distances) exactly;
step, reward and expert atol 1e-5.

LQR: the system built from the JAX package's node locations.  In float32
(cond(a_sys) = 138.8 for the ``key(0)`` locations) each matrix within
max |port - jax| <= 1e-3 max |jax| (the builds differ by ~5e-5 of it:
``matrix_exp``, ``inv`` and the 50 Riccati sweeps round differently); in
float64 against JAX under x64 within 1e-9 of it.  The port's own system is
held to the invariants: q_sys symmetric, a_net of spectral radius 1.  Step,
reward and expert run on the system carried across from JAX: with the noise
zeroed, the state atol 1e-5 and the reward within 1e-5 relative; the
noise's std within 2% over 409,600 draws.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.envs import lqr as jlqr
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs import lqr as tlqr
from gym_flock_tpu_torch.envs.formation import FormationFlyingEnv
from tests.test_torch_flocking_env import STATE_ATOL

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


LQR_F32_TOL = 1e-3
LQR_X64_TOL = 1e-9
SYSTEM_FIELDS = ("a_net", "a_sys", "b_sys", "q_sys", "r_sys", "std_dev", "k_gain")


# --------------------------------------------------------------- formation


def _formation_pair(x, **kw):
    jenv, jp = gft_jax.make("FormationFlying-v0", **kw)
    tenv, tp = gft.make("FormationFlying-v0", **kw)
    assert tp == convert.formation_params_from_jax(jp)
    tstate = convert.formation_state_from_numpy(x, "cpu")
    jstate = jax.vmap(lambda a: jenv.reset_env(jax.random.key(0), jp)[0].replace(x=a))(
        jnp.asarray(x))
    return jenv, jp, jstate, tenv, tp, tstate


def test_formation_reset_equals_jax():
    jenv, jp = gft_jax.make("FormationFlying-v0")
    tenv, tp = gft.make("FormationFlying-v0")
    state, obs = tenv.reset_env(torch.Generator().manual_seed(0), tp, 4)
    jstate, jobs = jenv.reset_env(jax.random.key(0), jp)
    for b in range(4):
        np.testing.assert_array_equal(state.x[b].numpy(), np.asarray(jstate.x))
        np.testing.assert_array_equal(obs[b].numpy(), np.asarray(jobs))
    assert isinstance(tenv, FormationFlyingEnv) and tp.max_steps == 500


@pytest.mark.parametrize("degree,mean_pooling", [(1, False), (2, False), (2, True)])
def test_formation_connectivity_ties_pick_the_lower_index(degree, mean_pooling):
    """Goals (0, 2), (-2, 2), (2, 2): agent 0 is equally far from 1 and 2,
    and picks 1, as JAX's top_k does."""
    tenv, tp = gft.make("FormationFlying-v0", degree=degree, mean_pooling=mean_pooling)
    state, _ = tenv.reset_env(torch.Generator().manual_seed(0), tp, 2)
    a = tenv.connectivity(state, tp)
    jenv, jp = gft_jax.make("FormationFlying-v0", degree=degree, mean_pooling=mean_pooling)
    want = jenv.connectivity(jenv.reset_env(jax.random.key(0), jp)[0], jp)
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(want))
    np.testing.assert_array_equal(a[1].numpy(), np.asarray(want))
    if degree == 1:
        assert a[0, 0].tolist() == [0.0, 1.0, 0.0]


def test_formation_step_and_expert_match_jax():
    rng = np.random.RandomState(1)
    x = rng.uniform(-3, 3, (5, 3, 4)).astype(np.float32)
    jenv, jp, jstate, tenv, tp, tstate = _formation_pair(x)
    u = tenv.controller(tstate, tp)
    ju = jax.vmap(lambda s: jenv.controller(s, jp))(jstate)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=STATE_ATOL)
    action = rng.uniform(-1, 1, (5, 6)).astype(np.float32)  # the flat (2n,) action
    st, obs, r, done, _ = tenv.step_env(None, tstate, torch.from_numpy(action), tp)
    jst, jobs, jr, jdone, _ = jax.vmap(
        lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp))(jstate, jnp.asarray(action))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=STATE_ATOL, atol=STATE_ATOL)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tenv.connectivity(tstate, tp).numpy(),
                                  np.asarray(jax.vmap(lambda s: jenv.connectivity(s, jp))(
                                      jstate)))
    assert tenv.action_space(tp).shape == jenv.action_space(jp).shape == (6,)


# --------------------------------------------------------------------- LQR


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_locations(dtype):
    jp = jlqr.LQRParams()
    return np.asarray(jp.alpha * jax.random.uniform(jax.random.key(0), (jp.n_nodes, 2),
                                                    dtype=dtype))


def test_lqr_system_from_jax_locations_f32():
    jp = jlqr.LQRParams()
    js = jlqr.build_lqr_system(jax.random.key(0), jp)
    loc = _jax_locations(jnp.float32)
    a = np.exp(-0.5 * ((loc[:, None] - loc[None]) ** 2).sum(-1).astype(np.float64))
    np.fill_diagonal(a, 0.0)
    assert np.linalg.cond(a) < 1e3  # the f32 builds are comparable
    ts = tlqr.lqr_system_from_locations(torch.from_numpy(loc.copy()), tlqr.LQRParams())
    for name in SYSTEM_FIELDS:
        assert _rel_max(getattr(ts, name).numpy(), getattr(js, name)) <= LQR_F32_TOL, name


def test_lqr_system_from_jax_locations_x64():
    with jax.enable_x64(True):
        jp = jlqr.LQRParams()
        js = jlqr.build_lqr_system(jax.random.key(0), jp)
        loc = _jax_locations(jnp.float64)
        want = {name: np.asarray(getattr(js, name)) for name in SYSTEM_FIELDS}
    ts = tlqr.lqr_system_from_locations(torch.from_numpy(loc.copy()), tlqr.LQRParams())
    for name in SYSTEM_FIELDS:
        got = getattr(ts, name)
        assert got.dtype == torch.float64
        assert _rel_max(got.numpy(), want[name]) <= LQR_X64_TOL, name


def _spectral_radius(a):
    return float(torch.linalg.eigvals(a.double()).abs().max())


@pytest.mark.parametrize("seed", [0, 7])
def test_lqr_own_system_invariants(seed):
    env, params = gft.make("LQR-v0", device="cpu", seed=seed)
    sys = params.system
    assert params.max_steps == 1000 and sys.a_net.shape == (100, 100)
    assert torch.equal(sys.q_sys, sys.q_sys.T)
    assert abs(_spectral_radius(sys.a_net) - 1.0) < 1e-5
    assert int((sys.a_net > 0).sum(dim=-1).max()) <= params.degree
    assert float(sys.std_dev) > 0
    _, again = gft.make("LQR-v0", device="cpu", seed=seed)
    for name in SYSTEM_FIELDS:
        assert torch.equal(getattr(again.system, name), getattr(sys, name))
    _, other = gft.make("LQR-v0", device="cpu", seed=seed + 1)
    assert not torch.equal(other.system.a_net, sys.a_net)


def _lqr_pair(x, zero_noise):
    jenv, jp = gft_jax.make("LQR-v0")
    if zero_noise:
        jp = jp.replace(system=jp.system.replace(std_dev=jnp.float32(0.0)))
    tp = convert.lqr_params_from_jax(jp, "cpu")
    tenv = tlqr.LQREnv()
    tstate = convert.lqr_state_from_numpy(x, "cpu")
    jstate = jax.vmap(lambda a: jenv.reset_env(jax.random.key(0), jp)[0].replace(x=a))(
        jnp.asarray(x))
    return jenv, jp, jstate, tenv, tp, tstate


def test_lqr_step_and_expert_match_jax_without_noise():
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (6, 100, 1)).astype(np.float32)
    jenv, jp, jstate, tenv, tp, tstate = _lqr_pair(x, zero_noise=True)
    u = tenv.controller(tstate, tp)
    ju = jax.vmap(lambda s: jenv.controller(s, jp))(jstate)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=STATE_ATOL)
    action = rng.uniform(-1, 1, (6, 100, 1)).astype(np.float32)
    st, obs, r, done, _ = tenv.step_env(torch.Generator().manual_seed(0), tstate,
                                        torch.from_numpy(action), tp)
    jst, jobs, jr, jdone, _ = jax.vmap(
        lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp))(jstate, jnp.asarray(action))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(obs[0].numpy(), np.asarray(jobs[0]), rtol=0, atol=STATE_ATOL)
    np.testing.assert_array_equal(obs[1].numpy(), np.asarray(jobs[1]))
    assert obs[1].stride(0) == 0  # the shared network, expanded
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_lqr_noise_std():
    jenv, jp, _, tenv, tp, _ = _lqr_pair(np.zeros((1, 100, 1), np.float32), zero_noise=False)
    b = 4096
    state = tenv.init_state(torch.zeros(b, 100, 1), tp)
    st, *_ = tenv.step_env(torch.Generator().manual_seed(1), state, torch.zeros(b, 100, 1), tp)
    std = float(st.x.std())
    assert abs(std / float(jp.system.std_dev) - 1.0) < 0.02
    assert abs(float(st.x.mean())) < 3 * std / np.sqrt(st.x.numel())


def test_lqr_reset_and_params_from_jax():
    jenv, jp = gft_jax.make("LQR-v0")
    tp = convert.lqr_params_from_jax(jp, "cpu")
    assert dataclasses.replace(tp, system=None) == dataclasses.replace(
        tlqr.LQRParams(), system=None)
    # a hand-built JAX system without a gain gets the recomputed one
    no_gain = convert.lqr_params_from_jax(jp.replace(system=jp.system.replace(k_gain=None)),
                                          "cpu")
    assert _rel_max(no_gain.system.k_gain.numpy(), jp.system.k_gain) <= LQR_F32_TOL
    state, (x, a_net) = tlqr.LQREnv().reset_env(torch.Generator().manual_seed(3), tp, 8)
    assert x.shape == (8, 100, 1) and float(x.abs().max()) <= tp.x_max
    assert a_net.shape == (8, 100, 100) and not state.time.any()
    assert tlqr.LQREnv().observation_space(tp).shape == jenv.observation_space(jp).shape


def test_lqr_and_mapping_default_to_the_card():
    """Without ``device=`` the factories put their tensors on the card: here
    that raises when torch has no card, and lands on cuda where it has."""
    for env_id in ("LQR-v0", "Mapping-v0"):
        if torch.cuda.is_available():
            _, params = gft.make(env_id)
            t = params.system.a_net if env_id == "LQR-v0" else params.target_x
            assert t.device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                gft.make(env_id)
