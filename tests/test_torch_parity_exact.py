"""The port's bit-exact parity mode and its NumPy parity resets against the
JAX package's, and the bank builders' default device.

``gym_flock_tpu_torch/compat/parity.py`` is a copy of the JAX package's
host-NumPy module: both are called with the same seeds and must agree bit for
bit.  With ``parity_exact=True`` at float64, FlockingRelative-v0 (centralized
and not), Shepherding-v0 and Mapping-v0 are stepped 50 times under their
experts from the same start state as JAX's ``parity_exact`` mode under x64:
the state, the observation (and the network), the reward and the expert's
action are 0 ulp apart at every step.  JAX runs in x64 only inside those
tests; an autouse fixture keeps it at 32 bits elsewhere.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.compat import parity as jparity
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.compat import make_legacy
from gym_flock_tpu_torch.compat import parity as tparity
from gym_flock_tpu_torch.envs import coverage_graph as tcg
from gym_flock_tpu_torch.envs.mapping import MappingState

torch.set_num_threads(2)

STEPS = 50


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


def _equal(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _coverage_arl_targets():
    rng = np.random.RandomState(3)
    return np.round(rng.uniform(0.0, 200.0, size=(4000, 2)) / 5.0) * 5.0


@pytest.mark.parametrize("name,call", [
    ("flocking", lambda m: m.reference_flocking_reset(
        40, np.sqrt(40.0), 5.0, 0.81, rng=np.random.RandomState(7))),
    ("twoflocks", lambda m: m.reference_twoflocks_reset(rng=np.random.RandomState(4))),
    ("stochastic_dt", lambda m: np.asarray(
        [m.reference_stochastic_dt(np.random.RandomState(5)) for _ in range(3)])),
    ("gym011", lambda m: m.gym011_np_random(123).uniform(size=8)),
    ("shepherding", lambda m: m.reference_shepherding_reset(5)),
    ("coverage", lambda m: np.concatenate([np.ravel(a) for a in m.reference_coverage_reset(
        2, map_rng=np.random.RandomState(9))])),
    ("coverage_arl", lambda m: m.reference_coverage_arl_subgraph(
        _coverage_arl_targets(), map_rng=np.random.RandomState(8))),
])
def test_parity_resets_equal_jax(name, call):
    want, got = call(jparity), call(tparity)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _loop(jenv, jp, jstate, tenv, tp, tstate, obs_names, n_steps=STEPS):
    """``n_steps`` expert steps of both envs: every action, state, observation
    part and reward 0 ulp apart."""
    step, ctrl = jax.jit(jenv.step_env), jax.jit(jenv.controller)
    key = jax.random.key(0)
    for t in range(n_steps):
        ju, tu = ctrl(jstate, jp), tenv.controller(tstate, tp)
        _equal(tu[0], ju, f"action@{t}")
        jstate, jobs, jr, _, _ = step(key, jstate, ju, jp)
        tstate, tobs, tr, _, _ = tenv.step_env(None, tstate, tu, tp)
        _equal(tstate.x[0], jstate.x, f"x@{t}")
        for name, a, b in zip(obs_names, tobs, jobs):
            _equal(a[0], b, f"{name}@{t}")
        _equal(tr[0], jr, f"reward@{t}")
    return tstate


@pytest.mark.parametrize("centralized", [True, False])
def test_flocking_relative_is_bit_exact_with_jax(centralized):
    n = 50
    x0 = jparity.reference_flocking_reset(n, np.sqrt(n), 5.0, 0.81,
                                          rng=np.random.RandomState(7))
    with jax.enable_x64(True):
        jenv, jp = gft_jax.make("FlockingRelative-v0")
        jp = jp.replace(n_agents=n, parity_exact=True, centralized=centralized)
        tenv, tp = gft.make("FlockingRelative-v0", n_agents=n, parity_exact=True,
                            centralized=centralized)
        assert convert.params_from_jax(jp) == tp
        _loop(jenv, jp, jenv.init_state(jnp.asarray(x0), jp),
              tenv, tp, tenv.init_state(torch.from_numpy(x0)[None], tp), ("values", "network"))


def test_shepherding_is_bit_exact_with_jax():
    x0 = jparity.reference_shepherding_reset(5)
    x0[:, 2] = np.random.RandomState(6).uniform(-np.pi, np.pi, size=(30,))
    with jax.enable_x64(True):
        jenv, jp = gft_jax.make("Shepherding-v0")
        jp = jp.replace(parity_exact=True)
        tenv, tp = gft.make("Shepherding-v0", parity_exact=True)
        assert convert.shepherding_params_from_jax(jp) == tp
        _loop(jenv, jp, jenv.init_state(jnp.asarray(x0), jp),
              tenv, tp, tenv.init_state(torch.from_numpy(x0)[None], tp), ("obs", "adj"))


def test_mapping_is_bit_exact_with_jax():
    """From JAX's x64 reset (the reference has no parity reset for mapping):
    the greedy expert's 50 steps, the unobserved mask exactly too."""
    with jax.enable_x64(True):
        jenv, jp = gft_jax.make("Mapping-v0")
        jp = jp.replace(parity_exact=True)
        tenv, tp = gft.make("Mapping-v0", parity_exact=True, device="cpu")
        assert tp.target_x.dtype == torch.float64
        _equal(tp.target_x, jp.target_x, "target_x")
        js, _ = jenv.reset_env(jax.random.key(11), jp)
        ts = MappingState(
            time=torch.zeros(1, dtype=torch.int32),
            **{k: torch.from_numpy(np.array(getattr(js, k)))[None]
               for k in ("x", "unobserved", "last_obs_target")})
        step, ctrl = jax.jit(jenv.step_env), jax.jit(jenv.controller)
        key = jax.random.key(0)
        for t in range(STEPS):
            ju, tu = ctrl(js, jp), tenv.controller(ts, tp)
            _equal(tu[0], ju, f"action@{t}")
            js, (jo, jn), jr, jd, _ = step(key, js, ju, jp)
            ts, (to, tn), tr, td, _ = tenv.step_env(None, ts, tu, tp)
            for name, a, b in (("x", ts.x, js.x), ("obs", to, jo), ("network", tn, jn),
                               ("reward", tr, jr), ("unobserved", ts.unobserved, js.unobserved),
                               ("done", td, jd)):
                _equal(a[0], b, f"{name}@{t}")


def test_parity_mode_reaches_the_params_from_the_entry_points():
    """``make`` and ``make_legacy`` take ``parity_exact`` as JAX's ``make``
    takes it, and the mode is off by default."""
    for env_id in ("FlockingRelative-v0", "Shepherding-v0"):
        assert not gft.make(env_id)[1].parity_exact
        assert gft.make(env_id, parity_exact=True)[1].parity_exact
        assert make_legacy(env_id, device="cpu", parity_exact=True).params.parity_exact
    _, tp = gft.make("Mapping-v0", parity_exact=True, device="cpu")
    assert tp.parity_exact and tp.target_x.dtype == torch.float64
    assert gft.make("Mapping-v0", device="cpu")[1].target_x.dtype == torch.float32
    _, jp = gft_jax.make("FlockingRelative-v0", parity_exact=True)
    assert jp.parity_exact


def test_parity_flocking_step_off_the_mode_differs_only_by_rounding():
    """The exact and the fast flocking paths compute the same function: one
    step of each from the same float64 state agrees to 1e-12."""
    x0 = jparity.reference_flocking_reset(30, np.sqrt(30.0), 5.0, 0.81,
                                          rng=np.random.RandomState(2))
    env, fast = gft.make("FlockingRelative-v0", n_agents=30)
    exact = dataclasses.replace(fast, parity_exact=True)
    state = env.init_state(torch.from_numpy(x0)[None], fast)
    outs = []
    for p in (fast, exact):
        u = env.controller(state, p)
        s2, (v, net), r, _, _ = env.step_env(None, state, u, p)
        outs.append((u, s2.x, v, net, r))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("builder", ["build", "load"])
def test_bank_builders_default_to_the_card(builder, tmp_path):
    """``build_graph_bank`` and ``load_graph_bank`` without ``device=`` put the
    bank on the card, as JAX's ``jnp.asarray`` puts it on the accelerator;
    without a card they raise instead of building on the host."""
    specs = [tcg.build_graph_spec(tcg.gen_grid(16, 5.5), 16, n_robots=2, motion_radius=6.6,
                                  horizon=2)]
    path = str(tmp_path / "bank.npz")
    tcg.save_graph_bank(path, tcg.build_graph_bank(specs, device="cpu"))

    def call():
        if builder == "build":
            return tcg.build_graph_bank(specs)
        return tcg.load_graph_bank(path)

    if torch.cuda.is_available():
        assert call()["graph_cost"].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()
