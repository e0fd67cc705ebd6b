"""The port's FlockingMulti-v0 against the JAX package's.

The aggregation runs on K2's plain version here (a CPU tensor): its degree
equals the JAX package's dense adjacency's exactly, and the aggregated
buffer is held to JAX's dense form within max |port - jax| / (1 + |jax|) <
1e-4 (the feature sums' tolerance; K2's plain version sums in f64, XLA's
matmul in f32).  One step with the noise zeroed: state atol 1e-5, buffer
and observation as the aggregation, reward atol 1e-4; the noise's std
within 2% over 327,680 draws.  Resets draw from other random streams and
are held to the acceptance invariants (min degree >= 2, min distance >=
0.1) and to K1 and K2's launch pattern: one K1 pass a draw, one K2 call
an aggregation over every pooled tap.
"""
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.envs import flocking_multi as jfm
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs import flocking_multi as tfm
from gym_flock_tpu_torch.ops.adjacency_matmul import adjacency_matmul_block_reference
from gym_flock_tpu_torch.utils import profiling
from tests.test_torch_flocking_env import STATE_ATOL, SUM_TOL, U_ATOL, _rel

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


N = 80  # the registered width
B = 4


def swarms(b, seed, spread=3.0):
    """Positions uniform over a square of side ``2 spread`` (about 2.2
    neighbours an agent at the default), one isolated agent far away in
    env 0, velocities uniform in [-3, 3]."""
    rng = np.random.RandomState(seed)
    x = np.empty((b, N, 4), np.float32)
    x[..., :2] = rng.uniform(-spread, spread, (b, N, 2))
    x[..., 2:] = rng.uniform(-3.0, 3.0, (b, N, 2))
    x[0, 5, :2] = (50.0, 50.0)
    return x


def _pair(x, x_agg, **kw):
    jenv, jp = gft_jax.make("FlockingMulti-v0", **kw)
    tenv, tp = gft.make("FlockingMulti-v0", **kw)
    assert tp == convert.flocking_multi_params_from_jax(jp)
    fields = dict(time=np.zeros(x.shape[0], np.int32), x=x, x_agg=x_agg,
                  init_vel=x[..., 2:4] * 0.5, mean_vel=(x[..., 2:4] * 0.5).mean(axis=1))
    jstate = jfm.FlockingMultiState(**{k: jnp.asarray(v) for k, v in fields.items()})
    tstate = convert.flocking_multi_state_from_numpy(jstate, "cpu")
    return jenv, jp, jstate, tenv, tp, tstate


def _jax_degree(x, cr2):
    pos = x[..., :2].astype(np.float32)
    d2 = ((pos[:, :, None, :] - pos[:, None, :, :]) ** 2).sum(-1)
    adj = (d2 < np.float32(cr2)) & ~np.eye(x.shape[1], dtype=bool)
    return adj.sum(-1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_matches_jax_dense_form(seed):
    x = swarms(B, seed)
    x_agg = np.random.RandomState(seed + 10).randn(B, N, 18).astype(np.float32)
    jenv, jp, jstate, tenv, tp, tstate = _pair(x, x_agg)
    got = tfm._aggregate(tstate.x, tstate.x_agg, tstate.init_vel, tp)
    want = jax.vmap(lambda a, g, v: jfm._aggregate(a, g, v, jp))(
        jstate.x, jstate.x_agg, jstate.init_vel)
    assert got.shape == (B, N, 18)
    assert _rel(got.numpy(), want) < SUM_TOL
    np.testing.assert_array_equal(got[..., :6].numpy(), np.asarray(want)[..., :6])
    assert not got[0, 5, 6:].any()  # the isolated agent pools to zero
    # K2's degree (its plain version) equals the dense adjacency's exactly
    _, deg = adjacency_matmul_block_reference(tstate.x, tstate.x, tstate.x_agg[..., :6], 0, 0,
                                              tp.comm_radius2)
    np.testing.assert_array_equal(deg.numpy(), _jax_degree(x, jp.comm_radius2))
    assert float(deg.mean()) > 1.0


def test_aggregate_runs_one_k2_pass_a_filter_tap(monkeypatch):
    calls = []
    real = tfm.adjacency_matmul

    def counting(x, h, cr2, mean_pool=True):
        calls.append((tuple(h.shape), mean_pool))
        return real(x, h, cr2, mean_pool=mean_pool)

    monkeypatch.setattr(tfm, "adjacency_matmul", counting)
    x = torch.from_numpy(swarms(2, 3))
    tp = tfm.FlockingMultiParams(filter_len=4)
    out = tfm._aggregate(x, torch.zeros(2, N, 24), x[..., 2:4], tp)
    assert out.shape == (2, N, 24) and not out[..., 6:].any()
    # one call over the three newest taps, as the JAX package's one matmul
    assert calls == [((2, N, 18), True)]


def test_step_without_noise_matches_jax():
    x = swarms(B, 4)
    x_agg = np.random.RandomState(5).randn(B, N, 18).astype(np.float32) * 300
    jenv, jp, jstate, tenv, tp, tstate = _pair(x, x_agg, std_dev=0.0)
    u = tenv.controller(tstate, tp)
    ju = jax.vmap(lambda s: jenv.controller(s, jp))(jstate)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=U_ATOL)
    st, obs, r, done, _ = tenv.step_env(torch.Generator().manual_seed(0), tstate, u, tp)
    jst, jobs, jr, jdone, _ = jax.vmap(
        lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp))(jstate, ju)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=0, atol=STATE_ATOL)
    assert _rel(st.x_agg.numpy(), jst.x_agg) < SUM_TOL
    assert obs.shape == (B, N * 18)
    assert _rel(obs.numpy(), jobs) < SUM_TOL
    assert float(obs.abs().max()) == tp.max_z  # the buffer's large entries clip
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=U_ATOL)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(st.time.numpy(), np.asarray(jst.time))


def test_step_noise_std():
    tenv, tp = gft.make("FlockingMulti-v0")
    x = torch.from_numpy(swarms(2048, 6))
    state = tenv.init_state(x, tp)
    st, *_ = tenv.step_env(torch.Generator().manual_seed(2), state, torch.zeros(2048, N, 2), tp)
    noise = st.x[..., 2:4] - x[..., 2:4]
    assert abs(float(noise.std()) / tp.std_dev - 1.0) < 0.02
    np.testing.assert_allclose(st.x[..., :2].numpy(), (x[..., :2] + x[..., 2:4] * tp.dt).numpy(),
                               rtol=0, atol=STATE_ATOL)


def test_reset_invariants_and_launch_pattern(monkeypatch):
    calls = {"k1": 0, "k2": 0}
    real_k1, real_k2 = tfm.flocking_sums_block, tfm.adjacency_matmul

    def k1(*a, **kw):
        calls["k1"] += 1
        return real_k1(*a, **kw)

    def k2(*a, **kw):
        calls["k2"] += 1
        return real_k2(*a, **kw)

    monkeypatch.setattr(tfm, "flocking_sums_block", k1)
    monkeypatch.setattr(tfm, "adjacency_matmul", k2)
    tenv, tp = gft.make("FlockingMulti-v0")
    state, obs = tenv.reset_env(torch.Generator().manual_seed(3), tp, 16)
    assert calls == {"k1": tenv.last_reset_tries, "k2": 1}
    x = state.x.numpy()
    assert x.shape == (16, N, 4) and obs.shape == (16, N * 18)
    ok = tenv._reset_accept(state.x, tp).numpy()
    assert ok.any()
    pos = x[..., :2]
    d2 = ((pos[:, :, None] - pos[:, None]) ** 2).sum(-1) + np.where(np.eye(N, dtype=bool),
                                                                    np.inf, 0.0)
    want = ((d2 < np.float32(tp.comm_radius2)).sum(-1).min(-1) >= 2) & (
        np.sqrt(d2.min(axis=(1, 2))) >= 0.1)
    np.testing.assert_array_equal(ok, want)
    assert float(np.linalg.norm(pos, axis=-1).max()) <= np.sqrt(tp.r_max) * (1 + 1e-6)
    assert float(np.abs(x[..., 2:]).max()) <= 2 * tp.v_max
    # the first aggregation is from an all-zero buffer
    assert torch.equal(state.x_agg[..., :6], torch.cat((state.x, state.init_vel), dim=-1))
    assert not state.x_agg[..., 6:].any()
    assert torch.equal(state.mean_vel, state.init_vel.mean(dim=1))
    assert torch.equal(obs, tenv._obs(state, tp))


def test_reset_keeps_last_draw_after_max_tries():
    tenv, tp = gft.make("FlockingMulti-v0", max_reset_tries=3, comm_radius=1e-3)
    state, _ = tenv.reset_env(torch.Generator().manual_seed(5), tp, 4)
    assert tenv.last_reset_tries == 3
    gen = torch.Generator().manual_seed(5)
    draws = [tenv._draw(gen, tp, 4) for _ in range(3)]
    assert torch.equal(state.x, draws[-1])


def test_a_reset_that_never_accepts_runs_the_shared_loop(monkeypatch, tmp_path):
    """The rejection loop of ``core.env`` through this env: every draw but
    the last ends in one host read, each draw in one ``gft.reset.draw``
    span."""
    monkeypatch.setattr(tfm.FlockingMultiEnv, "_reset_accept",
                        lambda self, x, params: torch.zeros(x.shape[0], dtype=torch.bool))
    tenv, tp = gft.make("FlockingMulti-v0", max_reset_tries=5)
    before = profiling.syncs
    tenv.reset_env(torch.Generator().manual_seed(1), tp, 2)
    assert tenv.last_reset_tries == tp.max_reset_tries
    assert profiling.syncs - before == tenv.last_reset_tries - 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tenv.reset_env(torch.Generator().manual_seed(2), tp, 2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    draws = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("name") == "gft.reset.draw"]
    assert len(draws) == tenv.last_reset_tries == tp.max_reset_tries


def test_factory_and_spaces_match_jax():
    jenv, jp = gft_jax.make("FlockingMulti-v0")
    tenv, tp = gft.make("FlockingMulti-v0")
    assert isinstance(tenv, tfm.FlockingMultiEnv) and tp.max_steps == 1000
    assert dataclasses.asdict(tp) == dataclasses.asdict(convert.flocking_multi_params_from_jax(jp))
    assert tenv.observation_space(tp).shape == jenv.observation_space(jp).shape
    assert tenv.action_space(tp).shape == jenv.action_space(jp).shape
