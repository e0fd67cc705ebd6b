"""The port's rollout loops against ``jax.vmap`` of the JAX package's, from
identical states (B=4 swarms of N=48 agents, 5 steps).

Tolerances: the expert action ``u`` and the reward atol 1e-4; observation
feature sums max |port - jax| / (1 + |jax|) < 1e-4; the mean-pooled network
atol 1e-6; FlockingLarge's degree exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.parallel.rollout import rollout as jax_rollout
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.parallel import rollout as tro
from tests.test_torch_flocking_env import NETWORK_ATOL, SUM_TOL, _rel, grid_swarms

torch.set_num_threads(2)

ATOL = 1e-4
B, N, STEPS = 4, 48, 5


def _both(env_id, seed):
    x = grid_swarms(B, N, seed)
    jenv, jp = gft_jax.make(env_id, n_agents=N)
    tenv, tp = gft.make(env_id, n_agents=N)
    jstate = jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(x))
    return (jenv, jp, jstate), (tenv, tp, convert.state_from_numpy(x, tp, "cpu"))


@pytest.mark.parametrize("env_id", ["FlockingRelative-v0", "FlockingLarge-v0"])
@pytest.mark.parametrize("centralized", [True, False])
def test_batch_expert_rollout_matches_jax(env_id, centralized):
    (jenv, jp, jstate), (tenv, tp, tstate) = _both(env_id, seed=21)
    final, traj = tro.batch_expert_rollout(
        tenv, tp, torch.Generator().manual_seed(0), B, STEPS,
        centralized=centralized, init_state=tstate,
    )
    jfinal, jtraj = jax.jit(jax.vmap(
        lambda s: jenv.expert_rollout(s, jp, STEPS, centralized=centralized)
    ))(jstate)
    assert final.time.tolist() == [STEPS] * B
    np.testing.assert_allclose(final.x.numpy(), np.asarray(jfinal.x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(traj["u"].numpy(), np.asarray(jtraj["u"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        traj["reward"].numpy(), np.asarray(jtraj["reward"]), rtol=0, atol=ATOL
    )
    assert _rel(traj["values"].numpy(), jtraj["values"]) < SUM_TOL
    if env_id == "FlockingLarge-v0":
        np.testing.assert_array_equal(traj["network"].numpy(), np.asarray(jtraj["network"]))
    else:
        np.testing.assert_allclose(
            traj["network"].numpy(), np.asarray(jtraj["network"]), rtol=0, atol=NETWORK_ATOL
        )


@pytest.mark.parametrize("env_id", ["FlockingRelative-v0", "FlockingLarge-v0"])
def test_rollout_expert_policy_matches_jax(env_id):
    (jenv, jp, jstate), (tenv, tp, tstate) = _both(env_id, seed=22)
    tobs = tenv._obs(tstate, tp)
    _, traj = tro.rollout(
        tenv, tp, torch.Generator().manual_seed(0), STEPS, auto_reset=False,
        init_state=tstate, init_obs=tobs,
    )
    jobs = jax.vmap(lambda s: jenv._obs(s, jp))(jstate)
    _, jtraj = jax.jit(jax.vmap(lambda s, o: jax_rollout(
        jenv, jp, jax.random.key(0), STEPS, auto_reset=False, init_state=s, init_obs=o,
    )))(jstate, jobs)
    np.testing.assert_allclose(traj["action"].numpy(), np.asarray(jtraj.action), rtol=0, atol=ATOL)
    np.testing.assert_allclose(traj["reward"].numpy(), np.asarray(jtraj.reward), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(traj["done"].numpy(), np.asarray(jtraj.done))
    assert _rel(traj["obs"][0].numpy(), jtraj.obs[0]) < SUM_TOL


def test_fused_rollout_equals_the_step_loop():
    """One pairwise pass per step gives the same actions and rewards as
    ``controller`` + ``step_env`` at every step."""
    _, (tenv, tp, tstate) = _both("FlockingRelative-v0", seed=23)
    _, traj = tenv.expert_rollout(tstate, tp, STEPS)
    state = tstate
    for t in range(STEPS):
        u = tenv.controller(state, tp)
        state, obs, r, _, _ = tenv.step_env(None, state, u, tp)
        np.testing.assert_allclose(traj["u"][:, t].numpy(), u.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(traj["reward"][:, t].numpy(), r.numpy(), rtol=0, atol=ATOL)
        assert _rel(traj["values"][:, t].numpy(), obs[0].numpy()) < SUM_TOL


@pytest.mark.parametrize("env_id", ["FlockingRelative-v0", "FlockingLarge-v0"])
def test_batch_expert_rollout_from_reset(env_id):
    tenv, tp = gft.make(env_id, n_agents=N)
    final, traj = tro.batch_expert_rollout(tenv, tp, torch.Generator().manual_seed(3), B, 3)
    net = (B, 3, N) if env_id == "FlockingLarge-v0" else (B, 3, N, N)
    assert traj["u"].shape == (B, 3, N, 2) and traj["values"].shape == (B, 3, N, 6)
    assert traj["network"].shape == net and traj["reward"].shape == (B, 3)
    assert all(bool(torch.isfinite(v).all()) for v in traj.values())
    assert final.time.tolist() == [3] * B


def test_batch_rollout_random_policy_autoresets():
    tenv, tp = gft.make("FlockingRelative-v0", n_agents=N, max_steps=2)
    state, traj = tro.batch_rollout(tenv, tp, torch.Generator().manual_seed(4), 3, 5,
                                    policy="random")
    assert traj["action"].shape == (3, 5, N, 2)
    assert float(traj["action"].abs().max()) <= tp.max_accel
    assert traj["done"].tolist() == [[False, True, False, True, False]] * 3
    assert traj["obs"][0].shape == (3, 5, N, 6) and traj["obs"][1].shape == (3, 5, N, N)
    assert state.time.tolist() == [1, 1, 1]
