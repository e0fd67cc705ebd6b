"""The port's rollout loops against ``jax.vmap`` of the JAX package's, from
identical states (B=4 swarms of N=48 agents, 5 steps), and the protocol
around them: autoreset over dict observations, the generator handed to the
expert.

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
from gym_flock_tpu_torch.core.env import Env, _select, step_autoreset
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


def test_select_over_dict_observations():
    done = torch.tensor([True, False])
    a = {"x": torch.zeros(2, 3), "y": (torch.zeros(2), torch.zeros(2, 1, dtype=torch.int32))}
    b = {"x": torch.ones(2, 3), "y": (torch.ones(2), torch.ones(2, 1, dtype=torch.int32))}
    out = _select(done, a, b)
    assert out["x"].tolist() == [[1.0] * 3, [0.0] * 3]
    assert out["y"][0].tolist() == [1.0, 0.0] and out["y"][1].tolist() == [[1], [0]]


def test_step_autoreset_with_dict_observations_where_one_env_is_done():
    """Coverage observations are dicts; env 0 is one step from its episode
    length, so it alone is done and replaced by a fresh reset."""
    tenv, tp = gft.make("Coverage-v0", n_graphs=2, episode_length=3, max_steps=3, device="cpu")
    gen = torch.Generator().manual_seed(1)
    state, _ = tenv.reset_env(gen, tp, 3)  # time 1
    state = type(state)(**{**state.__dict__, "time": torch.tensor([2, 1, 1], dtype=torch.int32)})
    u = tenv.controller(state, tp, gen)
    new_state, obs, reward, done, info = step_autoreset(tenv, gen, state, u, tp)
    assert done.tolist() == [True, False, False]
    assert new_state.time.tolist() == [1, 2, 2]
    assert obs["step"].flatten().tolist() == [0.0, 1.0, 1.0]
    assert info["terminal_obs"]["step"].flatten().tolist() == [2.0, 1.0, 1.0]
    assert torch.equal(obs["senders"][1:], info["terminal_obs"]["senders"][1:])
    assert set(obs) == {"nodes", "edges", "senders", "receivers", "step"}


class _SpyEnv(Env):
    """Counts steps; its expert records the generator it is handed."""

    def __init__(self):
        self.seen = []

    def reset_env(self, generator, params, n_envs):
        from gym_flock_tpu_torch.core.env import EnvState

        return EnvState(time=torch.zeros(n_envs, dtype=torch.int32)), torch.zeros(n_envs)

    def step_env(self, generator, state, action, params):
        state = type(state)(time=state.time + 1)
        return state, state.time.float(), action, state.time >= 100, {}

    def controller(self, state, params, generator=None):
        self.seen.append(generator)
        return torch.zeros(state.time.shape[0])


def test_expert_policy_passes_the_generator():
    """policy='expert' hands the rollout's generator to the controller, as
    the JAX package hands it the per-step key (coverage's random fallback
    needs it)."""
    env = _SpyEnv()
    gen = torch.Generator().manual_seed(0)
    tro.batch_rollout(env, None, gen, n_envs=2, n_steps=3, policy="expert")
    assert env.seen == [gen] * 3


def test_expert_policy_string_drives_coverage():
    """The counterpart of tests/test_coverage_rollout.py's key pass-through
    test: 30 expert steps of Coverage-v0 make steady progress."""
    tenv, tp = gft.make("Coverage-v0", n_graphs=1, device="cpu")
    _, traj = tro.batch_rollout(tenv, tp, torch.Generator().manual_seed(4), 2, 30,
                                policy="expert", keep_obs=False)
    assert bool(torch.isfinite(traj["reward"]).all())
    assert (traj["reward"].sum(dim=1) > 5).all()
