"""The port's rollout loop over the coverage envs, with the greedy expert,
against the JAX package's ``lax.scan`` rollout under ``jax.vmap``: the same
start states and the same random draws (B=3, 5 steps, procedural maps).

The expert's random actions (robots with no reachable target) come from
JAX's per-step policy keys in both: the port's controller is fed JAX's
draws through ``rand_u``.

Tolerances: actions, rewards, done flags, senders and receivers exactly;
observation features atol 1e-6.
"""
import numpy as np
import jax
import pytest
import torch

from gym_flock_tpu.parallel.rollout import rollout as jax_rollout
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs.coverage import CoverageEnv
from gym_flock_tpu_torch.parallel import rollout as tro
from tests.test_torch_coverage_env import FEAT_ATOL, _envs

torch.set_num_threads(2)

B, STEPS = 3, 5


class _FedDraws(CoverageEnv):
    """A coverage env whose expert takes its random actions from a list of
    ``[B, R]`` draws, one per call."""

    def __init__(self, draws):
        self.draws = list(draws)

    def controller(self, state, params, generator=None, rand_u=None):
        return super().controller(state, params, generator, rand_u=self.draws.pop(0))


@pytest.mark.parametrize("env_id,kw", [("Coverage-v0", (("n_graphs", 2),)),
                                       ("ExploreFullEnv-v0", ())])
def test_expert_rollout_matches_jax(env_id, kw):
    jenv, jp, _, tp, jfn = _envs(env_id, kw)
    keys = jax.random.split(jax.random.key(31), B)
    js, jobs = jfn["reset"](keys)
    _, jtraj = jax.jit(jax.vmap(lambda s, o, k: jax_rollout(
        jenv, jp, k, STEPS, policy="expert", init_state=s, init_obs=o)))(js, jobs, keys)

    # JAX's draws: the policy half of each step key (parallel/rollout.py)
    def step_draws(key):
        k_pol = jax.vmap(lambda kt: jax.random.split(kt)[0])(jax.random.split(key, STEPS))
        return jfn["draw"](k_pol)

    draws = np.array(jax.jit(jax.vmap(step_draws))(keys))  # [B, STEPS, R]
    env = _FedDraws(torch.from_numpy(draws[:, t]) for t in range(STEPS))
    ts = convert.coverage_state_from_numpy(js)
    tobs = {k: torch.from_numpy(np.array(v)) for k, v in jobs.items()}
    final, traj = tro.rollout(env, tp, torch.Generator().manual_seed(0), STEPS,
                              policy="expert", init_state=ts, init_obs=tobs)
    np.testing.assert_array_equal(traj["action"].numpy(), np.asarray(jtraj.action))
    np.testing.assert_array_equal(traj["reward"].numpy(), np.asarray(jtraj.reward))
    np.testing.assert_array_equal(traj["done"].numpy(), np.asarray(jtraj.done))
    assert float(traj["reward"].sum()) > 0
    for k in ("senders", "receivers"):
        np.testing.assert_array_equal(traj["obs"][k].numpy(), np.asarray(jtraj.obs[k]))
    for k in ("nodes", "edges", "step"):
        np.testing.assert_allclose(traj["obs"][k].numpy(), np.asarray(jtraj.obs[k]),
                                   rtol=0, atol=FEAT_ATOL)
    assert final.time.tolist() == [1 + STEPS] * B


def test_expert_rollout_autoresets_three_step_episodes():
    """``episode_length=4``: the reset leaves time at 1, so every third step
    is done and the batch resets there; the stored observation after it is
    the fresh episode's."""
    from gym_flock_tpu_torch import make

    env, params = make("Coverage-v0", n_graphs=2, episode_length=4, max_steps=4, device="cpu")
    state, traj = tro.batch_rollout(env, params, torch.Generator().manual_seed(2), 3, 7,
                                    policy="expert")
    assert traj["done"].tolist() == [[False, False, True, False, False, True, False]] * 3
    assert traj["obs"]["step"][:, :, 0, 0].tolist() == [[0.0, 1.0, 2.0, 0.0, 1.0, 2.0, 0.0]] * 3
    assert traj["obs"]["nodes"].shape == (3, 7, params.max_nodes, 3)
    assert traj["action"].shape == (3, 7, params.n_robots, 1)
    assert state.time.tolist() == [2, 2, 2]
    assert bool(torch.isfinite(traj["reward"]).all()) and float(traj["reward"].sum()) > 0
