"""The flocking DAGGER of the PyTorch port against the JAX package's
``parallel/dagger.py`` on the CPU (FlockingRelative-v0, N=12).

Random streams cannot match, so the loss is held to JAX's ``_loss`` on the
same states, labels and weights (flax's init carried across by
``convert.gnn_params_from_flax``), the labels to JAX's Turner controller on
the stored states, and the rest by the invariants of the buffer, the
mixture and the schedule.  Tolerances: the loss and its gradients within
1e-5 of the largest magnitude (at least 1); labels within 1e-4 of JAX's
controller (``tests/test_torch_flocking_env.py``'s U_ATOL) and equal bit
for bit to the port's own on the stored states.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.envs.flocking import turner_controller as jax_turner
from gym_flock_tpu.parallel import dagger as jdagger
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs import flocking as tflocking
from gym_flock_tpu_torch.envs.flocking import turner_controller
from gym_flock_tpu_torch.models import AggregationGNN
from gym_flock_tpu_torch.parallel import dagger as tdagger
from tests.test_torch_flocking_env import U_ATOL, grid_swarms

torch.set_num_threads(2)

TOL = 1e-5
N = 12


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |port - jax| = {err:.3e} > {tol} * {scale:.3e}"


def _trainer(capacity=32, seed=0, **kw):
    env, params = gft.make("FlockingRelative-v0", n_agents=N, **kw)
    trainer = tdagger.DaggerTrainer(env, params, capacity=capacity, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    trainer.init(gen)
    return trainer, gen


@pytest.mark.parametrize("mean_pooling", [True, False])
def test_loss_and_gradients_equal_jax(mean_pooling):
    jenv, jp = gft_jax.make("FlockingRelative-v0", n_agents=N, mean_pooling=mean_pooling)
    jtr = jdagger.DaggerTrainer(jenv, jp)
    state = jtr.init(jax.random.key(4))
    trainer, _ = _trainer(mean_pooling=mean_pooling)
    convert.gnn_params_from_flax(state.params, trainer.model)
    xs = grid_swarms(6, N, 21)
    labels = np.random.RandomState(2).uniform(-1, 1, size=(6, N, 2)).astype(np.float32)
    loss, grads = jax.value_and_grad(jtr._loss)(state.params, jnp.asarray(xs),
                                                jnp.asarray(labels))
    got = trainer._loss(torch.from_numpy(xs), torch.from_numpy(labels))
    got.backward()
    _close(float(got.detach()), float(loss))
    dense = grads["params"]["_MLP_0"]
    for i, layer in enumerate(trainer.model.mlp.layers):
        _close(layer.weight.grad.numpy().T, dense[f"Dense_{i}"]["kernel"])
        _close(layer.bias.grad.numpy(), dense[f"Dense_{i}"]["bias"])


def test_iteration_at_beta_1_labels_and_follows_the_expert():
    """Iteration 0 (beta=1): the labels are the Turner controller on the
    stored states (JAX's within U_ATOL), and each stored state is the step
    of the one before under that label."""
    trainer, gen = _trainer()
    n_envs, n_steps = 2, 4
    loss = trainer.iteration(gen, 1.0, n_envs, n_steps, n_grad_steps=2)
    assert np.isfinite(float(loss))
    s, p = trainer.state, trainer.env_params
    n_new = n_envs * n_steps
    xs, labels = s.buffer_x[:n_new], s.buffer_label[:n_new]
    assert torch.equal(labels, turner_controller(xs, p))
    jp = gft_jax.make("FlockingRelative-v0", n_agents=N)[1]
    want = jax.vmap(lambda x: jax_turner(x, jp))(jnp.asarray(xs.numpy()))
    np.testing.assert_allclose(labels.numpy(), np.asarray(want), rtol=0, atol=U_ATOL)
    x = xs.reshape(n_envs, n_steps, N, 4)
    u = labels.reshape(n_envs, n_steps, N, 2)
    for t in range(n_steps - 1):
        assert torch.equal(x[:, t + 1], trainer.env._rollout_integrate(x[:, t], u[:, t], p, gen))


def test_iteration_at_beta_0_follows_the_learner():
    """beta=0: each step is the learner's action (the weights before the
    iteration's updates); the labels stay the expert's."""
    trainer, gen = _trainer()
    before = AggregationGNN()
    before.load_state_dict(trainer.model.state_dict())
    n_envs, n_steps = 2, 3
    trainer.iteration(gen, 0.0, n_envs, n_steps, n_grad_steps=1)
    s, p = trainer.state, trainer.env_params
    xs = s.buffer_x[:n_envs * n_steps]
    assert torch.equal(s.buffer_label[:n_envs * n_steps], turner_controller(xs, p))
    x = xs.reshape(n_envs, n_steps, N, 4)
    with torch.no_grad():
        for t in range(n_steps - 1):
            values, _, adj_mean, _ = tflocking.flocking_features(x[:, t], p.comm_radius2)
            u = before(values, adj_mean)
            torch.testing.assert_close(x[:, t + 1], trainer.env._rollout_integrate(x[:, t], u, p,
                                                                                   gen),
                                       rtol=0, atol=1e-6)


def test_buffer_wraps_and_fills_and_checks_its_capacity():
    trainer, gen = _trainer(capacity=10)
    seen = []
    collect = trainer.collect
    trainer.collect = lambda *a: seen.append(collect(*a)) or seen[-1]
    for pos, filled in [(6, 6), (2, 10), (8, 10)]:
        trainer.iteration(gen, 0.5, 2, 3, n_grad_steps=1)
        assert (trainer.state.write_pos, trainer.state.filled) == (pos, filled)
    s = trainer.state
    # the second collect went to slots 6..9 and 0..1, the third to 2..7
    assert torch.equal(s.buffer_x[8:10], seen[1][0][2:4])
    assert torch.equal(s.buffer_x[0:2], seen[1][0][4:6])
    assert torch.equal(s.buffer_x[2:8], seen[2][0])
    assert torch.equal(s.buffer_label[2:8], seen[2][1])
    with pytest.raises(ValueError, match="capacity"):
        trainer.iteration(gen, 1.0, 4, 3)


def test_resets_run_the_acceptance_pass_once_a_draw(monkeypatch):
    """The iteration's reset goes through K1's wrapper once a draw (on the
    card each is one K1 launch)."""
    calls = []
    real = tflocking.flocking_sums_block

    def counting(*a, **kw):
        calls.append(kw.get("channels"))
        return real(*a, **kw)

    monkeypatch.setattr(tflocking, "flocking_sums_block", counting)
    trainer, gen = _trainer(max_reset_tries=8)
    trainer.iteration(gen, 1.0, 3, 2, n_grad_steps=1)
    assert len(calls) == trainer.env.last_reset_tries >= 1 and set(calls) == {"full"}


def test_fit_resume_reproduces_the_uninterrupted_run(tmp_path):
    """tests/test_models_train.py:287 on the port: interrupt + resume ==
    straight through, weights, buffer, cursor and losses."""
    kwargs = dict(n_envs=2, n_steps=2, n_grad_steps=1)
    full, _ = _trainer()
    losses_full = full.fit(torch.Generator().manual_seed(11), n_iters=4, **kwargs)

    path = str(tmp_path / "dagger.pt")
    part, _ = _trainer()
    first = part.fit(torch.Generator().manual_seed(11), n_iters=2, ckpt_path=path,
                     ckpt_every=1, **kwargs)
    resumed, _ = _trainer()
    rest = resumed.fit(torch.Generator().manual_seed(11), n_iters=4, ckpt_path=path, **kwargs)
    assert len(rest) == 2 and first + rest == losses_full
    for a, b in zip(full.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(full.state.buffer_x, resumed.state.buffer_x)
    assert torch.equal(full.state.buffer_label, resumed.state.buffer_label)
    assert (full.state.write_pos, full.state.filled) == (resumed.state.write_pos,
                                                         resumed.state.filled) == (16, 16)
    assert resumed.step == full.step == 4


def test_evaluate_is_a_finite_closed_loop_reward():
    trainer, gen = _trainer()
    r = trainer.evaluate(gen, n_envs=2, n_steps=5)
    assert np.isfinite(r) and r <= 0.0  # minus a variance


def test_dagger_trainer_defaults_to_the_card():
    env, params = gft.make("FlockingRelative-v0", n_agents=8)
    if torch.cuda.is_available():
        assert tdagger.DaggerTrainer(env, params).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tdagger.DaggerTrainer(env, params)
