"""Imitation training of the PyTorch port against the JAX package's
``parallel/train.py`` on the CPU.

Random streams cannot match (threefry against ``torch.Generator``), so the
trainers are held to JAX through the same weights (flax's init carried
across by ``convert.gnn_params_from_flax``) and the same batch (numpy arrays
fed to both): two Adam updates compared value for value with
``jax.value_and_grad`` + optax's ``adam``.  The JAX large model runs its
Pallas aggregation in interpret mode.  Tolerance: the loss, the gradients
and the updated weights within 1e-5 of the array's largest magnitude
(at least 1), so that an element whose gradient is near zero is held to the
same absolute bound as its layer.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.models import gnn as jgnn
from gym_flock_tpu.ops import sparse_flocking as jsf
from gym_flock_tpu.parallel import train as jtrain
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.models import LargeAggregationGNN
from gym_flock_tpu_torch.ops import adjacency_matmul as k2
from gym_flock_tpu_torch.ops import sparse_flocking as sf
from gym_flock_tpu_torch.parallel import train as tt
from tests.test_torch_flocking_env import SUM_TOL, _rel, grid_swarms

torch.set_num_threads(2)

TOL = 1e-5
U_ATOL = 1e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |port - jax| = {err:.3e} > {tol} * {scale:.3e}"


def _dense_layers(params):
    dense = params["params"]["_MLP_0"]
    return [dense[f"Dense_{i}"] for i in range(len(dense))]


def _sparse_model_pair(cr2):
    jmodel = jgnn.LargeAggregationGNN(
        comm_radius2=cr2,
        aggregate_fn=functools.partial(jsf.khop_aggregate_sparse, comm_radius2=cr2, k_hops=3))
    model = LargeAggregationGNN(
        comm_radius2=cr2,
        aggregate_fn=functools.partial(sf.khop_aggregate_sparse, comm_radius2=cr2, k_hops=3))
    return jmodel, model


def _trainers(kind):
    """The JAX and the port's trainer of one kind, with the same weights."""
    if kind == "dense":
        env_id, n = "FlockingRelative-v0", 12
    elif kind == "large":
        env_id, n = "FlockingLarge-v0", 48
    else:
        env_id, n = "FlockingSparse-v0", 256
    jenv, jp = gft_jax.make(env_id, n_agents=n)
    tenv, tp = gft.make(env_id, n_agents=n)
    if kind == "dense":
        jtr = jtrain.FlockingImitationTrainer(jenv, jp)
        ttr = tt.FlockingImitationTrainer(tenv, tp, device="cpu")
    elif kind == "large":
        jtr = jtrain.LargeFlockingImitationTrainer(jenv, jp, interpret=True)
        ttr = tt.LargeFlockingImitationTrainer(tenv, tp, device="cpu")
    else:
        jmodel, model = _sparse_model_pair(float(jp.comm_radius2))
        jtr = jtrain.LargeFlockingImitationTrainer(jenv, jp, model=jmodel)
        ttr = tt.LargeFlockingImitationTrainer(tenv, tp, model=model, device="cpu")
    carry = jtr.init(jax.random.key(3))
    convert.gnn_params_from_flax(carry[0], ttr.model)
    return (jtr, carry), ttr


def _batch(kind, ttr, seed):
    """One expert batch collected by the port, as numpy arrays."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "dense":
        batch = ttr.collect(gen, n_envs=3, n_steps=2)
    else:
        x0 = grid_swarms(2, ttr.env_params.n_agents, seed)
        state = ttr.env.init_state(torch.from_numpy(x0), ttr.env_params)
        batch = tt.collect_large_flocking_batch(ttr.env, ttr.env_params, gen, 2, 2,
                                                init_state=state)
    return [b.numpy().copy() for b in batch]


@pytest.mark.parametrize("kind", ["dense", "large", "sparse"])
def test_two_updates_equal_jax_and_optax(kind):
    (jtr, (params, opt_state)), ttr = _trainers(kind)
    for seed in (5, 6):
        batch = _batch(kind, ttr, seed)
        loss, grads = jax.value_and_grad(jtr.loss_fn)(params, *map(jnp.asarray, batch))
        updates, opt_state = jtr.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        got = ttr.update([torch.from_numpy(b) for b in batch])
        _close(float(got), float(loss))
        for layer, jg, jw in zip(ttr.model.mlp.layers, _dense_layers(grads),
                                 _dense_layers(params)):
            _close(layer.weight.grad.numpy().T, jg["kernel"])
            _close(layer.bias.grad.numpy(), jg["bias"])
            _close(layer.weight.detach().numpy().T, jw["kernel"])
            _close(layer.bias.detach().numpy(), jw["bias"])
    assert ttr.step == 2


def test_collect_large_flocking_batch_equals_the_jax_step_loop():
    """The fused collect (one pass a step) against JAX's controller, ``_obs``
    and ``step_env`` on the same start states."""
    n, steps = 48, 3
    x0 = grid_swarms(2, n, 31)
    jenv, jp = gft_jax.make("FlockingLarge-v0", n_agents=n)
    tenv, tp = gft.make("FlockingLarge-v0", n_agents=n)

    def one(state):
        def body(state, _):
            u = jenv.controller(state, jp)
            values, _ = jenv._obs(state, jp)
            x = state.x
            state, _, _, _, _ = jenv.step_env(jax.random.key(0), state, u, jp)
            return state, (x, values, u)

        return jax.lax.scan(body, state, None, length=steps)[1]

    jstate = jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(x0))
    jx, jfeats, jacts = (np.asarray(v).reshape((-1,) + v.shape[2:])
                         for v in jax.jit(jax.vmap(one))(jstate))
    k1_state = tenv.init_state(torch.from_numpy(x0), tp)
    xs, feats, acts = tt.collect_large_flocking_batch(
        tenv, tp, torch.Generator().manual_seed(0), 2, steps, init_state=k1_state)
    assert xs.shape == (2 * steps, n, 4) and feats.shape == (2 * steps, n, 6)
    assert acts.shape == (2 * steps, n, 2)
    np.testing.assert_allclose(xs.numpy(), jx, rtol=0, atol=U_ATOL)
    np.testing.assert_allclose(acts.numpy(), jacts, rtol=0, atol=U_ATOL)
    assert _rel(feats.numpy(), jfeats) < SUM_TOL


def test_collect_flocking_batch_shapes():
    env, params = gft.make("FlockingRelative-v0", n_agents=10)
    feats, adj, acts = tt.collect_flocking_batch(env, params, torch.Generator().manual_seed(0),
                                                 n_envs=3, n_steps=4)
    assert feats.shape == (12, 10, 6) and adj.shape == (12, 10, 10) and acts.shape == (12, 10, 2)
    # the mean-pooled network: rows of a node with neighbours sum to 1
    sums = adj.sum(-1)
    assert torch.allclose(sums[sums > 0], torch.ones(()), atol=1e-6)


def test_fit_lowers_the_loss():
    """tests/test_models_train.py:57-62's criterion on the port."""
    env, params = gft.make("FlockingRelative-v0", n_agents=12)
    trainer = tt.FlockingImitationTrainer(env, params, learning_rate=1e-3, device="cpu")
    losses = trainer.fit(torch.Generator().manual_seed(0), n_iters=20, n_envs=4, n_steps=6)
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_large_trainer_moves_the_parameters():
    """LargeAggregationGNN trains through K2's plain version at N=24; the
    aggregation runs forward only (it acts on inputs before any weight)."""
    env, params = gft.make("FlockingLarge-v0", n_agents=24, max_reset_tries=4)
    trainer = tt.LargeFlockingImitationTrainer(env, params, device="cpu")
    gen = torch.Generator().manual_seed(0)
    trainer.init(gen)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    launches = k2.launches
    losses = [float(trainer.train_step(gen, n_envs=2, n_steps=2)) for _ in range(3)]
    assert np.isfinite(losses).all()
    assert max(float((p.detach() - b).abs().max())
               for p, b in zip(trainer.model.parameters(), before)) > 0.0
    assert k2.launches == launches  # CPU tensors: the plain version, no launch


def test_checkpoint_round_trips(tmp_path):
    env, params = gft.make("FlockingRelative-v0", n_agents=8)
    trainer = tt.FlockingImitationTrainer(env, params, device="cpu")
    gen = torch.Generator().manual_seed(0)
    trainer.init(gen)
    trainer.train_step(gen, 2, 2)
    path = str(tmp_path / "ckpt.pt")
    tt.save_checkpoint(path, trainer.model, trainer.optimizer, step=7, generator=gen)
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt.pt"]  # no temp file left

    fresh = tt.FlockingImitationTrainer(env, params, device="cpu")
    gen2 = torch.Generator().manual_seed(9)
    fresh.init(gen2)
    step = tt.restore_checkpoint(path, fresh.model, fresh.optimizer, gen2)
    assert step == 7
    assert torch.equal(gen2.get_state(), gen.get_state())
    for a, b in zip(trainer.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = trainer.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][name], sb[k][name])
    # training goes on from the restored state, as from the saved one
    la = float(trainer.train_step(gen, 2, 2))
    lb = float(fresh.train_step(gen2, 2, 2))
    assert la == lb
    for a, b in zip(trainer.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


def test_fit_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Interrupt + resume == straight through: the same weights and losses."""
    env, params = gft.make("FlockingRelative-v0", n_agents=8)
    full = tt.FlockingImitationTrainer(env, params, device="cpu")
    losses_full = full.fit(torch.Generator().manual_seed(3), n_iters=4, n_envs=2, n_steps=2)

    path = str(tmp_path / "resume.pt")
    part = tt.FlockingImitationTrainer(env, params, device="cpu")
    first = part.fit(torch.Generator().manual_seed(3), n_iters=2, n_envs=2, n_steps=2,
                     ckpt_path=path, ckpt_every=1)
    # a "crash" after 2 steps: a new trainer resumes at step 2
    resumed = tt.FlockingImitationTrainer(env, params, device="cpu")
    rest = resumed.fit(torch.Generator().manual_seed(3), n_iters=4, n_envs=2, n_steps=2,
                       ckpt_path=path)
    assert len(rest) == 2 and resumed.step == 4
    assert first + rest == losses_full
    for a, b in zip(full.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["FlockingImitationTrainer", "LargeFlockingImitationTrainer"])
def test_trainers_default_to_the_card(name):
    """Without ``device=`` a trainer puts its model and Adam on the card; on
    a machine without one, construction raises instead of training on the
    host."""
    env_id = "FlockingRelative-v0" if name == "FlockingImitationTrainer" else "FlockingLarge-v0"
    env, params = gft.make(env_id, n_agents=8)
    trainer_cls = getattr(tt, name)
    if torch.cuda.is_available():
        assert trainer_cls(env, params).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            trainer_cls(env, params)
