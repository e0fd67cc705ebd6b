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

Under a learning-rate schedule the trainers take five updates against
``optax.adam(schedule)`` (the flocking trainers on optax's own gradients,
the DAGGER and coverage trainers on the port's gradients, held beside
JAX's at the same tolerance), and each update's Adam ``lr`` must be the
port's ``cosine_decay_schedule`` at the count of updates already taken.
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
from gym_flock_tpu.parallel import dagger as jdagger
from gym_flock_tpu.parallel import train as jtrain
from gym_flock_tpu.parallel import train_coverage as jtc
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.models import LargeAggregationGNN
from gym_flock_tpu_torch.ops import adjacency_matmul as k2
from gym_flock_tpu_torch.ops import sparse_flocking as sf
from gym_flock_tpu_torch.parallel import dagger as tdagger
from gym_flock_tpu_torch.parallel import distributed as tdist
from gym_flock_tpu_torch.parallel import train as tt
from gym_flock_tpu_torch.parallel import train_coverage as tc
from tests.test_torch_coverage_train import COVERAGE, _batch_np, _grad, _models, _pairs, _torch
from tests.test_torch_coverage_env import _envs
from tests.test_torch_flocking_env import SUM_TOL, _rel, grid_swarms

torch.set_num_threads(2)

TOL = 1e-5
U_ATOL = 1e-4
# decays over the first 3 of 5 updates, then holds alpha * init
SCHEDULE = dict(init_value=1e-3, decay_steps=3, alpha=0.03)


def _schedules():
    """The JAX package's and the port's schedule of ``SCHEDULE``."""
    return optax.cosine_decay_schedule(**SCHEDULE), tt.cosine_decay_schedule(**SCHEDULE)


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


def _trainers(kind, scheduled=False):
    """The JAX and the port's trainer of one kind, with the same weights;
    Adam at 1e-3, or on ``SCHEDULE`` when ``scheduled``."""
    if kind == "dense":
        env_id, n = "FlockingRelative-v0", 12
    elif kind == "large":
        env_id, n = "FlockingLarge-v0", 48
    else:
        env_id, n = "FlockingSparse-v0", 256
    jenv, jp = gft_jax.make(env_id, n_agents=n)
    tenv, tp = gft.make(env_id, n_agents=n)
    jlr, tlr = _schedules() if scheduled else (1e-3, 1e-3)
    if kind == "dense":
        jtr = jtrain.FlockingImitationTrainer(jenv, jp, learning_rate=jlr)
        ttr = tt.FlockingImitationTrainer(tenv, tp, learning_rate=tlr, device="cpu")
    elif kind == "large":
        jtr = jtrain.LargeFlockingImitationTrainer(jenv, jp, learning_rate=jlr, interpret=True)
        ttr = tt.LargeFlockingImitationTrainer(tenv, tp, learning_rate=tlr, device="cpu")
    else:
        jmodel, model = _sparse_model_pair(float(jp.comm_radius2))
        jtr = jtrain.LargeFlockingImitationTrainer(jenv, jp, model=jmodel, learning_rate=jlr)
        ttr = tt.LargeFlockingImitationTrainer(tenv, tp, model=model, learning_rate=tlr,
                                               device="cpu")
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


@pytest.mark.parametrize("kind,n_updates,scheduled", [
    pytest.param(kind, 2, False, id=kind) for kind in ("dense", "large", "sparse")] + [
    pytest.param(kind, 5, True, id=f"{kind}-cosine-5") for kind in ("dense", "large", "sparse")])
def test_two_updates_equal_jax_and_optax(kind, n_updates, scheduled):
    """Two updates at a constant rate; five on ``SCHEDULE``, each update's
    ``lr`` the port's schedule at the updates already taken."""
    (jtr, (params, opt_state)), ttr = _trainers(kind, scheduled)
    for i, seed in enumerate(range(5, 5 + n_updates)):
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
        assert ttr.optimizer.param_groups[0]["lr"] == ttr.lr_at(i)
    assert ttr.step == n_updates
    if scheduled:
        assert ttr.lr_at(0) == SCHEDULE["init_value"]
        assert ttr.lr_at(4) == pytest.approx(SCHEDULE["init_value"] * SCHEDULE["alpha"],
                                             rel=1e-12)


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


def _check_resume(tmp_path, learning_rate):
    """Interrupt + resume == straight through: the same weights and losses."""
    env, params = gft.make("FlockingRelative-v0", n_agents=8)

    def trainer():
        return tt.FlockingImitationTrainer(env, params, learning_rate=learning_rate,
                                           device="cpu")

    full = trainer()
    losses_full = full.fit(torch.Generator().manual_seed(3), n_iters=4, n_envs=2, n_steps=2)

    path = str(tmp_path / "resume.pt")
    part = trainer()
    first = part.fit(torch.Generator().manual_seed(3), n_iters=2, n_envs=2, n_steps=2,
                     ckpt_path=path, ckpt_every=1)
    # a "crash" after 2 steps: a new trainer resumes at step 2
    resumed = trainer()
    rest = resumed.fit(torch.Generator().manual_seed(3), n_iters=4, n_envs=2, n_steps=2,
                       ckpt_path=path)
    assert len(rest) == 2 and resumed.step == 4
    assert first + rest == losses_full
    for a, b in zip(full.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    return resumed


def test_fit_resume_reproduces_the_uninterrupted_run(tmp_path):
    _check_resume(tmp_path, 1e-3)


def test_fit_resume_under_a_schedule_reproduces_the_uninterrupted_run(tmp_path):
    """The resumed run reads its schedule at the checkpoint's step (the
    restored Adam state holds step 2's rate; update 3 must take
    ``schedule(3)``, not ``schedule(0)``)."""
    schedule = tt.cosine_decay_schedule(1e-2, 4, alpha=0.1)
    resumed = _check_resume(tmp_path, schedule)
    assert resumed.optimizer.param_groups[0]["lr"] == schedule(3) != schedule(1)


def _dagger_pair(schedules):
    jlr, tlr = schedules
    jenv, jp = gft_jax.make("FlockingRelative-v0", n_agents=12)
    jtr = jdagger.DaggerTrainer(jenv, jp, learning_rate=jlr)
    state = jtr.init(jax.random.key(4))
    env, params = gft.make("FlockingRelative-v0", n_agents=12)
    ttr = tdagger.DaggerTrainer(env, params, learning_rate=tlr, device="cpu")
    convert.gnn_params_from_flax(state.params, ttr.model)

    def batches(seed):
        xs = grid_swarms(6, 12, seed)
        labels = np.random.RandomState(seed).uniform(-1, 1, size=(6, 12, 2))
        return xs, labels.astype(np.float32)

    def to_port(batch):
        return tuple(torch.from_numpy(b) for b in batch)

    def port_grads():
        dense = {f"Dense_{i}": {"kernel": jnp.asarray(layer.weight.grad.numpy().T),
                                "bias": jnp.asarray(layer.bias.grad.numpy())}
                 for i, layer in enumerate(ttr.model.mlp.layers)}
        return {"params": {"_MLP_0": dense}}

    def pairs(tree):
        return [(tree["params"]["_MLP_0"][f"Dense_{i}"], layer)
                for i, layer in enumerate(ttr.model.mlp.layers)]

    return (jtr._loss, jtr.tx, state.params, batches, to_port, port_grads, pairs, ttr,
            lambda layer: layer.weight.grad.numpy(), lambda layer: layer.bias.grad.numpy())


def _coverage_pair(schedules):
    jlr, tlr = schedules
    jenv, jp, tenv, tp, _ = _envs(*COVERAGE)
    jmodel, variables, model = _models(tp)
    jtr = jtc.CoverageImitationTrainer(jenv, jp, model=jmodel, learning_rate=jlr)
    ttr = tc.CoverageImitationTrainer(tenv, tp, model=model, learning_rate=tlr, device="cpu")

    def batches(seed):
        return _batch_np(*COVERAGE, seed=seed - 5)

    def port_grads():
        tree = {"params": {}}
        for i, mlp in enumerate(ttr.model.mlps()):
            tree["params"][f"_MLP_{i}"] = {
                f"Dense_{j}": {"kernel": jnp.asarray(_grad(layer.weight).T),
                               "bias": jnp.asarray(_grad(layer.bias))}
                for j, layer in enumerate(mlp.layers)}
        return tree

    def jloss(params, batch):
        return jtr.loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})

    return (jloss, jtr.tx, variables, batches, _torch, port_grads,
            lambda tree: _pairs(tree, ttr.model), ttr,
            lambda layer: _grad(layer.weight), lambda layer: _grad(layer.bias))


@pytest.mark.parametrize("name", ["dagger", "coverage"])
def test_scheduled_updates_equal_optax(name):
    """Five Adam updates of ``DaggerTrainer`` and ``CoverageImitationTrainer``
    on ``SCHEDULE`` from the same flax weights: the loss and the gradients
    against ``jax.value_and_grad`` at JAX's weights, the weights against
    ``optax.adam(schedule)`` given the port's gradients (the coverage logit
    head's last bias has a gradient of zero up to rounding, which Adam
    would turn into +-lr by the sign of that rounding, see
    ``tests/test_torch_coverage_train.py``), and each update's ``lr``."""
    pair = _dagger_pair if name == "dagger" else _coverage_pair
    (jloss, tx, params, batches, to_port, port_grads, pairs, ttr, wgrad,
     bgrad) = pair(_schedules())
    _, schedule = _schedules()
    opt_state = tx.init(params)
    for i in range(5):
        batch = batches(5 + i)
        args = (batch,) if isinstance(batch, dict) else tuple(map(jnp.asarray, batch))
        loss, grads = jax.value_and_grad(jloss)(params, *args)
        got = ttr.update(to_port(batch))
        _close(float(got), float(loss))
        updates, opt_state = tx.update(port_grads(), opt_state, params)
        params = optax.apply_updates(params, updates)
        for (jg, layer), (jw, _) in zip(pairs(grads), pairs(params)):
            _close(wgrad(layer).T, jg["kernel"])
            _close(bgrad(layer), jg["bias"])
            _close(layer.weight.detach().numpy().T, jw["kernel"])
            _close(layer.bias.detach().numpy(), jw["bias"])
        assert ttr.optimizer.param_groups[0]["lr"] == schedule(i)
    assert ttr.step == 5


def test_dp_step_at_one_gloo_rank_follows_the_schedule(tmp_path):
    """``make_sharded_train_step`` at world size 1 takes the same three
    updates as ``update`` on the rank's batches, at the same scheduled
    rates."""
    import torch.distributed as dist

    env, params = gft.make("FlockingRelative-v0", n_agents=8)
    schedule = tt.cosine_decay_schedule(1e-2, 2, alpha=0.1)
    dp, twin = (tt.FlockingImitationTrainer(env, params, learning_rate=schedule, device="cpu")
                for _ in range(2))
    dp.init(torch.Generator().manual_seed(0))
    twin.init(torch.Generator().manual_seed(0))
    tdist.initialize("gloo", f"file://{tmp_path / 'store'}", 1, 0)
    try:
        step = dp.make_sharded_train_step(None, n_envs=2, n_steps=2)
        gen, replay = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
        for i in range(3):
            loss = step(gen)
            seed = int(torch.randint(0, 1 << 62, (1,), generator=replay))
            want = twin.update(twin.collect(tdist.host_fold(seed, 0), 2, 2))
            assert float(loss) == float(want)
            assert dp.optimizer.param_groups[0]["lr"] == schedule(i)
            assert twin.optimizer.param_groups[0]["lr"] == schedule(i)
    finally:
        dist.destroy_process_group()
    assert dp.step == twin.step == 3
    for a, b in zip(dp.model.parameters(), twin.model.parameters()):
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
