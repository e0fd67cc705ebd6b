"""Coverage imitation learning of the PyTorch port against the JAX
package's ``models/gnn.py`` and ``parallel/train_coverage.py`` on the CPU.

Inputs come from numpy seeds or from the port's own observations
(``Coverage-v0`` / ``ExploreEnv-v0`` with ``n_graphs=2`` on procedural maps;
the suite sets GYM_FLOCK_TPU_MAPS=off), at latent 16 and 2 rounds.  Random
streams cannot match, so collects are held to JAX from the same states with
the controller's ``rand_u`` set to JAX's own draw, and DAGGER by the
invariants of its buffer and schedule.

Tolerances: the observation decoding and the action-edge gather exactly;
EdgeGraphNet's node states and edge logits, the loss and every gradient
within 1e-5 of the array's largest magnitude (at least 1); the weights
after one Adam step within 1e-6 of optax's ``adam`` on the same gradients.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gym_flock_tpu.models import gnn as jgnn
from gym_flock_tpu.parallel import train_coverage as jtc
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs.coverage import CoverageEnv
from gym_flock_tpu_torch.models import gnn
from gym_flock_tpu_torch.parallel import train_coverage as tc
from tests.test_torch_coverage_env import B, _envs, _keys

torch.set_num_threads(2)

TOL = 1e-5
ADAM_TOL = 1e-6
LATENT, ROUNDS = 16, 2
COVERAGE = ("Coverage-v0", (("n_graphs", 2),))
EXPLORE = ("ExploreEnv-v0", (("n_graphs", 2),))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |port - jax| = {err:.3e} > {tol} * {scale:.3e}"


def _flat_obs(obs) -> np.ndarray:
    """The flat observation (nodes, edges, senders, receivers, step) of a
    batched port observation, as the reference's ``unpack_obs`` reads it."""
    b = obs["nodes"].shape[0]
    parts = [obs[k].reshape(b, -1).to(torch.float32)
             for k in ("nodes", "edges", "senders", "receivers", "step")]
    return torch.cat(parts, dim=1).numpy()


@functools.lru_cache(maxsize=None)
def _batch_np(env_id, kw, n_steps=3, seed=0):
    """A batch of real port observations (B envs x ``n_steps`` steps of the
    greedy expert, the layout of ``collect_coverage_batch``), as numpy."""
    _, _, tenv, tp, _ = _envs(env_id, kw)
    batch = tc.collect_coverage_batch(tenv, tp, torch.Generator().manual_seed(seed), B, n_steps)
    return {k: v.numpy().copy() for k, v in batch.items()}


def _graph_np(batch):
    mask = batch["senders"] != -1
    return {"nodes": batch["nodes"], "edges": batch["edges"],
            "senders": np.where(mask, batch["senders"], 0).astype(np.int32),
            "receivers": np.where(mask, batch["receivers"], 0).astype(np.int32),
            "edge_mask": mask}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _models(tp, seed=3):
    """flax's EdgeGraphNet and its variables, and the port's with the same
    weights."""
    jmodel = jgnn.EdgeGraphNet(latent=LATENT, rounds=ROUNDS)
    e = tp.max_edges
    dummy = {"nodes": jnp.zeros((tp.max_nodes, tp.n_node_feat), jnp.float32),
             "edges": jnp.zeros((e, tp.n_edge_feat), jnp.float32),
             "senders": jnp.zeros((e,), jnp.int32), "receivers": jnp.zeros((e,), jnp.int32),
             "edge_mask": jnp.zeros((e,), bool)}
    variables = jmodel.init(jax.random.key(seed), dummy)
    model = gnn.EdgeGraphNet(latent=LATENT, rounds=ROUNDS, n_node_feat=tp.n_node_feat,
                             n_edge_feat=tp.n_edge_feat)
    convert.edge_graph_net_params_from_flax(variables, model)
    return jmodel, variables, model


def _grad(t: torch.Tensor) -> np.ndarray:
    # the last round's node MLP reaches no edge logit: torch leaves its
    # gradient None where JAX gives zeros
    return np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()


def _pairs(tree, model):
    """(flax Dense dict, port Linear) in flax's naming order."""
    return [(tree["params"][f"_MLP_{i}"][f"Dense_{j}"], layer)
            for i, mlp in enumerate(model.mlps()) for j, layer in enumerate(mlp.layers)]


# ------------------------------------------------------------ decoding


@pytest.mark.parametrize("nf,ef,epn,glob", [(3, 1, 4, 1), (4, 2, 3, 2)])
def test_unpack_obs_equals_jax_on_random_flat_obs(nf, ef, epn, glob):
    rng = np.random.RandomState(nf)
    n, b = 37, 4
    e = n * epn
    ids = rng.randint(-1, n, size=(b, 2 * e)).astype(np.float32)
    ids[:, :5] += 0.75  # non-integral ids truncate as astype(int32) does
    flat = np.concatenate([rng.randn(b, n * nf + e * ef).astype(np.float32), ids,
                           rng.randn(b, glob).astype(np.float32)], axis=1)
    want = jgnn.unpack_obs(jnp.asarray(flat), n, nf, ef, epn, glob)
    got = gnn.unpack_obs(torch.from_numpy(flat), n, nf, ef, epn, glob)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["senders"].dtype == torch.int32 and got["edge_mask"].dtype == torch.bool
    state = rng.randn(b, n * 2 * 5).astype(np.float32)
    want = jgnn.unpack_obs_state(jnp.asarray(flat), jnp.asarray(state), n, 5, nf, ef, epn, glob)
    got = gnn.unpack_obs_state(torch.from_numpy(flat), torch.from_numpy(state), n, 5, nf, ef,
                               epn, glob)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("env_id,kw", [COVERAGE, EXPLORE])
def test_unpack_obs_equals_jax_on_port_observations(env_id, kw):
    """The port's own observations flattened (hidden edges included), then
    decoded by both packages."""
    _, _, tenv, tp, _ = _envs(env_id, kw)
    _, obs = tenv.reset_env(torch.Generator().manual_seed(2), tp, B)
    flat = _flat_obs(obs)
    n = gnn.get_number_nodes(flat.shape[1], n_node_feat=tp.n_node_feat)
    assert n == jgnn.get_number_nodes(flat.shape[1], n_node_feat=tp.n_node_feat) == tp.max_nodes
    want = jgnn.unpack_obs(jnp.asarray(flat), n, n_node_feat=tp.n_node_feat)
    got = gnn.unpack_obs(torch.from_numpy(flat), n, n_node_feat=tp.n_node_feat)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["nodes"].numpy(), obs["nodes"].numpy())
    np.testing.assert_array_equal(got["edge_mask"].numpy(), obs["senders"].numpy() != -1)


@pytest.mark.parametrize("flat_dim", [1, 17, 2000 * 15 + 1, 500 * 15 + 1, 12345])
def test_get_number_nodes_equals_jax(flat_dim):
    for kw in ({}, {"n_node_feat": 4, "n_edge_feat": 2, "max_edges_per_node": 3}):
        assert gnn.get_number_nodes(flat_dim, **kw) == jgnn.get_number_nodes(flat_dim, **kw)


@pytest.mark.parametrize("env_id,kw", [COVERAGE, EXPLORE])
def test_action_edge_logits_equals_jax(env_id, kw):
    _, jp, _, tp, _ = _envs(env_id, kw)
    logits = np.random.RandomState(1).randn(B, tp.max_edges, 1).astype(np.float32)
    want = jax.vmap(lambda x: jtc.action_edge_logits(x, jp))(jnp.asarray(logits))
    got = tc.action_edge_logits(torch.from_numpy(logits), tp)
    assert got.shape == (B, tp.n_robots, tp.n_actions)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one graph without the batch axis, as the JAX function takes it
    np.testing.assert_array_equal(tc.action_edge_logits(torch.from_numpy(logits[0]), tp).numpy(),
                                  np.asarray(want[0]))


# ------------------------------------------------------------ the model


def test_edge_graph_net_equals_flax_on_explore_observations():
    """Node states and edge logits of ``jax.vmap(model.apply)`` on a batch
    of ExploreEnv-v0 observations with padded AND hidden edges (sender -1,
    receiver real: the mask must come from the senders)."""
    _, _, _, tp, _ = _envs(*EXPLORE)
    batch = _batch_np(*EXPLORE)
    hidden = (batch["senders"] == -1) & (batch["receivers"] != -1)
    assert hidden.any() and (batch["senders"] != -1).any()
    jmodel, variables, model = _models(tp)
    graph = _graph_np(batch)
    jh, jl = jax.vmap(lambda g: jmodel.apply(variables, g))(
        {k: jnp.asarray(v) for k, v in graph.items()})
    with torch.no_grad():
        h, logits = model(_torch(graph))
    assert h.shape == (len(batch["label"]), tp.max_nodes, LATENT)
    assert logits.shape == (len(batch["label"]), tp.max_edges, 1)
    _close(h.numpy(), jh)
    _close(logits.numpy(), jl)


def test_edge_graph_net_params_from_flax_raises_on_a_mismatch():
    _, _, _, tp, _ = _envs(*COVERAGE)
    _, variables, _ = _models(tp)
    with pytest.raises(ValueError, match="MLPs"):
        convert.edge_graph_net_params_from_flax(variables, gnn.EdgeGraphNet(LATENT, ROUNDS + 1))
    with pytest.raises(ValueError, match="kernel"):
        convert.edge_graph_net_params_from_flax(variables, gnn.EdgeGraphNet(LATENT + 1, ROUNDS))


def test_edge_graph_net_init_is_flax_lecun_normal_from_the_generator():
    """Same generator seed, same weights; zero biases; std sqrt(1/fan_in)."""
    a = gnn.EdgeGraphNet(32, 2, generator=torch.Generator().manual_seed(5))
    b = gnn.EdgeGraphNet(32, 2, generator=torch.Generator().manual_seed(5))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.message_mlps[0].layers[0].weight.detach()
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(w.shape[1]) + 1e-6
    assert all(not layer.bias.detach().any() for m in a.mlps() for layer in m.layers)


# ------------------------------------------------------------ the trainer


def _trainers(env_id, kw, seed=3):
    jenv, jp, tenv, tp, _ = _envs(env_id, kw)
    jmodel, variables, model = _models(tp, seed)
    jtr = jtc.CoverageImitationTrainer(jenv, jp, model=jmodel)
    ttr = tc.CoverageImitationTrainer(tenv, tp, model=model, device="cpu")
    return jtr, (variables, jtr.tx.init(variables)), ttr


@pytest.mark.parametrize("env_id,kw", [COVERAGE, EXPLORE])
def test_loss_gradients_and_adam_step_equal_jax_and_optax(env_id, kw):
    """The loss and every gradient against ``jax.value_and_grad``; the
    weights after the Adam step against optax's ``adam`` given the port's
    gradients.  (Adam's first step divides each gradient by its own size,
    so where a gradient is zero in exact arithmetic and f32 round-off in
    both packages, e.g. the logit head's output bias, whose softmax
    gradient sums to zero over the actions, the two steps differ by up to
    lr * |g| / (|g| + eps); the gradients themselves agree.)"""
    jtr, (params, opt_state), ttr = _trainers(env_id, kw)
    batch = _batch_np(env_id, kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(jtr.loss_fn)(params, jbatch)

    got = ttr.update(_torch(batch))
    _close(float(got), float(loss))
    port_grads = {"params": {}}
    for i, mlp in enumerate(ttr.model.mlps()):
        port_grads["params"][f"_MLP_{i}"] = {
            f"Dense_{j}": {"kernel": jnp.asarray(_grad(layer.weight).T),
                           "bias": jnp.asarray(_grad(layer.bias))}
            for j, layer in enumerate(mlp.layers)}
    updates, _ = jtr.tx.update(port_grads, opt_state, params)
    new_params = optax.apply_updates(params, updates)
    for (jg, layer), (jw, _) in zip(_pairs(grads, ttr.model), _pairs(new_params, ttr.model)):
        _close(_grad(layer.weight).T, jg["kernel"])
        _close(_grad(layer.bias), jg["bias"])
        _close(layer.weight.detach().numpy().T, jw["kernel"], ADAM_TOL)
        _close(layer.bias.detach().numpy(), jw["bias"], ADAM_TOL)
    assert ttr.step == 1
    # update_from_batch takes the same step
    jloss2 = float(jtr.loss_fn(new_params, jbatch))
    _close(float(ttr.update_from_batch(_torch(batch))), jloss2)


def test_accuracy_equals_jax():
    """Equal to JAX's up to the robots whose two best logits tie within
    1e-5 (padded action slots repeat an edge, so exact ties are common at
    initialisation, and round-off picks the argmax there)."""
    jtr, (params, _), ttr = _trainers(*COVERAGE)
    batch = _batch_np(*COVERAGE)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = float(jtr.accuracy(params, jbatch))
    _, edge_logits = jax.vmap(lambda g: jtr.model.apply(params, g))(
        {k: jnp.asarray(v) for k, v in _graph_np(batch).items()})
    top2 = np.sort(np.asarray(jax.vmap(lambda e: jtc.action_edge_logits(e, jtr.env_params))(
        edge_logits)), axis=-1)[..., -2:]
    ties = int((top2[..., 1] - top2[..., 0] < 1e-5).sum())
    got = float(ttr.accuracy(_torch(batch)))
    assert abs(got - want) * batch["label"].size <= ties + 1e-3


class _ReplayEnv(CoverageEnv):
    """The port's env started from a given state, its controller fed JAX's
    random draws: a collect from the same states as a JAX loop."""

    def __init__(self, start, draws):
        self.start, self.draws = start, iter(draws)

    def reset_env(self, generator, params, n_envs):
        return self.start

    def controller(self, state, params, generator=None, rand_u=None):
        return super().controller(state, params, rand_u=next(self.draws))


@pytest.mark.parametrize("env_id,kw", [COVERAGE, EXPLORE])
def test_collect_equals_the_jax_loop_from_the_same_states(env_id, kw):
    jenv, jp, tenv, tp, jfn = _envs(env_id, kw)
    n_steps = 3
    js, jobs = jfn["reset"](_keys(7))
    ts = convert.coverage_state_from_numpy(js)
    start_obs = {k: torch.from_numpy(np.array(v)) for k, v in jobs.items()}
    want, draws = {k: [] for k in ("nodes", "edges", "senders", "receivers", "label")}, []
    for t in range(n_steps):
        keys = _keys(7, t + 1)
        ju = jfn["controller"](js, keys)
        draws.append(torch.from_numpy(np.array(jfn["draw"](keys))))
        for k in ("nodes", "edges", "senders", "receivers"):
            want[k].append(np.asarray(jobs[k]))
        want["label"].append(np.asarray(ju).reshape(B, -1))
        js, jobs, _, _, _ = jfn["step"](keys, js, ju)
    env = _ReplayEnv((ts, start_obs), draws)
    got = tc.collect_coverage_batch(env, tp, torch.Generator(), B, n_steps)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.stack(v, axis=1).reshape((B * n_steps,) + v[0].shape[1:])
        assert got[k].dtype == (torch.float32 if k in ("nodes", "edges") else torch.int32), k
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-6, err_msg=k)


def test_fit_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Interrupt + resume == straight through (tests/test_models_train.py:240
    on the coverage trainer): the same weights and losses, evaluations on."""
    _, _, tenv, tp, _ = _envs(*COVERAGE)

    def trainer():
        return tc.CoverageImitationTrainer(tenv, tp, model=gnn.EdgeGraphNet(LATENT, ROUNDS),
                                           device="cpu")

    kw = dict(n_envs=2, n_steps=2, eval_params=tp, eval_every=2)
    full = trainer()
    losses_full, evals_full = full.fit(torch.Generator().manual_seed(3), n_iters=4, **kw)
    assert [e["iter"] for e in evals_full] == [2, 4]
    assert all(np.isfinite(list(e.values())).all() for e in evals_full)

    path = str(tmp_path / "coverage.pt")
    part = trainer()
    first, _ = part.fit(torch.Generator().manual_seed(3), n_iters=2, ckpt_path=path,
                        ckpt_every=1, **kw)
    resumed = trainer()
    rest, evals = resumed.fit(torch.Generator().manual_seed(3), n_iters=4, ckpt_path=path, **kw)
    assert len(rest) == 2 and resumed.step == 4
    assert first + rest == losses_full
    assert evals == evals_full[1:]
    for a, b in zip(full.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    # without evaluations fit returns the losses alone
    assert len(trainer().fit(torch.Generator().manual_seed(3), n_iters=1, n_envs=2,
                             n_steps=2)) == 1


def test_evaluate_reports_both_policies_over_the_same_resets():
    _, _, tenv, tp, _ = _envs(*COVERAGE)
    ttr = tc.CoverageImitationTrainer(tenv, tp, model=gnn.EdgeGraphNet(LATENT, ROUNDS),
                                      device="cpu")
    m = ttr.evaluate(torch.Generator().manual_seed(0), n_envs=3, n_steps=5)
    assert set(m) == {"accuracy", "policy_reward", "expert_reward", "reward_ratio"}
    assert 0.0 <= m["accuracy"] <= 1.0 and m["expert_reward"] > 0
    assert m["reward_ratio"] == pytest.approx(m["policy_reward"] / m["expert_reward"])
    # the expert's episode reward is the greedy rollout's from the same reset
    gen = torch.Generator().manual_seed(4)
    state, obs = tenv.reset_env(gen, tp, 3)
    copy = torch.Generator()
    copy.set_state(gen.get_state())
    got = ttr.episode_reward(state, obs, tp, 5, expert_generator=gen)
    total = torch.zeros(3)
    for _ in range(5):
        state, obs, r, _, _ = tenv.step_env(None, state, tenv.controller(state, tp, copy), tp)
        total += r
    assert torch.equal(got, total)


# ------------------------------------------------------------ DAGGER


def _replay_check(env, params, gen_state, batch, n_envs, n_steps, actions_fn):
    """Reset from ``gen_state`` as the collect did, then step with
    ``actions_fn(t, state, stored obs)``: every stored observation must be
    the one those actions lead to."""
    gen = torch.Generator()
    gen.set_state(gen_state)
    state, obs = env.reset_env(gen, params, n_envs)
    view = {k: v.reshape((n_envs, n_steps) + v.shape[1:]) for k, v in batch.items()}
    for t in range(n_steps):
        stored = {k: v[:, t] for k, v in view.items()}
        for k in ("nodes", "edges", "senders", "receivers"):
            assert torch.equal(obs[k], stored[k]), f"t={t} {k}"
        state, obs, _, _, _ = env.step_env(None, state, actions_fn(t, state, stored), params)
    return view


def _dagger(capacity=20, seed=0):
    _, _, tenv, tp, _ = _envs(*COVERAGE)
    trainer = tc.CoverageDaggerTrainer(tenv, tp, model=gnn.EdgeGraphNet(LATENT, ROUNDS),
                                       capacity=capacity, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    trainer.init(gen)
    return trainer, gen


def test_dagger_at_beta_1_stores_the_expert_actions_it_took():
    """At beta=1 every action taken is the expert's, and the stored labels
    are those actions: replaying them reproduces every stored observation,
    and they equal the greedy controller on the replayed states wherever
    no random draw decides."""
    trainer, gen = _dagger()
    n_envs, n_steps = 2, 4
    start = gen.get_state()
    loss = trainer.iteration(gen, 1.0, n_envs, n_steps, n_grad_steps=2, batch_size=8)
    assert np.isfinite(float(loss))
    p = trainer.env_params
    batch = {k: v[:n_envs * n_steps] for k, v in trainer.buffer.items()}

    def expert_label(t, state, stored):
        plain = trainer.env.controller(state, p, rand_u=torch.full((n_envs, p.n_robots), -1))
        decided = plain[..., 0] != -1
        assert torch.equal(stored["label"][decided], plain[..., 0][decided])
        return stored["label"]

    _replay_check(trainer.env, p, start, batch, n_envs, n_steps, expert_label)


def test_dagger_at_beta_0_follows_the_learner_and_labels_with_the_expert():
    trainer, gen = _dagger()
    n_envs, n_steps = 2, 4
    before = gnn.EdgeGraphNet(LATENT, ROUNDS)
    before.load_state_dict(trainer.model.state_dict())
    learner = tc.CoverageImitationTrainer(trainer.env, trainer.env_params, model=before,
                                          device="cpu")
    start = gen.get_state()
    trainer.iteration(gen, 0.0, n_envs, n_steps, n_grad_steps=1, batch_size=8)
    p = trainer.env_params
    batch = {k: v[:n_envs * n_steps] for k, v in trainer.buffer.items()}

    def learner_action(t, state, stored):
        plain = trainer.env.controller(state, p, rand_u=torch.full((n_envs, p.n_robots), -1))
        decided = plain[..., 0] != -1
        assert torch.equal(stored["label"][decided], plain[..., 0][decided])
        with torch.no_grad():
            return learner.logits(stored).argmax(dim=-1).to(torch.int32)

    _replay_check(trainer.env, p, start, batch, n_envs, n_steps, learner_action)


def test_dagger_buffer_wraps_and_fills_and_checks_its_capacity():
    trainer, gen = _dagger(capacity=20)
    collected = []
    collect = trainer.collect
    trainer.collect = lambda *a: collected.append(collect(*a)) or collected[-1]
    expect = [(8, 8), (16, 16), (4, 20), (12, 20)]
    for k, (pos, filled) in enumerate(expect):
        trainer.iteration(gen, trainer.beta_decay ** k, 2, 4, n_grad_steps=1, batch_size=8)
        assert (trainer.write_pos, trainer.filled) == (pos, filled)
    # slots 16..19 and 0..3 hold the third collect, 4..11 the fourth,
    # 12..15 still the second's last half
    order = [(collected[2], range(0, 4), range(16, 20)), (collected[2], range(4, 8), range(0, 4)),
             (collected[3], range(0, 8), range(4, 12)), (collected[1], range(4, 8), range(12, 16))]
    for traj, src, dst in order:
        for k, buf in trainer.buffer.items():
            assert torch.equal(buf[list(dst)], traj[k][list(src)].to(buf.dtype)), k
    with pytest.raises(ValueError, match="capacity"):
        trainer.iteration(gen, 1.0, 3, 7)


def test_dagger_fit_follows_the_beta_schedule():
    trainer, _ = _dagger(capacity=64)
    betas = []
    iteration = trainer.iteration
    trainer.iteration = lambda gen, beta, **kw: betas.append(beta) or iteration(gen, beta, **kw)
    losses = trainer.fit(torch.Generator().manual_seed(1), n_iters=3, n_envs=2, n_steps=2,
                         n_grad_steps=1, batch_size=4)
    assert betas == [1.0, 0.7, 0.7 ** 2] and len(losses) == 3 and np.isfinite(losses).all()
    assert (trainer.write_pos, trainer.filled) == (12, 12)


@pytest.mark.parametrize("name", ["CoverageImitationTrainer", "CoverageDaggerTrainer"])
def test_coverage_trainers_default_to_the_card(name):
    """Without ``device=`` a trainer puts its model on the card; on a
    machine without one, construction raises."""
    _, _, tenv, tp, _ = _envs(*COVERAGE)
    cls = getattr(tc, name)
    if torch.cuda.is_available():
        assert cls(tenv, tp).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            cls(tenv, tp)


def test_default_model_reads_the_envs_feature_widths():
    _, _, tenv, tp, _ = _envs(*EXPLORE)
    ttr = tc.CoverageImitationTrainer(tenv, tp, device="cpu")
    assert (ttr.model.latent, ttr.model.rounds) == (32, 2)
    assert ttr.model.node_encoder.layers[0].in_features == tp.n_node_feat == 4
    batch = _torch(_batch_np(*EXPLORE))
    assert np.isfinite(float(ttr.loss_fn(batch).detach()))
