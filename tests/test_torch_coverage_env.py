"""The port's coverage envs against ``jax.vmap`` of the JAX package's, from
identical states (B=3, procedural maps: the suite sets
GYM_FLOCK_TPU_MAPS=off).

``ExploreFullEnv-v0`` (T=1400, R=100, hide_nodes) takes the JAX package's
one-hot routes there (the MXU greedy expert and discovery masks), the port
its gather routes, so these tests hold the two formulations equal too.

Tolerances: integers and bools exactly (actions, senders, receivers, done,
robot locations, visited and discovered masks, rewards: sums of 0/1);
float features atol 1e-6 (edge distances divided by ``res``).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.envs.coverage import _resolve_conflicts as jax_resolve_conflicts
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs.coverage import CoverageEnv, _resolve_conflicts
from gym_flock_tpu_torch.envs.coverage_graph import reach_key

torch.set_num_threads(2)

FEAT_ATOL = 1e-6
B = 3
ENVS = [
    ("Coverage-v0", (("n_graphs", 2),)),
    ("ExploreEnv-v0", (("n_graphs", 2),)),
    ("ExploreFullEnv-v0", ()),
]
STATE_FIELDS = ("time", "graph", "robot_loc", "visited", "discovered", "episode_reward",
                "last_loc")


@functools.lru_cache(maxsize=None)
def _envs(env_id, kw):
    """Both packages' env and params, and the JAX functions, jitted and
    vmapped over the batch."""
    jenv, jp = gft_jax.make(env_id, **dict(kw))
    tenv, tp = gft.make(env_id, device="cpu", **dict(kw))
    jfn = {
        "reset": jax.jit(jax.vmap(lambda k: jenv.reset_env(k, jp))),
        "controller": jax.jit(jax.vmap(lambda s, k: jenv.controller(s, jp, key=k))),
        "step": jax.jit(jax.vmap(lambda k, s, u: jenv.step_env(k, s, u, jp))),
        "draw": jax.jit(jax.vmap(lambda k: jax.random.randint(
            k, (jp.n_robots,), 0, jp.n_actions, dtype=jnp.int32))),
    }
    return jenv, jp, tenv, tp, jfn


def _keys(seed, t=0):
    return jax.vmap(lambda k: jax.random.fold_in(k, t))(jax.random.split(jax.random.key(seed), B))


def _assert_obs_equal(tobs, jobs, msg=""):
    assert set(tobs) == set(jobs)
    for k in ("senders", "receivers"):
        assert tobs[k].dtype == torch.int32
        np.testing.assert_array_equal(tobs[k].numpy(), np.asarray(jobs[k]), err_msg=msg + k)
    for k in ("nodes", "edges", "step"):
        assert tobs[k].dtype == torch.float32
        assert tobs[k].shape == np.asarray(jobs[k]).shape, msg + k
        np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]), rtol=0, atol=FEAT_ATOL,
                                   err_msg=msg + k)
    np.testing.assert_array_equal(tobs["nodes"].numpy(), np.asarray(jobs["nodes"]))


def _assert_state_equal(ts, js, msg=""):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=msg + f)


def _sequential_reference(cur, chosen):
    """The reference's two-pass procedure (coverage.py:186-201), NumPy."""
    nxt = [-1] * len(cur)
    for i in range(len(cur)):
        if chosen[i] == cur[i]:
            nxt[i] = chosen[i]
    for i in range(len(cur)):
        if nxt[i] == -1:
            nxt[i] = cur[i] if chosen[i] in nxt else chosen[i]
    return np.asarray(nxt)


# the fuzz cases of tests/test_coverage_rollout.py: 1650 in all
@pytest.mark.parametrize("r,n_nodes,trials", [(2, 2, 200), (3, 2, 300), (6, 3, 500),
                                              (6, 8, 300), (12, 4, 300), (100, 30, 50)])
def test_resolve_conflicts_matches_jax(r, n_nodes, trials):
    """Tiny node universes force collisions; batched, every case at once."""
    rng = np.random.RandomState(r * 100 + n_nodes)
    cur = rng.randint(0, n_nodes, size=(trials, r)).astype(np.int32)
    chosen = rng.randint(0, n_nodes, size=(trials, r)).astype(np.int32)
    got, rounds = _resolve_conflicts(torch.from_numpy(cur), torch.from_numpy(chosen), True)
    want = jax.jit(jax.vmap(lambda c, ch: jax_resolve_conflicts(c, ch, True)))(
        jnp.asarray(cur), jnp.asarray(chosen))
    assert got.shape == (trials, r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.stack([_sequential_reference(c, ch) for c, ch in zip(cur, chosen)]))
    assert 1 <= rounds <= r


def test_resolve_conflicts_off_moves_every_robot():
    cur = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    chosen = torch.tensor([[1, 1, 1]], dtype=torch.int32)
    got, rounds = _resolve_conflicts(cur, chosen, False)
    assert torch.equal(got, chosen) and rounds == 0


@pytest.mark.parametrize("env_id,kw", ENVS)
def test_reset_observation_matches_jax(env_id, kw):
    """The observation rebuilt from a JAX reset state equals JAX's (the
    reset's targets under the robots are already visited there, so the
    rebuilt reward is 0)."""
    jenv, jp, tenv, tp, jfn = _envs(env_id, kw)
    js, jobs = jfn["reset"](_keys(1))
    ts = convert.coverage_state_from_numpy(js)
    _assert_state_equal(ts, js)
    pre = type(ts)(**{**ts.__dict__, "time": ts.time - 1})
    tobs, reward, done, ts2 = tenv._obs_reward(pre, tp)
    _assert_obs_equal(tobs, jobs)
    _assert_state_equal(ts2, js)
    assert reward.tolist() == [0.0] * B and not done.any()


@pytest.mark.parametrize("env_id,kw", ENVS)
def test_step_matches_jax(env_id, kw):
    """Three steps from the same states: expert actions, then random
    actions with out-of-range entries (clamped), then expert actions."""
    jenv, jp, tenv, tp, jfn = _envs(env_id, kw)
    js, _ = jfn["reset"](_keys(2))
    ts = convert.coverage_state_from_numpy(js)
    rng = np.random.RandomState(0)
    for t in range(3):
        keys = _keys(2, t + 1)
        ju = jfn["controller"](js, keys)
        if t == 1:
            ju = jnp.asarray(rng.randint(-2, 6, size=(B, jp.n_robots, 1)), jnp.int32)
        js, jobs, jr, jd, _ = jfn["step"](keys, js, ju)
        ts, tobs, tr, td, info = tenv.step_env(None, ts, torch.from_numpy(np.array(ju)), tp)
        assert info == {}
        msg = f"t={t} "
        _assert_obs_equal(tobs, jobs, msg)
        _assert_state_equal(ts, js, msg)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=msg)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=msg)
        assert tr.dtype == torch.float32 and td.dtype == torch.bool


@pytest.mark.parametrize("env_id,kw", ENVS)
def test_controller_matches_jax(env_id, kw):
    """With ``rand_u`` set to JAX's own draw for the same key, the greedy
    actions are equal exactly, over states that grow visited/discovered."""
    jenv, jp, tenv, tp, jfn = _envs(env_id, kw)
    js, _ = jfn["reset"](_keys(3))
    for t in range(3):
        keys = _keys(3, t + 1)
        ju = np.asarray(jfn["controller"](js, keys))
        rand_u = torch.from_numpy(np.asarray(jfn["draw"](keys)))
        tu = tenv.controller(convert.coverage_state_from_numpy(js), tp, rand_u=rand_u)
        assert tu.dtype == torch.int32 and tu.shape == (B, jp.n_robots, 1)
        np.testing.assert_array_equal(tu.numpy(), ju, err_msg=f"t={t}")
        js, _, _, _, _ = jfn["step"](keys, js, jnp.asarray(ju))


@pytest.mark.parametrize("env_id,kw", ENVS[:2])
def test_controller_random_action_where_nothing_is_left(env_id, kw):
    """Every target visited: every robot is unreachable and takes its random
    action, from ``rand_u`` (JAX's draw) or from the generator."""
    jenv, jp, tenv, tp, jfn = _envs(env_id, kw)
    js, _ = jfn["reset"](_keys(4))
    js = js.replace(visited=jnp.ones_like(js.visited))
    keys = _keys(4, 1)
    ju = np.asarray(jfn["controller"](js, keys))
    ts = convert.coverage_state_from_numpy(js)
    rand_u = torch.from_numpy(np.asarray(jfn["draw"](keys)))
    np.testing.assert_array_equal(tenv.controller(ts, tp, rand_u=rand_u).numpy(), ju)
    np.testing.assert_array_equal(ju[..., 0], rand_u.numpy())
    gen = torch.Generator().manual_seed(9)
    want = torch.randint(0, tp.n_actions, (B, tp.n_robots), generator=gen, dtype=torch.int32)
    gen.manual_seed(9)
    assert torch.equal(tenv.controller(ts, tp, generator=gen)[..., 0], want)


def test_discovery_fallback_matches_reach_lists():
    """Without reach lists for the radius, discovery takes the pairwise
    ``nodes_within_radius`` pass and gives the same steps."""
    jenv, jp, tenv, tp, jfn = _envs("ExploreEnv-v0", (("n_graphs", 2),))
    key = reach_key(tp.discover_radius)
    tp_fall = type(tp)(**{**tp.__dict__,
                          "bank": {k: v for k, v in tp.bank.items() if k != key}})
    js, _ = jfn["reset"](_keys(5))
    ts = tf = convert.coverage_state_from_numpy(js)
    for t in range(4):
        u = tenv.controller(ts, tp, rand_u=torch.zeros(B, tp.n_robots, dtype=torch.int32))
        ts, o1, r1, _, _ = tenv.step_env(None, ts, u, tp)
        tf, o2, r2, _, _ = tenv.step_env(None, tf, u, tp_fall)
        for k in o1:
            assert torch.equal(o1[k], o2[k]), (t, k)
        assert torch.equal(ts.discovered, tf.discovered) and torch.equal(r1, r2)


@pytest.mark.parametrize("env_id,kw", ENVS)
def test_reset_invariants(env_id, kw):
    """JAX keys and torch generators give different draws, so the reset is
    held to its invariants: R distinct robots inside the start region, every
    robot's node visited, at most floor(n_targets * frac) masked targets
    unvisited, every unmasked target visited, time 1."""
    _, _, tenv, tp, _ = _envs(env_id, kw)
    n = 6
    state, obs = tenv.reset_env(torch.Generator().manual_seed(7), tp, n)
    # replay the reset's first draws: the graph, then the start-region centre
    replay = torch.Generator().manual_seed(7)
    g = torch.randint(0, tp.bank["n_targets"].shape[0], (n,), generator=replay,
                      dtype=torch.int32)
    u = torch.rand(n, generator=replay, dtype=torch.float64)
    assert torch.equal(state.graph, g)
    r = tp.n_robots
    for b in range(n):
        gi = int(g[b])
        n_t = int(tp.bank["n_targets"][gi])
        mask = tp.bank["target_mask"][gi].numpy()
        hops = tp.bank["graph_hops"][gi].numpy()
        center = int(np.floor(float(u[b]) * n_t))
        d = np.where(mask, hops[center], np.inf)
        level = np.sort(d)[min(r * tp.nearby_density, n_t) - 1]
        region = (d <= level) & mask
        locs = state.robot_loc[b].numpy()
        assert len(set(locs.tolist())) == r
        assert region[locs].all()
        visited = state.visited[b].numpy()
        assert (visited[locs] == 1.0).all()
        assert ((visited == 0.0) & mask).sum() <= np.floor(n_t * tp.frac_active_targets)
        assert (visited[~mask] == 1.0).all()
    assert state.time.tolist() == [1] * n
    assert state.last_loc.tolist() == [[-1] * r] * n
    assert obs["step"].flatten().tolist() == [0.0] * n
    assert obs["nodes"].shape == (n, tp.max_nodes, tp.n_node_feat)
    assert obs["senders"].shape == (n, tp.max_edges)
    assert tenv.observation_space(tp).shape["nodes"] == (tp.max_nodes, tp.n_node_feat)


def test_params_from_jax_equal_the_factory_params():
    """``convert.coverage_params_from_jax`` gives the factory's params: the
    JAX bank's arrays plus the port's own operands."""
    for env_id, kw in ENVS[1:]:
        _, jp, _, tp, _ = _envs(env_id, kw)
        cp = convert.coverage_params_from_jax(jp)
        assert set(cp.bank) == set(tp.bank)
        for k in tp.bank:
            assert cp.bank[k].dtype == tp.bank[k].dtype, k
            assert torch.equal(cp.bank[k], tp.bank[k]), k
        assert {**cp.__dict__, "bank": None} == {**tp.__dict__, "bank": None}


def test_spaces_and_random_policy_actions():
    _, _, tenv, tp, _ = _envs("Coverage-v0", (("n_graphs", 2),))
    space = tenv.action_space(tp)
    a = space.sample(torch.Generator().manual_seed(0), (5,))
    assert a.shape == (5, tp.n_robots) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < tp.n_actions
    assert space.contains(a[0])
    assert set(tenv.observation_space(tp).keys()) == {"nodes", "edges", "senders",
                                                       "receivers", "step"}


def test_generator_on_another_device_raises():
    _, _, tenv, tp, _ = _envs("Coverage-v0", (("n_graphs", 2),))

    class Elsewhere:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="generator"):
        tenv.reset_env(Elsewhere(), tp, 2)
    state, _ = tenv.reset_env(torch.Generator().manual_seed(0), tp, 2)
    with pytest.raises(ValueError, match="generator"):
        tenv.controller(state, tp, generator=Elsewhere())


def test_default_params_build_coverage_v0():
    env = CoverageEnv()
    params = env.default_params(device="cpu")
    assert params.n_robots == 6 and "cost_rows_pad" in params.bank
    state, obs = env.reset_env(torch.Generator().manual_seed(1), params, 2)
    assert obs["nodes"].shape == (2, 500, 3)


def test_factory_builds_the_bank_on_the_card_by_default():
    """``make("Coverage-v0")`` without ``device=`` puts the bank, and with it
    the env, on the card; on a machine without one it raises instead of
    stepping on the host."""
    if torch.cuda.is_available():
        _, params = gft.make("Coverage-v0", n_graphs=1)
        assert params.bank["n_targets"].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            gft.make("Coverage-v0", n_graphs=1)


def test_default_params_and_bank_build_on_the_card_by_default():
    """``CoverageEnv().default_params()`` and ``default_coverage_bank()``
    without ``device=`` build on the card, as ``make`` does; without one
    they raise instead of falling back to the host."""
    from gym_flock_tpu_torch.envs.coverage import default_coverage_bank

    if torch.cuda.is_available():
        assert CoverageEnv().default_params().device.type == "cuda"
        assert default_coverage_bank(n_graphs=1)["n_targets"].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            CoverageEnv().default_params()
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            default_coverage_bank(n_graphs=1)


def test_reset_with_fewer_weighted_nodes_than_robots_fills_as_jax():
    """A graph of 3 targets and R=6 (a bank a registered id builds when its
    ``n_robots`` exceeds a graph's target count): ``jax.random.choice``
    takes the 3 weighted nodes, then the unweighted nodes of lowest index,
    and so does the port, for every env of the batch."""
    from gym_flock_tpu.envs import coverage_graph as jcg

    res = jcg.DELTA
    targets = np.stack([np.arange(3) * res, np.zeros(3)], axis=1)
    bank = jcg.build_graph_bank([jcg.build_graph_spec(targets, 10, 6, res * 1.2, 10)])
    jenv, jp = gft_jax.make("Coverage-v0", bank=bank, max_nodes=16)
    tp = convert.coverage_params_from_jax(jp)
    assert jp.n_robots == tp.n_robots == 6
    js, _ = jax.vmap(lambda k: jenv.reset_env(k, jp))(jax.random.split(jax.random.key(0), 8))
    ts, _ = CoverageEnv().reset_env(torch.Generator().manual_seed(0), tp, 8)
    want = np.arange(6)
    for b in range(8):
        np.testing.assert_array_equal(np.sort(np.asarray(js.robot_loc[b])), want)
        np.testing.assert_array_equal(np.sort(ts.robot_loc[b].numpy()), want)
        # the weighted nodes come first, in the order drawn
        assert set(ts.robot_loc[b, :3].tolist()) == {0, 1, 2}
        np.testing.assert_array_equal(ts.robot_loc[b, 3:].numpy(), [3, 4, 5])
