"""The legacy facade's K-deep lookahead (``compat/gym_api.py``), on the host.

Counterparts of the JAX package's speculation tests
(``tests/test_compat.py``).  Each drives a facade with the lookahead
against a twin whose queue is flushed after every controller call, so that
the twin's every step is computed as it comes (the eager path), and holds
the two to each other exactly: every observation, reward and done, the final state and the
generator's state (``torch.Generator.get_state``).  One test holds the
port's queue to the JAX facade's from the same ``init_state(x)``, at the
flocking env tests' tolerances (``tests/test_torch_flocking_env.py``: the
expert action and the rewards atol 1e-4, the observation's values
max |port - jax| / (1 + |jax|) < 1e-4, the mean-pooled network atol 1e-6),
done exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gym_flock_tpu.compat import gym_api as jgym
from gym_flock_tpu_torch.compat import FlattenDictWrapper, make_legacy
from gym_flock_tpu_torch.compat.gym_api import fetch, first, tree_map

torch.set_num_threads(2)

CPU = dict(device="cpu")
U_ATOL = 1e-4
REWARD_ATOL = 1e-4
SUM_TOL = 1e-4
NETWORK_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


DEEP_RUN = 1 << 12  # a run of hits long enough for the deepest queue


def _deep(env):
    """The facade as after a long run of hits: its next queue is the deepest."""
    env._run = DEEP_RUN


def _pair(env_id, seed, **kw):
    a = make_legacy(env_id, **CPU, **kw)
    b = make_legacy(env_id, **CPU, **kw)
    a.seed(seed), b.seed(seed)
    _eq(a.reset(), b.reset())
    return a, b


def _eq(x, y):
    """Two trees of tensors and arrays equal exactly, dtype and shape too."""
    fx, fy = [], []
    tree_map(fx.append, fetch(x))
    tree_map(fy.append, fetch(y))
    assert len(fx) == len(fy)
    for u, v in zip(fx, fy):
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


def _same_stream(a, b):
    assert torch.equal(a._gen.get_state(), b._gen.get_state())


def _ctrl(env, greedy):
    return env.controller(greedy=True) if greedy else env.controller()


def _unfused(b, greedy):
    """The twin's controller call, its queue flushed at once."""
    u = _ctrl(b, greedy)
    b._flush_queue()
    return u


def _steps_equal(a, b, ua, ub):
    oa, ra, da, ia = a.step(ua)
    ob, rb, db, ib = b.step(ub)
    _eq(oa, ob)
    assert ra == rb and da == db and ia == ib
    return da


@pytest.mark.parametrize("env_id,kw,greedy", [
    ("FlockingRelative-v0", dict(n_agents=12), False),
    ("Coverage-v0", dict(n_graphs=1), True),
])
def test_speculation_matches_unfused(env_id, kw, greedy):
    """controller() then step(u) (a hit) equals the unfused pair of calls,
    the generator's stream included (JAX ``test_flocking_``/
    ``test_coverage_speculation_matches_unfused``)."""
    a, b = _pair(env_id, 7, **kw)
    for _ in range(3 * a._RAMP):  # alone, then queues of 1 and 2
        ua, ub = _ctrl(a, greedy), _unfused(b, greedy)
        np.testing.assert_array_equal(ua, ub)
        _steps_equal(a, b, ua, ub)
    assert a.computed_pairs > 0 and b.computed_pairs == 0
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_speculation_miss_on_different_action():
    """A step with another action than the controller's ignores the queue
    and equals a step with no controller call (for the deterministic
    flocking expert, which draws nothing)."""
    a, b = _pair("FlockingRelative-v0", 11, n_agents=12)
    other = np.full((12, 2), 0.25)
    _deep(a)
    a.controller()
    _steps_equal(a, b, other, other)
    assert a._run == 0 and not a._queue
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_speculation_survives_user_mutation_of_action():
    """The action returned is a copy: mutating it and stepping is a miss
    with the mutated action, not a stale hit."""
    a, b = _pair("FlockingRelative-v0", 5, n_agents=12)
    _deep(a)
    u = a.controller()
    u[:] = 0.125
    _steps_equal(a, b, u, np.full_like(u, 0.125))
    assert a.controller() is not a.controller()


def test_coverage_k_speculation_matches_unfused_stream():
    """A 24-step greedy loop through ``FlattenDictWrapper`` gives the same
    observations, rewards, dones and stream as the flushed twin, and the
    next controller call agrees."""
    a, b = _pair("Coverage-v0", 3, n_graphs=1)
    wa, wb = FlattenDictWrapper(a), FlattenDictWrapper(b)
    for t in range(24):
        if t == 12:
            _deep(a)
        ua, ub = a.controller(greedy=True), _unfused(b, True)
        np.testing.assert_array_equal(ua, ub)
        oa, ra, da, _ = wa.step(ua)
        ob, rb, db, _ = wb.step(ub)
        np.testing.assert_array_equal(oa, ob)
        assert ra == rb and da == db
    assert a._run > DEEP_RUN and len(a._queue) > 1
    np.testing.assert_array_equal(a.controller(greedy=True), b.controller(greedy=True))
    _same_stream(a, b)


def test_coverage_k_speculation_mid_run_miss():
    """A perturbed action mid-run commits the right transition and stream."""
    a, b = _pair("Coverage-v0", 5, n_graphs=1)
    _deep(a)
    for t in range(10):
        ua, ub = a.controller(greedy=True), _unfused(b, True)
        if t == 4:
            ua = (np.asarray(ua) + 1) % 4
            ub = ua.copy()
        _steps_equal(a, b, ua, ub)
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_coverage_k_speculation_double_controller_and_direct_step():
    """A doubled controller call (the greedy expert draws, so the second
    call draws again) and a step without a controller call keep the stream
    of the unfused calls."""
    a, b = _pair("Coverage-v0", 7, n_graphs=1)
    _deep(a)
    for _ in range(3):
        ua, ub = a.controller(greedy=True), _unfused(b, True)
        _steps_equal(a, b, ua, ub)
    a.controller(greedy=True)
    ua = a.controller(greedy=True)
    _unfused(b, True)
    ub = _unfused(b, True)
    np.testing.assert_array_equal(ua, ub)
    _steps_equal(a, b, ua, ub)
    _deep(a)  # a deep queue, so that the hit below leaves entries
    ua, ub = a.controller(greedy=True), _unfused(b, True)
    _steps_equal(a, b, ua, ub)
    assert a._queue and not a._head_served
    # the queued action itself, stepped without its controller call
    act = a._queue[0].action.copy()
    _steps_equal(a, b, act, act)
    _same_stream(a, b)
    act = np.zeros((6, 1), dtype=np.int32)
    _steps_equal(a, b, act, act)
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_flocking_k_speculation_long_run_stream_equality():
    """20 steps of the base class's deep queue: the same trajectory and
    stream as the unfused loop; a doubled controller call of the Turner
    expert (which draws nothing) re-serves the head; a perturbed action is
    a miss that falls back identically."""
    a, b = _pair("FlockingRelative-v0", 11, n_agents=12)
    _deep(a)
    for t in range(20):
        ua = a.controller()
        if t == 5:
            np.testing.assert_array_equal(ua, a.controller())
        ub = _unfused(b, False)
        np.testing.assert_array_equal(ua, ub)
        if t == 12:
            ua = np.asarray(ua) + 0.125
            ub = ua.copy()
        _steps_equal(a, b, ua, ub)
    assert a._deep_depth == a._SPEC_DEPTH_MAX and a.computed_pairs >= 32
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_k_speculation_depth_respects_byte_budget():
    """The deep queue's depth is the byte budget over an entry's bytes:
    N=12 takes the full depth, N=600 (a [600, 600] network an entry) less."""
    env = make_legacy("FlockingRelative-v0", **CPU, n_agents=12)
    env.seed(0), env.reset()
    env.step(env.controller())  # the first transition, computed alone: the budget
    _deep(env)
    env.step(env.controller())  # the deep queue
    assert env._deep_depth == env._SPEC_DEPTH_MAX == 32
    assert len(env._queue) == 31

    big = make_legacy("FlockingRelative-v0", **CPU, n_agents=600)
    big.seed(0), big.reset()
    big.step(big.controller())
    _deep(big)
    big.step(big.controller())
    assert 1 <= big._deep_depth < big._SPEC_DEPTH_MAX
    assert len(big._queue) == big._deep_depth - 1


@pytest.mark.parametrize("ramp", [1, 8])
@pytest.mark.parametrize("env_id,kw", [
    ("FlockingRelative-v0", dict(n_agents=10)),
    ("Coverage-v0", dict(n_graphs=1)),
])
def test_k_speculation_randomized_differential(env_id, kw, ramp):
    """A random 120-event interleaving of pairs, doubled controller calls,
    perturbed steps and resets against the flushed twin, with queues after
    every hit (``_RAMP`` 1) and at the facade's own ramp."""
    rng = np.random.RandomState(0)
    a, b = _pair(env_id, 9, **kw)
    a._RAMP = ramp
    greedy = env_id.startswith("Coverage")
    for i in range(120):
        ev = rng.choice(["pair", "double", "miss", "reset"], p=[0.6, 0.15, 0.15, 0.1])
        if ev == "reset":
            _eq(a.reset(), b.reset())
            continue
        ua, ub = _ctrl(a, greedy), _unfused(b, greedy)
        np.testing.assert_array_equal(ua, ub)
        if ev == "double":
            ua, ub = _ctrl(a, greedy), _unfused(b, greedy)
            np.testing.assert_array_equal(ua, ub)
        if ev == "miss":
            ua = (np.asarray(ua) + 1) % 4 if greedy else np.asarray(ua) + 0.25
            ub = np.array(ua)
        if _steps_equal(a, b, ua, ub):
            _eq(a.reset(), b.reset())
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_coverage_autoreset_speculation_crosses_episode_boundary():
    """The greedy queue runs on through the reset after a done step: over two
    episode ends every value and the stream equal the unfused calls', and
    the driver's reset() is served from the queue, which survives it."""
    a, b = _pair("Coverage-v0", 5, n_graphs=1)
    _deep(a)
    boundaries = 0
    for _ in range(200):
        ua, ub = a.controller(greedy=True), _unfused(b, True)
        np.testing.assert_array_equal(ua, ub)
        if _steps_equal(a, b, ua, ub):
            boundaries += 1
            before = len(a._queue)
            assert a._pending_reset is not None
            _eq(a.reset(), b.reset())
            assert before > 0 and len(a._queue) == before
            if boundaries == 2:
                break
    assert boundaries == 2
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_coverage_step_past_done_without_reset_matches_unfused():
    """A driver that steps on past done without reset() sees the unfused
    stream: the staged reset is dropped."""
    a, b = _pair("Coverage-v0", 9, n_graphs=1)
    _deep(a)
    dones = 0
    for _ in range(120):
        ua, ub = a.controller(greedy=True), _unfused(b, True)
        np.testing.assert_array_equal(ua, ub)
        dones += _steps_equal(a, b, ua, ub)
    assert dones > 0
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_coverage_controller_after_done_without_reset_matches_unfused():
    """A controller call right after a done step (no reset) computes from
    the done state, not from the staged reset; a step past done without a
    controller call drops the staged reset too."""
    for direct_step in (False, True):
        a, b = _pair("Coverage-v0", 13, n_graphs=1)
        _deep(a)
        for _ in range(120):
            ua, ub = a.controller(greedy=True), _unfused(b, True)
            if _steps_equal(a, b, ua, ub):
                break
        assert a._pending_reset is not None
        if direct_step:
            act = np.ones((6, 1), dtype=np.int32)
            _steps_equal(a, b, act, act)
        ua, ub = a.controller(greedy=True), _unfused(b, True)
        np.testing.assert_array_equal(ua, ub)
        _steps_equal(a, b, ua, ub)
        _eq(a.reset(), b.reset())
        _eq(a.state, b.state)
        _same_stream(a, b)


def test_every_state_or_parameter_change_flushes():
    """seed, reset, params_from_cfg, update_state and observe each flush
    the queue and end the run of hits, and the stream stays the unfused
    calls'."""
    a, b = _pair("Coverage-v0", 17, n_graphs=1)

    def pairs(n):
        _deep(a)
        for _ in range(n):
            ua, ub = a.controller(greedy=True), _unfused(b, True)
            _steps_equal(a, b, ua, ub)
        assert a._queue

    g = int(a.state.graph[0])
    pos = a.params.bank["target_pos"][g].numpy()
    nodes = np.nonzero(a.params.bank["target_mask"][g].numpy())[0][:6]
    for call in (lambda e: e.update_state(pos[nodes] + 0.3), lambda e: e.observe(),
                 lambda e: e.reset(), lambda e: e.seed(4)):
        pairs(3)
        _eq(call(a), call(b))
        assert not a._queue and a._pending_reset is None and a._run == 0
        _eq(a.state, b.state)
        _same_stream(a, b)
    a, b = _pair("FlockingRelative-v0", 2, n_agents=12)
    _deep(a)
    for _ in range(3):
        ua, ub = a.controller(), _unfused(b, False)
        _steps_equal(a, b, ua, ub)
    cfg = {"comm_radius": "1.5", "n_agents": "14"}
    a.params_from_cfg(cfg), b.params_from_cfg(cfg)
    assert not a._queue and a._deep_depth is None and a._run == 0
    _eq(a.reset(), b.reset())
    for _ in range(3):
        ua, ub = a.controller(), _unfused(b, False)
        assert ua.shape == (14, 2)
        _steps_equal(a, b, ua, ub)
    _same_stream(a, b)


def test_unhashable_option_computes_alone():
    """A controller option that cannot be hashed computes the action alone,
    as the JAX facade's eager path does, and equals the queued call's."""
    a, b = _pair("FlockingRelative-v0", 3, n_agents=12)
    ua = a.controller(centralized=np.array(True))
    assert not a._queue
    ub = b.controller(centralized=True)
    b._flush_queue()
    np.testing.assert_array_equal(ua, ub)
    _steps_equal(a, b, ua, ub)
    _same_stream(a, b)


@pytest.mark.parametrize("env_id,kw", [
    ("FlockingRelative-v0", dict(n_agents=10)),
    ("Coverage-v0", dict(n_graphs=1)),
])
def test_learner_actions_never_queue(env_id, kw):
    """A DAgger-style driver that asks the controller for labels and steps
    other actions never makes a hit, so the facade computes every
    controller call alone and every step as it comes: no pair is computed
    ahead, and every value equals the twin's."""
    rng = np.random.RandomState(1)
    a, b = _pair(env_id, 4, **kw)
    greedy = env_id.startswith("Coverage")
    for _ in range(3 * a._RAMP):
        ua, ub = _ctrl(a, greedy), _unfused(b, greedy)
        np.testing.assert_array_equal(ua, ub)
        if greedy:
            u = (np.asarray(ua) + rng.randint(1, 4, ua.shape)) % 4
        else:
            u = np.asarray(ua) + rng.uniform(0.1, 0.2, ua.shape).astype(ua.dtype)
        if _steps_equal(a, b, u, u.copy()):
            _eq(a.reset(), b.reset())
    assert a.computed_pairs == 0 and a.controller_evals == 3 * a._RAMP
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_a_miss_wastes_at_most_a_ramp_share():
    """On a loop that steps the controller's action nine times in ten (a
    DAgger mix), the queues grow past one entry, every value equals the
    twin's, and the pairs computed ahead and dropped are at most one for
    each ``_RAMP`` hits."""
    rng = np.random.RandomState(2)
    a, b = _pair("FlockingRelative-v0", 6, n_agents=10)
    hits = depth = 0
    for _ in range(300):
        ua, ub = a.controller(), _unfused(b, False)
        depth = max(depth, len(a._queue))
        if rng.uniform() < 0.9:
            hits += 1
        else:
            ua = np.asarray(ua) + np.float32(0.125)
            ub = ua.copy()
        if _steps_equal(a, b, ua, ub):
            _eq(a.reset(), b.reset())
    assert depth > 1 and a.computed_pairs <= hits + hits // a._RAMP
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_queue_stops_at_the_episode_end():
    """A flocking queue reaches no further than the step that ends the
    episode by its length, so that an expert loop that resets there drops
    no pair it computed: every controller evaluation is served."""
    a, b = _pair("FlockingRelative-v0", 8, n_agents=10, max_steps=30)
    for t in range(90):
        if t % 30 == 0:
            _deep(a)  # a long run at each episode's start: the deepest queues
        ua, ub = a.controller(), _unfused(b, False)
        np.testing.assert_array_equal(ua, ub)
        if _steps_equal(a, b, ua, ub):
            _eq(a.reset(), b.reset())
    assert a.computed_pairs == 90 and a.controller_evals == 90
    _eq(a.state, b.state)
    _same_stream(a, b)


@pytest.mark.parametrize("env_id,kw", [
    ("FlockingStochastic-v0", dict(n_agents=12)),
    ("FlockingLeader-v0", dict(n_agents=12)),
    ("Shepherding-v0", {}),
    ("FormationFlying-v0", {}),
    ("LQR-v0", {}),
    ("Mapping-v0", dict(n_agents=8)),
    ("FlockingMulti-v0", dict(n_agents=12)),
])
def test_other_families_match_unfused(env_id, kw):
    """Every other family's base-class queue equals the flushed twin over
    a deep queue, stepping on past the end of an episode (LQR and
    FlockingStochastic draw in their steps)."""
    a, b = _pair(env_id, 1, **kw)
    _deep(a)
    for _ in range(40):
        ua, ub = a.controller(), _unfused(b, False)
        np.testing.assert_array_equal(ua, ub)
        _steps_equal(a, b, ua, ub)
    assert a.computed_pairs > 40
    _eq(a.state, b.state)
    _same_stream(a, b)


def test_flocking_queue_equals_jax_from_the_same_state():
    """From one ``init_state(x)`` the port's deep queue (32 controller/step
    pairs of the Turner expert) equals the JAX facade's, entry by entry."""
    n = 12
    x = np.random.RandomState(4).uniform(-2.0, 2.0, (n, 4)).astype(np.float32)
    x[:, 2:] *= 0.5
    tl = make_legacy("FlockingRelative-v0", **CPU, n_agents=n)
    jl = jgym.make_legacy("FlockingRelative-v0", n_agents=n)
    tl.seed(0), jl.seed(0)
    tl.reset(), jl.reset()
    tl._state = tl.env.init_state(torch.as_tensor(x)[None], tl.params)
    jl._state = jl.env.init_state(jnp.asarray(x), jl.params)
    tl._flush_queue(), jl._flush_queue()
    tl.step(tl.controller())  # computed alone: the port's next queue is deep
    jl.step(jl.controller())  # a hit: the JAX facade's next queue is deep
    _deep(tl)
    tl.controller(), jl.controller()
    assert len(tl._queue) == len(jl._queue) == 32
    for te, je in zip(tl._queue, jl._queue):
        np.testing.assert_allclose(te.action, je["action"], rtol=0, atol=U_ATOL)
        values, network = te.obs
        jvalues, jnetwork = (np.asarray(v) for v in je["obs"])
        assert np.max(np.abs(values - jvalues) / (1 + np.abs(jvalues))) < SUM_TOL
        np.testing.assert_allclose(network, jnetwork, rtol=0, atol=NETWORK_ATOL)
        np.testing.assert_allclose(float(te.reward), float(je["reward"]), rtol=0,
                                   atol=REWARD_ATOL)
        assert bool(te.done) == bool(je["done"])
        np.testing.assert_allclose(first(fetch(te.state.x)), np.asarray(je["state"].x),
                                   rtol=0, atol=U_ATOL)
