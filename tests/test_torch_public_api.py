"""The port's public names held to the JAX package's, on the host.

The edge helpers of ``ops/pairwise.py`` on the same NumPy inputs: indices
and masks exactly, distances within 1e-6 relative; ``flatten_space`` on
every registered id's observation space; ``Env.reset/step/expert`` against
the functions they call; every name that a JAX ``__init__`` re-exports;
the VRP library's ``native_available``.
"""
import ast
import dataclasses
import importlib
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
from gym_flock_tpu.core import env as jenv
from gym_flock_tpu.core import spaces as jspaces
from gym_flock_tpu.ops import pairwise as jpw
from gym_flock_tpu_torch.compat.gym_api import fetch, make_on, tree_map
from gym_flock_tpu_torch.core import env as tenv
from gym_flock_tpu_torch.core import spaces as tspaces
from gym_flock_tpu_torch.experts import vrp
from gym_flock_tpu_torch.ops import pairwise as tpw

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
DIST_RTOL = 1e-6
AIRSIM_IDS = ("FlockingAirsimAccel-v0", "MappingAirsim-v0")


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


def _points(seed, *shape):
    return np.random.RandomState(seed).uniform(0, 10, shape).astype(np.float32)


def _jax_batched(fn, *arrays):
    """``fn`` over the leading axis of each array, as the port takes it."""
    return jax.vmap(fn)(*(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("with_pos2", [False, True])
def test_pos_diff_equals_jax(with_pos2):
    a, b = _points(0, 13, 4), _points(1, 7, 4)
    args = (a, b) if with_pos2 else (a,)
    want = np.asarray(jpw.pos_diff(*(jnp.asarray(x) for x in args)))
    got = tpw.pos_diff(*(torch.as_tensor(x) for x in args)).numpy()
    np.testing.assert_array_equal(got, want)
    batched = [np.stack([x, x[::-1]]) for x in args]
    want = np.asarray(_jax_batched(jpw.pos_diff, *batched))
    np.testing.assert_array_equal(tpw.pos_diff(*map(torch.as_tensor, batched)).numpy(), want)


@pytest.mark.parametrize("with_pos2,self_loops", [(False, False), (False, True), (True, False)])
def test_radius_edges_masked_equals_jax(with_pos2, self_loops):
    pts, other = _points(2, 40, 2), _points(3, 25, 2)
    pts[5] = pts[4]  # a coincident pair: r = 0 is no edge
    args = (pts, other) if with_pos2 else (pts,)
    for rad in (0.0, 2.5, 20.0):
        want = jpw.radius_edges_masked(rad, *(jnp.asarray(x) for x in args),
                                       self_loops=self_loops)
        got = tpw.radius_edges_masked(rad, *(torch.as_tensor(x) for x in args),
                                      self_loops=self_loops)
        mask, dist, diff, r = (t.numpy() for t in got)
        np.testing.assert_array_equal(mask, np.asarray(want[0]))
        np.testing.assert_allclose(dist, np.asarray(want[1]), rtol=DIST_RTOL, atol=0)
        np.testing.assert_array_equal(diff, np.asarray(want[2]))
        np.testing.assert_allclose(r, np.asarray(want[3]), rtol=DIST_RTOL, atol=0)
    batched = [np.stack([x, x + 1.0, x[::-1]]) for x in args]
    want = _jax_batched(lambda *xs: jpw.radius_edges_masked(2.5, *xs), *batched)
    got = tpw.radius_edges_masked(2.5, *map(torch.as_tensor, batched))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=DIST_RTOL, atol=0)


def _grid(n_side):
    """A square lattice: every interior point has four neighbours at one
    distance, so the k nearest are decided by the tie rule."""
    g = np.stack(np.meshgrid(np.arange(n_side), np.arange(n_side)), -1).reshape(-1, 2)
    return g.astype(np.float32)


@pytest.mark.parametrize("allow_nearest", [True, False])
@pytest.mark.parametrize("case", ["random", "random_pos2", "ties", "ties_pos2", "self_loops"])
def test_knn_edges_equals_jax(allow_nearest, case):
    k = 4
    if case.startswith("ties"):
        pts, other = _grid(5), _grid(5)[::-1].copy()
    else:
        pts, other = _points(4, 15, 2), _points(5, 30, 2)
    args = (pts, other) if case.endswith("pos2") else (pts,)
    kw = dict(self_loops=case == "self_loops", allow_nearest=allow_nearest)
    want = jpw.knn_edges(k, *(jnp.asarray(x) for x in args), **kw)
    idx, dists, diffs = tpw.knn_edges(k, *(torch.as_tensor(x) for x in args), **kw)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(dists.numpy(), np.asarray(want[1]), rtol=DIST_RTOL, atol=0)
    np.testing.assert_array_equal(diffs.numpy(), np.asarray(want[2]))
    batched = [np.stack([x, x * 0.5]) for x in args]
    want = _jax_batched(lambda *xs: jpw.knn_edges(k, *xs, **kw), *batched)
    got = tpw.knn_edges(k, *map(torch.as_tensor, batched), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=DIST_RTOL, atol=0)


def _small(env_id):
    return dict(n_graphs=1) if env_id.startswith(("Coverage", "Explore")) else {}


@pytest.mark.parametrize("env_id", sorted(set(gft_jax.registry) - set(AIRSIM_IDS)))
def test_flatten_space_equals_jax_for_every_id(env_id):
    jenv_, jparams = gft_jax.make(env_id, **_small(env_id))
    tenv_, tparams = make_on(env_id, "cpu", **_small(env_id))
    want = jspaces.flatten_space(jenv_.observation_space(jparams))
    assert tspaces.flatten_space(tenv_.observation_space(tparams)) == want
    assert tspaces.flatten_space(tenv_.action_space(tparams)) == jspaces.flatten_space(
        jenv_.action_space(jparams))


def test_flatten_space_rejects_an_unknown_space():
    with pytest.raises(TypeError, match="Cannot flatten"):
        tspaces.flatten_space(tspaces.Space())
    assert tspaces.flatten_space(tspaces.Discrete(5)) == 1


@pytest.mark.parametrize("env_id,kw", [("FlockingRelative-v0", dict(n_agents=16)),
                                       ("Coverage-v0", dict(n_graphs=1)),
                                       ("LQR-v0", {})])
def test_env_reset_step_expert_are_the_env_functions(env_id, kw):
    """``reset``/``step``/``expert`` return what ``reset_env``/``step_env``/
    ``controller`` return from a generator in the same state."""
    env, params = make_on(env_id, "cpu", **kw)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    s1, o1 = env.reset(g1, params)
    s2, o2 = env.reset_env(g2, params, 1)
    assert fetch(s1.time).shape == (1,)
    _tree_equal((s1, o1), (s2, o2))
    s1, o1 = env.reset(g1, params, n_envs=3)
    s2, o2 = env.reset_env(g2, params, 3)
    _tree_equal((s1, o1), (s2, o2))
    u1, u2 = env.expert(s1, params, g1), env.controller(s2, params, g2)
    _tree_equal(u1, u2)
    _tree_equal(env.step(g1, s1, u1, params)[:4], env.step_env(g2, s2, u2, params)[:4])
    assert torch.equal(g1.get_state(), g2.get_state())


def _tree_equal(a, b):
    la, lb = [], []
    tree_map(la.append, a)
    tree_map(lb.append, b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_env_transition_has_jax_fields():
    want = [f.name for f in dataclasses.fields(jenv.EnvTransition)]
    assert [f.name for f in dataclasses.fields(tenv.EnvTransition)] == want
    t = tenv.EnvTransition(obs=1, action=2, reward=torch.zeros(1), done=torch.ones(1),
                           info={})
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.obs = 3


def _jax_reexports():
    """``(package, name)`` of every name a JAX ``__init__`` imports from the
    package, and the top level's ``__version__``."""
    out = []
    for init in sorted((REPO / "gym_flock_tpu").rglob("__init__.py")):
        pkg = ".".join(init.relative_to(REPO).parent.parts)
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and node.module.startswith("gym_flock_tpu"):
                out += [(pkg, a.asname or a.name) for a in node.names]
            elif isinstance(node, ast.Assign):
                out += [(pkg, t.id) for t in node.targets if getattr(t, "id", "") == "__version__"]
    return [(pkg, name) for pkg, name in out if name != "_register_all"]


@pytest.mark.parametrize("pkg,name", _jax_reexports())
def test_every_jax_reexport_has_its_counterpart(pkg, name):
    """Each name a JAX ``__init__`` re-exports imports from the port's
    package of the same path.  Where the port's submodule of that name
    holds the function (``ops.flocking_sums``, ``ops.adjacency_matmul``,
    ``parallel.rollout``: bound in the package, the function would hide
    its submodule), the function is the submodule's attribute."""
    port = importlib.import_module(pkg.replace("gym_flock_tpu", "gym_flock_tpu_torch", 1))
    want = getattr(importlib.import_module(pkg), name)
    obj = getattr(port, name)
    if isinstance(obj, types.ModuleType) and not isinstance(want, types.ModuleType):
        obj = getattr(obj, name)
    assert type(obj) is type(want) or (callable(obj) and callable(want)), (pkg, name)


def test_native_available(monkeypatch):
    assert vrp.native_available() is True

    def broken():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(vrp, "_lib", None)
    monkeypatch.setattr(vrp, "_build", broken)
    assert vrp.native_available() is False
