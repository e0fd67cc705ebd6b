"""The port's coverage graph banks, reach lists and map lookup against the
JAX package (procedural maps: the suite sets GYM_FLOCK_TPU_MAPS=off).

Tolerance: none.  Banks are compared array for array, exactly; bf16 arrays
through float32.
"""
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.envs.maps import find_reference_map as jax_find_reference_map
from gym_flock_tpu.ops.pairwise import nodes_within_radius as jax_nodes_within_radius
from gym_flock_tpu_torch.envs import maps
from gym_flock_tpu_torch.envs.coverage_graph import disc_reach_lists, reach_key
from gym_flock_tpu_torch.ops.pairwise import nodes_within_radius

torch.set_num_threads(2)

CASES = [("Coverage-v0", dict(n_graphs=2)), ("ExploreEnv-v0", dict(n_graphs=2))]


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("env_id,kw", CASES)
def test_bank_equals_jax_bank(env_id, kw):
    _, jp = gft_jax.make(env_id, **kw)
    _, tp = gft.make(env_id, device="cpu", **kw)
    shared = [k for k in tp.bank if k in jp.bank and not k.startswith("disc_reach_r")]
    assert {"graph_cost", "graph_prev", "graph_hops", "graph_cost_mm", "cost_pack_ok",
            "neighbor_table", "motion_senders", "target_pos"} <= set(shared)
    for k in shared:
        j, t = _np(jp.bank[k]), _np(tp.bank[k])
        assert t.dtype == j.dtype, k
        np.testing.assert_array_equal(t, j, err_msg=k)
    for f in ("n_robots", "max_nodes", "n_node_feat", "episode_length", "hide_nodes",
              "res", "discover_radius"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.bank["graph_cost_mm"].dtype == torch.bfloat16
    # K5's operand rides on every bank with the packing marker
    g, t = tp.bank["target_mask"].shape
    assert tp.bank["cost_rows_pad"].shape == (g * t, -(-t // 64) * 64)


def test_disc_reach_lists_equal_the_jax_table():
    _, jp = gft_jax.make("ExploreEnv-v0", n_graphs=2)
    _, tp = gft.make("ExploreEnv-v0", n_graphs=2, device="cpu")
    key = reach_key(jp.discover_radius)
    table = _np(jp.bank[key])  # [G*T, T] 0/1
    lists = disc_reach_lists(tp.bank, tp.discover_radius)[key].numpy()  # [G, T, K]
    g, t, _ = lists.shape
    assert table.shape == (g * t, t)
    flat = lists.reshape(g * t, -1)
    for row in range(g * t):
        want = np.nonzero(table[row])[0]
        got = flat[row][flat[row] >= 0]
        np.testing.assert_array_equal(got, want, err_msg=f"row {row}")
    assert torch.equal(tp.bank[key], torch.from_numpy(lists))


def test_nodes_within_radius_matches_jax():
    rng = np.random.RandomState(3)
    pos1 = rng.uniform(-5, 5, size=(3, 6, 2)).astype(np.float32)
    pos2 = np.concatenate([pos1, rng.uniform(-5, 5, size=(3, 40, 2)).astype(np.float32)], 1)
    got = nodes_within_radius(2.5, torch.from_numpy(pos1), torch.from_numpy(pos2)).numpy()
    want = np.stack([
        np.asarray(jax_nodes_within_radius(2.5, jnp.asarray(a), jnp.asarray(b)))
        for a, b in zip(pos1, pos2)
    ])
    assert got.shape == (3, 46)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("value", ["off", "none", "0", "false", " OFF "])
def test_find_reference_map_honours_off(monkeypatch, value):
    monkeypatch.setenv("GYM_FLOCK_TPU_MAPS", value)
    assert maps.reference_map_dirs() == []
    assert maps.find_reference_map(10) is None
    assert jax_find_reference_map(10) is None


def test_find_reference_map_order(monkeypatch, tmp_path):
    """An explicit directory wins; with discovery on and no override the
    bundled copy is found, as the JAX module finds it."""
    np.save(tmp_path / "grid_slice10.npy", np.ones((4, 4), dtype=bool))
    monkeypatch.setenv("GYM_FLOCK_TPU_MAPS", str(tmp_path))
    assert maps.find_reference_map(10) == str(tmp_path / "grid_slice10.npy")
    monkeypatch.setenv("GYM_FLOCK_TPU_MAPS", "")
    monkeypatch.delenv("GYM_FLOCK_REFERENCE", raising=False)
    found = maps.find_reference_map(10)
    assert found is not None and Path(found) == Path(jax_find_reference_map(10))
    assert maps.find_reference_map(7) is None


def test_explore_full_factory_is_procedural_when_maps_are_off():
    env, params = gft.make("ExploreFullEnv-v0", device="cpu")
    assert params.n_robots == 100 and params.hide_nodes and params.n_node_feat == 4
    # the 1500-node budget of the procedural map, not the real map's 5,759
    assert params.max_targets == 1400
    assert params.bank["target_mask"].shape == (1, params.max_targets)
    assert params.max_neighbor_dist is not None
    assert params.max_neighbor_dist <= params.discover_radius


@pytest.mark.parametrize("flag", ["comm_edges", "last_edge_feature", "pos_delta",
                                  "revisit_nodes"])
def test_unported_modes_raise(flag):
    """The four flag modes once raised ``NotImplementedError``; they are
    ported now (held to JAX in ``tests/test_torch_coverage_modes.py``), so
    each builds, resets and steps, with its edge-feature width."""
    env, params = gft.make("Coverage-v0", n_graphs=1, device="cpu", **{flag: True})
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset_env(gen, params, 2)
    state, obs, reward, done, _ = env.step_env(gen, state, env.controller(state, params, gen),
                                               params)
    assert getattr(params, flag)
    assert obs["edges"].shape == (2, params.max_edges, params.n_edge_feat)
    assert params.n_edge_feat == {"pos_delta": 3, "last_edge_feature": 2}.get(flag, 1)

