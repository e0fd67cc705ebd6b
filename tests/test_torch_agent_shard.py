"""The port's agent-axis sharding (``gym_flock_tpu_torch/parallel/agent_shard.py``)
against the JAX package's ``parallel/agent_shard.py``.

One module-scoped spawn of 4 gloo ranks (``tests/helpers/torch_shard_worker.py``)
runs every case and writes each rank's blocks; this process runs JAX's
``shard_map`` on as many of the conftest's virtual CPU devices over the same
numpy inputs (B=2 swarms of N=256, m=64 at P=4) and compares.  Cases at P=2
run on ranks {0, 1}.

Tolerances: the K1 sums max |port - jax| / (1 + |jax|) < 1e-4, the degree
exactly and channel 9 (min r^2) within 1 ulp; the controller and the step
1e-4; the aggregation and its gradient 1e-5; the agent-sharded train step's
loss and weights after one Adam step 1e-5 of the array's largest magnitude
(at least 1).  The reset streams differ from JAX's (threefry against
``torch.Generator``), so the reset is held by its acceptance invariants and
by its equality at P=1, 2 and 4, and the rollout by (dp=2, ap=2) against
(1, 1) and, at P=1, against ``LargeFlockingEnv`` from the same reset.
"""
import dataclasses
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import gym_flock_tpu as gft_jax
import gym_flock_tpu_torch as gft
from gym_flock_tpu.envs.flocking import FlockingParams as JFlockingParams
from gym_flock_tpu.parallel import agent_shard as jash
from gym_flock_tpu.parallel import train as jtrain
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs.flocking import FlockingParams, LargeFlockingEnv
from gym_flock_tpu_torch.ops.adjacency_matmul import khop_aggregate
from gym_flock_tpu_torch.parallel.train import LargeFlockingImitationTrainer
from tests.test_torch_flocking_env import SUM_TOL, _rel, grid_swarms

torch.set_num_threads(2)

WORKER = Path(__file__).resolve().parent / "helpers" / "torch_shard_worker.py"
B, N, WORLD = 2, 256, 4
CR, CR2 = 0.9, 0.81
AGG_TOL = 1e-5
TRAIN_TOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_f32():
    """JAX in its default 32-bit mode, whatever an earlier test module in
    the same worker set globally."""
    with jax.enable_x64(False):
        yield


def _inputs():
    rng = np.random.RandomState(0)
    x = grid_swarms(B, N, seed=1)
    jenv, jp = gft_jax.make("FlockingLarge-v0", n_agents=N)
    with jax.enable_x64(False):
        weights = jtrain.LargeFlockingImitationTrainer(jenv, jp).init(jax.random.key(3))[0]
    dense = weights["params"]["_MLP_0"]
    inp = {
        "x": x,
        "h": rng.randn(B, N, 16).astype(np.float32),
        "feats": rng.randn(B, N, 6).astype(np.float32),
        "co": rng.randn(B, N, 18).astype(np.float32),
        "bx": grid_swarms(B, N, seed=2),
        "bf": rng.randn(B, N, 6).astype(np.float32),
        "ba": (0.1 * rng.randn(B, N, 2)).astype(np.float32),
    }
    for i in range(len(dense)):
        inp[f"kernel_{i}"] = np.asarray(dense[f"Dense_{i}"]["kernel"])
        inp[f"bias_{i}"] = np.asarray(dense[f"Dense_{i}"]["bias"])
    return inp, weights


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, the JAX weights, and every rank's results."""
    where = tmp_path_factory.mktemp("agent_shard")
    inp, weights = _inputs()
    np.savez(where / "inputs.npz", **inp)
    procs = [subprocess.Popen([sys.executable, str(WORKER), "agent_shard", str(r), str(WORLD),
                               str(where)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0].decode(errors="replace") for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    outs = [dict(np.load(where / f"out_{r}.npz")) for r in range(WORLD)]
    return inp, weights, outs


def _joined(outs, key, p):
    """The whole ``[B, N, ...]`` result of a P-rank case from its blocks."""
    return np.concatenate([outs[r][key] for r in range(p)], axis=1)


def _mesh(p):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:p]), ("ap",))


def _jax_sharded(fn, p, *arrays, out_specs=P(None, "ap"), check_vma=True):
    """``fn`` of one swarm's blocks, vmapped over the batch, under a jitted
    ``shard_map`` on ``p`` devices with every array split on its agent axis."""
    sm = jax.shard_map(jax.vmap(fn), mesh=_mesh(p),
                       in_specs=tuple(P(None, "ap") for _ in arrays), out_specs=out_specs,
                       check_vma=check_vma)
    return jax.jit(sm)(*map(jnp.asarray, arrays))


def _assert_sums(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[..., 8], want[..., 8])  # degree
    np.testing.assert_array_max_ulp(got[..., 9], want[..., 9], maxulp=1)  # min r^2
    rest = [c for c in range(12) if c not in (8, 9)]
    assert _rel(got[..., rest], want[..., rest]) < SUM_TOL


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("mode", ["ring", "allgather"])
def test_sums_match_jax(run, mode, p):
    inp, _, outs = run
    want = _jax_sharded(partial(jash.flocking_sums_sharded, comm_radius=CR, comm_radius2=CR2,
                                axis_name="ap", mode=mode), p, inp["x"])
    _assert_sums(_joined(outs, f"sums_{mode}_P{p}", p), want)


def test_sums_match_jax_pallas_tile(run):
    """JAX's Pallas tile (interpret mode), as its own tests run it."""
    inp, _, outs = run
    want = _jax_sharded(partial(jash.flocking_sums_sharded, comm_radius=CR, comm_radius2=CR2,
                                axis_name="ap", mode="ring", use_pallas=True, interpret=True),
                        4, inp["x"], check_vma=False)
    _assert_sums(_joined(outs, "sums_ring_P4", 4), want)


@pytest.mark.parametrize("key,mode,central", [("ctrl_1_P4", "ring", True),
                                              ("ctrl_0_P4", "ring", False),
                                              ("ctrl_ag_P4", "allgather", True)])
def test_controller_matches_jax(run, key, mode, central):
    inp, _, outs = run
    params = JFlockingParams(n_agents=N)
    want = _jax_sharded(partial(jash.turner_controller_sharded, params=params, axis_name="ap",
                                mode=mode, centralized=central), 4, inp["x"])
    assert _rel(_joined(outs, key, 4), want) < SUM_TOL


def test_step_matches_jax(run):
    inp, _, outs = run
    params = JFlockingParams(n_agents=N)
    x2, values, reward = _jax_sharded(
        partial(jash.flocking_step_sharded, params=params, axis_name="ap", mode="ring"), 4,
        inp["x"], out_specs=(P(None, "ap"), P(None, "ap"), P()), check_vma=False)
    assert _rel(_joined(outs, "step_x_P4", 4), x2) < SUM_TOL
    assert _rel(_joined(outs, "step_v_P4", 4), values) < SUM_TOL
    for r in range(WORLD):  # every rank holds the whole reward
        assert _rel(outs[r]["step_r_P4"], reward) < SUM_TOL


@pytest.mark.parametrize("mode", ["ring", "allgather"])
@pytest.mark.parametrize("pool", [True, False])
def test_adjacency_matmul_matches_jax(run, mode, pool):
    inp, _, outs = run
    want = _jax_sharded(partial(jash.adjacency_matmul_sharded, comm_radius2=CR2,
                                axis_name="ap", mode=mode, mean_pool=pool),
                        4, inp["x"], inp["h"])
    assert _rel(_joined(outs, f"adj_{mode}_{int(pool)}_P4", 4), want) < AGG_TOL


def test_adjacency_matmul_at_two_ranks_equals_four(run):
    _, _, outs = run
    assert _rel(_joined(outs, "adj_ring_1_P2", 2), _joined(outs, "adj_ring_1_P4", 4)) < AGG_TOL


@pytest.mark.parametrize("mode", ["ring", "allgather"])
def test_khop_gradient_matches_jax_and_unsharded_autograd(run, mode):
    """The aggregation and its gradient (through the ring shift's or the
    all-gather's backward and K2's swapped tile) against JAX's gradient
    through ``ppermute``/``all_gather`` and against autograd of the port's
    unsharded ``khop_aggregate``."""
    inp, _, outs = run
    fn = partial(jash.khop_aggregate_sharded, comm_radius2=CR2, k_hops=3, axis_name="ap",
                 mode=mode)
    co = jnp.asarray(inp["co"])
    want = _jax_sharded(fn, 4, inp["x"], inp["feats"])
    want_g = jax.grad(lambda f: jnp.sum(_jax_sharded(fn, 4, inp["x"], f) * co))(
        jnp.asarray(inp["feats"]))
    got, got_g = _joined(outs, f"khop_{mode}_P4", 4), _joined(outs, f"khop_grad_{mode}_P4", 4)
    assert _rel(got, want) < AGG_TOL
    assert _rel(got_g, want_g) < AGG_TOL

    f = torch.from_numpy(inp["feats"]).requires_grad_(True)
    plain = khop_aggregate(torch.from_numpy(inp["x"]), f, CR2, 3)
    (plain * torch.from_numpy(inp["co"])).sum().backward()
    assert _rel(got, plain.detach().numpy()) < AGG_TOL
    assert _rel(got_g, f.grad.numpy()) < AGG_TOL


def test_reset_accepts_and_is_the_same_at_one_two_and_four_ranks(run):
    """Every rank draws the whole proposal and keeps its block, so the reset
    is a function of the generator alone; it also equals
    ``LargeFlockingEnv.reset_env`` from the same generator."""
    _, _, outs = run
    swarms = {p: _joined(outs, f"reset_P{p}", p) for p in (1, 2, 4)}
    np.testing.assert_array_equal(swarms[1], swarms[2])
    np.testing.assert_array_equal(swarms[1], swarms[4])
    tries = {int(outs[0][f"reset_tries_P{p}"]) for p in (1, 2, 4)}
    assert len(tries) == 1
    params = FlockingParams(n_agents=N, min_dist_thresh=0.01)
    env = LargeFlockingEnv()
    state, _ = env.reset_env(torch.Generator().manual_seed(7), params, B)
    np.testing.assert_array_equal(state.x.numpy(), swarms[1])
    x = swarms[1].astype(np.float64)
    d = x[:, :, None, :2] - x[:, None, :, :2]
    r2 = (d ** 2).sum(-1) + np.where(np.eye(N, dtype=bool), np.inf, 0.0)
    assert np.sqrt(r2.min()) > params.min_dist_thresh
    assert (r2 < params.comm_radius2).sum(-1).min() >= 2


@pytest.mark.parametrize("name", ["dp2ap2", "dp2ap2_ag"])
def test_rollout_on_a_2x2_mesh_equals_one_rank(run, name):
    """Envs split over dp, agents over ap: the same final swarms and mean
    reward as one rank.  On the 2 x 2 mesh, rank 2 dp + ap holds envs
    2dp..2dp+1 and agents 128 ap..128 ap+127."""
    _, _, outs = run
    one = outs[0]["roll_x_dp1ap1"]
    for r in range(WORLD):
        dp, ap = divmod(r, 2)
        assert _rel(outs[r][f"roll_x_{name}"], one[2 * dp:2 * dp + 2, 128 * ap:128 * ap + 128]) \
            < SUM_TOL
        assert _rel(outs[r][f"roll_r_{name}"], outs[0]["roll_r_dp1ap1"]) < SUM_TOL


def test_rollout_at_one_rank_equals_the_large_env(run):
    """At P=1 the sharded rollout from its reset is ``LargeFlockingEnv``'s
    fused rollout from the same state.  The sharded step integrates the
    controller's output as it is, as JAX's does, where the env integrates
    ``u * action_scalar``: the two are the same function at
    ``action_scalar=1``, which this comparison uses."""
    _, _, outs = run
    params = FlockingParams(n_agents=N, min_dist_thresh=0.01)
    env = LargeFlockingEnv()
    state, _ = env.reset_env(torch.Generator().manual_seed(11), params, 4)
    final, traj = env.expert_rollout(state, dataclasses.replace(params, action_scalar=1.0), 3)
    assert _rel(outs[0]["roll_x_dp1ap1"], final.x.numpy()) < SUM_TOL
    assert _rel(outs[0]["roll_r_dp1ap1"], traj["reward"].mean().numpy()) < SUM_TOL


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("mode", ["ring", "allgather"])
def test_agent_sharded_train_step_matches_jax_and_the_unsharded_step(run, mode):
    """One agent-sharded Adam step on 4 ranks from the flax weights: the loss
    and the weights equal JAX's ``make_agent_sharded_train_step`` and the
    port's unsharded ``update``; every rank holds the same weights.

    Both take the gradient of the whole batch's mean loss.  JAX's step runs
    its Pallas tile (interpret mode), as its own test of this step does: its
    XLA tile under ``check_vma`` sums the ranks' gradients (P times the
    mean's), which moves Adam's first step by up to 3e-5 where a gradient
    is near its ``eps``, and which that test's 5e-4 bound admits."""
    inp, weights, outs = run
    batch = [inp[k] for k in ("bx", "bf", "ba")]
    jenv, jp = gft_jax.make("FlockingLarge-v0", n_agents=N)
    jtr = jtrain.LargeFlockingImitationTrainer(jenv, jp)
    step, _ = jtr.make_agent_sharded_train_step(mesh=_mesh(4), use_pallas=True, interpret=True)
    (jparams, _), jloss = step((weights, jtr.tx.init(weights)), tuple(map(jnp.asarray, batch)))
    dense = jparams["params"]["_MLP_0"]
    want = np.concatenate([np.concatenate([np.asarray(dense[f"Dense_{i}"]["kernel"]).T.ravel(),
                                           np.asarray(dense[f"Dense_{i}"]["bias"])])
                           for i in range(len(dense))])
    for r in range(WORLD):
        np.testing.assert_array_equal(outs[r][f"train_params_{mode}"],
                                      outs[0][f"train_params_{mode}"])
    _close(outs[0][f"train_loss_{mode}"], jloss, TRAIN_TOL)
    _close(outs[0][f"train_params_{mode}"], want, TRAIN_TOL)

    env, tp = gft.make("FlockingLarge-v0", n_agents=N)
    trainer = LargeFlockingImitationTrainer(env, tp, device="cpu")
    convert.gnn_params_from_flax(weights, trainer.model)
    loss = trainer.update([torch.from_numpy(b) for b in batch])
    flat = torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()]).numpy()
    _close(outs[0][f"train_loss_{mode}"], float(loss), TRAIN_TOL)
    _close(outs[0][f"train_params_{mode}"], flat, TRAIN_TOL)
