"""The port's process-group plumbing (``parallel/distributed.py``), its
env-batch sharded rollouts and its data-parallel train steps, on 2 gloo ranks.

One module-scoped spawn of ``tests/helpers/torch_shard_worker.py`` runs every
case; this process replays each rank's share with the same generators
(``distributed.rank_generator``: one seed drawn from the caller's generator,
folded with the rank) and compares.  A data-parallel step at P=2 equals one
process's step on the two ranks' batches concatenated (the loss and the
weights within 1e-5 of the array's largest magnitude, at least 1), and every
rank leaves each step with the same weights, bit for bit.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import gym_flock_tpu_torch as gft
from gym_flock_tpu_torch.parallel import distributed as tdist
from gym_flock_tpu_torch.parallel import rollout, train, train_coverage

torch.set_num_threads(2)

WORKER = Path(__file__).resolve().parent / "helpers" / "torch_shard_worker.py"
WORLD = 2
TOL = 1e-5


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    where = tmp_path_factory.mktemp("distributed")
    procs = [subprocess.Popen([sys.executable, str(WORKER), "distributed", str(r), str(WORLD),
                               str(where)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0].decode(errors="replace") for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [dict(np.load(where / f"out_{r}.npz")) for r in range(WORLD)]


def _rank_gens(seed):
    """The generators the ranks drew from for a step called with a
    generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    s = int(torch.randint(0, 1 << 62, (1,), generator=gen))
    return [tdist.host_fold(s, r) for r in range(WORLD)]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


def _flat_grads(model):
    """The gradients, zeros for a parameter the loss does not reach."""
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                      for p in model.parameters()]).numpy()


@pytest.mark.filterwarnings("ignore:Device capability of no-such-backend")
@pytest.mark.parametrize("kwargs", [
    dict(backend="gloo", init_method="nowhere://at-all", world_size=1, rank=0),
    dict(backend="no-such-backend", init_method="file://{tmp}/store", world_size=1, rank=0),
])
def test_initialize_raises_on_a_bad_init(kwargs, tmp_path):
    """A failed init raises and leaves no process group: nothing swallows
    the error as the JAX package's ``initialize`` does."""
    kwargs = dict(kwargs, init_method=kwargs["init_method"].format(tmp=tmp_path))
    with pytest.raises((RuntimeError, ValueError, AssertionError)):
        tdist.initialize(**kwargs)
    assert not dist.is_initialized()


def test_initialize_nccl_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: NCCL would start")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.initialize("nccl", f"file://{tmp_path}/store", 1, 0)
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,rank,want", [
    (dict(RANK="3", LOCAL_RANK="3", WORLD_SIZE="4"), None, 3),
    (dict(RANK="5", LOCAL_RANK="1", WORLD_SIZE="8"), None, 1),
    (dict(RANK="6", WORLD_SIZE="8"), None, 2),
    (dict(RANK="5", LOCAL_RANK="1", WORLD_SIZE="8"), 7, 3),
])
def test_initialize_nccl_puts_each_rank_on_its_card(monkeypatch, env, rank, want):
    """NCCL's card on a host of 4 faked cards: ``rank % 4`` when the rank
    is given; else ``LOCAL_RANK``, else ``RANK``, modulo 4, when the
    rendezvous comes from the environment (as torchrun sets it)."""
    cards, groups = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: groups.append(kw))
    for name in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    tdist.initialize("nccl", rank=rank)
    assert cards == [want]
    assert groups[0]["backend"] == "nccl" and groups[0]["rank"] == (-1 if rank is None else rank)


def test_second_initialize_raises_and_the_helpers_see_the_group(outs):
    for r, o in enumerate(outs):
        assert str(o["second_init"]) == "torch.distributed is already initialized"
        assert int(o["shard"]) == 3 and int(o["mesh_size"]) == WORLD
        assert "do not split" in str(o["shard_raise"])
        want = torch.rand(3, generator=tdist.host_fold(5, r)).numpy()
        np.testing.assert_array_equal(o["fold"], want)
    assert not np.array_equal(outs[0]["fold"], outs[1]["fold"])


def test_sharded_rollout_is_each_ranks_rollout_with_all_reduced_stats(outs):
    env, params = gft.make("FlockingRelative-v0", n_agents=8)
    rewards = []
    for r, g in enumerate(_rank_gens(3)):
        _, traj = rollout.rollout(env, params, g, 3, keep_obs=False, n_envs=2)
        np.testing.assert_array_equal(outs[r]["sr_reward"], traj["reward"].numpy())
        rewards.append(traj["reward"].numpy())
    for o in outs:
        _close(o["sr_stats"], [np.concatenate(rewards).mean(), 0.0])


def test_batch_expert_rollout_on_a_mesh_is_each_ranks_part(outs):
    env, params = gft.make("FlockingRelative-v0", n_agents=8)
    for r, g in enumerate(_rank_gens(4)):
        _, traj = rollout.batch_expert_rollout(env, params, g, 2, 2)
        np.testing.assert_array_equal(outs[r]["ber_u"], traj["u"].numpy())


def test_dp_step_equals_one_step_on_the_concatenated_batch(outs):
    env, params = gft.make("FlockingRelative-v0", n_agents=8)
    trainer = train.FlockingImitationTrainer(env, params, device="cpu")
    trainer.init(torch.Generator().manual_seed(0))
    parts = [trainer.collect(g, 2, 2) for g in _rank_gens(1)]
    batch = [torch.cat(leaves) for leaves in zip(*parts)]
    loss = trainer.update(batch)
    np.testing.assert_array_equal(outs[0]["dp_params"], outs[1]["dp_params"])
    _close(outs[0]["dp_loss"], float(loss))
    _close(outs[0]["dp_params"], _flat(trainer.model))


def test_sharded_dagger_keeps_every_rank_in_step(outs):
    """Two sharded DAGGER iterations: each rank's buffer holds its own 2 envs
    x 4 steps an iteration; the weights and Adam's state leave every
    iteration the same on both ranks."""
    for key in ("dagger_params", "dagger_adam", "dagger_loss"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
    assert int(outs[0]["dagger_filled"]) == 16
    assert np.isfinite(outs[0]["dagger_loss"]).all()


def test_coverage_dp_step_equals_one_step_on_the_concatenated_batch(outs):
    """The loss and the averaged gradients; the weights after Adam are not
    compared here, since the logit head's last bias has a gradient of zero up
    to rounding (a constant shift of every logit), which Adam's first step
    turns into +-lr or 0 by the sign of that rounding."""
    env, params = gft.make("Coverage-v0", n_graphs=1, device="cpu")
    trainer = train_coverage.CoverageImitationTrainer(env, params, device="cpu")
    trainer.init(torch.Generator().manual_seed(0))
    parts = [train_coverage.collect_coverage_batch(env, params, g, 2, 2)
             for g in _rank_gens(1)]
    loss = trainer.update({k: torch.cat([p[k] for p in parts]) for k in parts[0]})
    np.testing.assert_array_equal(outs[0]["cov_params"], outs[1]["cov_params"])
    _close(outs[0]["cov_loss"], float(loss))
    _close(outs[0]["cov_grads"], _flat_grads(trainer.model))
