"""One gloo rank of the port's scale-out tests: imports torch and the port only.

    python tests/helpers/torch_shard_worker.py <suite> <rank> <world> <dir>

Joins the process group through ``file://<dir>/store``, reads the inputs the
test wrote to ``<dir>/inputs.npz``, runs every case of ``<suite>``
(``agent_shard`` on 4 ranks, ``distributed`` on 2) and writes this rank's
results to ``<dir>/out_<rank>.npz``.  Cases at P=2 run on the groups of
ranks {0, 1} and {2, 3}; cases at P=1 on one group a rank.
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
os.environ.setdefault("GYM_FLOCK_TPU_MAPS", "off")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from gym_flock_tpu_torch import convert  # noqa: E402
from gym_flock_tpu_torch.envs.flocking import FlockingParams  # noqa: E402
from gym_flock_tpu_torch.parallel import agent_shard as ash  # noqa: E402
from gym_flock_tpu_torch.parallel import distributed as tdist  # noqa: E402

CR = 0.9
CR2 = CR * CR


def _flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


def _flat_grads(model):
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                      for p in model.parameters()]).numpy()


def _flax_variables(inp):
    """The flax ``{"params": {"_MLP_0": {"Dense_i": ...}}}`` tree of the
    weights the test wrote as ``kernel_i``/``bias_i``."""
    n = sum(1 for k in inp.files if k.startswith("kernel_"))
    dense = {f"Dense_{i}": {"kernel": inp[f"kernel_{i}"], "bias": inp[f"bias_{i}"]}
             for i in range(n)}
    return {"params": {"_MLP_0": dense}}


def agent_shard_suite(rank, inp, out):
    g2 = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
    g1 = [dist.new_group([r]) for r in range(4)][rank]
    groups = {1: g1, 2: g2, 4: None}
    x, h = torch.from_numpy(inp["x"]), torch.from_numpy(inp["h"])
    feats, co = torch.from_numpy(inp["feats"]), torch.from_numpy(inp["co"])
    params = FlockingParams(n_agents=x.shape[1])

    def local(t, p):
        r = dist.get_rank(groups[p]) if p > 1 else 0
        m = t.shape[1] // p
        return t[:, r * m:(r + 1) * m]

    for p in (2, 4):
        for mode in ("ring", "allgather"):
            out[f"sums_{mode}_P{p}"] = ash.flocking_sums_sharded(
                local(x, p), CR, CR2, groups[p], mode)[..., :12].numpy()
    for central in (True, False):
        out[f"ctrl_{int(central)}_P4"] = ash.turner_controller_sharded(
            local(x, 4), params, None, "ring", centralized=central).numpy()
    out["ctrl_ag_P4"] = ash.turner_controller_sharded(local(x, 4), params, None,
                                                      "allgather").numpy()
    x2, values, reward = ash.flocking_step_sharded(local(x, 4), params, None, "ring")
    out["step_x_P4"], out["step_v_P4"], out["step_r_P4"] = (
        x2.numpy(), values.numpy(), reward.numpy())
    for mode in ("ring", "allgather"):
        for pool in (True, False):
            out[f"adj_{mode}_{int(pool)}_P4"] = ash.adjacency_matmul_sharded(
                local(x, 4), local(h, 4), CR2, None, mode, pool).numpy()
        f = local(feats, 4).clone().requires_grad_(True)
        agg = ash.khop_aggregate_sharded(local(x, 4), f, CR2, 3, None, mode)
        (agg * local(co, 4)).sum().backward()
        out[f"khop_{mode}_P4"], out[f"khop_grad_{mode}_P4"] = agg.detach().numpy(), f.grad.numpy()
    out["adj_ring_1_P2"] = ash.adjacency_matmul_sharded(local(x, 2), local(h, 2), CR2,
                                                        groups[2], "ring").numpy()

    reset_params = FlockingParams(n_agents=x.shape[1], min_dist_thresh=0.01)
    for p in (1, 2, 4):
        gen = torch.Generator().manual_seed(7)
        out[f"reset_P{p}"] = ash.flocking_reset_sharded(gen, reset_params, 2,
                                                        groups[p]).numpy()
        out[f"reset_tries_P{p}"] = np.asarray(ash.last_reset_tries)

    # action_scalar 1: the sharded step integrates the controller's output
    # as it is, the env's u * action_scalar, the same function only there
    roll_params = dataclasses.replace(reset_params, action_scalar=1.0)
    for name, mesh_groups, mode in (("dp2ap2", None, "ring"), ("dp2ap2_ag", None, "allgather"),
                                    ("dp1ap1", (g1, g1), "ring")):
        gen = torch.Generator().manual_seed(11)
        if mesh_groups is None:
            mesh = ash.make_flock_mesh(2, 2)
            xf, mr = ash.agent_sharded_rollout(roll_params, gen, 4, 3, mesh, mode)
        else:
            xf, mr = ash._rollout(roll_params, gen, 4, 3, *mesh_groups, mode)
        out[f"roll_x_{name}"], out[f"roll_r_{name}"] = xf.numpy(), mr.numpy()

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.parallel.train import LargeFlockingImitationTrainer

    env, tp = gft.make("FlockingLarge-v0", n_agents=x.shape[1])
    batch = [torch.from_numpy(inp[k]) for k in ("bx", "bf", "ba")]
    for mode in ("ring", "allgather"):
        trainer = LargeFlockingImitationTrainer(env, tp, device="cpu")
        convert.gnn_params_from_flax(_flax_variables(inp), trainer.model)
        step = trainer.make_agent_sharded_train_step(None, mode)
        out[f"train_loss_{mode}"] = step(batch).numpy()
        out[f"train_params_{mode}"] = _flat_params(trainer.model)


def distributed_suite(rank, inp, out):
    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.parallel import dagger, rollout, train, train_coverage

    try:
        tdist.initialize("gloo", "file:///nonexistent/store", 2, rank)
    except RuntimeError as e:
        out["second_init"] = np.asarray(str(e))
    out["shard"] = np.asarray(tdist.local_shard_size(6))
    try:
        tdist.local_shard_size(7)
    except ValueError as e:
        out["shard_raise"] = np.asarray(str(e))
    out["fold"] = torch.rand(3, generator=tdist.host_fold(5)).numpy()
    mesh = rollout.make_env_mesh()
    out["mesh_size"] = np.asarray(mesh.size())

    env, params = gft.make("FlockingRelative-v0", n_agents=8)
    traj, stats = rollout.sharded_rollout(env, params, torch.Generator().manual_seed(3), 4, 3,
                                          mesh)
    out["sr_reward"] = traj["reward"].numpy()
    out["sr_stats"] = np.asarray([float(stats["mean_reward"]), float(stats["done_rate"])])
    _, etraj = rollout.batch_expert_rollout(env, params, torch.Generator().manual_seed(4), 4,
                                            2, mesh=mesh)
    out["ber_u"] = etraj["u"].numpy()

    trainer = train.FlockingImitationTrainer(env, params, device="cpu")
    trainer.init(torch.Generator().manual_seed(0))
    step = trainer.make_sharded_train_step(None, n_envs=4, n_steps=2)
    out["dp_loss"] = step(torch.Generator().manual_seed(1)).numpy()
    out["dp_params"] = _flat_params(trainer.model)

    dtr = dagger.DaggerTrainer(env, params, capacity=64, device="cpu")
    dstep, dinit = dagger.make_sharded_iteration(dtr, None, n_envs=4, n_steps=4, n_grad_steps=2)
    dinit(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    out["dagger_loss"] = np.asarray([float(dstep(gen, 1.0)), float(dstep(gen, 0.7))])
    out["dagger_params"] = _flat_params(dtr.model)
    out["dagger_adam"] = torch.cat([v.reshape(-1) for s in dtr.optimizer.state.values()
                                    for v in s.values()]).numpy()
    out["dagger_filled"] = np.asarray(dtr.state.filled)

    cenv, cparams = gft.make("Coverage-v0", n_graphs=1, device="cpu")
    ctr = train_coverage.CoverageImitationTrainer(cenv, cparams, device="cpu")
    ctr.init(torch.Generator().manual_seed(0))
    cstep = train_coverage.make_sharded_train_step(ctr, None, n_envs=4, n_steps=2)
    out["cov_loss"] = cstep(torch.Generator().manual_seed(1)).numpy()
    out["cov_params"] = _flat_params(ctr.model)
    out["cov_grads"] = _flat_grads(ctr.model)


def main():
    suite, rank, world, where = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    where = Path(where)
    tdist.initialize("gloo", f"file://{where / 'store'}", world, rank, timeout_s=120)
    inp = np.load(where / "inputs.npz") if (where / "inputs.npz").exists() else None
    out = {}
    {"agent_shard": agent_shard_suite, "distributed": distributed_suite}[suite](rank, inp, out)
    dist.barrier()
    np.savez(where / f"out_{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
