#!/usr/bin/env python3
"""Training quality of the PyTorch port's imitation pipelines on one GPU.

Trains a policy once per pipeline and reports how close it comes to its
expert, with the pipelines, worlds, widths, iteration counts and batches of
``benchmarks/train_quality.py`` (the JAX package's) and its JSON key names,
so that the two files can be read side by side:

  bc_greedy        CoverageImitationTrainer, EdgeGraphNet(latent=64, rounds=6),
                   800 iterations of 8 envs x 16 steps, Adam 1e-3;
  dagger           CoverageDaggerTrainer, the same model, capacity 4096, 28
                   iterations of 8 envs x 16 steps, 32 grad steps of batch 128;
  flocking         FlockingImitationTrainer on FlockingRelative-v0 (N=100),
                   AggregationGNN(k_hops=4, hidden=(128, 128)), 2500
                   iterations of 8 envs x 8 steps, Adam on
                   cosine_decay_schedule(1e-3, 2500, alpha=0.03); held-out
                   action MSE on 16 x 8 expert samples beside predicting zero;
  flocking_dagger  DaggerTrainer, the same model, capacity 8192, 40
                   iterations of 8 envs x 16 steps, 24 grad steps each;
  bc_vrp           1024 states of a greedy rollout (32 envs x 32 steps)
                   labelled twice by the C++ VRP expert (``or_default``, and
                   ``or_default`` with ``last_accept``) on 2 threads; two
                   EdgeGraphNet(32, 2) models from the same initial weights,
                   60 epochs of shuffled 64-sample minibatches each;
  probe_vrp_speed  seconds per VRP solve, 2 envs x 4 steps on 2 threads.

The coverage world is CoverageARL-v0 on the real ARL facility map: a
training bank of 8 sub-windows (``bank_seed=0``) and a held-out bank of 8
others (``bank_seed=1234``); a coverage policy is evaluated on both at 64
envs x 50 steps (accuracy on the greedy expert's labels, policy and expert
episode reward from the same resets, their ratio), beside uniform random
actions.  A flocking policy is evaluated in closed loop, 64 envs x 200
steps, as the policy, the Turner expert and uniform random actions in
[-1, 1], all three from the same resets; the reward is minus the velocity
variance, so ``policy_vs_expert`` is a ratio of costs.

Each pipeline is a function of the device and its sizes.  ``--seed`` moves
every training-side seed (collects, initial weights, shuffles); the
evaluations keep theirs.  Prints one JSON object and writes it to
``--out``.  It needs a card and exits non-zero without one.

    python3 tools/train_quality_torch.py all --out chiprun_out/train_quality_torch.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

EVAL_ENVS, EVAL_STEPS, EVAL_SEED = 64, 50, 99
FLOCK_EVAL_ENVS, FLOCK_EVAL_STEPS = 64, 200
HELDOUT_SEED = 991  # the flocking held-out batch
INIT_SEED, SHUFFLE_SEED = 7, 3  # bc_vrp: the models' weights, the minibatch order
MODES = ("policy", "expert", "random")
N_AGENTS, ALPHA = 100, 0.03  # the flocking world; the schedule's floor over its start


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _generator(device, seed: int):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def coverage_world(device: str):
    """CoverageARL-v0 on the real map: the env, its training bank's params
    and the held-out bank's."""
    import gym_flock_tpu_torch as gft

    env, params = gft.make("CoverageARL-v0", n_graphs=8, bank_seed=0, device=device,
                           real_map=True)
    _, eval_params = gft.make("CoverageARL-v0", n_graphs=8, bank_seed=1234, device=device,
                              real_map=True)
    return env, params, eval_params


def random_reward(env, params, device: str, n_envs: int = EVAL_ENVS,
                  n_steps: int = EVAL_STEPS) -> float:
    """Mean coverage episode reward of uniform random actions (the floor)."""
    import torch

    gen = _generator(device, EVAL_SEED)
    state, _ = env.reset_env(gen, params, n_envs)
    total = torch.zeros(n_envs, device=device)
    for _ in range(n_steps):
        u = torch.randint(0, params.n_actions, (n_envs, params.n_robots), generator=gen,
                          device=device, dtype=torch.int32)
        state, _, r, _, _ = env.step_env(None, state, u, params)
        total += r
    return float(total.mean())


def report(trainer, env, params, eval_params, device: str, n_envs: int = EVAL_ENVS,
           n_steps: int = EVAL_STEPS) -> dict:
    """``evaluate`` on the training and the held-out bank, each beside its
    random reward."""
    out = {}
    for name, p in (("train_bank", params), ("heldout_bank", eval_params)):
        m = trainer.evaluate(_generator(device, EVAL_SEED), p, n_envs=n_envs, n_steps=n_steps)
        out[name] = {**m, "random_reward": random_reward(env, p, device, n_envs, n_steps)}
    return out


def run_bc_greedy(device: str, n_iters: int = 800, seed: int = 0) -> dict:
    from gym_flock_tpu_torch.models import EdgeGraphNet
    from gym_flock_tpu_torch.parallel import CoverageImitationTrainer

    env, params, eval_params = coverage_world(device)
    gen = _generator(device, seed)
    trainer = CoverageImitationTrainer(
        env, params, model=EdgeGraphNet(64, 6, generator=gen, device=device),
        learning_rate=1e-3, device=device)
    _sync(device)
    t0 = time.perf_counter()
    losses = trainer.fit(gen, n_iters=n_iters, n_envs=8, n_steps=16)
    _sync(device)
    seconds = time.perf_counter() - t0
    return {"pipeline": "coverage BC, greedy expert labels (EdgeGraphNet 64x6)",
            "world": "CoverageARL-v0, 8 real-facility sub-windows, R=4",
            "model": {"latent": 64, "rounds": 6, "lr": 1e-3},
            "train": {"n_iters": n_iters, "samples_per_iter": 128, "loss_first": losses[0],
                      "loss_last": sum(losses[-10:]) / len(losses[-10:]), "seconds": seconds},
            **report(trainer, env, params, eval_params, device)}


def run_dagger(device: str, n_iters: int = 28, seed: int = 0) -> dict:
    from gym_flock_tpu_torch.models import EdgeGraphNet
    from gym_flock_tpu_torch.parallel import CoverageDaggerTrainer

    env, params, eval_params = coverage_world(device)
    gen = _generator(device, seed)
    trainer = CoverageDaggerTrainer(
        env, params, model=EdgeGraphNet(64, 6, generator=gen, device=device),
        capacity=4096, device=device)
    _sync(device)
    t0 = time.perf_counter()
    losses = trainer.fit(gen, n_iters=n_iters, n_envs=8, n_steps=16, n_grad_steps=32,
                         batch_size=128)
    _sync(device)
    seconds = time.perf_counter() - t0
    return {"pipeline": "coverage DAGGER (mixture rollouts, rolling buffer)",
            "world": "CoverageARL-v0, 8 real-facility sub-windows, R=4",
            "model": {"latent": 64, "rounds": 6},
            "train": {"n_iters": n_iters, "beta_decay": trainer.beta_decay,
                      "loss_first": losses[0], "loss_last": losses[-1], "seconds": seconds},
            **report(trainer.inner, env, params, eval_params, device)}


# ------------------------------------------------------------------ flocking


def flocking_closed_loop(env, params, model, device: str, n_envs: int = FLOCK_EVAL_ENVS,
                         n_steps: int = FLOCK_EVAL_STEPS):
    """The closed loop shared by both flocking pipelines: the mean summed
    reward of ``n_envs`` episodes of ``n_steps`` under the policy, the
    Turner expert and uniform random actions in [-1, 1].  Each mode draws
    from its own generator seeded ``EVAL_SEED``, so all three start from
    the same resets.  Returns ``(rewards, resets, reset_draws)``: the reward of each
    mode, each mode's reset state ``x`` and the reset draws taken (K1 runs
    once a draw)."""
    import torch

    rewards, resets, draws = {}, {}, 0
    n = params.n_agents
    with torch.no_grad():
        for mode in MODES:
            gen = _generator(device, EVAL_SEED)
            state, obs = env.reset_env(gen, params, n_envs)
            draws += env.last_reset_tries
            resets[mode] = state.x
            total = torch.zeros(n_envs, device=device)
            for _ in range(n_steps):
                if mode == "policy":
                    u = model(*obs)
                elif mode == "expert":
                    u = env.expert(state, params)
                else:
                    u = 2.0 * torch.rand((n_envs, n, 2), generator=gen, device=device) - 1.0
                state, obs, r, _, _ = env.step_env(None, state, u, params)
                total += r
            rewards[mode] = float(total.mean())
    return rewards, resets, draws


def _episode_entry(env, params, model, device, eval_envs, eval_steps, ratio_key: str,
                   probe) -> tuple:
    """The closed loop's JSON entry under ``ratio_key`` and its reset draws."""
    import torch

    rewards, resets, draws = flocking_closed_loop(env, params, model, device, eval_envs,
                                                  eval_steps)
    if probe is not None:
        probe["resets"] = resets
    same = all(torch.equal(resets["policy"], resets[m]) for m in MODES)
    exp = rewards["expert"]
    return {**rewards, ratio_key: rewards["policy"] / exp if exp else None}, same, draws


def _flocking_model(device, gen, k_hops, hidden):
    from gym_flock_tpu_torch.models import AggregationGNN

    return AggregationGNN(k_hops=k_hops, hidden=tuple(hidden), generator=gen, device=device)


def run_flocking(device: str, n_iters: int = 2500, n_envs: int = 8, n_steps: int = 8,
                 k_hops: int = 4, hidden=(128, 128), lr: float = 1e-3, heldout=(16, 8),
                 eval_envs: int = FLOCK_EVAL_ENVS, eval_steps: int = FLOCK_EVAL_STEPS,
                 seed: int = 0, probe: dict | None = None) -> dict:
    """Flocking BC.  ``probe``, when given, receives the trainer, the
    schedule, each step's Adam ``lr``, the first batch with the weights
    before its update, and the closed loop's reset states."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.parallel import (
        FlockingImitationTrainer,
        collect_flocking_batch,
        cosine_decay_schedule,
    )

    env, params = gft.make("FlockingRelative-v0", n_agents=N_AGENTS)
    gen = _generator(device, seed)
    schedule = cosine_decay_schedule(lr, n_iters, alpha=ALPHA)
    trainer = FlockingImitationTrainer(env, params, model=_flocking_model(device, gen, k_hops,
                                                                         hidden),
                                       learning_rate=schedule, device=device)
    trainer.init(gen)
    losses, lrs, draws = [], [], 0
    _sync(device)
    t0 = time.perf_counter()
    for it in range(n_iters):
        batch = trainer.collect(gen, n_envs, n_steps)
        draws += env.last_reset_tries
        if it == 0 and probe is not None:
            probe["first_batch"] = batch
            probe["initial_weights"] = {k: v.clone() for k, v in
                                        trainer.model.state_dict().items()}
        losses.append(trainer.update(batch))
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
    losses = torch.stack(losses).tolist()
    _sync(device)
    seconds = time.perf_counter() - t0

    feats, adj, acts = collect_flocking_batch(env, params, _generator(device, HELDOUT_SEED),
                                              *heldout)
    draws += env.last_reset_tries
    with torch.no_grad():
        mse = float(trainer.loss_fn(feats, adj, acts))
    base_mse = float(torch.mean(acts ** 2))
    if probe is not None:
        probe.update(trainer=trainer, schedule=schedule, lrs=lrs)
    episode, same, eval_draws = _episode_entry(env, params, trainer.model, device, eval_envs,
                                               eval_steps, "policy_vs_expert", probe)
    return {"pipeline": "flocking BC (AggregationGNN, Turner expert)",
            "world": f"FlockingRelative-v0, N={N_AGENTS}",
            "model": {"k_hops": k_hops, "hidden": list(hidden), "lr": lr,
                      "schedule": f"cosine_decay_schedule({lr}, {n_iters}, alpha={ALPHA})"},
            "train": {"n_iters": n_iters, "samples_per_iter": n_envs * n_steps,
                      "loss_first": losses[0],
                      "loss_last": sum(losses[-10:]) / len(losses[-10:]),
                      "lr_first": lrs[0], "lr_last": lrs[-1], "seconds": seconds},
            "heldout_action_mse": mse,
            "predict_zero_mse": base_mse,
            "episode_reward_200_steps": episode,
            "eval": {"n_envs": eval_envs, "n_steps": eval_steps, "resets_equal": same},
            "reset_draws": draws + eval_draws}


def run_flocking_dagger(device: str, n_iters: int = 40, n_envs: int = 8, n_steps: int = 16,
                        n_grad_steps: int = 24, capacity: int = 8192, k_hops: int = 4,
                        hidden=(128, 128), eval_envs: int = FLOCK_EVAL_ENVS,
                        eval_steps: int = FLOCK_EVAL_STEPS, seed: int = 0,
                        probe: dict | None = None) -> dict:
    """Flocking DAGGER with the flocking BC's model and closed loop (its
    ``fit``, iteration by iteration, counting the reset draws)."""
    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.parallel import DaggerTrainer

    env, params = gft.make("FlockingRelative-v0", n_agents=N_AGENTS)
    gen = _generator(device, seed)
    trainer = DaggerTrainer(env, params, model=_flocking_model(device, gen, k_hops, hidden),
                            capacity=capacity, device=device)
    trainer.init(gen)
    losses, draws = [], 0
    _sync(device)
    t0 = time.perf_counter()
    for k in range(n_iters):
        losses.append(float(trainer.iteration(gen, trainer.beta_decay ** k, n_envs, n_steps,
                                              n_grad_steps)))
        draws += env.last_reset_tries
    _sync(device)
    seconds = time.perf_counter() - t0
    if probe is not None:
        probe["trainer"] = trainer
    episode, same, eval_draws = _episode_entry(env, params, trainer.model, device, eval_envs,
                                               eval_steps, "policy_vs_expert_cost", probe)
    return {"pipeline": "flocking DAGGER (AggregationGNN, Turner expert)",
            "world": f"FlockingRelative-v0, N={N_AGENTS}",
            "model": {"k_hops": k_hops, "hidden": list(hidden)},
            "train": {"n_iters": n_iters, "beta_decay": trainer.beta_decay,
                      "loss_first": losses[0], "loss_last": losses[-1], "seconds": seconds},
            "episode_reward_200_steps": episode,
            "eval": {"n_envs": eval_envs, "n_steps": eval_steps, "resets_equal": same},
            "reset_draws": draws + eval_draws}


# ------------------------------------------------------------ VRP labels


def collect_states(env, params, generator, n_envs: int, n_steps: int):
    """A greedy-expert rollout keeping the observation graphs and the raw
    state fields: ``(batch, states)``, each flat over ``n_envs * n_steps``
    (the greedy labels are dropped; the VRP expert's replace them)."""
    from gym_flock_tpu_torch.parallel.train_coverage import STATE_KEYS, greedy_rollout

    batch = greedy_rollout(env, params, generator, n_envs, n_steps, keep_state=True)
    batch.pop("label")
    return batch, {k: batch.pop(k) for k in STATE_KEYS}


def epoch_train(trainer, batch, device, n_epochs: int, minibatch: int, seed: int = 0,
                initial: dict | None = None):
    """Fixed-dataset BC from the weights of seed ``INIT_SEED + seed`` (copied
    into ``initial`` when given): ``n_epochs`` of shuffled minibatches
    through ``update_from_batch`` (the last partial one dropped); returns
    each epoch's last loss."""
    import torch

    n = batch["label"].shape[0]
    trainer.init(_generator(device, INIT_SEED + seed))
    if initial is not None:
        initial.update({k: v.clone() for k, v in trainer.model.state_dict().items()})
    shuffle = _generator(device, SHUFFLE_SEED + seed)
    losses = []
    for _ in range(n_epochs):
        perm = torch.randperm(n, generator=shuffle, device=device)
        for lo in range(0, n - minibatch + 1, minibatch):
            idx = perm[lo:lo + minibatch]
            loss = trainer.update_from_batch({k: v[idx] for k, v in batch.items()})
        losses.append(loss)
    return torch.stack(losses).tolist()


def run_bc_vrp(device: str, n_envs: int = 32, n_steps: int = 32, workers: int = 2,
               n_epochs: int = 60, minibatch: int = 64, eval_envs: int = EVAL_ENVS,
               eval_steps: int = EVAL_STEPS, world=None, seed: int = 0,
               probe: dict | None = None) -> dict:
    """The label-sensitivity experiment: one set of greedy-rollout states
    labelled in two VRP descent orders, two models from the same weights.
    ``world`` is ``(env, params, eval_params)`` (default
    :func:`coverage_world`); ``probe``, when given, receives the states,
    both label sets and each model's initial weights."""
    import numpy as np
    import torch

    from gym_flock_tpu_torch.parallel import CoverageImitationTrainer, vrp_label_states

    env, params, eval_params = world or coverage_world(device)
    trainer = CoverageImitationTrainer(env, params, device=device)
    batch, states = collect_states(env, params, _generator(device, seed), n_envs, n_steps)
    n = states["graph"].shape[0]
    labels, label_seconds = {}, {}
    for name, kw in (("or_default", {}), ("last_accept", {"last_accept": True})):
        t0 = time.perf_counter()
        labels[name] = vrp_label_states(params, states, mode="or_default", workers=workers,
                                        **kw)
        label_seconds[name] = time.perf_counter() - t0
    flip = float(np.mean(labels["or_default"] != labels["last_accept"]))
    if probe is not None:
        probe.update(states=states, labels=labels, initial_weights={})

    models, held_ratio = {}, {}
    for name, other in (("or_default", "last_accept"), ("last_accept", "or_default")):
        own = {**batch, "label": torch.from_numpy(labels[name]).to(device)}
        _sync(device)
        t0 = time.perf_counter()
        initial = None if probe is None else probe["initial_weights"].setdefault(name, {})
        losses = epoch_train(trainer, own, device, n_epochs, minibatch, seed, initial)
        _sync(device)
        seconds = time.perf_counter() - t0
        cross = {**batch, "label": torch.from_numpy(labels[other]).to(device)}
        ev_train = trainer.evaluate(_generator(device, EVAL_SEED), params, n_envs=eval_envs,
                                    n_steps=eval_steps)
        ev_held = trainer.evaluate(_generator(device, EVAL_SEED), eval_params,
                                   n_envs=eval_envs, n_steps=eval_steps)
        held_ratio[name] = ev_held["reward_ratio"]
        models[name] = {"loss_last": sum(losses[-5:]) / len(losses[-5:]),
                        "train_seconds": seconds,
                        "acc_on_own_labels": float(trainer.accuracy(own)),
                        "acc_on_other_labels": float(trainer.accuracy(cross)),
                        "closedloop_train": ev_train, "closedloop_heldout": ev_held}
    return {"pipeline": "coverage BC, C++ VRP expert labels; or_default vs last_accept "
                        "descent-order probe",
            "world": "CoverageARL-v0, 8 real-facility sub-windows, R=4",
            "n_labeled_states": n,
            "label_flip_rate": flip,
            "label_seconds": label_seconds,
            "models": models,
            "train": {"n_epochs": n_epochs, "minibatch": minibatch},
            "heldout_random_reward": random_reward(env, eval_params, device, eval_envs,
                                                   eval_steps),
            "downstream_delta": {"heldout_reward_ratio_gap":
                                 abs(held_ratio["or_default"] - held_ratio["last_accept"])}}


def run_probe_vrp_speed(device: str, world=None) -> dict:
    """Seconds per VRP solve on 2 envs x 4 steps of the training bank's
    rollout states, on 2 threads."""
    from gym_flock_tpu_torch.parallel import vrp_label_states

    workers = 2
    env, params, _ = world or coverage_world(device)
    _, states = collect_states(env, params, _generator(device, 0), 2, 4)
    n = states["graph"].shape[0]
    t0 = time.perf_counter()
    vrp_label_states(params, states, workers=workers)
    seconds = time.perf_counter() - t0
    print(f"{n} states in {seconds:.3f}s ({seconds / n:.4f} s/state, workers={workers})")
    return {"states": n, "workers": workers, "seconds": seconds,
            "seconds_per_state": seconds / n}


PIPELINES = {"bc_greedy": run_bc_greedy, "dagger": run_dagger, "flocking": run_flocking,
             "flocking_dagger": run_flocking_dagger, "bc_vrp": run_bc_vrp,
             "probe_vrp_speed": run_probe_vrp_speed}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pipeline", choices=[*PIPELINES, "all"])
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    ap.add_argument("--seed", type=int, default=0,
                    help="moves every training-side seed (not probe_vrp_speed's)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_quality_torch: no CUDA device; this measurement needs a GPU",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": card,
              "torch": torch.__version__, "seed": args.seed}
    for name in (PIPELINES if args.pipeline == "all" else [args.pipeline]):
        kw = {} if name == "probe_vrp_speed" else {"seed": args.seed}
        result[name] = PIPELINES[name]("cuda", **kw)
        print(name, json.dumps(result[name]), flush=True)
        if args.out:  # after every pipeline, so a cut run keeps what it finished
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
