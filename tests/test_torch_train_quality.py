"""The port's learning-rate schedule against optax's, and the pipelines of
``tools/train_quality_torch.py`` at toy sizes on the CPU.

``cosine_decay_schedule`` is held to ``optax.cosine_decay_schedule`` at
double precision (JAX's x64 mode: at 32 bits optax's own value is the
formula's rounded one, within ~1.4e-7 of ``init_value``, and near
``decay_steps`` at ``alpha=0`` two roundings of ``1 + cos`` differ by a
percent), every step from 0 to ``decay_steps + 3``, within 1e-7 relative.

The pipelines run with the full models at a few iterations of a few envs;
their JSON entries keep the key names of ``TRAIN_r05.json`` (the JAX
package's records), the closed loop's three modes start from equal resets,
the VRP labels are ``vrp_label_states``'s and the two VRP-label models
start from equal weights.
"""
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import optax
import pytest
import torch

import gym_flock_tpu_torch as gft
from gym_flock_tpu_torch.parallel import cosine_decay_schedule, vrp_label_states

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "train_quality_torch.py"
JAX_RECORD = json.loads((REPO / "TRAIN_r05.json").read_text())
SCHEDULE_RTOL = 1e-7


def _tool():
    spec = importlib.util.spec_from_file_location("train_quality_torch", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tq = _tool()


def _all_finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_all_finite(v) for v in tree)
    if isinstance(tree, float):
        return math.isfinite(tree)
    return True


def _keys_of(want: dict, got: dict, where: str = "") -> None:
    """Every key of the JAX record ``want`` is in ``got``, nested dicts too."""
    for k, v in want.items():
        assert k in got, f"{where}{k}"
        if isinstance(v, dict):
            _keys_of(v, got[k], f"{where}{k}.")


@pytest.mark.parametrize("alpha", [0.0, 0.03])
@pytest.mark.parametrize("init_value,decay_steps", [(1e-3, 16), (1e-3, 2500), (0.37, 7)])
def test_cosine_decay_schedule_equals_optax(init_value, decay_steps, alpha):
    ours = cosine_decay_schedule(init_value, decay_steps, alpha=alpha)
    with jax.enable_x64(True):
        theirs = optax.cosine_decay_schedule(init_value, decay_steps, alpha=alpha)
        want = [float(theirs(step)) for step in range(decay_steps + 4)]
    for step, w in enumerate(want):
        got = ours(step)
        assert isinstance(got, float)
        assert abs(got - w) <= SCHEDULE_RTOL * abs(w), (step, got, w)
    assert ours(decay_steps + 3) == pytest.approx(alpha * init_value, rel=1e-12, abs=0.0)


def test_cosine_decay_schedule_rejects_no_decay_steps():
    for bad in (0, -3):
        with pytest.raises(ValueError):
            optax.cosine_decay_schedule(1e-3, bad)
        with pytest.raises(ValueError):
            cosine_decay_schedule(1e-3, bad)


def test_flocking_bc_pipeline_at_toy_size():
    """3 iterations of 2 envs x 2 steps, the held-out batch and the closed
    loop at 2 x 3: JAX's keys, finite numbers, each step's ``lr`` the
    schedule's, the three modes from equal resets."""
    probe = {}
    entry = tq.run_flocking("cpu", n_iters=3, n_envs=2, n_steps=2, heldout=(2, 2),
                            eval_envs=2, eval_steps=3, probe=probe)
    _keys_of(JAX_RECORD["flocking"], entry)
    assert _all_finite(entry)
    assert entry["train"]["n_iters"] == 3 and entry["train"]["samples_per_iter"] == 4
    assert probe["lrs"] == [probe["schedule"](i) for i in range(3)]
    assert probe["lrs"][0] == 1e-3 and probe["trainer"].step == 3
    resets = probe["resets"]
    assert set(resets) == {"policy", "expert", "random"}
    assert all(torch.equal(resets["policy"], x) for x in resets.values())
    assert entry["eval"]["resets_equal"] is True
    ep = entry["episode_reward_200_steps"]
    assert ep["policy_vs_expert"] == ep["policy"] / ep["expert"]
    assert all(ep[m] < 0 for m in ("policy", "expert", "random"))  # minus a variance
    assert probe["first_batch"][0].shape == (4, 100, 6)
    assert entry["reset_draws"] >= 3 + 1 + 3  # a draw or more a reset


def test_flocking_dagger_pipeline_at_toy_size():
    probe = {}
    entry = tq.run_flocking_dagger("cpu", n_iters=2, n_envs=2, n_steps=2, n_grad_steps=2,
                                   capacity=64, eval_envs=2, eval_steps=3, probe=probe)
    _keys_of(JAX_RECORD["flocking_dagger"], entry)
    assert _all_finite(entry)
    assert probe["trainer"].state.filled == 8 and probe["trainer"].step == 4
    assert entry["eval"]["resets_equal"] is True
    assert all(torch.equal(probe["resets"]["policy"], x) for x in probe["resets"].values())


def _coverage_world():
    env, params = gft.make("Coverage-v0", n_graphs=2, device="cpu")
    _, eval_params = gft.make("Coverage-v0", n_graphs=2, bank_seed=1234, device="cpu")
    return env, params, eval_params


def test_bc_vrp_pipeline_at_toy_size():
    """2 envs x 2 steps labelled in both orders, 2 epochs of minibatches of
    2: the label sets are ``vrp_label_states``'s on the kept states, the two
    models start from the same weights."""
    world = _coverage_world()
    probe = {}
    entry = tq.run_bc_vrp("cpu", n_envs=2, n_steps=2, n_epochs=2, minibatch=2, eval_envs=2,
                          eval_steps=3, world=world, probe=probe)
    _keys_of(JAX_RECORD["bc_vrp"], entry)
    assert _all_finite(entry)
    params = world[1]
    states = probe["states"]
    assert states["graph"].shape == (4,) and entry["n_labeled_states"] == 4
    for name, kw in (("or_default", {}), ("last_accept", {"last_accept": True})):
        np.testing.assert_array_equal(probe["labels"][name],
                                      vrp_label_states(params, states, mode="or_default", **kw))
    flip = float(np.mean(probe["labels"]["or_default"] != probe["labels"]["last_accept"]))
    assert entry["label_flip_rate"] == flip
    a, b = (probe["initial_weights"][n] for n in ("or_default", "last_accept"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for m in entry["models"].values():
        assert 0.0 <= m["acc_on_own_labels"] <= 1.0 and 0.0 <= m["acc_on_other_labels"] <= 1.0


def test_epoch_train_drops_the_partial_minibatch_and_starts_from_the_same_weights():
    env, params, _ = _coverage_world()
    batch, _ = tq.collect_states(env, params, torch.Generator().manual_seed(0), 2, 3)
    batch["label"] = torch.zeros(6, params.n_robots, dtype=torch.int32)
    trainer = gft.parallel.CoverageImitationTrainer(env, params, device="cpu")
    first = tq.epoch_train(trainer, batch, "cpu", n_epochs=2, minibatch=4)
    assert len(first) == 2 and trainer.step == 2  # one full minibatch of 4 an epoch
    again = tq.epoch_train(trainer, batch, "cpu", n_epochs=2, minibatch=4)
    assert again == first


def test_probe_vrp_speed_runs():
    out = tq.run_probe_vrp_speed("cpu", world=_coverage_world())
    assert out["states"] == 8 and out["workers"] == 2 and out["seconds"] > 0.0


def test_cli_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run the pipeline")
    proc = subprocess.run([sys.executable, str(TOOL), "flocking"], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode != 0 and "needs a GPU" in proc.stderr
    assert proc.stdout == ""


def test_cli_names_every_pipeline_of_the_jax_script():
    """The pipelines are the JAX script's (``benchmarks/train_quality.py``)."""
    text = (REPO / "benchmarks" / "train_quality.py").read_text()
    jax_choices = {"bc_greedy", "bc_vrp", "dagger", "flocking", "flocking_dagger",
                   "probe_vrp_speed"}
    assert all(f'"{c}"' in text for c in jax_choices)
    assert set(tq.PIPELINES) == jax_choices
