"""Runs of every cell at a tiny size on the CPU, with the harness's look for
a card skipped: the port agrees with the plain reference, and the control
(the reference in the program's place, one precision below float32) and
each planted fault come out as not correct, for every cell of
``BENCHMARK.json``.  One test needs the card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SEED = 2_147_483_999  # past 32 signed bits, as the driver's seeds are
TINY = {
    "flocking_large.expert_rollout": {
        "params": {"n_agents": 64, "max_steps": 12},
        "traffic": {"n_envs": 3, "steps_per_call": 4, "checked_envs": 3,
                    "reference_reset_envs": 8, "trace_skip_calls": 1, "trace_calls": 3}},
    "flocking_relative.expert_rollout": {
        "params": {"n_agents": 20, "max_steps": 12},
        "traffic": {"n_envs": 6, "steps_per_call": 4, "checked_envs": 3,
                    "reference_reset_envs": 64, "trace_skip_calls": 1, "trace_calls": 3}},
    "flocking_relative.expert_rollout_64k": {
        "params": {"n_agents": 20, "max_steps": 12},
        "traffic": {"n_envs": 6, "steps_per_call": 4, "checked_envs": 3,
                    "reference_reset_envs": 64, "trace_skip_calls": 1, "trace_calls": 3}},
}
CELLS = sorted(TINY)
# the faults every cell can have; the exchange between chips does not exist
# on one chip
FAULTS = ("state_unchanged", "half_batch", "answer_altered", "reset_wide", "reset_first_draw")


def run(name, **kw):
    from portbench import harness

    return harness.run_cell(name, SEED, 0.2, device="cpu", overrides=TINY[name],
                            trace=kw.pop("trace", False), **kw)


def test_every_cell_has_a_tiny_size():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(CELLS) == {w["name"] for w in b["workloads"]}


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(name):
    from portbench import harness

    r = run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] is not None and c["value"] <= c["limit"] for c in r["checks"].values())
    e2e, _ = harness.cell_metrics(harness.benchmark(), name)
    assert set(r["metrics"]) == {m["name"] for m in e2e}


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_per_layer_metrics(name):
    r = run(name, trace=True)
    assert r["correct"], r["checks"]
    assert "setup_s" not in r["metrics"]
    assert not any(k.startswith(("call_ms_p95", "agent_steps_per_s")) for k in r["metrics"])
    # the CPU has no device trace: device metrics are left out, never zero
    assert not any(k.startswith(("device_idle_pct", "launches_per_step")) for k in r["metrics"])
    assert "busy_s" not in r["device"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    r = run(name, system="control")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    r = run(name, fault=fault)
    assert not r["correct"], r["checks"]


def test_nothing_loads_jax_or_the_jax_package():
    code = """
import sys, importlib.util, pathlib
sys.path.insert(0, sys.argv[1])
root = pathlib.Path(sys.argv[1]) / "portbench"
import portbench.harness, portbench.checks, portbench.systems, portbench.readers
import portbench.reference.flocking, portbench.work.counts
import portbench.calibrate
import gym_flock_tpu_torch, gym_flock_tpu_torch.parallel
for sub in ("drivers", "metrics"):
    for p in sorted((root / sub).glob("*.py")):
        spec = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "gym_flock_tpu"}))
"""
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.flocking; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'gym_flock_tpu_torch'))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "flocking_large.expert_rollout", "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "flocking_large.expert_rollout", "--seed", str(SEED), "--seconds", "2",
                        "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
