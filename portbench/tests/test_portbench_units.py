"""The harness's arithmetic: percentiles, the acceptance z, the judgement,
the frozen counts and the trace summary."""
import json
import math

import pytest
import torch

from portbench import checks, harness
from portbench.reference import flocking as ref
from portbench.work import counts


def test_percentile_interpolates_between_order_statistics():
    v = list(range(1, 101))
    assert harness.percentile(v, 95) == pytest.approx(95.05)
    assert harness.percentile([3.0], 95) == 3.0


def test_judge_fails_a_missing_or_non_finite_number():
    ok, c = harness.judge({"a": 1.0, "b": 0.0}, {"a": 2.0, "b": 0})
    assert ok and list(c) == ["a", "b"]
    assert not harness.judge({"a": math.nan}, {"a": 2.0})[0]
    assert not harness.judge({}, {"a": 2.0})[0]
    assert not harness.judge({"a": 3.0}, {"a": 2.0})[0]


def test_accept_z_reads_zero_for_equal_shares_and_large_for_far_ones():
    assert checks.accept_z(0, 32, 0, 1) == 0.0
    assert checks.accept_z(50, 100, 500, 1000) == pytest.approx(0.0)
    assert checks.accept_z(1, 1000, 360, 1000) > 20


def test_pair_counts_match_a_brute_force_count():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 50, 4), generator=g) * 3
    pairs, hits, neigh = counts.pair_counts(x, 0.9, 0.81)
    d = x[:, :, None, :2] - x[:, None, :, :2]
    r2 = (d ** 2).sum(-1)
    off = ~torch.eye(50, dtype=torch.bool)
    assert pairs == 2 * 50 * 49
    assert neigh == int(((r2 < 0.81) & off).sum())
    assert hits == int((((r2 < 0.81) | (r2 <= 0.9)) & off).sum())
    secs, by = counts.bound_s(67e12, 0.0)
    assert secs == pytest.approx(1.0) and by == "operations"


def test_the_reference_reset_draws_within_its_support():
    world = ref.World(n_agents=30)
    x, ok, draws = ref.reset(torch.Generator().manual_seed(1), world, 16)
    assert 1 <= draws <= world.max_reset_tries
    assert x.shape == (16, 30, 4) and ref.out_of_support(x, world) == 0
    assert bool(ref.accepted(x, world)[ok].all())
    wide = x.clone()
    wide[..., :2] *= 1.5
    assert ref.out_of_support(wide, world) > 0


def test_the_trace_summary_unions_device_time_and_names_idle_gaps(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.call", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.reset", "ts": 0, "dur": 60},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 20, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 15, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60, "dur": 20},
    ]

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    s = harness.summarize_trace(Prof(), units=4)
    assert s["busy_s"] == pytest.approx(35e-6) and s["window_s"] == pytest.approx(100e-6)
    assert s["kernels"] == 3 and s["device_ops"][0][0] == "k1"
    gaps = dict(s["idle_gaps"])
    assert gaps["portbench.reset/cudaStreamSynchronize"] == pytest.approx(35e-6)
    assert sum(gaps.values()) == pytest.approx(65e-6)


def test_reset_verdict_counts_a_reset_that_stopped_early_on_a_rejected_swarm():
    world = ref.World(n_agents=30)
    x, ok, _ = ref.reset(torch.Generator().manual_seed(2), world, 8)
    rejected = x[~ok] if not bool(ok.all()) else None
    assert rejected is not None  # at N=30 most draws fail the test
    bad = checks.reset_numbers(world, [(rejected, 1)], 8, 3)
    good = checks.reset_numbers(world, [(rejected, world.max_reset_tries)], 8, 3)
    assert bad["reset_verdict"] == 1 and good["reset_verdict"] == 0
