"""The device-led cell ``flocking_relative.expert_rollout_64k``: the metrics
it reports beside those of the B=8192 cell, K6's frozen count and the
reader of K6's roofline."""
import json

import pytest
import torch

from portbench import harness
from portbench.work import counts

REPO = harness.REPO
CELL = "flocking_relative.expert_rollout_64k"


def names(metrics):
    return {m["name"] for m in metrics}


def test_the_dense_pass_at_b8192_n100_is_bound_by_its_bytes_at_0_1115_ms():
    b, n = 8192, 100
    pairs = b * n * (n - 1)
    secs, by = counts.bound_s(*counts.dense_pass_work(b, n, pairs, pairs))
    assert by == "bytes"
    assert secs == pytest.approx(0.1115e-3, rel=5e-3)
    # the pass at a call's start writes the expert's sums alone
    assert counts.dense_pass_work(b, n, pairs, 0, observation=False)[1] == b * n * 8 * 4


def test_the_device_led_cell_reports_its_own_metrics():
    e2e, layer = harness.cell_metrics(harness.benchmark(), CELL)
    assert names(e2e) == {"agent_steps_per_s.device_led", "call_ms_p95.device_led", "setup_s"}
    assert names(layer) == {"device_idle_pct.device_led", "mfu_pct.device_led",
                            "dense_pass_roofline"}
    assert {m["moves"] for m in layer} == {"agent_steps_per_s.device_led"}


def test_the_b8192_cell_reports_the_metrics_it_did():
    e2e, layer = harness.cell_metrics(harness.benchmark(), "flocking_relative.expert_rollout")
    assert names(e2e) == {"agent_steps_per_s", "call_ms_p95", "setup_s"}
    assert names(layer) == {"device_idle_pct.rollout", "launches_per_step.rollout",
                            "mfu_pct.rollout"}


def test_the_mix_is_the_b8192_mix_at_the_largest_batch_the_port_takes():
    def mix(traffic):
        return json.loads(harness.traffic_file(traffic, "flocking_relative").read_text())

    small, large = mix("expert_rollout"), mix("expert_rollout_64k")
    assert small["n_envs"] == 8192 and large["n_envs"] == 65535
    differ = {k for k in set(small) | set(large) if small.get(k) != large.get(k)}
    assert differ == {"n_envs", "sizes_from", "trace_states"}


class _Run:
    """What the roofline reader sees of a run: two traced calls of 8 steps,
    the second begun by a reset, and one that ran without the profiler."""

    def __init__(self, kernel_s):
        g = torch.Generator().manual_seed(5)
        self.xs = [torch.rand((3, 20, 4), generator=g) * 4 for _ in range(2)]
        self.config = {"params": {"comm_radius": 0.9}}
        # the passes as `cell.traced` counts them: one at the start, one a step, one for a reset
        self.cell = type("C", (), {"traced": [(self.xs[0], 9), (self.xs[1], 10)]})()
        self.window = harness.Window(
            units=[{"steps": 8.0, "resets": 0.0}, {"steps": 8.0, "resets": 0.0},
                   {"steps": 8.0, "resets": 1.0}],
            traced=[False, True, True])
        self.trace = {"kernel_s": kernel_s}


def read_roofline(run):
    return harness.load_module(harness.metric_file("dense_pass_roofline"), "t_k6").read(run)


def test_the_roofline_counts_each_pass_of_the_traced_calls():
    seconds = 2e-6
    run = _Run({"void dense_pass_kernel<true, false, true>(float4 const*)": [1.5e-6, 16],
                "void dense_pass_kernel<true, false, false>(float4 const*)": [0.5e-6, 2],
                "void other_kernel()": [9.0, 1]})
    flops = nbytes = 0
    for x in run.xs:
        pairs, hits, _ = counts.pair_counts(x, 0.9, 0.81)
        for observation, passes in ((False, 1), (True, 8)):
            f, b = counts.dense_pass_work(3, 20, pairs, hits, observation)
            flops, nbytes = flops + passes * f, nbytes + passes * b
    want = 100.0 * counts.bound_s(flops, nbytes)[0] / seconds
    assert read_roofline(run) == pytest.approx(want, rel=1e-12)


def test_the_roofline_leaves_out_the_passes_run_after_the_trace_ends():
    # the trace holds 5 of the last call's 8 passes with the observation
    run = _Run({"void dense_pass_kernel<true, false, true>(float4 const*)": [1.5e-6, 13],
                "void dense_pass_kernel<true, false, false>(float4 const*)": [0.5e-6, 2]})
    flops = nbytes = 0
    for x, n in zip(run.xs, (8, 5)):
        pairs, hits, _ = counts.pair_counts(x, 0.9, 0.81)
        for observation, passes in ((False, 1), (True, n)):
            f, b = counts.dense_pass_work(3, 20, pairs, hits, observation)
            flops, nbytes = flops + passes * f, nbytes + passes * b
    want = 100.0 * counts.bound_s(flops, nbytes)[0] / 2e-6
    assert read_roofline(run) == pytest.approx(want, rel=1e-12)


def test_the_roofline_reads_nothing_where_the_trace_and_the_passes_disagree():
    for launches in (19, 7):  # more passes than the calls make; fewer than the last holds
        run = _Run({"void dense_pass_kernel<true, false, true>(float4 const*)": [1.5e-6,
                                                                                 launches - 2],
                    "void dense_pass_kernel<true, false, false>(float4 const*)": [0.5e-6, 2]})
        assert read_roofline(run) is None


def test_the_roofline_reads_nothing_without_the_kernel_in_the_trace():
    assert read_roofline(_Run({"void other_kernel()": [1.0, 1]})) is None
    run = _Run({})
    run.trace = None
    assert read_roofline(run) is None
