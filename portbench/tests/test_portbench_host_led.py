"""The host-led cell ``flocking_large.expert_rollout``: its rate, which the
host's speed moves past any bound the cell could hold, is read per layer,
and the cell's per-layer metrics move its call latency's tail."""
import pytest

from portbench import harness

CELL = "flocking_large.expert_rollout"


def names(metrics):
    return {m["name"] for m in metrics}


def test_the_host_led_cell_reports_its_tail_end_to_end_and_its_rate_per_layer():
    e2e, layer = harness.cell_metrics(harness.benchmark(), CELL)
    assert names(e2e) == {"call_ms_p95.host_led", "setup_s"}
    assert names(layer) == {"rollout_agent_steps_per_s.host_led", "device_idle_pct.host_led",
                            "launches_per_step.host_led", "mfu_pct.host_led", "reset_draws",
                            "reset_ms", "pair_sums_roofline", "host_syncs_per_step.host_led"}
    assert {m["moves"] for m in layer} == {"call_ms_p95.host_led"}


def read_rate(run):
    return harness.load_module(harness.metric_file("rollout_agent_steps_per_s.host_led"),
                               "t_rate").read(run)


def test_the_rate_counts_the_calls_that_ran_without_the_profiler():
    win = harness.Window(seconds=9.0, traced=[False, True, False],
                         units=[{"agent_steps": 600.0}, {"agent_steps": 600.0},
                                {"agent_steps": 300.0}],
                         call_s=[2.0, 5.0, 1.0])
    run = type("R", (), {"window": win})()
    assert read_rate(run) == pytest.approx(900.0 / 3.0, rel=1e-12)


def test_the_rate_reads_nothing_without_an_untraced_call():
    win = harness.Window(seconds=1.0, traced=[True], units=[{"agent_steps": 6.0}],
                         call_s=[1.0])
    assert read_rate(type("R", (), {"window": win})()) is None
