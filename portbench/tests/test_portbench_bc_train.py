"""The behaviour-cloning cell ``explore_full_arl_bc.bc_train``: runs at a tiny
size on the CPU (the port agrees with the plain reference; the control and
each planted fault do not), the update's frozen count, the readers of its
per-layer metrics on fake runs, and the metrics the cell reports."""
import pytest

from portbench import harness
from portbench.work import edge_graph_net_counts as counts

CELL = "explore_full_arl_bc.bc_train"
SEED = 2_147_483_999  # past 32 signed bits, as a run's --seed may be
# the procedural map at 8 robots, 4 worlds and 3 steps a call
TINY = {"params": {"real_map": False, "n_robots": 8, "episode_length": 6},
        "traffic": {"n_envs": 4, "steps_per_call": 3, "checked_envs": 2,
                    "reference_reset_envs": 512, "trace_skip_calls": 1, "trace_calls": 2}}
# ``tf32`` changes nothing on the CPU, whose products have no TF32
CPU_FAULTS = ("round_dropped", "half_batch", "update_skipped", "grad_dropped",
              "state_unchanged")


def run(**kw):
    return harness.run_cell(CELL, SEED, 0.2, device="cpu", overrides=TINY,
                            trace=kw.pop("trace", False), **kw)


def test_the_port_agrees_with_the_reference():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    e2e, _ = harness.cell_metrics(harness.benchmark(), CELL)
    assert set(r["metrics"]) == {m["name"] for m in e2e}


def test_a_traced_run_reports_no_device_metric_off_the_card():
    r = run(trace=True)
    assert r["correct"], r["checks"]
    # the CPU has no CUDA events and no device trace: left out, never zero
    assert r["metrics"] == {}
    assert "busy_s" not in r["device"]


def test_the_control_is_not_correct():
    r = run(system="control")
    assert not r["correct"], r["checks"]
    assert r["checks"]["grad_gap"]["value"] > r["checks"]["grad_gap"]["limit"]


@pytest.mark.parametrize("fault", CPU_FAULTS)
def test_a_broken_update_is_not_correct(fault):
    r = run(fault=fault)
    assert not r["correct"], r["checks"]


def test_the_cell_reports_its_rate_its_tail_and_three_per_layer_metrics():
    e2e, layer = harness.cell_metrics(harness.benchmark(), CELL)
    assert {m["name"] for m in e2e} == {"agent_steps_per_s", "call_ms_p95", "setup_s"}
    assert {m["name"] for m in layer} == {"update_ms.bc_train", "collect_ms.bc_train",
                                          "mfu_pct.bc_train"}
    assert {m["moves"] for m in layer} == {"agent_steps_per_s"}


def test_the_updates_count_is_a_hand_count_on_a_small_model():
    # latent 2, one round, one node feature and one edge feature; 1 sample of
    # 3 nodes, 4 edges and 1 robot
    flops, nbytes = counts.update_work(1, 3, 4, 1, 2, 1, 1, 1)
    # multiply-adds a row: node encoder 1x2, edge encoder 1x2 (no input
    # gradient: x2); head 2x2 + 2x1, message 6x2 + 2x2 (x3); the only round's
    # node MLP feeds no logit and is not counted
    want = 2 * 2 * (3 * 2 + 4 * 2) + 2 * 3 * (4 * (4 + 2) + 4 * (12 + 4))
    assert flops == want
    # params: 4 + 4 + (6 + 3) + (14 + 6) + (10 + 6) = 53
    assert counts.n_params(2, 1, 1, 1) == 53
    # bytes: the layers' 72 + 96 + (160 + 128) + (352 + 160), the batch 64,
    # Adam 7 x 4 x 53
    assert nbytes == 72 + 96 + 288 + 512 + 64 + 7 * 4 * 53


class _Cell:
    def __init__(self, rows=None, ms=None):
        self.rows, self.ms = rows, ms

    def message_rows_per_call(self):
        return self.rows

    def half_ms(self, half):
        return None if self.ms is None else self.ms[half]


def fake_run(cell, device="cuda"):
    cfg = harness.load_json(harness.config_file("explore_full_arl_bc"))
    win = harness.Window(seconds=2.0, traced=[False, False, True],
                         units=[{"calls": 1.0}] * 3, call_s=[0.5, 0.5, 0.9])
    return harness.Run(CELL, cfg, {}, cell, win, 0.0, device)


def reader(name):
    return harness.load_module(harness.metric_file(name), f"t_{name}").read


def test_the_readers_read_the_cells_events_and_the_models_counter():
    rows = 128 * 23036 * 6
    r = fake_run(_Cell(rows, {"update": [3.0, 1.0, 2.0], "collect": [5.0, 4.0]}))
    assert reader("update_ms.bc_train")(r) == 2.0
    assert reader("collect_ms.bc_train")(r) == 4.5
    flops, nbytes = counts.update_work(128, 5759, 23036, 6, 64, 4, 1, 100)
    least = max(flops / 67e12, nbytes / 3.35e12)
    assert reader("mfu_pct.bc_train")(r) == pytest.approx(100.0 * least / 0.5)
    assert 2.0e12 < flops < 2.3e12  # about 2.1 TFLOP an update


def test_a_port_without_the_counter_a_control_or_the_cpu_reads_nothing():
    assert reader("mfu_pct.bc_train")(fake_run(_Cell(None))) is None
    assert reader("mfu_pct.bc_train")(fake_run(_Cell(1000), device="cpu")) is None
    assert reader("update_ms.bc_train")(fake_run(_Cell())) is None
    assert reader("collect_ms.bc_train")(fake_run(object())) is None
