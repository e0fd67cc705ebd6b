"""What the benchmark reads of the port's own instrumentation: the counter
``profiling.syncs`` behind ``host_syncs_per_step.host_led``, and the
program's ``gft.`` spans in the names the trace summary gives idle gaps."""
import json

import pytest

from portbench import harness

SEED = 2_147_483_999
CELL = "flocking_large.expert_rollout"
TINY = {"params": {"n_agents": 64, "max_steps": 12},
        "traffic": {"n_envs": 3, "steps_per_call": 4, "checked_envs": 3,
                    "reference_reset_envs": 8, "trace_skip_calls": 1, "trace_calls": 3}}
METRIC = "host_syncs_per_step.host_led"


def read_metric(run):
    return harness.load_module(harness.metric_file(METRIC), "t_syncs").read(run)


def test_a_traced_run_reports_the_syncs_of_every_step_it_ran(monkeypatch):
    from gym_flock_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "syncs", 0)  # the counter of a fresh process
    r = harness.run_cell(CELL, SEED, 0.2, trace=True, device="cpu", overrides=TINY)
    assert r["correct"], r["checks"]
    # every call runs 4 steps (4 divides the 12-step episode); the set-up
    # warms up two calls and a reset
    steps = 4 * r["attempted"] + 2 * 4
    assert profiling.syncs > 0
    assert r["metrics"][METRIC]["value"] == pytest.approx(profiling.syncs / steps, rel=1e-12)
    assert r["metrics"][METRIC]["unit"] == "syncs/step"


class _Run:
    def __init__(self, system_name):
        self.cell = type("C", (), {"system_name": system_name, "chunk": 16, "episode": 1000})()
        self.window = harness.Window(units=[{"steps": 16.0}] * 3, traced=[False] * 3)


def test_a_port_without_the_counter_or_the_control_gives_nothing(monkeypatch):
    from gym_flock_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "syncs", 63)
    assert read_metric(_Run("program")) == 63 / (48 + 32 + 8)
    assert read_metric(_Run("control")) is None
    monkeypatch.delattr(profiling, "syncs")
    assert read_metric(_Run("program")) is None


class _Trace:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _gaps(events):
    return dict(harness.summarize_trace(_Trace(events), 1.0)["idle_gaps"])


def test_an_idle_gap_is_named_by_the_innermost_program_span():
    # one call, its rollout span; device busy 0-10, 50-51 and 90-100 (us);
    # gaps 10-50 (mid 30: inside gft.pair_pass, no op) and 51-90 (mid 70.5:
    # inside aten::mul, in gft.step)
    events = [_x("portbench.call", "user_annotation", 0, 100),
              _x("portbench.rollout", "user_annotation", 0, 100),
              _x("gft.step", "user_annotation", 5, 90),
              _x("gft.pair_pass", "user_annotation", 20, 30),
              _x("aten::mul", "cpu_op", 65, 10),
              _x("k", "kernel", 0, 10), _x("k", "kernel", 50, 1), _x("k", "kernel", 90, 10)]
    gaps = _gaps(events)
    assert gaps == pytest.approx({"portbench.rollout/gft.pair_pass": 40e-6,
                                  "portbench.rollout/aten::mul": 39e-6})


def test_a_gap_with_no_program_span_keeps_its_name():
    events = [_x("portbench.call", "user_annotation", 0, 100),
              _x("portbench.rollout", "user_annotation", 0, 100),
              _x("k", "kernel", 0, 10), _x("k", "kernel", 90, 10)]
    assert _gaps(events) == pytest.approx({"portbench.rollout/python": 80e-6})
