"""The coverage cell ``explore_full_arl.expert_collect``: runs at a tiny size
on the CPU (the port agrees with the plain reference; the control and each
planted fault do not), K5's frozen count, the readers of its per-layer
metrics on fake runs, and the metrics the cell reports."""
import pytest

from portbench import harness
from portbench.work import counts, rowmin_counts

CELL = "explore_full_arl.expert_collect"
SEED = 2_147_483_999  # past 32 signed bits, as the driver's seeds are
# the procedural map at 8 robots, 64 worlds and 6-step episodes
TINY = {"params": {"real_map": False, "n_robots": 8, "episode_length": 6},
        "traffic": {"n_envs": 64, "steps_per_call": 6, "checked_envs": 4,
                    "reference_reset_envs": 512, "trace_skip_calls": 1, "trace_calls": 2}}
FAULTS = ("state_unchanged", "half_batch", "answer_altered", "reset_wide", "reset_first_draw")


def run(**kw):
    return harness.run_cell(CELL, SEED, 0.2, device="cpu", overrides=TINY,
                            trace=kw.pop("trace", False), **kw)


def test_the_port_agrees_with_the_reference():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] is not None and c["value"] <= c["limit"] for c in r["checks"].values())
    e2e, _ = harness.cell_metrics(harness.benchmark(), CELL)
    assert set(r["metrics"]) == {m["name"] for m in e2e}


def test_a_traced_run_reports_per_layer_metrics():
    r = run(trace=True)
    assert r["correct"], r["checks"]
    assert "setup_s" not in r["metrics"]
    assert not any(k.startswith(("call_ms_p95", "agent_steps_per_s")) for k in r["metrics"])
    assert r["metrics"]["conflict_rounds_per_step.explore"]["value"] >= 1
    # the CPU has no device trace: device metrics are left out, never zero
    assert not any(k.startswith(("device_idle_pct", "launches_per_step", "rowmin_roofline"))
                   for k in r["metrics"])
    assert "busy_s" not in r["device"]


def test_the_control_is_not_correct():
    r = run(system="control")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(fault):
    r = run(fault=fault)
    assert not r["correct"], r["checks"]


def names(metrics):
    return {m["name"] for m in metrics}


def reader(name):
    return harness.load_module(harness.metric_file(name), f"t_{name}").read


def fake_run(cell, trace=None, steps=(50.0, 50.0)):
    win = harness.Window(seconds=1.0, traced=[False] * len(steps),
                         units=[{"steps": s} for s in steps], call_s=[0.5] * len(steps))
    return type("R", (), {"cell": cell, "trace": trace, "window": win})()


def test_the_cell_reports_its_tail_its_rate_and_four_per_layer_metrics():
    e2e, layer = harness.cell_metrics(harness.benchmark(), CELL)
    assert names(e2e) == {"agent_steps_per_s", "call_ms_p95.host_led", "setup_s"}
    assert names(layer) == {"device_idle_pct.host_led", "launches_per_step.host_led",
                            "conflict_rounds_per_step.explore", "rowmin_roofline"}
    assert {m["moves"] for m in layer} == {"call_ms_p95.host_led"}


@pytest.mark.parametrize("g, rows", [(1, 5), (2, 6)])
def test_k5s_count_is_a_hand_count_on_a_small_operand(g, rows):
    # 2 worlds x 3 robots x 5 targets on g graphs: 6 robots gather from g * 5
    # rows of 5 bf16 costs, each distinct row read once; 10 blocked flags,
    # 6 row indices (int32) in, 6 packed minima (float32) out
    flops, nbytes = rowmin_counts.rowmin_work(2, 3, 5, g)
    assert flops == 2 * 30
    assert nbytes == rows * 5 * 2 + 10 * 1 + 6 * 4 + 6 * 4
    assert rowmin_counts.rowmin_bound_s(2, 3, 5, g) == counts.bound_s(flops, nbytes)


def test_k5_at_the_cells_size_is_bound_by_its_bytes():
    # 51,200 robots gather from the map's 5,659 rows: the whole table once
    seconds, kind = rowmin_counts.rowmin_bound_s(512, 100, 5659, 1)
    assert kind == "bytes"
    assert seconds == pytest.approx(0.0201e-3, rel=0.01)


def test_the_roofline_reads_the_traced_launches_of_k5_alone():
    cell = type("C", (), {"b": 2, "r": 3, "t": 5, "g": 1})()
    bound = rowmin_counts.rowmin_bound_s(2, 3, 5, 1)[0]
    trace = {"kernel_s": {"void rowmin_kernel(int const*, bool const*)": [8 * bound, 4],
                          "void other_kernel()": [1.0, 9]}}
    assert reader("rowmin_roofline")(fake_run(cell, trace)) == pytest.approx(50.0)
    assert reader("rowmin_roofline")(fake_run(cell, {"kernel_s": {}})) is None
    assert reader("rowmin_roofline")(fake_run(cell, None)) is None
    assert reader("rowmin_roofline")(fake_run(object(), trace)) is None


def test_the_conflict_reader_divides_the_windows_rounds_by_its_steps():
    read = reader("conflict_rounds_per_step.explore")
    counted = type("C", (), {"conflict_rounds": lambda self: 250})()
    assert read(fake_run(counted)) == pytest.approx(2.5)
    control = type("C", (), {"conflict_rounds": lambda self: None})()
    assert read(fake_run(control)) is None
    assert read(fake_run(object())) is None
    assert read(fake_run(counted, steps=())) is None


@pytest.fixture(scope="module")
def procedural():
    """The cell's configuration on the procedural map, at 8 robots."""
    import gym_flock_tpu_torch as gft
    from portbench import coverage_systems

    cfg = harness.load_json(harness.config_file(CELL.split(".")[0]))
    cfg = {**cfg, "params": {**cfg["params"], "real_map": False, "n_robots": 8}}
    _, params = gft.make(cfg["env_id"], device="cpu", **cfg["params"])
    return cfg, params, coverage_systems.world_of(params, cfg["world"]["horizon"])


def test_the_env_is_the_deployment_its_configuration_states(procedural):
    from portbench import coverage_systems

    cfg, params, world = procedural
    assert coverage_systems.deployment_gaps(cfg, params, world) == []


@pytest.mark.parametrize("entry, value", [("horizon", 12), ("horizon", 25),
                                          ("discover_radius", 20.0),
                                          ("nearby_density", 4), ("collision_checks", False)])
def test_a_deployment_the_env_is_not_is_refused(procedural, entry, value):
    import dataclasses

    from portbench import coverage_systems

    cfg, params, world = procedural
    cfg = {**cfg, "world": {**cfg["world"], entry: value}}
    if entry == "horizon":
        world = dataclasses.replace(world, horizon=value, _cache=world._cache)
    gaps = coverage_systems.deployment_gaps(cfg, params, world)
    assert gaps and all(gap.startswith(entry) for gap in gaps)


@pytest.mark.parametrize("table", [None, "neighbor_table", "graph_prev", "graph_cost"])
def test_a_wrong_table_in_the_ports_bank_reads_as_a_gap(procedural, table):
    """The reference derives its tables from the map alone, so a fault in
    the port's motion options, predecessors or hop costs shows."""
    import dataclasses

    import torch

    import gym_flock_tpu_torch as gft
    from portbench import coverage_checks, coverage_systems

    cfg, params, world = procedural
    env, _ = gft.make(cfg["env_id"], device="cpu", **cfg["params"])
    bank = dict(params.bank)
    if table == "neighbor_table":
        bank[table] = bank[table].flip(-1).contiguous()
    elif table == "graph_prev":
        bank[table] = bank[table].transpose(1, 2).contiguous()
    elif table == "graph_cost":  # each row's targets in reverse; read without K5's operand
        bank = {k: v for k, v in bank.items() if k not in ("cost_pack_ok", "cost_rows_pad")}
        bank[table] = bank[table].flip(-1).contiguous()
    system = coverage_systems.ProgramCollect(env, dataclasses.replace(params, bank=bank))
    b, n = 4, 6
    batch, rec = system.collect(torch.Generator().manual_seed(5), b, n, keep=torch.arange(b))
    samples = {k: v.reshape((b, n) + tuple(v.shape[1:])) for k, v in batch.items()}
    gaps = coverage_checks.episode_gaps(world, rec["states"], rec["rewards"], samples)
    wrong = gaps["label_gap"] + gaps["ids_gap"] + gaps["state_gap"]
    assert wrong == 0 if table is None else wrong > 0, gaps
