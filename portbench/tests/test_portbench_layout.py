"""The benchmark's files: ``BENCHMARK.json`` keeps to its contract, and every
configuration, traffic mix, limit and metric sits in a file of its own that
the harness finds by name."""
import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert not any(p.endswith("_torch") for p in b["paths"])
    assert len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(configs) == len(b["configs"]) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    cells = [w["name"] for w in b["workloads"]]
    assert 1 <= len(cells) == len(set(cells)) <= 24
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and one_line(w["why"])
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in b["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert one_line(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert m["source"] in SOURCES
        assert all(c in cells for c in m.get("workloads", []))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    from portbench import harness

    b = bench()
    for w in b["workloads"]:
        e2e, layer = harness.cell_metrics(b, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer
        for m in layer:  # each per-layer metric's cells report what it moves
            assert m["moves"] in names


def test_every_piece_is_found_by_name():
    from portbench import harness

    b = bench()
    for c in b["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert harness.config_file(c["name"]) == REPO / c["file"]
    for w in b["workloads"]:
        traffic = json.loads(harness.traffic_file(w["traffic"], w["config"]).read_text())
        assert (ROOT / "drivers" / f"{traffic['driver']}.py").is_file()
        limits = json.loads(harness.limits_file(w["name"]).read_text())
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in b["end_to_end"] + b["per_layer"]:
        mod = harness.load_module(harness.metric_file(m["name"]), f"t_{m['name']}")
        assert callable(mod.read)


def test_files_under_paths_are_named_from_name_characters():
    for path in ROOT.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert PATH.match(rel), rel


@pytest.mark.parametrize("module", sorted(p.name for p in (ROOT / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(module):
    tree = ast.parse((ROOT / "reference" / module).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "dataclasses", "math", "typing", "torch"}, names
