"""The benchmark's engine: it finds a cell's pieces by name, runs the set-up,
measures the window, reads the metrics and decides ``correct``.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in a file of its own under ``portbench/``, found by the names in
``BENCHMARK.json``:

  configs/<config>.json            the configuration as it is run
  traffic/<traffic>/<config>.json  the mix's parameters for that
                                   configuration; its ``driver`` names the
                                   general generator in ``drivers/``
  metrics/<metric>.py              ``read(run) -> float | None``
  limits/<workload>.json           the limit of each number compared

A run: set-up (``setup_s`` runs from the process's start to the first timed
call), the window (calls until ``--seconds`` have passed, each timed by a
pair of CUDA events and ended by a synchronisation), with ``--trace 1`` a
``torch.profiler`` trace over a steady run of calls inside it, then the
per-layer readers, and last the comparison with the plain reference, after
the program's state is freed.

A driver's ``Cell`` offers ``setup()``, ``call() -> units of work``,
``release()`` and ``check() -> numbers``; before each call the harness sets
``cell.tracing`` (whether the call runs under the profiler), and it calls
``cell.before_trace()``, where the cell has one, before the profiler starts.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import statistics
import tempfile
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
TOP_OPS = 10


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> Path:
    return ROOT / "configs" / f"{name}.json"


def traffic_file(traffic: str, config: str) -> Path:
    return ROOT / "traffic" / traffic / f"{config}.json"


def limits_file(name: str) -> Path:
    return ROOT / "limits" / f"{name}.json"


def metric_file(name: str) -> Path:
    return ROOT / "metrics" / f"{name}.py"


def driver(kind: str) -> ModuleType:
    return load_module(ROOT / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def reports(metric: dict, name: str, end_to_end_names: List[str]) -> bool:
    """Whether the cell ``name`` reports ``metric``."""
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric.get("moves", None) is None or metric["moves"] in end_to_end_names


def cell_metrics(bench: dict, name: str):
    """``(end-to-end metrics, per-layer metrics)`` that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return e2e, layer


@dataclasses.dataclass
class Window:
    """What the window did: its calls' latencies (ms), which of them ran
    under the profiler, the units of work each completed, its seconds."""

    seconds: float = 0.0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    traced: List[bool] = dataclasses.field(default_factory=list)
    units: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    call_s: List[float] = dataclasses.field(default_factory=list)
    ends: List[float] = dataclasses.field(default_factory=list)

    def buckets(self, width: float = 5.0) -> List[float]:
        """Steps a second in each ``width``-second stretch of the window."""
        out: Dict[int, float] = {}
        for e, u in zip(self.ends, self.units):
            out[int(e // width)] = out.get(int(e // width), 0.0) + u.get("steps", 0.0)
        return [out.get(i, 0.0) / width for i in range(int(self.seconds // width))]

    def total(self, unit: str, traced: Optional[bool] = None) -> float:
        return sum(u.get(unit, 0.0) for u, t in zip(self.units, self.traced)
                   if traced is None or t == traced)

    def untraced_seconds(self) -> float:
        return sum(s for s, t in zip(self.call_s, self.traced) if not t)


@dataclasses.dataclass
class Run:
    """What a metric reader sees."""

    name: str
    config: dict
    traffic: dict
    cell: Any
    window: Window
    setup_s: float
    device: str
    trace: Optional[dict] = None


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# --------------------------------------------------------------------------
# trace


def _union(intervals):
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize_trace(prof, units: float) -> dict:
    """The device's busy time, the traced span, the kernels, the device
    operations that took most time and the longest idle gaps named by what
    the host was doing, from a ``torch.profiler`` Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    dev, host, calls = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        s = float(e["ts"]) * 1e-6
        d = float(e["dur"]) * 1e-6
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((s, s + d, cat, str(e.get("name", ""))))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"):
            host.append((s, s + d, str(e.get("name", ""))))
            if cat == "user_annotation" and e.get("name") == "portbench.call":
                calls.append((s, s + d))
    if not calls:
        return {"busy_s": None}
    t0, t1 = min(s for s, _ in calls), max(e for _, e in calls)
    clipped = [(max(s, t0), min(e, t1), c, n) for s, e, c, n in dev if e > t0 and s < t1]
    busy = _union([(s, e) for s, e, _, _ in clipped])
    by_name: Dict[str, float] = {}
    kernel_s: Dict[str, List[float]] = {}  # a kernel's full name: [seconds, launches]
    for s, e, c, n in clipped:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s)
        if c == "kernel":
            k = kernel_s.setdefault(n, [0.0, 0])
            k[0] += e - s
            k[1] += 1
    kernels = sum(1 for _, _, c, _ in clipped if c == "kernel")
    # idle gaps: stretches of the traced span with no device operation,
    # named by the innermost host event (harness span / op) at their middle
    gaps, end = [], t0
    for s, e, _, _ in sorted(clipped):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    host.sort()
    gap_by: Dict[str, float] = {}
    active, nxt = [], 0
    for gs, ge in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (gs + ge)
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        spans = [h[2] for h in active
                 if h[2].startswith("portbench.") and h[2] != "portbench.call"]
        ops = [h for h in active if not h[2].startswith("portbench.")]
        op = min(ops, key=lambda h: h[1] - h[0])[2] if ops else "python"
        key = f"{spans[-1] if spans else 'portbench.call'}/{op}"[:120]
        gap_by[key] = gap_by.get(key, 0.0) + (ge - gs)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    top_gaps = sorted(gap_by.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    return {"busy_s": busy, "window_s": t1 - t0, "kernels": kernels, "units": units,
            "kernel_s": kernel_s,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in top_gaps]}


# --------------------------------------------------------------------------
# the run


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def measure_window(cell, seconds: float, trace: bool, traffic: dict, device: str):
    """Drive ``cell.call()`` until ``seconds`` have passed (and, with
    ``trace``, until the traced run of calls is complete)."""
    import torch

    skip = int(traffic.get("trace_skip_calls", 0))
    n_traced = int(traffic.get("trace_calls", 8))
    cuda = device.startswith("cuda")
    win = Window()
    prof, summary, summary_s = None, None, 0.0
    # the harness's own first uses (events, spans) before the window
    with torch.profiler.record_function("portbench.warm"):
        if cuda:
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            ev[1].record()
            ev[1].synchronize()
            ev[0].elapsed_time(ev[1])
    _sync(device)
    gc.collect()
    gc.freeze()
    t_start = time.perf_counter()
    i = 0
    while True:
        tracing = trace and skip <= i < skip + n_traced
        if trace and i == skip:
            from torch.profiler import ProfilerActivity, profile

            if hasattr(cell, "before_trace"):
                cell.before_trace()

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
        t0 = time.perf_counter()
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        cell.tracing = tracing
        with torch.profiler.record_function("portbench.call"):
            units = cell.call()
        if cuda:
            ev1.record()
            ev1.synchronize()
            ms = ev0.elapsed_time(ev1)
        else:
            ms = 1e3 * (time.perf_counter() - t0)
        win.call_s.append(time.perf_counter() - t0)
        win.ends.append(time.perf_counter() - t_start)
        win.latencies_ms.append(ms)
        win.traced.append(tracing)
        win.units.append(units)
        i += 1
        if prof is not None and i == skip + n_traced:
            t_summary = time.perf_counter()
            _sync(device)
            prof.__exit__(None, None, None)
            summary = summarize_trace(prof, sum(
                u.get(traffic.get("trace_unit", "steps"), 0.0)
                for u, t in zip(win.units, win.traced) if t))
            prof = None
            summary_s = time.perf_counter() - t_summary
        # a traced run's window holds ``seconds`` of calls without the
        # profiler besides the traced ones and the reading of the trace
        elapsed = time.perf_counter() - t_start - summary_s - sum(
            s for s, t in zip(win.call_s, win.traced) if t)
        if elapsed >= seconds and prof is None and (not trace or i >= skip + n_traced):
            break
    _sync(device)
    win.seconds = time.perf_counter() - t_start
    return win, summary


def _device_info(device: str) -> dict:
    if device.startswith("cuda"):
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: each number the cell's limits file names,
    beside its limit; one that is missing or not finite fails."""
    checks, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k)
        good = v is not None and math.isfinite(float(v)) and float(v) <= lim
        ok = ok and good
        checks[k] = {"value": None if v is None else float(v), "limit": lim}
    return ok, checks


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[dict] = None, system: str = "program",
             fault: Optional[str] = None, t_process: Optional[float] = None,
             bench: Optional[dict] = None) -> dict:
    """One run of cell ``name``: returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
    traced, ``checks`` last).

    ``overrides`` (``{"params": {...}, "traffic": {...}}``) shrink a cell for
    the CPU tests; ``system`` is ``"program"`` or ``"control"`` (the plain
    reference in the program's place, in the lower precision); ``fault``
    breaks the program underneath (``drivers`` name them)."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    t_enter = time.perf_counter()
    bench = bench or benchmark()
    w = workload(bench, name)
    cfg = load_json(config_file(w["config"]))
    traffic = load_json(traffic_file(w["traffic"], w["config"]))
    limits = load_json(limits_file(name))
    overrides = overrides or {}
    cfg = {**cfg, "params": {**cfg["params"], **overrides.get("params", {})}}
    traffic = {**traffic, **overrides.get("traffic", {})}
    if device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    cell = driver(traffic["driver"]).Cell(cfg, traffic, seed, device, system=system,
                                          fault=fault)
    t_cell = time.perf_counter()
    cell.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_process
    setup_parts = {"imports_s": t_enter - t_process, "card_s": t_cell - t_enter,
                   "cell_s": time.perf_counter() - t_cell}
    win, summary = measure_window(cell, seconds, trace, traffic, device)
    dev = _device_info(device)
    t_read = time.perf_counter()
    run = Run(name, cfg, traffic, cell, win, setup_s, device, summary)
    e2e, layer = cell_metrics(bench, name)
    metrics = {}
    wanted = layer if trace else e2e
    for m in wanted:
        value = load_module(metric_file(m["name"]), f"portbench_metric_{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cell.release()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = cell.check()
    correct, checks = judge(numbers, limits)
    lat = win.latencies_ms
    result = {"correct": correct, "attempted": len(lat), "failed": 0,
              "metrics": metrics, "device": dev,
              "run": {"first_call_ms": lat[0], "median_call_ms": statistics.median(lat),
                      "max_call_ms": max(lat), "window_s": win.seconds,
                      "steps_per_s_by_5s": win.buckets(),
                      "setup": setup_parts, "readers_s": t_check - t_read,
                      "check_s": time.perf_counter() - t_check,
                      "numbers": numbers}}
    if trace and summary is not None and summary.get("busy_s"):
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        top = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
        result["run"]["kernel_launches"] = [[n[:80], c] for n, (_, c) in top]
    result["checks"] = checks
    return result
