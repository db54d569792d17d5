"""One run of one cell: set-up, warm-up, the measured window, the check.

The harness is driven by data. `BENCHMARK.json` names the cell's
configuration and traffic mix; the configuration is
`configs/<name>.json`, the traffic mix `traffic/<name>.json`, whose
`driver` key names the general driver in `drivers/` that generates its
inputs and drives the port. End-to-end metrics are read by
`e2e/<name>.py` and per-layer metrics by `metrics/<name>.py`, each a
`read` function that returns a number, or None where it finds nothing.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import time
from typing import NamedTuple

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
TRACED_CYCLES = 2          # the profiler covers the window's first cycles


class Check(NamedTuple):
    """One number compared: correct while value <= limit."""
    name: str
    value: float
    limit: float


class Window(NamedTuple):
    """What the end-to-end readers read."""
    cycles: list    # per-cycle dicts: wall_s, device_ms, ticks, solves,
                    # converged
    setup_s: float


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_reader(kind: str, name: str):
    """The `read` function of `<kind>/<name>.py`."""
    path = os.path.join(PKG, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"qrwbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def make_cell(bench: dict, workload: dict, seed: int, device,
              overrides=None, mark=lambda name: None):
    """The driver's cell object, its inputs built from the seed."""
    config = load_json(PKG, "configs", workload["config"] + ".json")
    traffic = load_json(PKG, "traffic", workload["traffic"] + ".json")
    traffic = {**traffic, **(overrides or {})}
    driver = importlib.import_module("qrwbench.drivers." + traffic["driver"])
    mark("port_s")
    return driver.Cell(config, traffic, seed, device)


def run_cell(bench: dict, workload: dict, seed: int, seconds: float,
             trace: bool, device, t0: float, overrides=None, marks=()):
    """One run: returns (result dict without `checks`, list of Check).
    `marks`: (stage, time) of the caller's set-up stages after t0."""
    import torch
    cuda = torch.device(device).type == "cuda"
    marks = [("", t0), *marks]

    def mark(name):
        marks.append((name, time.perf_counter()))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell = make_cell(bench, workload, seed, device, overrides, mark)
    sync()
    mark("inputs_s")
    cell.warm()
    sync()
    mark("warm_s")
    t_win = marks[-1][1]
    setup_s = t_win - t0
    # where set-up went, stage by stage
    split = {n: t - marks[i][1] for i, (n, t) in enumerate(marks[1:])}

    cycles, trace_obj, breakdown = [], None, None

    def timed():
        c0 = time.perf_counter()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            ev[0].record()
        out = cell.cycle()
        if cuda:
            ev[1].record()
        sync()
        out["wall_s"] = time.perf_counter() - c0
        if cuda:
            out["device_ms"] = ev[0].elapsed_time(ev[1])
        return out

    traced = []
    if trace:
        from qrwbench.trace import profile_cycles
        trace_obj, breakdown, traced = profile_cycles(
            cell.cycle, TRACED_CYCLES, cell.spans(), sync, cell.constants())
        for o in traced:
            o["wall_s"] = trace_obj.wall_s / TRACED_CYCLES
    # whole cycles that fit in the window, each ending in a synchronize;
    # a traced run keeps at least one untraced cycle after its profile
    while True:
        last = (cycles or traced)[-3:]
        if last and (cycles or not trace) and (
                time.perf_counter() - t_win
                + max(c["wall_s"] for c in last) > seconds):
            break
        cycles.append(timed())
    if trace:
        trace_obj.window = Window(cycles=cycles, setup_s=setup_s)
        cycles = traced + cycles
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    for c in cycles:
        c["converged"] = float(c["converged"])
    attempted, failed = cell.outcome()
    checks = cell.check(seed)
    cell.close()

    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if listed(m, workload["name"]):
                v = load_reader("metrics", m["name"])(trace_obj)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        win = Window(cycles=cycles, setup_s=setup_s)
        metrics = {}
        for m in bench["end_to_end"]:
            if listed(m, workload["name"]):
                v = load_reader("e2e", m["name"])(win)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": all(c.value <= c.limit for c in checks),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(cuda, workload["chips"], memory_peak),
    }
    device_ms = [c["device_ms"] for c in cycles if "device_ms" in c]
    result["window"] = {"cycles": len(cycles),
                        "seconds": sum(c["wall_s"] for c in cycles),
                        "cycle_ms_max": max(device_ms, default=None),
                        "setup": split}
    if trace:
        result["device"]["busy_s"] = trace_obj.busy_s
        result["device"]["window_s"] = trace_obj.wall_s
        result["breakdown"] = breakdown
    return result, checks


def device_info(cuda: bool, chips: int, memory_peak: int) -> dict:
    import torch
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": chips, "memory_peak_bytes": memory_peak}
