"""Tiny sizes of the cells, for the CPU tests."""

import time

from qrwbench import harness

TINY = {
    "hetero-fleet": {"batch": 12, "tile": 4, "sample_lanes": 12,
                     "sample_robots": 12, "schedule_cycles": 8},
    "trot-mpc-rolled": {"per_phase": 8, "sample_lanes": 64},
    "trot-fullsize-ns": {"batch": 16, "sample_lanes": 16},
}


def bench():
    return harness.load_json(harness.ROOT, "BENCHMARK.json")


def workload(name):
    return {w["name"]: w for w in bench()["workloads"]}[name]


def run_tiny(name, seed=7, seconds=0.5, trace=False, extra=None):
    """One run of the cell at its tiny size on the CPU."""
    torch_threads()
    return harness.run_cell(bench(), workload(name), seed, seconds, trace,
                            "cpu", time.perf_counter(),
                            overrides={**TINY[name], **(extra or {})})


def torch_threads():
    import torch
    torch.set_num_threads(1)
