"""The DDP cell `ddp-trot-rolled` at a tiny size on the CPU: it runs and
is correct, its inputs follow the seed, the control and three planted
faults come out not correct, and its six per-layer readers read a
synthetic trace and nothing where their span or counter is missing."""

import json
import subprocess
import sys
import time

import pytest
import torch
from _pytest.monkeypatch import MonkeyPatch
from torch.profiler import ProfilerActivity, profile

from qrwbench import control, harness, trace
from qrwbench.tests.helpers import bench, torch_threads, workload
from qrwbench.tests.test_qrwbench_metrics import Ev
from qrw_tpu_torch.utils import profiling

CELL = "ddp-trot-rolled"
TINY = {"per_phase": 2, "sample_lanes": 16}
SPAN_READERS = {"ddp_derivs_ms_per_cycle.ddp": "qrw.ilqr.derivs",
                "ddp_backward_ms_per_cycle.ddp": "qrw.ilqr.backward",
                "ddp_linesearch_ms_per_cycle.ddp": "qrw.ilqr.linesearch"}
READERS = (*SPAN_READERS, "launches_per_cycle.ddp", "device_idle_frac.ddp",
           "ddp_accept_frac.ddp")


def run_tiny(seed=7, seconds=0.3, trace_on=False):
    torch_threads()
    return harness.run_cell(bench(), workload(CELL), seed, seconds, trace_on,
                            "cpu", time.perf_counter(), overrides=TINY)


def test_the_benchmark_lists_the_cell_and_its_readers():
    b = bench()
    assert workload(CELL)["chips"] == 1
    listed = [m["name"] for m in b["per_layer"]
              if CELL in m.get("workloads", ())]
    assert sorted(listed) == sorted(READERS)
    e2e = [m["name"] for m in b["end_to_end"] if harness.listed(m, CELL)]
    assert sorted(e2e) == ["mpc_solves_per_s", "setup_s"]


def test_cell_runs_and_is_correct():
    res, checks = run_tiny()
    assert res["correct"], checks
    assert res["attempted"] == 32 and res["failed"] == 0
    assert res["window"]["cycles"] >= 1
    assert set(res["metrics"]) == {"mpc_solves_per_s", "setup_s"}
    assert [c.name for c in checks] == [
        "ddp_rollout_gap", "ddp_cost_gap", "ddp_progress_gap_p50",
        "ddp_progress_gap_p95"]
    assert all(c.value >= 0 for c in checks)


def test_a_traced_run_reads_the_port_spans_and_counters():
    """On the CPU the device's readers find no kernel and read nothing."""
    profiling.reset()
    try:
        res, checks = run_tiny(trace_on=True)
    finally:
        profiling.reset()
    assert res["correct"], checks
    got = set(res["metrics"])
    assert got == set(SPAN_READERS) | {"ddp_accept_frac.ddp"}
    assert 0.0 < res["metrics"]["ddp_accept_frac.ddp"]["value"] <= 1.0


def test_same_seed_same_inputs_other_seed_other():
    torch_threads()
    cells = [harness.make_cell(bench(), workload(CELL), s, "cpu", TINY)
             for s in (5, 5, 2 ** 31 + 5)]
    try:
        q = [c.x0 for c in cells]
        assert torch.equal(q[0], q[1])
        assert not torch.equal(q[0], q[2])
        assert torch.equal(cells[0].state.us, cells[1].state.us)
        cells[0].cycle()
        cells[1].cycle()
        a, b = (c.hooks.latest("ddp")[0][1] for c in cells[:2])
        assert torch.equal(a, b)
    finally:
        for c in cells:
            c.close()


def test_control_is_not_correct():
    torch_threads()
    got = control.readings(bench(), workload(CELL), 11, 1, "cpu", TINY)
    lim = got["limits"]
    assert all(got["program"][k] <= v for k, v in lim.items()), got
    assert any(got["control"][k] > v for k, v in lim.items()), got


def answer_altered(mp):
    """The iLQR's controls altered where they are produced."""
    from qrw_tpu_torch.ops import ilqr
    orig = ilqr.solve

    def bad(*a, **k):
        res = orig(*a, **k)
        return res._replace(us=res.us + 0.5)
    mp.setattr(ilqr, "solve", bad)


def half_at_warm_start(mp):
    """Half of the batch left at its warm start: its rollout, controls and
    cost, as a solve whose every step is rejected gives them."""
    from qrw_tpu_torch.ops import ilqr
    orig = ilqr.solve

    def bad(*a, settings, **k):
        res = orig(*a, settings=settings, **k)
        none = orig(*a, settings=settings._replace(
            max_iters=1, alphas=(float("inf"),)), **k)
        h = res.us.shape[0] // 2
        return res._replace(**{f: torch.cat([getattr(res, f)[:h],
                                             getattr(none, f)[h:]])
                               for f in ("xs", "us", "cost")})
    mp.setattr(ilqr, "solve", bad)


def three_iterations(mp):
    """The solve cut to 3 of its 10 iterations."""
    from qrw_tpu_torch.core import mpc_ddp
    orig = mpc_ddp.solve_mpc_ddp

    def bad(cfg, xref, fsteps, state=None, settings=mpc_ddp.DDPSettings(),
            **k):
        return orig(cfg, xref, fsteps, state,
                    settings._replace(max_iters=3), **k)
    mp.setattr(mpc_ddp, "solve_mpc_ddp", bad)


@pytest.mark.parametrize("fault", [answer_altered, half_at_warm_start,
                                   three_iterations],
                         ids=lambda f: f.__name__)
def test_a_planted_fault_is_not_correct(fault):
    mp = MonkeyPatch()
    try:
        fault(mp)
        res, checks = run_tiny()
    finally:
        mp.undo()
    assert not res["correct"], checks


def _trace(events, cycles=2):
    return trace.Trace(events, 1.0, cycles, 0, {}, {})


@pytest.fixture
def clean_counters():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("name", READERS)
def test_readers_on_a_synthetic_trace(name, clean_counters):
    ev = [Ev("span:qrw.ddp", 0, 9000, False),
          Ev("span:qrw.ilqr", 100, 8000, False),
          Ev("span:qrw.ilqr.derivs", 200, 1200, False),
          Ev("span:qrw.ilqr.derivs", 3000, 3500, False),
          Ev("span:qrw.ilqr.backward", 1200, 2000, False),
          Ev("span:qrw.ilqr.linesearch", 2000, 2600, False),
          Ev("k1", 300, 700, True), Ev("k2", 500, 900, True),
          Ev("k3", 2100, 2200, True)]
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("ilqr.problems", 40)
        profiling.count("ilqr.accepted", torch.tensor(30))
    read = harness.load_reader("metrics", name)
    want = {"ddp_derivs_ms_per_cycle.ddp": 1e3 * 1500e-9 / 2,
            "ddp_backward_ms_per_cycle.ddp": 1e3 * 800e-9 / 2,
            "ddp_linesearch_ms_per_cycle.ddp": 1e3 * 600e-9 / 2,
            "launches_per_cycle.ddp": 3 / 2,
            "device_idle_frac.ddp": 1.0 - 700e-9 / 1.0,
            "ddp_accept_frac.ddp": 30 / 40}[name]
    assert read(_trace(ev)) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_their_source(name, clean_counters,
                                                   monkeypatch):
    """No port span, no kernel and no counter: a program without them
    (the parent of the change that added them)."""
    read = harness.load_reader("metrics", name)
    ev = [Ev("span:ddp", 0, 5000, False), Ev("span:window", 0, 9000, False)]
    assert read(_trace(ev)) is None
    monkeypatch.delattr(profiling, "counters")
    assert read(_trace(ev)) is None


def test_a_run_loads_no_jax():
    code = ("import json, sys\n"
            "from qrwbench.tests.test_qrwbench_ddp import run_tiny\n"
            "from qrwbench.run import forbidden_modules\n"
            "run_tiny(seconds=0.1)\n"
            "import qrwbench.reference.ddp_mpc\n"
            "print(json.dumps({'bad': forbidden_modules(),\n"
            "    'port': 'qrw_tpu_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "port": True}
