"""The readers of the port's own spans and counters (qrw_tpu_torch/utils/
profiling): the arithmetic on a synthetic trace, and nothing read from
a program that has neither (the parent of the change that added them)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qrwbench import harness, trace
from qrwbench.tests.test_qrwbench_metrics import Ev
from qrw_tpu_torch.utils import profiling

SPAN_READERS = ("wbc_qp_ms_per_tick.fleet", "host_wait_ms_per_tick.fleet",
                "host_wait_ms_per_cycle.mpc")
COUNTER_READERS = ("wbc_qp_rounds_per_tick.fleet", "rescued_lanes_per_cycle",
                   "k1_iters_per_tile.fleet")


def _trace(events, cycles=2):
    return trace.Trace(events, 1.0, cycles, cycles * 10, {}, {"k_mpc": 10})


@pytest.fixture
def clean_counters():
    profiling.reset()
    yield
    profiling.reset()


def test_host_wait_is_the_union_of_the_sync_spans():
    ev = [Ev("span:wbc", 0, 5000, False),
          Ev("span:qrw.wbc.qp", 100, 4000, False),
          Ev("span:qrw.sync.wbc_qp_done", 200, 700, False),
          Ev("span:qrw.sync.wbc_qp_done", 1000, 1300, False),
          Ev("span:qrw.sync.rescue_any", 1200, 1400, False),
          Ev("span:qrw.wbc.qp.iterate", 700, 1000, False),
          Ev("k", 300, 650, True)]
    tr = _trace(ev)
    tick = harness.load_reader("metrics", "host_wait_ms_per_tick.fleet")
    cycle = harness.load_reader("metrics", "host_wait_ms_per_cycle.mpc")
    qp = harness.load_reader("metrics", "wbc_qp_ms_per_tick.fleet")
    wait_s = (500 + 400) * 1e-9            # (200, 700) and (1000, 1400)
    assert tick(tr) == pytest.approx(1e3 * wait_s / 20)
    assert cycle(tr) == pytest.approx(1e3 * wait_s / 2)
    assert qp(tr) == pytest.approx(1e3 * 3900e-9 / 20)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_nothing_without_the_port_spans(name):
    """The wrappers' spans alone (a program without its own spans)."""
    ev = [Ev("span:wbc", 0, 5000, False), Ev("span:rescue", 10, 20, False),
          Ev("k", 300, 650, True)]
    assert harness.load_reader("metrics", name)(_trace(ev)) is None


def test_counter_readers(clean_counters):
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("wbc.qp_rounds", 3)
        profiling.count("wbc.qp_rounds", 5)
        profiling.count("mpc.rescued", torch.tensor(4))
        profiling.count("mpc.rescued", 0)
        profiling.count("mpc.k1_tiles", 8)
        profiling.count("mpc.k1_tile_iters", torch.tensor(1000))
        profiling.count("mpc.k1_tile_iters", torch.tensor(200))
    tr = _trace([], cycles=2)
    rd = lambda n: harness.load_reader("metrics", n)(tr)  # noqa: E731
    assert rd("wbc_qp_rounds_per_tick.fleet") == pytest.approx(8 / 20)
    assert rd("rescued_lanes_per_cycle") == pytest.approx(4 / 2)
    assert rd("k1_iters_per_tile.fleet") == pytest.approx(1200 / 8)


def test_a_stage_that_ran_and_rescued_nothing_reads_zero(clean_counters):
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("mpc.rescued", 0)
    rd = harness.load_reader("metrics", "rescued_lanes_per_cycle")
    assert rd(_trace([])) == 0.0


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_counter_readers_read_nothing_without_counters(name, clean_counters,
                                                       monkeypatch):
    read = harness.load_reader("metrics", name)
    assert read(_trace([])) is None              # no profiled cycle
    monkeypatch.delattr(profiling, "counters")   # no counters at all
    assert read(_trace([])) is None
