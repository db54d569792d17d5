"""The metric arithmetic: union idle share, span attribution, roofline
work for known shapes, whole-cycle rates."""

import pytest
import torch

from qrwbench import harness, trace, work


class Ev:
    def __init__(self, name, s, e, cuda, annot=False):
        self._n, self._s, self._e, self._c, self._a = name, s, e, cuda, annot

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._a


def test_union_not_sum():
    iv = [(0, 10), (5, 15), (20, 30), (22, 25)]
    assert trace.union_seconds(iv) == pytest.approx(25e-9)
    assert sum(e - s for s, e in iv) == 33


def test_idle_gaps():
    assert trace.idle_gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == \
        [(0, 2), (6, 8), (9, 10)]


def test_trace_assigns_kernels_to_spans_and_reads_idle():
    ev = [Ev("span:mpc", 100, 200, False), Ev("span:k1", 120, 180, False),
          Ev("span:k1", 120, 180, True, annot=True),
          Ev("k1_kernel", 130, 170, True), Ev("glue", 185, 195, True),
          Ev("other", 210, 250, True)]
    tr = trace.Trace(ev, 300e-9, 1, 10, {}, {"k_mpc": 10})
    assert tr.n_kernels == 3
    assert tr.kernel_s("k1") == pytest.approx(40e-9)
    assert tr.kernel_s("mpc") == pytest.approx(50e-9)
    assert tr.busy_s == pytest.approx(90e-9)
    bd = tr.breakdown(0, 300)
    # a gap goes to the innermost span that holds its midpoint:
    # (0, 130) and (195, 210) and (250, 300) outside, (170, 185) in k1
    gaps = dict(bd["idle_gaps"])
    assert gaps["outside_spans"] == pytest.approx((130 + 15 + 50) * 1e-9)
    assert gaps["k1"] == pytest.approx(15e-9)
    assert "mpc" not in gaps


def test_idle_share_reader():
    read = harness.load_reader("metrics", "device_idle_frac.fleet")
    ev = [Ev("a", 0, 25, True), Ev("b", 10, 50, True)]
    tr = trace.Trace(ev, 200e-9, 2, 20, {}, {"k_mpc": 10})
    assert read(tr) == pytest.approx(0.75)
    assert read(trace.Trace([], 1.0, 1, 1, {}, {})) is None


def test_k1_work_known_shape():
    # cap 32: n = 96, m = 160; one tile of 4 problems that all converged
    # by iteration 100 with stop_at_eps, one tile that did not
    cap, n, m = 32, 96, 160
    hx = 24 * cap * cap + 63 * cap + 2 * n
    per_it = 12 * m + 13 * cap + 5 * n + 2 * n * n + hx
    per_check = hx + 7 * cap + 6 * m + 6 * n
    iters = [100, 75, 100, 50, 25, 300, 300, 300]
    conv = [True] * 4 + [True, False, True, True]
    fl, nb = work.k1_work(8, cap, 16, 4, iters, conv, 300, True)
    total = 4 * 100 + 4 * 300
    assert fl == pytest.approx(total * per_it + (total / 25 + 8) * per_check)
    fl_off, nb_off = work.k1_work(8, cap, 16, 4, iters, conv, 300, False)
    total = 8 * 300
    assert fl_off == pytest.approx(total * per_it
                                   + (total / 25 + 8) * per_check)
    assert nb == nb_off > 0


def test_k1_work_matches_the_bring_up_count():
    import chip_smoke
    it = torch.tensor([100, 75, 100, 50, 25, 300, 300, 300])
    cv = torch.tensor([True] * 5 + [False, True, True])
    assert work.k1_work(8, 48, 40, 4, it.tolist(), cv.tolist(), 300, True) \
        == pytest.approx(chip_smoke.k1_work(8, 48, 40, 4, it, cv))


def test_k2_k3_work_match_the_bring_up_count():
    import chip_smoke
    from qrw_tpu_torch.ops import qp
    cone = qp.ConeStructure(16, 0.9)
    assert work.k2_cone_work(4096, 192, 512, 50, 64, True) == \
        pytest.approx(chip_smoke.k2_cone_work(4096, 192, 512, 50, cone))
    rcone = qp.ReducedConeStructure(48, 0.9)
    assert work.k2_cone_work(32, 144, 240, 50, 48, False, True) == \
        pytest.approx(chip_smoke.k2_cone_work(32, 144, 240, 50, rcone,
                                              k_ref=True))
    assert work.k3_work(4096, 192, 3) == chip_smoke.k3_work(4096, 192, 3)


def test_roofline_bound_and_share():
    fl, nb = 67e12, 1e9            # one second of float32 operations
    assert work.bound_s(fl, nb) == pytest.approx(1.0)
    assert work.bound_s(fl, nb, tf32x3=True) == pytest.approx(3 * 67 / 495)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.roofline_pct(1.0, 4.0) == pytest.approx(25.0)
    assert work.roofline_pct(1.0, 0.0) is None


def test_whole_cycle_rates():
    cyc = [{"wall_s": 1.0, "ticks": 100, "solves": 10, "converged": 9.0},
           {"wall_s": 0.5, "ticks": 100, "solves": 10, "converged": 10.0}]
    win = harness.Window(cycles=cyc, setup_s=3.5)
    rd = lambda n: harness.load_reader("e2e", n)(win)  # noqa: E731
    tr = trace.Trace([], 1.0, 1, 1, {}, {})
    tr.window = win
    host = harness.load_reader("metrics", "robot_ticks_per_s.host")
    assert host(tr) == pytest.approx(200 / 1.5)
    assert rd("mpc_solves_per_s") == pytest.approx(20 / 1.5)
    assert rd("mpc_conv") == pytest.approx(0.95)
    assert rd("setup_s") == 3.5
    empty = harness.Window(cycles=[{"wall_s": 1.0, "ticks": 0, "solves": 0,
                                    "converged": 0.0}], setup_s=1.0)
    tr.window = empty
    assert host(tr) is None


def test_cycle_p95_over_every_cycle():
    """The 95th percentile of the untraced cycles' device times,
    interpolated between order statistics as numpy's default does."""
    p95 = harness.load_reader("metrics", "mpc_cycle_ms_p95")
    tr = trace.Trace([], 1.0, 1, 1, {}, {})
    assert p95(tr) is None
    ms = [float(v) for v in range(1, 101)]          # 1 .. 100 ms
    tr.window = harness.Window(cycles=[{"device_ms": v} for v in ms],
                               setup_s=1.0)
    assert p95(tr) == pytest.approx(95.05)
    tr.window = harness.Window(cycles=[{"device_ms": 4.0}], setup_s=1.0)
    assert p95(tr) == 4.0
    # a run without device times (the CPU) reports nothing
    tr.window = harness.Window(cycles=[{"wall_s": 1.0}], setup_s=1.0)
    assert p95(tr) is None
