"""Each traffic mix's generator and driver at a tiny size on the CPU."""

import numpy as np
import pytest
import torch

from qrwbench import harness
from qrwbench.drivers import fullsize, phase_mpc
from qrwbench.tests.helpers import TINY, bench, run_tiny, torch_threads, \
    workload


@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_runs_and_is_correct(name):
    res, checks = run_tiny(name)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["window"]["cycles"] >= 1
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert all(c.value >= 0 for c in checks)


@pytest.mark.parametrize("name", sorted(TINY))
def test_same_seed_same_inputs_other_seed_other(name):
    torch_threads()
    cells = [harness.make_cell(bench(), workload(name), s, "cpu", TINY[name])
             for s in (5, 5, 2 ** 31 + 5)]
    try:
        if name == "hetero-fleet":
            q = [c.carry.sim_states.q for c in cells]
            assert [tuple(c.meta.velID) for c in cells[:2]] == \
                [tuple(cells[0].meta.velID)] * 2
            # the same set of profiles and terrains in every seed
            for c in cells:
                assert sorted(np.bincount(c.meta.velID)) == \
                    sorted(np.bincount(cells[0].meta.velID))
        else:
            q = [c.x0 for c in cells]
        assert torch.equal(q[0], q[1])
        assert not torch.equal(q[0], q[2])
    finally:
        for c in cells:
            c.close()


def test_phase_batch_matches_the_port():
    from qrw_tpu_torch.config import Config
    from qrw_tpu_torch.core import mpc_lane as ml
    cfg = Config()
    mine = phase_mpc.trot_phase_fsteps(cfg.n_steps, cfg.N_gait)
    np.testing.assert_array_equal(mine, ml.trot_phase_fsteps(cfg))
    xr, fs, _ = phase_mpc.phase_batch(cfg.n_steps, cfg.N_gait, [0, 3], 4,
                                      np.random.default_rng(0))
    assert xr.shape == (12, cfg.n_steps + 1, 8)
    assert fs.shape == (cfg.N_gait, 12, 8)
    np.testing.assert_array_equal(fs[:, :, 4], mine[3])


def test_build_batch_matches_the_port():
    from qrw_tpu_torch.config import Config
    from qrw_tpu_torch.eval.kernel_profile import build_batch
    cfg = Config()
    a = fullsize.build_batch(cfg.n_steps, cfg.N_gait, 8,
                             np.random.default_rng(3))
    b = build_batch(cfg, 8, np.random.default_rng(3))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(TINY))
def test_traced_run_reads_the_spans(name):
    res, _ = run_tiny(name, trace=True)
    per_layer = {m["name"] for m in bench()["per_layer"]
                 if name in m.get("workloads", [name])}
    assert set(res["metrics"]) <= per_layer
    # on the CPU no kernel runs: spans are read, device shares are not
    assert any(k.endswith(("_ms_per_tick.fleet", "_ms_per_cycle.mpc",
                           "_ms_per_cycle.fullsize", "_ms_per_cycle.fleet"))
               for k in res["metrics"])
    assert not any("roofline" in k or "idle" in k for k in res["metrics"])
    assert res["device"]["window_s"] > 0
    assert "device_ops" in res["breakdown"]


def test_fleet_schedule_grows_past_set_up():
    """A window that outlasts the velocity commands made in set-up gets
    more of them: the warm-up takes the one cycle planned."""
    res, checks = run_tiny("hetero-fleet", seconds=0.1,
                           extra={"schedule_cycles": 1})
    assert res["window"]["cycles"] >= 1 and res["correct"], checks


def test_fleet_check_spreads_its_robots_over_the_cycle():
    """The fleet's check samples each robot at one tick of the last
    cycle, and every tick of it has robots."""
    torch_threads()
    cell = harness.make_cell(bench(), workload("hetero-fleet"), 3, "cpu",
                             TINY["hetero-fleet"])
    try:
        cell.warm()
        cell.cycle()
        S = cell.sample(3)
    finally:
        cell.close()
    k = cell.k_mpc
    n = TINY["hetero-fleet"]["sample_robots"]
    assert S["next"].q.shape[0] == S["w_in"]["pos"].shape[0] == n
    assert len(cell.hooks.calls["physics"]) == k
