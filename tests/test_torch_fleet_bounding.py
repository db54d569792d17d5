"""Calibrated bounding in the heterogeneous fleet, against qrw_tpu.

On the card the port's heterogeneous fleet converges 0.9067 of its
calibrated bounding solves (chip_smoke.py 5b, PERF.md). This holds the
port's bounding tiles to qrw_tpu's on the same cell: a fleet of bounding
tiles only (tile 1, B = 6, velIDs 0-5 on flat and bumpy ground) built by
make_hetero_fleet in both packages with one calibration capture, the
port starting from qrw_tpu's carry converted, ten 50 Hz cycles (bench.py's
hetero cell: 100 ticks) of 300-iteration phase solves with stop_at_eps
and the rescue off, the real estimator. Converged flags and iteration
counts are equal per cycle and lane: on the CPU both packages converge
41 of the 60 solves, every robot failing the same cycles (the phases
that all six robots reach together, since they start in one phase).

The capture is seeded and synthetic: 200 bounding windows at random
offsets with their footholds scattered 1 cm around the nominal ones,
standing in for the 1,200-tick shakedown capture
(sim/fleet.hetero_shakedown_capture) the CLI records, which takes minutes
on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config as JConfig
from qrw_tpu.core import mpc_lane as jml
from qrw_tpu.sim import fleet as jfl
from qrw_tpu_torch import convert
from qrw_tpu_torch.config import Config
from qrw_tpu_torch.sim import fleet as tfl
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
JCFG = JConfig()
B = 6
CYCLES = 10


def _capture(seed=0, n=200):
    rng = np.random.default_rng(seed)
    bd = jml.gait_phase_fsteps(JCFG, "bounding")
    pick = bd[rng.integers(0, len(bd), n)]
    noise = rng.normal(scale=0.01, size=pick.shape).astype(np.float32)
    return np.where(pick != 0, pick + noise, 0.0).astype(np.float32)


KW = dict(gaits=("bounding",), velIDs=(0, 1, 2, 3, 4, 5),
          terrain_ids=(0, 1), seed=3, calibration={"bounding": _capture()})


@pytest.fixture(scope="module")
def runs():
    jctl, jcarry, jps, jter, meta = jfl.make_hetero_fleet(JCFG, B, tile=1,
                                                         **KW)
    tctl, _, tps, _, _ = tfl.make_hetero_fleet(CFG, B, tile=1, device="cpu",
                                               **KW)
    sched = np.array(jfl.hetero_v_ref_schedule(JCFG, meta.velID,
                                               CYCLES * JCFG.k_mpc))
    kw = dict(tile=1, rescue_cap=0, perfect_estimator=False,
              stop_at_eps=False, phase_offsets=meta.phase_offsets,
              phase_periods=meta.phase_periods, with_logs=False)
    _, _, jcyc = jax.jit(lambda c, s: jfl.fleet_rollout(
        jctl, c, CYCLES, jps, n_iters=300, terrain=jter, use_ref=True,
        interpret=True, v_ref_schedule=s, **kw))(jcarry, sched)
    tter = convert.to_torch(jax.tree.map(np.asarray, jter))
    tcarry = convert.to_torch(jax.tree.map(np.asarray, jcarry))
    _, _, tcyc = tfl.fleet_rollout(tctl, tcarry, CYCLES, tps, n_iters=300,
                                   terrain=tter,
                                   v_ref_schedule=torch.as_tensor(sched),
                                   **kw)
    return tcyc, jax.tree.map(np.asarray, jcyc), tps


def test_bounding_phase_set_is_calibrated(runs):
    """The calibration moved the bounding classes' footholds, and the
    fleet runs at cap 32 (bounding's 2-stance rows)."""
    *_, tps = runs
    nominal = jml.gait_phase_fsteps(JCFG, "bounding")
    got = jml.calibrate_phase_fsteps(JCFG, nominal,
                                     KW["calibration"]["bounding"])
    assert tps.cap == 32
    assert np.abs(got - nominal).max() > 0.001


@pytest.mark.parametrize("field", ["converged", "iters", "phase"])
def test_bounding_convergence_equal(runs, field):
    tcyc, jcyc, _ = runs
    w = getattr(jcyc, field)
    assert w.shape[0] == CYCLES
    np.testing.assert_array_equal(getattr(tcyc, field).numpy(), w)
    if field == "converged":    # passing and failing solves alike
        assert 0 < w.sum() < w.size, w
