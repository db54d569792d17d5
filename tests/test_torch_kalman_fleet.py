"""The trot fleet with the 18-state Kalman estimator against qrw_tpu.

As tests/test_torch_fleet.py, with cfg.kf_enabled: JAX builds the fleet
(B = 4, tile 1, seed 0) and its carry goes to the port through
qrw_tpu_torch.convert; both run 2 MPC cycles (20 ticks) in float32 with
the estimator in the loop (perfect_estimator=False), JAX through its
plain solver path (use_ref=True), the port through
ops/qp_phase.solve_plain, both without the rescue stage and with
stop_at_eps off (the one semantics both plain paths share). The Kalman
filter runs per robot on the lane-major foot kinematics the fleet
injects (est_fk).

Tolerance: tests/test_torch_fleet.py's: positions and quaternions 1e-5,
forces, torques and every leaf of the final carry (the Kalman state
included) 1e-3 of their scale, flags, iteration counts and phases
equal.
"""

import jax
import numpy as np
import pytest

from qrw_tpu.config import Config
from qrw_tpu.core import mpc_lane as jml
from qrw_tpu.sim import fleet as jfl
from qrw_tpu_torch import convert
from qrw_tpu_torch.core import mpc_lane as tml
from qrw_tpu_torch.sim import fleet as tfl
from tests.torch_threads import single_thread

single_thread()

CFG = Config(kf_enabled=True)
B = 4
N_CYCLES = 2


@pytest.fixture(scope="module")
def runs():
    jps = jml.build_phase_data(CFG, jml.trot_phase_fsteps(CFG))
    jctl, jcarry = jfl.make_fleet(CFG, B, jps, tile=1, seed=0)
    jout = jax.jit(lambda c: jfl.fleet_rollout(
        jctl, c, N_CYCLES, jps, tile=1, n_iters=300, rescue_cap=0,
        use_ref=True, interpret=True, stop_at_eps=False,
        perfect_estimator=False))(jcarry)
    jout = jax.tree.map(np.asarray, jout)
    tps = tml.build_phase_data(CFG, tml.trot_phase_fsteps(CFG),
                               device="cpu")
    tcarry = convert.to_torch(jax.tree.map(np.asarray, jcarry))
    tout = tfl.fleet_rollout(tfl.make_controller(CFG), tcarry, N_CYCLES,
                             tps, tile=1, n_iters=300, rescue_cap=0,
                             stop_at_eps=False, perfect_estimator=False)
    return tout, jout, jcarry


def _tol(w, rel):
    return rel * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("field,rel", [("base_pos", 1e-5),
                                       ("base_quat", 1e-5),
                                       ("f_mpc", 1e-3), ("tau_ff", 1e-3),
                                       ("error", 0)])
def test_kf_fleet_log_parity(runs, field, rel):
    (_, tlog, _), (_, jlog, _), _ = runs
    w = getattr(jlog, field)
    g = getattr(tlog, field).numpy()
    assert g.shape == w.shape == (N_CYCLES * CFG.k_mpc, B) + w.shape[2:]
    if rel == 0:
        np.testing.assert_array_equal(g, w)
        assert not w.any(), "no robot may latch its security stop"
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=_tol(w, rel))


def test_kf_fleet_cycle_log_parity(runs):
    (_, _, tcyc), (_, _, jcyc), _ = runs
    np.testing.assert_array_equal(tcyc.converged.numpy(), jcyc.converged)
    np.testing.assert_array_equal(tcyc.iters.numpy(), jcyc.iters)
    np.testing.assert_array_equal(tcyc.phase.numpy(), jcyc.phase)


def test_kf_fleet_final_carry_parity(runs):
    """Every leaf of the final carry to 1e-3 of its scale; the Kalman
    state moved from its initial value."""
    (tcarry, _, _), (jcarry, _, _), jcarry0 = runs
    got = convert.to_numpy(tcarry, like=jcarry)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jcarry)]
    for path, g, w in zip(paths, jax.tree_util.tree_leaves(got),
                          jax.tree_util.tree_leaves(jcarry)):
        assert g.shape == w.shape, path
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=_tol(w, 1e-3),
                                       err_msg=path)
    kf0 = np.asarray(jcarry0.ctl_states.estimator.kf.P)
    assert not np.allclose(jcarry.ctl_states.estimator.kf.P, kf0)
