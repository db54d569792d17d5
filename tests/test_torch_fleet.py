"""The slice as a whole: the closed-loop trot fleet against qrw_tpu.

JAX builds the fleet (B = 4, tile 1, seed 0) and its carry goes to the
port through qrw_tpu_torch.convert, so both packages start from the
same perturbed robots. Both run 2 MPC cycles (20 ticks) in float32:
JAX through its plain solver path (use_ref=True, interpret=True), the
port on the CPU through ops/qp_phase.solve_plain, both without the
rescue stage. stop_at_eps is off on both sides: the JAX plain path
exits per BATCH under stop_at_eps (qrw_tpu/ops/qp_phase.py:442-447)
while the port exits per tile, so only the full-budget solve has one
semantics on both sides.

The same two cycles run again with the complementary-filter estimator
in the loop (perfect_estimator=False, the CLI's default), from the same
converted carry: the `_real_estimator` cases.

Tolerance: float32 on both sides, same equations, different op order.
The closed loop (ADMM, WBC QP, stiff contact) keeps round-off from
growing over 20 ticks: measured 3e-8 m on base positions, 4e-4 N on the
consumed plan forces (of 21 N), 3e-5 N m on torques and 5e-5 of scale
on the final carry. Positions and quaternions are held to 1e-5, forces,
torques and the carry to 1e-3 of their scale, which still flags any
change of formula.
"""

import jax
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import mpc_lane as jml
from qrw_tpu.sim import fleet as jfl
from qrw_tpu_torch import convert
from qrw_tpu_torch.core import mpc_lane as tml
from qrw_tpu_torch.sim import fleet as tfl
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
B = 4
N_CYCLES = 2


def _run(perfect_estimator):
    jps = jml.build_phase_data(CFG, jml.trot_phase_fsteps(CFG))
    jctl, jcarry = jfl.make_fleet(CFG, B, jps, tile=1, seed=0)
    jout = jax.jit(lambda c: jfl.fleet_rollout(
        jctl, c, N_CYCLES, jps, tile=1, n_iters=300, rescue_cap=0,
        use_ref=True, interpret=True, stop_at_eps=False,
        perfect_estimator=perfect_estimator))(jcarry)
    jout = jax.tree.map(np.asarray, jout)

    tps = tml.build_phase_data(CFG, tml.trot_phase_fsteps(CFG),
                               device="cpu")
    tcarry = convert.to_torch(jax.tree.map(np.asarray, jcarry))
    tctl = tfl.make_controller(CFG)
    tout = tfl.fleet_rollout(tctl, tcarry, N_CYCLES, tps, tile=1,
                             n_iters=300, rescue_cap=0, stop_at_eps=False,
                             perfect_estimator=perfect_estimator)
    return tout, jout


@pytest.fixture(scope="module")
def runs():
    return _run(True)


@pytest.fixture(scope="module")
def runs_real():
    return _run(False)


def _scale_tol(w, rel):
    return rel * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("field,rel", [("base_pos", 1e-5),
                                       ("base_quat", 1e-5),
                                       ("f_mpc", 1e-3), ("tau_ff", 1e-3),
                                       ("error", 0)])
def test_fleet_log_parity(runs, field, rel):
    _check_log(runs, field, rel)


@pytest.mark.parametrize("field,rel", [("base_pos", 1e-5),
                                       ("base_quat", 1e-5),
                                       ("f_mpc", 1e-3), ("tau_ff", 1e-3),
                                       ("error", 0)])
def test_fleet_log_parity_real_estimator(runs_real, field, rel):
    _check_log(runs_real, field, rel)


def _check_log(runs, field, rel):
    (_, tlog, _), (_, jlog, _) = runs
    w = getattr(jlog, field)
    g = getattr(tlog, field).numpy()
    assert g.shape == w.shape == (N_CYCLES * CFG.k_mpc, B) + w.shape[2:]
    if rel == 0:
        np.testing.assert_array_equal(g, w)
        assert not w.any(), "no robot may latch its security stop"
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=_scale_tol(w, rel))


def test_fleet_cycle_log_parity(runs):
    _check_cycle_log(runs)


def test_fleet_cycle_log_parity_real_estimator(runs_real):
    _check_cycle_log(runs_real)


def _check_cycle_log(runs):
    (_, _, tcyc), (_, _, jcyc) = runs
    np.testing.assert_array_equal(tcyc.converged.numpy(), jcyc.converged)
    np.testing.assert_array_equal(tcyc.iters.numpy(), jcyc.iters)
    np.testing.assert_array_equal(tcyc.phase.numpy(), jcyc.phase)
    # the phase rotates p -> p - 1 every cycle
    ph = jcyc.phase[:, 0]
    assert ((ph[:-1] - ph[1:]) % CFG.n_steps == 1).all()


def test_fleet_final_carry_parity(runs):
    _check_carry(runs)


def test_fleet_final_carry_parity_real_estimator(runs, runs_real):
    """The estimator's own state is part of the carry; the real one
    drives a different loop from the perfect one."""
    _check_carry(runs_real)
    assert not np.array_equal(runs_real[1][0].sim_states.q,
                              runs[1][0].sim_states.q)


def _check_carry(runs):
    (tcarry, _, _), (jcarry, _, _) = runs
    got = convert.to_numpy(tcarry, like=jcarry)
    flat_g = jax.tree_util.tree_leaves(got)
    flat_w = jax.tree_util.tree_leaves(jcarry)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jcarry)]
    assert len(flat_g) == len(flat_w)
    for path, g, w in zip(paths, flat_g, flat_w):
        assert g.shape == w.shape, path
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=_scale_tol(w, 1e-3),
                                       err_msg=path)
