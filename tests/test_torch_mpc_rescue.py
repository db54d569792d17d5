"""Parity of the port's rescue stage with qrw_tpu: core/mpc's
recover_dx and support-reduced batched solver, and core/mpc_lane's
rescue of failed lanes (solve_mpc_batch_phase with rescue_cap > 0).

The JAX side reaches its Pallas kernel in interpret mode (as
tests/test_mpc_lane.py:251-285 does); the port's side runs on CPU
tensors, i.e. the kernels' plain versions. Inputs are made with numpy
from a seed. Tolerances follow tests/test_torch_qp_pallas.py: float32
ADMM through a K^-1 of condition ~1e7 keeps the two packages' forces
within ~1e-5 of their scale (held to 1e-4 of it); converged flags and
iteration counts are equal; the adapted rho is set by primal residuals
at the float32 round-off floor and is held within a factor 2 where an
adaptation ran, equal where none did.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import mpc as jmpc
from qrw_tpu.core import mpc_lane as jml
from qrw_tpu.ops import qp as jqp
from qrw_tpu_torch import convert
from qrw_tpu_torch.core import mpc as tmpc
from qrw_tpu_torch.core import mpc_lane as tml
from qrw_tpu_torch.ops import qp as tqp
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
N = CFG.n_steps
CAP = 2 * N
JST = jqp.QPSettings(sigma=CFG.osqp_sigma, alpha=CFG.osqp_alpha,
                     rho=CFG.osqp_rho, eps_abs=1e-4, eps_rel=1e-4,
                     max_iter=450, adaptive_rho_interval=200)
TST = tqp.QPSettings(*JST)


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, rel=1e-4, name=""):
    w = np.asarray(want)
    np.testing.assert_allclose(_np(got), w, rtol=0,
                               atol=rel * max(1.0, np.abs(w).max()),
                               err_msg=name)


def _lane_batch(phases, per_phase, seed=0, vmax=0.3):
    """The phase-sorted trot batch of tests/test_mpc_lane.py:
    xrefs (12, N+1, B), fsteps (N_gait, 12, B)."""
    rng = np.random.default_rng(seed)
    phase_fs = jml.trot_phase_fsteps(CFG)
    B = len(phases) * per_phase
    xrefs = np.zeros((12, N + 1, B), np.float32)
    xrefs[2] = CFG.h_ref
    xrefs[:, 0, :] += rng.normal(scale=0.02, size=(12, B)).astype(np.float32)
    xrefs[6, 1:, :] = rng.uniform(0, vmax, B).astype(np.float32)
    fsteps = np.zeros((CFG.N_gait, 12, B), np.float32)
    for i, p in enumerate(phases):
        fsteps[:, :, i * per_phase:(i + 1) * per_phase] = \
            phase_fs[p][:, :, None]
    return xrefs, fsteps, phase_fs


@pytest.mark.parametrize("batched", [False, True])
def test_recover_dx_parity(batched):
    """dx = G x + h by prefix sums, float64: round-off only."""
    rng = np.random.default_rng(0)
    lead = (3,) if batched else ()
    Bl = rng.normal(size=lead + (N, 6, 12))
    x = rng.normal(size=lead + (12 * N,))
    h = rng.normal(size=lead + (12 * N,))
    fn = lambda b, xx, hh: jmpc.recover_dx(CFG, b, xx, hh)
    if batched:
        fn = jax.vmap(fn)
    want = fn(jnp.asarray(Bl), jnp.asarray(x), jnp.asarray(h))
    got = tmpc.recover_dx(CFG, torch.as_tensor(Bl), torch.as_tensor(x),
                          torch.as_tensor(h))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-12)


@pytest.fixture(scope="module")
def reduced_runs():
    """A cold batched solve and a warm, shifted one on the next cycle's
    problems, in both packages; the port's warm call starts from the
    JAX cold state."""
    xrefs, fsteps, phase_fs = _lane_batch([0, 3, 9], 1, seed=2, vmax=0.5)
    xb = np.ascontiguousarray(xrefs.transpose(2, 0, 1))
    fb = np.ascontiguousarray(fsteps.transpose(2, 0, 1))
    jcold = jmpc.solve_mpc_batch_reduced(
        CFG, jnp.asarray(xb), jnp.asarray(fb), settings=JST, tile=3,
        interpret=True)
    tcold = tmpc.solve_mpc_batch_reduced(
        CFG, torch.as_tensor(xb), torch.as_tensor(fb), settings=TST)
    fb2 = np.stack([phase_fs[(p - 1) % N] for p in (0, 3, 9)])
    xb2 = xb.copy()
    xb2[:, :, 0] += 0.002
    jwarm = jmpc.solve_mpc_batch_reduced(
        CFG, jnp.asarray(xb2), jnp.asarray(fb2), state=jcold[1],
        settings=JST, tile=3, shift=True, interpret=True)
    st = convert.to_torch(jax.tree.map(np.asarray, jcold[1]))
    twarm = tmpc.solve_mpc_batch_reduced(
        CFG, torch.as_tensor(xb2), torch.as_tensor(fb2), state=st,
        settings=TST, shift=True)
    return (tcold, jax.tree.map(np.asarray, jcold)), \
        (twarm, jax.tree.map(np.asarray, jwarm))


@pytest.mark.parametrize("which", ["cold", "warm-shift"])
def test_solve_mpc_batch_reduced_parity(reduced_runs, which):
    """Predicted states and forces, the full-layout carry, the flags and
    iteration counts. The warm call converges in its one default round,
    so its rho is the carried one, exactly."""
    (tx, tst, tsol, tok), (jx, jst, jsol, jok) = \
        reduced_runs[0 if which == "cold" else 1]
    assert tx.shape == jx.shape == (3, 24, N)
    np.testing.assert_array_equal(_np(tok), jok)
    np.testing.assert_array_equal(_np(tsol.converged), jsol.converged)
    np.testing.assert_array_equal(_np(tsol.iters), jsol.iters)
    assert jsol.converged.all()
    _close(tx, jx, name="x_f")
    _close(tst.f, jst.f, name="f")
    _close(tst.y, jst.y, name="y")
    if which == "cold":
        ratio = _np(tst.rho) / jst.rho
        assert (ratio > 0.5).all() and (ratio < 2.0).all(), ratio
    else:
        np.testing.assert_array_equal(jsol.iters, 50)
        np.testing.assert_array_equal(_np(tst.rho), jst.rho)


def _phase_solve_both(xrefs, fsteps, phase, tile, rescue_cap):
    jps = jml.build_phase_data(CFG, jml.trot_phase_fsteps(CFG))
    tps = tml.build_phase_data(CFG, tml.trot_phase_fsteps(CFG),
                               device="cpu")
    want = jax.jit(lambda: jml.solve_mpc_batch_phase(
        CFG, jnp.asarray(xrefs), jnp.asarray(fsteps), jps,
        np.array([phase]), n_iters=1, tile=tile, interpret=True,
        rescue_cap=rescue_cap))()
    got = tml.solve_mpc_batch_phase(
        CFG, torch.as_tensor(xrefs), torch.as_tensor(fsteps), tps,
        np.array([phase]), n_iters=1, tile=tile, rescue_cap=rescue_cap)
    return got, jax.tree.map(np.asarray, want)


def test_rescue_recovers_failed_lanes():
    """A budget-starved phase solve (1 iteration: nothing converges)
    comes back fully converged through the rescue, with the JAX
    package's forces, duals and adapted rescue rho (cold rescue: rho
    adapts, so within a factor 2)."""
    xrefs, fsteps, _ = _lane_batch([3], 2)
    (tx, tst, tsol), (jx, jst, jsol) = _phase_solve_both(xrefs, fsteps, 3,
                                                         2, 2)
    assert jsol.converged.all(), "rescue did not fire in the JAX package"
    np.testing.assert_array_equal(_np(tsol.converged), jsol.converged)
    assert int(tsol.rescued) == 2
    _close(tx, jx, name="x_f")
    _close(tst.f, jst.f, name="f")
    _close(tst.y, jst.y, name="y")
    ratio = _np(tst.rrho) / jst.rrho
    assert (ratio > 0.5).all() and (ratio < 2.0).all(), ratio


def test_rescue_respects_capacity():
    """Four failures, capacity two: exactly the first two lanes of the
    stable rank order are rescued, the rest ship the stale plan."""
    xrefs, fsteps, _ = _lane_batch([5], 4)
    (tx, tst, tsol), (jx, jst, jsol) = _phase_solve_both(xrefs, fsteps, 5,
                                                         4, 2)
    assert jsol.converged.sum() == 2, jsol.converged
    np.testing.assert_array_equal(_np(tsol.converged), jsol.converged)
    assert int(tsol.rescued) == 2
    _close(tst.f, jst.f, name="f")
    # the lanes the rescue did not reach keep the default rescue rho
    np.testing.assert_array_equal(_np(tst.rrho)[~jsol.converged],
                                  jst.rrho[~jsol.converged])
