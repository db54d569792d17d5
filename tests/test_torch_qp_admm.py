"""Parity of the port's per-problem ADMM (ops/qp.solve) and dense MPC
(core/mpc.build_qp, solve_mpc) with qrw_tpu's, in float64.

qrw_tpu batches the per-problem solver with jax.vmap, so each problem
runs its own while_loop; the port runs one loop over the batch while
any problem is active, freezing the converged ones. The cases hold the
two equal where that matters:
  * MPC problems (n = 192, m = 512, the cone structure) whose lanes
    converge at different checks, cold and warm-started;
  * lanes that run past an adaptive-rho check, so that some refactor
    and others do not, against the same batch with adaptation off;
  * the WBC's box QP (n = 12, a shared dense A) and a per-problem A,
    with two leading batch axes;
  * no Ruiz scaling.
Converged flags and iteration counts must be equal on every lane. The
solutions agree to round-off: x, y, z and the residuals are held to
1e-8 of their scale (measured: 4e-12 on the MPC plans), rho-dependent
quantities included.

One case runs in float32, the controller's precision: the bounding
gait's 16 phases, cold. There the MPC's K^-1 must be formed as qrw_tpu
forms it at n = 192 (two triangular solves against the identity): W'W
with W = L^-1 squares the factor's conditioning, and 7 of the 16
problems then stall at max_iter where qrw_tpu converges in 225-450
iterations. Every lane must converge in both packages, each within 150
iterations (6 checks) of qrw_tpu's count (measured: 100 at most, the
round-off of two float32 operation orders moving a residual across its
tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import mpc as jm
from qrw_tpu.core import mpc_lane as jml
from qrw_tpu.core import wbc as jw
from qrw_tpu.ops import qp as jqp
from qrw_tpu_torch.core import mpc as tm
from qrw_tpu_torch.ops import qp as tqp
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
REL = 1e-8
PHASES = (0, 3, 7, 11)


def _mpc_inputs(seed, vmax=1.0):
    """Four trot MPC problems (one phase each) from seeded states and
    forward velocities."""
    rng = np.random.default_rng(seed)
    B = len(PHASES)
    fs = np.stack([jml.trot_phase_fsteps(CFG)[p] for p in PHASES])
    xr = np.zeros((B, 12, CFG.n_steps + 1))
    xr[:, 2] = CFG.h_ref
    xr[:, :, 0] += rng.normal(scale=0.01, size=(B, 12))
    xr[:, 6, 1:] = rng.uniform(0, vmax, size=(B, 1))
    return xr, fs


def _scale_close(got, want, name):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * max(1.0, np.abs(want).max()),
                               err_msg=name)


def _same_solution(got, want):
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    for f in ("x", "y", "z", "pri_res", "dua_res"):
        _scale_close(getattr(got, f), getattr(want, f), f)


def _mpc_qp(xr, fs):
    H, q, l, u, _, _ = tm.build_qp(CFG, torch.as_tensor(xr),
                                   torch.as_tensor(fs))
    A = torch.as_tensor(jm.cone_matrix(CFG.n_steps, CFG.mu))
    return H, q, A, l, u


@pytest.fixture(scope="module")
def mpc_runs():
    """Cold MPC solves, then warm solves from their solution on states
    moved by 1 mm, through solve_mpc in both packages."""
    xr, fs = _mpc_inputs(0)
    jsolve = jax.jit(jax.vmap(lambda x, f, st: jm.solve_mpc(CFG, x, f, st)))
    zero = jm.MPCState(f=jnp.zeros((len(PHASES), 12 * CFG.n_steps)),
                       y=jnp.zeros((len(PHASES), 32 * CFG.n_steps)))
    jcold = jax.tree.map(np.asarray, jsolve(jnp.asarray(xr), jnp.asarray(fs),
                                           zero))
    tcold = tm.solve_mpc(CFG, torch.as_tensor(xr), torch.as_tensor(fs))
    xr2 = xr + 1e-3
    jwarm = jax.tree.map(np.asarray, jsolve(jnp.asarray(xr2),
                                           jnp.asarray(fs), jcold.state))
    twarm = tm.solve_mpc(CFG, torch.as_tensor(xr2), torch.as_tensor(fs),
                         tm.MPCState(torch.as_tensor(jcold.state.f),
                                     torch.as_tensor(jcold.state.y)))
    return {"cold": (tcold, jcold), "warm": (twarm, jwarm)}


def test_build_qp_parity():
    xr, fs = _mpc_inputs(1)
    got = tm.build_qp(CFG, torch.as_tensor(xr), torch.as_tensor(fs))
    for b in range(len(PHASES)):
        want = jm.build_qp(CFG, jnp.asarray(xr[b]), jnp.asarray(fs[b]))
        for name, g, w in zip(("H", "qlin", "l", "u", "G", "h"), got, want):
            w = np.asarray(w)
            fin = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g[b].numpy()), fin,
                                          err_msg=name)
            np.testing.assert_allclose(g[b].numpy()[fin], w[fin], rtol=0,
                                       atol=1e-12 * max(1.0, np.abs(
                                           w[fin]).max()), err_msg=name)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_solve_mpc_parity(mpc_runs, start):
    got, want = mpc_runs[start]
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    np.testing.assert_array_equal(got.iters.numpy(), want.iters)
    assert want.converged.all()
    if start == "cold":     # the lanes converge at different checks
        assert len(set(want.iters.tolist())) > 1, want.iters
    _scale_close(got.x_f_applied, want.x_f_applied, "x_f_applied")
    _scale_close(got.state.f, want.state.f, "f")
    _scale_close(got.state.y, want.state.y, "y")


@pytest.mark.parametrize("interval", [100, 200, 100000])
def test_adaptive_rho_lanes(interval):
    """Every `interval` iterations, the active lanes whose residual
    ratio lies outside [1/5, 5] refactor at a new rho; converged lanes
    and the others keep theirs. The lanes converge at different checks,
    so at the later checks some lanes are frozen while others adapt.
    With the interval out of reach nothing adapts, and no lane converges
    within max_iter (so the refactors above did happen)."""
    xr, fs = _mpc_inputs(2, vmax=1.5)
    H, q, A, l, u = _mpc_qp(xr, fs)
    s = tm.mpc_settings(CFG)._replace(adaptive_rho_interval=interval)
    cone = tqp.ConeStructure(CFG.n_steps, CFG.mu)
    got = tqp.solve(H, q, A, l, u, s, cone=cone)
    jcone = jqp.ConeStructure(CFG.n_steps, CFG.mu)
    want = jax.jit(jax.vmap(lambda *a: jqp.solve(
        *a, settings=s, cone=jcone), in_axes=(0, 0, None, 0, 0)))(
        *[jnp.asarray(t.numpy()) for t in (H, q, A, l, u)])
    _same_solution(got, want)
    iters = np.asarray(want.iters)
    if interval > CFG.mpc_max_iter:
        assert not np.asarray(want.converged).any()
        assert (iters == CFG.mpc_max_iter).all()
    else:
        assert np.asarray(want.converged).all()
        assert len(set(iters.tolist())) > 1 and iters.max() > interval, \
            iters


def _box_qps(batch, seed, shared_A=True):
    """WBC-shaped box QPs: H = A'A q1 + q2 I, friction rows of f + df in
    [0, fz_max] around seeded contact forces."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=batch + (6, 12))
    H = 0.1 * np.swapaxes(X, -1, -2) @ X + 5.0 * np.eye(12)
    g = rng.normal(size=batch + (12,))
    G = jw.friction_generators(CFG.mu)
    if not shared_A:
        G = G * rng.uniform(0.5, 1.5, size=batch + (20, 1))
    f = np.abs(rng.normal(scale=5.0, size=batch + (12,)))
    Gf = (G @ f[..., None])[..., 0] if not shared_A else f @ G.T
    return H, g, G, -Gf, -Gf + CFG.fz_max


@pytest.mark.parametrize("shared_A", [True, False])
def test_dense_path_two_batch_axes(shared_A):
    """The non-cone path (the WBC's QP) with batch axes (2, 3), cold and
    from a warm start."""
    H, g, G, l, u = _box_qps((2, 3), 3, shared_A)
    s = tqp.QPSettings(eps_abs=CFG.wbc_eps_abs, eps_rel=CFG.wbc_eps_rel,
                       max_iter=CFG.wbc_max_iter)
    t = [torch.as_tensor(a) for a in (H, g, G, l, u)]
    j = [jnp.asarray(a) for a in (H, g, G, l, u)]
    got = tqp.solve(*t, s)
    want = jqp.solve(*j, s)
    _same_solution(got, want)
    got2 = tqp.solve(t[0], t[1] * 1.1, *t[2:], s, x0=got.x, y0=got.y)
    want2 = jqp.solve(j[0], j[1] * 1.1, *j[2:], s, x0=want.x, y0=want.y)
    _same_solution(got2, want2)
    assert (np.asarray(want2.iters) < np.asarray(want.iters)).any()


def test_no_scaling():
    H, g, G, l, u = _box_qps((4,), 5)
    s = tqp.QPSettings(scaling_iters=0, eps_abs=1e-5, eps_rel=1e-5)
    got = tqp.solve(*[torch.as_tensor(a) for a in (H, g, G, l, u)], s)
    want = jqp.solve(*[jnp.asarray(a) for a in (H, g, G, l, u)], s)
    _same_solution(got, want)


def test_single_problem_has_no_batch_axis():
    H, g, G, l, u = _box_qps((), 6)
    s = tqp.QPSettings(eps_abs=1e-5, eps_rel=1e-5)
    got = tqp.solve(*[torch.as_tensor(a) for a in (H, g, G, l, u)], s)
    assert got.x.shape == (12,) and got.iters.shape == ()
    want = jqp.solve(*[jnp.asarray(a) for a in (H, g, G, l, u)], s)
    _same_solution(got, want)


def test_float32_bounding_converges():
    ph = jml.gait_phase_fsteps(CFG, "bounding")
    rng = np.random.default_rng(0)
    B = len(ph)
    fs = np.stack(ph).astype(np.float32)
    xr = np.zeros((B, 12, CFG.n_steps + 1))
    xr[:, 2] = CFG.h_ref
    xr[:, :, 0] += rng.normal(scale=0.01, size=(B, 12))
    xr[:, 6, 1:] = rng.uniform(0, 0.4, size=(B, 1))
    xr = xr.astype(np.float32)
    want = jax.jit(jax.vmap(lambda x, f: jm.solve_mpc(CFG, x, f)))(
        jnp.asarray(xr), jnp.asarray(fs))
    got = tm.solve_mpc(CFG, torch.as_tensor(xr), torch.as_tensor(fs))
    assert got.x_f_applied.dtype == torch.float32
    assert np.asarray(want.converged).all() and bool(got.converged.all())
    d = np.abs(got.iters.numpy() - np.asarray(want.iters))
    assert d.max() <= 150, (got.iters.tolist(), np.asarray(want.iters))
