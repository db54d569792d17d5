"""Parity of the port's rescue solver (ops/qp_pallas, ops/qp) with
qrw_tpu.

The JAX side reaches its Pallas kernel in interpret mode, as
tests/test_qp_pallas.py runs it; the port's side runs the kernel's plain
version (CPU tensors). Inputs are made with numpy from a seed and handed
to both packages. The problems are the rescue stage's: the
support-reduced trot MPC QP at cap = 2N (n = 96, m = 160), built once
per module by the JAX package's build_qp_reduced.

Tolerances. The x-update multiplies by a float32 K^-1 of a KKT matrix
whose condition number is ~1e7, so the two packages' iterates agree to
~1e-5 of their scale after a 50-iteration round (measured 7e-5 N on
~25 N forces from the same K^-1) and to ~2e-5 after a whole solve from
each package's own Cholesky (measured 5e-4 N): forces and constraint
values are held to 1e-4 of their scale, duals to 1e-4 of theirs plus
1e-6. Converged flags and iteration counts must be equal. The adapted
rho is NOT a float32-stable quantity on these problems: OSQP's rule
scales rho by sqrt((pri / n1) / (dua / n2)) and the primal residual
after a round sits at 1-3 units in the last place of |z| (~25 N), so an
ulp of difference moves one adaptation by up to sqrt(2) (measured: the
two packages' rho differ by 1.0-1.16x after one adaptation). Where no
adaptation runs (one round, or a warm start that converges in round
one) rho must be equal; where it runs, it is held within a factor 2.
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
from qrw_tpu.ops import qp_pallas as jqpp
from qrw_tpu_torch.ops import qp as tqp
from qrw_tpu_torch.ops import qp_pallas as tqpp
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
N = CFG.n_steps
CAP = 2 * N
B = 3
JST = jqp.QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=450,
                     adaptive_rho_interval=200, scaling_iters=4)
TST = tqp.QPSettings(*JST)
RESCUE_SCHEDULE = [50, 150, 150, 100]


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def problem():
    """B rescue-shaped QPs (float32 numpy): H, q, A, l, u."""
    rng = np.random.default_rng(0)
    phase_fs = jml.trot_phase_fsteps(CFG)
    xr = np.zeros((B, 12, N + 1), np.float32)
    xr[:, 2] = CFG.h_ref
    xr[:, :, 0] += rng.normal(scale=0.02, size=(B, 12))
    xr[:, 6, 1:] = rng.uniform(0.0, 0.6, size=(B, 1))
    fs = np.stack([phase_fs[p] for p in (0, 3, 9)]).astype(np.float32)
    H, q, *_ = jax.vmap(lambda x, f: jmpc.build_qp_reduced(
        CFG, x, f, CAP))(jnp.asarray(xr), jnp.asarray(fs))
    A = jqp.ReducedConeStructure(CAP, CFG.mu).matrix().astype(np.float32)
    l = np.tile(np.array([-np.inf] * 4 + [-CFG.fz_max], np.float32),
                (B, CAP))
    return (np.array(H, np.float32), np.array(q, np.float32), A, l,
            np.zeros_like(l))


def _solve_both(problem, **kw):
    """The same solve in both packages; kw holds numpy warm starts."""
    H, q, A, l, u = problem
    jcone = jqp.ReducedConeStructure(CAP, CFG.mu)
    tcone = tqp.ReducedConeStructure(CAP, CFG.mu)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jqpp.solve(*map(jnp.asarray, (H, q, A, l, u)), JST, tile=B,
                      cone=jcone, interpret=True, **jkw)
    got = tqpp.solve(*map(torch.as_tensor, (H, q, A, l, u)), TST, tile=B,
                     cone=tcone, **tkw)
    return got, want


def _close(got, want, fields=("x", "y", "z")):
    for f in fields:
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(
            _np(getattr(got, f)), w, rtol=0,
            atol=1e-4 * np.abs(w).max() + 1e-6, err_msg=f)


def test_rho_vec_for_bounds_parity():
    """Loose, equality and inequality rows, float64: exact."""
    rng = np.random.default_rng(1)
    l = rng.normal(size=(2, 12))
    u = l + np.abs(rng.normal(size=(2, 12)))
    l[:, 0:3], u[:, 0:3] = -1e20, 1e20                 # loose
    u[:, 3:6] = l[:, 3:6]                              # equality
    l[:, 6] = -np.inf                                  # one-sided
    rho = np.array([[0.1], [2.5]])
    want = jqp.rho_vec_for_bounds(jnp.asarray(l), jnp.asarray(u),
                                  jnp.asarray(rho))
    got = tqp.rho_vec_for_bounds(torch.as_tensor(l), torch.as_tensor(u),
                                 torch.as_tensor(rho))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("branch", ["reduced", "full", "dense"])
def test_build_K_parity(branch):
    """K = P + diag(sig) + A' diag(rho) A in float64 through the
    reduced-cone, full-cone and dense branches: same sums in a different
    order, held to 1e-12 of the largest entry."""
    rng = np.random.default_rng(2)
    n_steps = 2
    if branch == "reduced":
        jc = jqp.ReducedConeStructure(4, CFG.mu)
        tc = tqp.ReducedConeStructure(4, CFG.mu)
        A = jc.matrix()
    elif branch == "full":
        jc = jqp.ConeStructure(n_steps, CFG.mu)
        tc = tqp.ConeStructure(n_steps, CFG.mu)
        A = jmpc.cone_matrix(n_steps, CFG.mu)
    else:
        jc = tc = None
        A = rng.normal(size=(20, 12))
    m, n = A.shape
    M = rng.normal(size=(2, n, n))
    P = M @ M.transpose(0, 2, 1)
    rho = np.abs(rng.normal(size=(2, m))) + 0.05
    sig = np.abs(rng.normal(size=(2, n))) * 1e-3
    want = jqpp._build_K(jnp.asarray(P), jnp.asarray(A), jnp.asarray(rho),
                         jnp.asarray(sig), jc)
    got = tqpp._build_K(torch.as_tensor(P), torch.as_tensor(A),
                        torch.as_tensor(rho), torch.as_tensor(sig), tc)
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    # and the inverse that the kernel consumes
    Ki = tqpp._chol_inv(got)
    np.testing.assert_allclose(_np(Ki) @ want, np.broadcast_to(
        np.eye(n), want.shape), atol=1e-8)


def test_kernel_round_parity(problem):
    """One 50-iteration round of the plain kernel against the Pallas
    kernel (interpret mode) on the same float32 inputs, K^-1 included:
    x, y, z and the four residual norms. pri = |A x - z| is a difference
    of ~25 N values at their round-off floor, held to 4 ulps of that
    scale; the other norms follow their vectors' tolerance."""
    H, q, A, l, u = problem
    rng = np.random.default_rng(3)
    rho = np.full((B, 5 * CAP), 0.1, np.float32)
    sig = np.full((B, 3 * CAP), 1e-6, np.float32)
    Kinv = np.array(jqpp._chol_inv(jqpp._build_K(
        jnp.asarray(H), jnp.asarray(A), jnp.asarray(rho), jnp.asarray(sig),
        jqp.ReducedConeStructure(CAP, CFG.mu))), np.float32)
    x0 = rng.normal(scale=5.0, size=(B, 3 * CAP)).astype(np.float32)
    y0 = rng.normal(scale=1e-3, size=(B, 5 * CAP)).astype(np.float32)
    args = (Kinv, H, A, q, l, u, rho, sig, x0, y0)
    want = jqpp._run_kernel(*map(jnp.asarray, args), 1.6, 50, B, True)
    got = tqpp._run_kernel(*map(torch.as_tensor, args), 1.6, 50)
    ulp4 = 4 * np.spacing(np.float32(32.0))
    for name, g, w in zip(["x", "y", "z", "pri", "dua", "n1", "n2"], got,
                          want):
        w = np.asarray(w)
        tol = (ulp4 if name == "pri"
               else 1e-4 * np.abs(w).max() + 1e-6)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["default", "rescue-early-exit",
                                  "rescue-no-early-exit"])
def test_solve_cold_parity(problem, case):
    """Cold solves: the default schedule [50, 200, 200], and the rescue
    schedule with and without the early exit."""
    kw = {} if case == "default" else dict(
        schedule=RESCUE_SCHEDULE, early_exit=case == "rescue-early-exit")
    got, want = _solve_both(problem, **kw)
    np.testing.assert_array_equal(_np(got.converged),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(_np(got.iters), np.asarray(want.iters))
    assert np.asarray(want.converged).all()
    _close(got, want)
    ratio = _np(got.rho) / np.asarray(want.rho)
    assert (ratio > 0.5).all() and (ratio < 2.0).all(), ratio
    for a, b in zip(got.precond, want.precond):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5)


@pytest.fixture(scope="module")
def cold(problem):
    """The JAX package's cold solution, the warm start of the tests
    below (on a 1%-perturbed linear term)."""
    H, q, A, l, u = problem
    return jqpp.solve(*map(jnp.asarray, (H, q, A, l, u)), JST, tile=B,
                      cone=jqp.ReducedConeStructure(CAP, CFG.mu),
                      interpret=True)


@pytest.mark.parametrize("early_exit", [True, False])
def test_solve_warm_parity(problem, cold, early_exit):
    """Warm start (x0, y0, rho_init) under the rescue schedule. Every
    problem converges in round one, so both sides report 50 iterations
    and carry rho_init through unchanged; without the early exit the
    later rounds still run (and rho stays, converged problems do not
    adapt)."""
    H, q, A, l, u = problem
    warm = (H, q * np.float32(1.01), A, l, u)
    rho0 = np.asarray(cold.rho)
    got, want = _solve_both(warm, x0=np.asarray(cold.x),
                            y0=np.asarray(cold.y), rho_init=rho0,
                            schedule=RESCUE_SCHEDULE, early_exit=early_exit)
    np.testing.assert_array_equal(_np(got.converged),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(_np(got.iters), np.asarray(want.iters))
    np.testing.assert_array_equal(np.asarray(want.iters), 50)
    np.testing.assert_array_equal(_np(got.rho), np.asarray(want.rho))
    np.testing.assert_array_equal(_np(got.rho), rho0)
    _close(got, want)


def test_solve_nonfinite_warm_start_resets(problem, cold):
    """NaN / inf entries of x0 and y0 restart from zero, in both
    packages: the solve equals the one with those entries zeroed."""
    H, q, A, l, u = problem
    x0 = np.asarray(cold.x).copy()
    y0 = np.asarray(cold.y).copy()
    x0[0, :5] = np.nan
    x0[1, 7] = np.inf
    y0[2, :3] = -np.inf
    kw = dict(rho_init=np.asarray(cold.rho), schedule=[50])
    got, want = _solve_both(problem, x0=x0, y0=y0, **kw)
    zx, zy = np.nan_to_num(x0, nan=0.0, posinf=0.0, neginf=0.0), \
        np.nan_to_num(y0, nan=0.0, posinf=0.0, neginf=0.0)
    ref = tqpp.solve(*map(torch.as_tensor, problem), TST,
                     cone=tqp.ReducedConeStructure(CAP, CFG.mu),
                     x0=torch.as_tensor(zx), y0=torch.as_tensor(zy),
                     rho_init=torch.as_tensor(kw["rho_init"]),
                     schedule=[50])
    np.testing.assert_array_equal(_np(got.x), _np(ref.x))
    assert np.isfinite(_np(got.x)).all()
    np.testing.assert_array_equal(_np(got.converged),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(_np(got.iters), np.asarray(want.iters))
    _close(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chol_inv_parity(dtype):
    """The plain K^-1 (`_chol_inv` on CPU tensors: cholesky_ex of
    (K + K') / 2, then two triangular solves) against qrw_tpu's
    `_chol_inv` on random SPD batches at the rescue's n = 96 and the
    fleet rescue's n = 144, with K not bitwise symmetric (as `_build_K`
    can give it), so that both read the symmetrized matrix. Condition
    numbers ~4e3-6e3. float64: 1e-10 of the largest entry (measured
    8e-14: the same factor, XLA's own triangular solves). float32: 5e-4
    (measured 4.8e-5; two float32 orders of one solve differ by up to
    cond x eps ~ 3.6e-4)."""
    rng = np.random.default_rng(4)
    tol = 1e-10 if dtype == np.float64 else 5e-4
    for n in (96, 144):
        M = rng.normal(size=(3, n, n))
        K = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(n)
        K = (K + np.triu(rng.normal(scale=1e-6, size=K.shape), 1)
             ).astype(dtype)
        want = np.asarray(jqpp._chol_inv(jnp.asarray(K)))
        got = _np(tqpp._chol_inv(torch.as_tensor(K)))
        assert got.dtype == want.dtype == dtype
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=f"n = {n}")


def test_solve_nonpd_problem_fails_alone():
    """One problem that is not positive definite fails alone, as in
    qrw_tpu: B = 4 random QPs (n = 6, m = 8, seed 0), problem 2's P all
    NaN, max_iter 100, tile 4. qrw_tpu's Cholesky gives NaN for that
    problem, so its K^-1, x and flag go non-finite and unconverged
    while the other three solve; the port used to raise LinAlgError for
    the whole batch. Flags equal, x finite on lanes 0, 1, 3 and within
    the module's tolerance of qrw_tpu's there."""
    rng = np.random.default_rng(0)
    Bq, n, m = 4, 6, 8
    M = rng.normal(size=(Bq, n, n))
    P = M @ M.transpose(0, 2, 1) + np.eye(n)
    P[2] = np.nan
    q = rng.normal(size=(Bq, n))
    A = rng.normal(size=(m, n))
    u = 1.0 + np.abs(rng.normal(size=(Bq, m)))
    l = -u
    P, q, A, l, u = (a.astype(np.float32) for a in (P, q, A, l, u))
    st = jqp.QPSettings(max_iter=100)
    want = jqpp.solve(*map(jnp.asarray, (P, q, A, l, u)), st, tile=Bq,
                      interpret=True)
    got = tqpp.solve(*map(torch.as_tensor, (P, q, A, l, u)),
                     tqp.QPSettings(*st), tile=Bq)
    np.testing.assert_array_equal(np.asarray(want.converged),
                                  [True, True, False, True])
    np.testing.assert_array_equal(_np(got.converged),
                                  np.asarray(want.converged))
    ok = [0, 1, 3]
    assert np.isfinite(_np(got.x)[ok]).all()
    assert not np.isfinite(_np(got.kinv)[2]).any()
    assert np.isfinite(_np(got.kinv)[ok]).all()
    w = np.asarray(want.x)[ok]
    np.testing.assert_allclose(_np(got.x)[ok], w, rtol=0,
                               atol=1e-4 * np.abs(w).max() + 1e-6)
