"""Parity of the port's full-size QP solver pieces (ops/qp_pallas) with
qrw_tpu: the Newton-Schulz refinement `_ns_refine` (kernel K3), the
guarded `_factor`, one K2 round at n = 192, m = 512 with and without its
K_ref refinement variant, and `solve` under the refactor policies "ns",
"chol" and "stale".

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_qp_pallas.py does; the port's side runs on CPU tensors, i.e.
the kernels' plain versions. Inputs are the full-size condensed trot QPs
of bench.build_batch (seed 0), built by the JAX package's
build_qp_compact and handed to both packages as float32 numpy arrays.

Tolerances (measured on the CPU in brackets):
* `_ns_refine`: X within 1e-5 of max|X| on the entries that are finite
  in both, the same entries finite, resid within 1e-4 relative [both
  exact, 0.0, from good seeds (resid 7e-7 after three steps, 8e-4 with
  none) and from rolled-stance seeds that diverge (resid ~1e21 after
  three steps, ~500 with none)]. The bad flags (resid > 1e-2) must be
  equal; the test asserts that no resid lies within a factor 2 of 1e-2,
  where float32 rounding could flip a flag.
* `_factor`: the same problems take the Cholesky fallback, and each
  problem's inverse agrees within 1e-4 of its max|X| [4.0e-7; the two
  packages' Cholesky solves round differently].
* one K2 round (50 iterations): x, y, z, dua, n1, n2 within 1e-4 of
  their scale plus 1e-6 [x 8.2e-6, z 6.8e-6, dua 2.1e-5 of scale];
  pri, a difference of ~25 N values at their round-off floor, within 8
  ulps of 32 [1.2e-5 = 3.2 ulps].
* `solve`, cold: flags and iteration counts equal, x within 1e-3 of its
  scale [7.8e-5; the adapted rho differs by up to 1.22x, ROADMAP queue
  3]. Warm from the JAX package's cold carry: flags, iteration counts
  and kinv_rho equal; x and z within 1e-4 of their scale [x 4.0e-5, z
  2.5e-5 under "chol"], y within 3e-4 of its scale [1.3e-4 under
  "chol"; the duals of the active cone rows are the most sensitive],
  K^-1 within 2e-4 of max|K^-1| [2.6e-5; 0.0 under "ns", where both
  refine the same seed and no row falls back].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from qrw_tpu.config import Config
from qrw_tpu.core import mpc as jmpc
from qrw_tpu.ops import qp as jqp
from qrw_tpu.ops import qp_pallas as jqpp
from qrw_tpu_torch.ops import qp as tqp
from qrw_tpu_torch.ops import qp_pallas as tqpp

torch.set_num_threads(1)

CFG = Config()
N = CFG.n_steps
JST = jqp.QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=450,
                     adaptive_rho_interval=200)
TST = tqp.QPSettings(*JST)
B = 3


def _np(t):
    return t.detach().cpu().numpy()


def _f32(a):
    return np.array(a, np.float32)


def _problems(batch, shift=0.0, seed=0):
    """Full-size trot QPs: (H, q, A, l, u) float32 numpy."""
    xr, fs = bench.build_batch(CFG, batch, np.random.default_rng(seed))
    xr[:, :, 0] += shift
    H, q, l, u, _, _ = jax.vmap(lambda x, f: jmpc.build_qp_compact(
        CFG, x, f))(jnp.asarray(xr), jnp.asarray(fs))
    A = jmpc.cone_matrix(N, CFG.mu).astype(np.float32)
    return _f32(H), _f32(q), A, _f32(l), _f32(u)


def _kkt(problem, rho=0.1):
    """K = P + diag(sigma') + A' diag(rho') A of each problem at a
    uniform rho, with the solver's Ruiz scaling; also rho', sigma'."""
    H, q, A, l, u = map(jnp.asarray, problem)
    D, E, c = jqp.ruiz_equilibrate(H, q, A, JST.scaling_iters)
    sig = (JST.sigma / c) / (D * D)
    rho_vec = jqp.rho_vec_for_bounds(E * l, E * u, jnp.full(
        (H.shape[0], 1), rho, jnp.float32)) * E * E / c
    K = jqpp._build_K(H, A, rho_vec, sig, jqp.ConeStructure(N, CFG.mu))
    return _f32(K), _f32(rho_vec), _f32(sig)


@pytest.fixture(scope="module")
def kkt():
    """K of B problems, the inverse of the same problems a moment before
    (a 0.1 mm shift of the current state: the good seed), and the K^-1 of
    the neighbouring problem in the batch, whose stance pattern is rolled
    one MPC step (the seed that diverges)."""
    K, _, _ = _kkt(_problems(B))
    K_prev, _, _ = _kkt(_problems(B, shift=-1e-4))
    good = _f32(jqpp._chol_inv(jnp.asarray(K_prev)))
    return K, good, np.roll(good, 1, axis=0)


def _check_ns(Kn, X0, ns_iters):
    X_j, r_j = jqpp._ns_refine(jnp.asarray(Kn), jnp.asarray(X0), ns_iters,
                               interpret=True)
    X_t, r_t = tqpp._ns_refine(torch.as_tensor(Kn), torch.as_tensor(X0),
                               ns_iters)
    X_j, r_j, X_t, r_t = np.asarray(X_j), np.asarray(r_j), _np(X_t), _np(r_t)
    fin = np.isfinite(X_j)
    np.testing.assert_array_equal(np.isfinite(X_t), fin)
    scale = np.abs(X_j[fin]).max()
    np.testing.assert_allclose(X_t[fin], X_j[fin], rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-4)
    near = (r_j > 0.5e-2) & (r_j < 2e-2)
    assert not near.any(), r_j
    np.testing.assert_array_equal(r_t > 1e-2, r_j > 1e-2)
    return r_j


@pytest.mark.parametrize("ns_iters", [3, 0])
@pytest.mark.parametrize("seed", ["good", "rolled"])
def test_ns_refine_parity(kkt, ns_iters, seed):
    """K3's plain version against the Pallas kernel in interpret mode:
    three steps or none, from the inverse of a 0.1 mm earlier state
    (converges: a residual of ~1e-3 with no step, ~1e-6 after three) or
    from a rolled-stance inverse (diverges). A 1 mm earlier state would
    leave 0.0076-0.0087 with no step, within a factor 2 of the 1e-2
    guard (ROADMAP queue 3)."""
    K, good, rolled = kkt
    resid = _check_ns(K, good if seed == "good" else rolled, ns_iters)
    if seed == "good":
        assert (resid < 1e-2).all(), resid
    else:
        assert (resid > 1e-2).all(), resid


@pytest.mark.parametrize("ns_iters", [3, 0])
def test_factor_guard_and_fallback(ns_iters):
    """B = 12, so the fallback capacity is 8: two good seeds, five NaN
    seeds (resid inf: ties, taken lowest index first) and five rolled
    seeds (bad). The five NaN problems and the three worst rolled ones
    take a fresh Cholesky; the two other rolled ones keep their refined
    seed. Both packages pick the same problems."""
    Bf = 12
    K, _, _ = _kkt(_problems(Bf))
    K_prev, _, _ = _kkt(_problems(Bf, shift=-1e-4))
    seed = _f32(jqpp._chol_inv(jnp.asarray(K_prev)))
    seed[7:] = np.roll(seed, 1, axis=0)[7:]
    seed[2:7, 0, 0] = np.nan
    want = np.asarray(jqpp._factor(jnp.asarray(K), jnp.asarray(seed),
                                   ns_iters=ns_iters, interpret=True))
    got = _np(tqpp._factor(torch.as_tensor(K), torch.as_tensor(seed),
                           ns_iters=ns_iters))
    chol = np.asarray(jqpp._chol_inv(jnp.asarray(K)))

    def fixed(X):
        d = np.abs(X - chol).reshape(Bf, -1).max(axis=1)
        return d <= 1e-3 * np.abs(chol).reshape(Bf, -1).max(axis=1)

    fx = fixed(want)
    np.testing.assert_array_equal(fixed(got), fx)
    assert fx[2:7].all() and fx.sum() == 8 + int(fx[:2].sum()), fx
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    for b in range(Bf):
        w, g = want[b], got[b]
        f = np.isfinite(w)
        np.testing.assert_allclose(g[f], w[f], rtol=0,
                                   atol=1e-4 * np.abs(w[f]).max(),
                                   err_msg=f"problem {b}")


@pytest.mark.parametrize("variant", ["plain", "K_ref"])
def test_kernel_round_full_shape_parity(kkt, variant):
    """One 50-iteration K2 round at n = 192, m = 512 against the Pallas
    kernel in interpret mode, on the same float32 inputs: a fresh
    inverse, or (K_ref) the previous step's inverse refined twice per
    x-update against the current K."""
    H, q, A, l, u = _problems(B)
    K, rho_vec, sig = _kkt((H, q, A, l, u))
    good = kkt[1]
    Kinv = good if variant == "K_ref" else _f32(jqpp._chol_inv(
        jnp.asarray(K)))
    rng = np.random.default_rng(3)
    x0 = rng.normal(scale=5.0, size=(B, 12 * N)).astype(np.float32)
    y0 = rng.normal(scale=1e-3, size=(B, 32 * N)).astype(np.float32)
    args = (Kinv, H, A, q, l, u, rho_vec, sig, x0, y0)
    Kk = K if variant == "K_ref" else None
    want = jqpp._run_kernel(*map(jnp.asarray, args), 1.6, 50, B, True,
                            K=None if Kk is None else jnp.asarray(Kk))
    got = tqpp._run_kernel(*map(torch.as_tensor, args), 1.6, 50,
                           K=None if Kk is None else torch.as_tensor(Kk))
    ulp8 = 8 * np.spacing(np.float32(32.0))
    for name, g, w in zip(["x", "y", "z", "pri", "dua", "n1", "n2"], got,
                          want):
        w = np.asarray(w)
        tol = ulp8 if name == "pri" else 1e-4 * np.abs(w).max() + 1e-6
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def cold():
    """The JAX package's cold solve of the B problems (default schedule
    [50, 200, 200]): the carry of the warm tests."""
    H, q, A, l, u = _problems(B)
    return jqpp.solve(*map(jnp.asarray, (H, q, A, l, u)), JST, tile=B,
                      cone=jqp.ConeStructure(N, CFG.mu), interpret=True)


def test_solve_cold_parity(cold):
    """The cold solve (Ruiz, three rounds, two rho adaptations): flags
    and iteration counts equal, x within 1e-3 of its scale (the two
    packages' adapted rho differ by float32 round-off; ROADMAP queue
    3)."""
    prob = _problems(B)
    got = tqpp.solve(*map(torch.as_tensor, prob), TST,
                     cone=tqp.ConeStructure(N, CFG.mu))
    np.testing.assert_array_equal(_np(got.converged),
                                  np.asarray(cold.converged))
    np.testing.assert_array_equal(_np(got.iters), np.asarray(cold.iters))
    assert np.asarray(cold.converged).all()
    w = np.asarray(cold.x)
    np.testing.assert_allclose(_np(got.x), w, rtol=0,
                               atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("refactor", ["ns", "chol", "stale"])
def test_solve_warm_policy_parity(cold, refactor):
    """A warm call on the next step's problems (1 mm shift) from the JAX
    cold carry: x0, y0, rho, the preconditioner and K^-1 at kinv_rho,
    one 100-iteration round under each refactor policy."""
    prob = _problems(B, shift=0.001)
    carry = dict(x0=cold.x, y0=cold.y, rho_init=cold.rho,
                 precond=cold.precond, kinv_init=cold.kinv,
                 kinv_rho=cold.kinv_rho)
    want = jqpp.solve(*map(jnp.asarray, prob), JST, tile=B,
                      cone=jqp.ConeStructure(N, CFG.mu), schedule=[100],
                      refactor=refactor, interpret=True, **carry)
    tcarry = {k: (tuple(torch.as_tensor(np.array(a)) for a in v)
                  if isinstance(v, tuple) else torch.as_tensor(np.array(v)))
              for k, v in carry.items()}
    got = tqpp.solve(*map(torch.as_tensor, prob), TST,
                     cone=tqp.ConeStructure(N, CFG.mu), schedule=[100],
                     refactor=refactor, **tcarry)
    np.testing.assert_array_equal(_np(got.converged),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(_np(got.iters), np.asarray(want.iters))
    assert np.asarray(want.converged).all()
    np.testing.assert_array_equal(_np(got.kinv_rho),
                                  np.asarray(want.kinv_rho))
    for f, rel in (("x", 1e-4), ("y", 3e-4), ("z", 1e-4), ("kinv", 2e-4)):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(_np(getattr(got, f)), w, rtol=0,
                                   atol=rel * np.abs(w).max(), err_msg=f)
