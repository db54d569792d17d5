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
* K3's resident CUDA variant takes each float32 product as three TF32
  products (3xTF32); `test_ns_refine_3xtf32_emulation` runs Newton-Schulz
  through an emulation of that rounding against the Pallas kernel: X
  within 1e-5 of max|X| [1.3e-6 from good seeds, 3.0e-6 from rolled-
  stance seeds, whose divergence amplifies it over three steps; 0.0 with
  no step], resid within 1e-4 relative or 1e-5 absolute, whichever is
  larger [7.2e-7 absolute (0.75 relative) at the round-off floor after
  three good steps, 4.2e-7 (5.0e-4 relative) with none, 1.3e-6 relative
  from rolled seeds], the same entries finite and the same bad flags.
  chip_smoke.py sets the kernel's tolerances on the card from these.
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
from tests.torch_threads import single_thread

single_thread()

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


@pytest.fixture(scope="module")
def ns_ref():
    """The Pallas kernel's (X, resid) in interpret mode, per (seed array
    id, ns_iters), computed once for the module."""
    cache = {}

    def ref(Kn, X0, ns_iters):
        key = (id(X0), ns_iters)
        if key not in cache:
            cache[key] = tuple(np.asarray(a) for a in jqpp._ns_refine(
                jnp.asarray(Kn), jnp.asarray(X0), ns_iters, interpret=True))
        return cache[key]
    return ref


def _check_ns(ns_ref, Kn, X0, ns_iters):
    X_j, r_j = ns_ref(Kn, X0, ns_iters)
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
def test_ns_refine_parity(kkt, ns_ref, ns_iters, seed):
    """K3's plain version against the Pallas kernel in interpret mode:
    three steps or none, from the inverse of a 0.1 mm earlier state
    (converges: a residual of ~1e-3 with no step, ~1e-6 after three) or
    from a rolled-stance inverse (diverges). A 1 mm earlier state would
    leave 0.0076-0.0087 with no step, within a factor 2 of the 1e-2
    guard (ROADMAP queue 3)."""
    K, good, rolled = kkt
    resid = _check_ns(ns_ref, K, good if seed == "good" else rolled,
                      ns_iters)
    if seed == "good":
        assert (resid < 1e-2).all(), resid
    else:
        assert (resid > 1e-2).all(), resid


def _tf32_rna(x):
    """cvt.rna.tf32.f32 on float32 values: the 13 low bits of the
    significand rounded away, to nearest, ties away from zero; non-finite
    values pass unchanged."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    r = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(x), r, x)


def _matmul_3xtf32(a, b):
    """a b as the resident K3 takes it: each operand split as big =
    tf32(a), small = tf32(a - big), then small b_big + big b_small +
    big b_big, summed in float64 and rounded to float32 per product."""
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)
    f64 = lambda u, v: np.matmul(u.astype(np.float64), v.astype(np.float64))
    return (f64(a_small, b_big) + f64(a_big, b_small)
            + f64(a_big, b_big)).astype(np.float32)


def _ns_refine_3xtf32(Kn, X, ns_iters):
    """K3's Newton-Schulz steps and residual through `_matmul_3xtf32`,
    the updates in float32."""
    eye = np.eye(Kn.shape[-1], dtype=np.float32)
    for _ in range(ns_iters):
        X = np.float32(2.0) * X - _matmul_3xtf32(X, _matmul_3xtf32(Kn, X))
    R = np.abs(_matmul_3xtf32(Kn, X) - eye)
    return X, R.reshape(len(Kn), -1).max(axis=1)


@pytest.mark.parametrize("ns_iters", [3, 0])
@pytest.mark.parametrize("seed", ["good", "rolled"])
def test_ns_refine_3xtf32_emulation(kkt, ns_ref, ns_iters, seed):
    """K3's resident CUDA variant rounds its products as 3xTF32, not as a
    float32 FMA chain. The emulation of that rounding, against the Pallas
    kernel in interpret mode, sets the tolerances chip_smoke.py holds the
    kernel to (measured errors in the module docstring): X within 1e-5 of
    max|X|, resid within max(1e-4 relative, 1e-5), the same finite
    pattern and the same bad flags."""
    K, good, rolled = kkt
    X0 = good if seed == "good" else rolled
    X_j, r_j = ns_ref(K, X0, ns_iters)
    with np.errstate(over="ignore", invalid="ignore"):
        X_e, r_e = _ns_refine_3xtf32(K, X0, ns_iters)
    X_e = 0.5 * (X_e + X_e.transpose(0, 2, 1))
    fin = np.isfinite(X_j)
    np.testing.assert_array_equal(np.isfinite(X_e), fin)
    scale = np.abs(X_j[fin]).max()
    np.testing.assert_allclose(X_e[fin], X_j[fin], rtol=0, atol=1e-5 * scale)
    lim = np.maximum(1e-4 * np.abs(r_j), 1e-5)
    assert (np.abs(r_e - r_j) <= lim).all(), (r_e, r_j)
    np.testing.assert_array_equal(r_e > 1e-2, r_j > 1e-2)


@pytest.mark.parametrize("n", [96, 191, 192, 193, 384])
def test_ns_variant_choice(n):
    """K3's wrapper takes the resident variant at n = 192, the full-size
    MPC's n (12 N), and the general variant at every other n; asked for
    the resident variant at another n, it raises before any launch."""
    assert 12 * N == tqpp.NS_RESIDENT_N == 192
    assert tqpp.ns_variant(n) == ("resident" if n == 192 else "general")
    if n != 192:
        K = torch.zeros((2, n, n))
        with pytest.raises(ValueError, match="compiled for n = 192"):
            tqpp._ns_launch(K, K, 3, variant="resident")


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
