"""Parity of the port's ops/lin with qrw_tpu's, in float64.

The same seeded SPD matrices (orders 3, 12 and 18: the leg Jacobian
blocks, the WBC's KKT matrix, the joint-space inertia) over leading
batch axes (2, 3) and the same right-hand sides, as vectors and as
(n, 4) matrices, go through both packages. qrw_tpu factorizes by an
unrolled column sweep, the port through torch.linalg (cholesky_ex and
triangular solves): the same factor up to round-off. Tolerance: 1e-10
relative to the result's scale (measured: 1e-15 to 1e-13; the order-18
matrices have condition numbers up to ~1e3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.ops import lin as jlin
from qrw_tpu_torch.ops import lin as tlin
from tests.torch_threads import single_thread

single_thread()

BATCH = (2, 3)
REL = 1e-10


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=BATCH + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * max(1.0, np.abs(want).max()))


def test_inv3():
    rng = np.random.default_rng(0)
    A = rng.normal(size=BATCH + (3, 3)) + 2 * np.eye(3)
    _close(tlin.inv3(torch.as_tensor(A)), jlin.inv3(jnp.asarray(A)))
    np.testing.assert_allclose(
        tlin.inv3(torch.as_tensor(A)).numpy() @ A,
        np.broadcast_to(np.eye(3), A.shape), atol=1e-12)


@pytest.mark.parametrize("n", [3, 12, 18])
def test_cholesky(n):
    M = _spd(n, n)
    _close(tlin.cholesky(torch.as_tensor(M)), jlin.cholesky(jnp.asarray(M)))


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
@pytest.mark.parametrize("fn", ["solve_lower", "solve_upper_t",
                                "chol_solve"])
@pytest.mark.parametrize("n", [3, 12, 18])
def test_solves(n, fn, rhs):
    M = _spd(n, 100 + n)
    rng = np.random.default_rng(n)
    b = rng.normal(size=BATCH + ((n,) if rhs == "vector" else (n, 4)))
    if fn == "chol_solve":
        A_t, A_j = torch.as_tensor(M), jnp.asarray(M)
    else:                   # a lower-triangular factor of M
        L = np.linalg.cholesky(M)
        A_t, A_j = torch.as_tensor(L), jnp.asarray(L)
    _close(getattr(tlin, fn)(A_t, torch.as_tensor(b)),
           getattr(jlin, fn)(A_j, jnp.asarray(b)))


@pytest.mark.parametrize("n", [3, 12, 18])
def test_spd_inverse(n):
    M = _spd(n, 200 + n)
    got = tlin.spd_inverse(torch.as_tensor(M))
    _close(got, jlin.spd_inverse(jnp.asarray(M)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.swapaxes(got.numpy(), -1, -2))

