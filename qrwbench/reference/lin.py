# Frozen copy of qrw_tpu_torch/ops/lin.py as of the benchmark's first version;
# a plain reference: it imports nothing of the port.
"""Small-matrix linear algebra over leading batch axes.

Port of qrw_tpu/ops/lin.py: `inv3`, `cholesky`, `solve_lower`,
`solve_upper_t`, `chol_solve` and `spd_inverse`. The JAX module writes
the factorization as an unrolled column sweep because XLA's batched
LAPACK-style path serializes tiny problems on the TPU. On the card the
batched cuSOLVER / cuBLAS routines take a whole batch of small matrices
in one launch each, so these functions call torch.linalg: the factor
through `cholesky_ex`, whose `info` is never read, and the solves
through `solve_triangular` (triangular solves cannot fail).
`torch.linalg.cholesky`, `cholesky_solve` and `cholesky_inverse` check
a status and would read it back to the host: a synchronization on every
physics substep. `inv3` keeps the adjugate form, elementwise over the
batch.

All functions take the matrix order from the trailing shape and
broadcast over any leading batch axes. Preconditions, as in the JAX
module: `inv3` needs nonsingular inputs and the Cholesky routines SPD
ones; they are not checked.
"""

from __future__ import annotations

import numpy as np
import torch


def inv3(A):
    """Inverse of (..., 3, 3) by the adjugate formula (branch-free)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    M = torch.stack([torch.stack([A11, A12, A13], -1),
                     torch.stack([A21, A22, A23], -1),
                     torch.stack([A31, A32, A33], -1)], -2)
    return M / det[..., None, None]


def cholesky(M):
    """Lower Cholesky factor of SPD (..., n, n), without reading the
    factorization's status back to the host."""
    return torch.linalg.cholesky_ex(M)[0]


def broadcast_shapes(*shapes) -> tuple:
    """torch.broadcast_shapes without its first-call import of sympy
    (about a second on a cold process)."""
    return tuple(np.broadcast_shapes(*[tuple(s) for s in shapes]))


def _as_matrix(L, b):
    """b (..., n) or (..., n, k) -> ((..., n, k) broadcast against L,
    whether b was a vector)."""
    vec = b.dim() == L.dim() - 1
    B = b[..., None] if vec else b
    batch = broadcast_shapes(L.shape[:-2], B.shape[:-2])
    return B.expand(batch + tuple(B.shape[-2:])), vec


def solve_lower(L, b):
    """x with L x = b for lower-triangular L (..., n, n), b (..., n) or
    (..., n, k)."""
    B, vec = _as_matrix(L, b)
    L = L.expand(B.shape[:-2] + tuple(L.shape[-2:]))
    x = torch.linalg.solve_triangular(L, B, upper=False)
    return x[..., 0] if vec else x


def solve_upper_t(L, b):
    """x with L' x = b (L lower-triangular)."""
    B, vec = _as_matrix(L, b)
    L = L.expand(B.shape[:-2] + tuple(L.shape[-2:]))
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), B, upper=True)
    return x[..., 0] if vec else x


def chol_solve(M, b):
    """x = M^-1 b for SPD M (..., n, n), b (..., n) or (..., n, k)."""
    L = cholesky(M)
    return solve_upper_t(L, solve_lower(L, b))


def spd_inverse(M):
    """M^-1 for SPD (..., n, n): W = L^-1 by forward substitution
    against the identity, then M^-1 = W' W (symmetric by construction)."""
    L = cholesky(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    W = torch.linalg.solve_triangular(L, eye.expand(M.shape), upper=False)
    return W.transpose(-1, -2) @ W
