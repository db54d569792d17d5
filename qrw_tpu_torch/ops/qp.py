"""QP solver settings, the support-reduced cone structure and Ruiz
equilibration.

Partial port of qrw_tpu/ops/qp.py (qp.py:75-188): what
core/mpc_lane.build_phase_data needs on the host. The OSQP-semantics
ADMM `solve` serves the rescue stage and is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MIN_SCALING = 1e-4
MAX_SCALING = 1e4


class ReducedConeStructure(NamedTuple):
    """The support-reduced cone matrix A = I_blocks (x) C: one 5x3
    friction block per retained stance (step, foot) pair."""
    n_blocks: int
    mu: float

    @property
    def n(self) -> int:
        return 3 * self.n_blocks

    @property
    def m(self) -> int:
        return 5 * self.n_blocks

    def cone_rows(self) -> np.ndarray:
        return np.array([
            [1.0, 0.0, -self.mu],
            [-1.0, 0.0, -self.mu],
            [0.0, 1.0, -self.mu],
            [0.0, -1.0, -self.mu],
            [0.0, 0.0, -1.0],
        ])

    def matrix(self) -> np.ndarray:
        """(5B, 3B) dense A = I (x) C."""
        return np.kron(np.eye(self.n_blocks), self.cone_rows())


class QPSettings(NamedTuple):
    sigma: float = 1e-6
    alpha: float = 1.6
    rho: float = 0.1
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    max_iter: int = 1000
    check_every: int = 25
    adaptive_rho_interval: int = 200
    adaptive_rho_tolerance: float = 5.0
    scaling_iters: int = 10


def _limit(s):
    return torch.clamp(s, MIN_SCALING, MAX_SCALING)


def ruiz_equilibrate(P, q, A, iters: int):
    """Modified Ruiz equilibration with cost scaling (osqp scaling.c).

    P (..., n, n); q (..., n); A (m, n). Returns (D (..., n),
    E (..., m), c (..., 1)): the scaled problem is P' = c D P D,
    q' = c D q, A' = E A D."""
    dtype = q.dtype
    n = q.shape[-1]
    m = A.shape[-2]
    batch = torch.broadcast_shapes(P.shape[:-2], q.shape[:-1])
    kw = dict(dtype=dtype, device=q.device)
    D = torch.ones(batch + (n,), **kw)
    E = torch.ones(batch + (m,), **kw)
    c = torch.ones(batch + (1,), **kw)
    absA = torch.abs(A)
    absP = torch.abs(P)
    for _ in range(iters):
        colP = torch.amax(absP * D[..., None, :] * D[..., :, None]
                          * c[..., None], dim=-2)
        sA = absA * D[..., None, :] * E[..., :, None]
        colA = torch.amax(sA, dim=-2)
        rowA = torch.amax(sA, dim=-1)
        col = torch.maximum(colP, colA)
        D = D * (1.0 / torch.sqrt(_limit(col)))
        E = E * (1.0 / torch.sqrt(_limit(rowA)))
        colP2 = torch.amax(absP * D[..., None, :] * D[..., :, None]
                           * c[..., None], dim=-2)
        qn = torch.amax(torch.abs(q * D * c[..., 0:1]), dim=-1)[..., None]
        gamma = 1.0 / _limit(torch.maximum(colP2.mean(-1, keepdim=True),
                                           qn))
        c = c * gamma
    return D, E, c
