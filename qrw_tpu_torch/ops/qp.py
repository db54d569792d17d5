"""QP solver settings, the OSQP rho classes, the cone structures and
Ruiz equilibration.

Partial port of qrw_tpu/ops/qp.py (qp.py:36-188): what
core/mpc_lane.build_phase_data and the rescue stage's solver
(ops/qp_pallas) need. The XLA-style per-problem ADMM loop `solve` is on
neither path and is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_EQ_SCALE = 1e3       # osqp RHO_EQ_OVER_RHO_INEQ
LOOSE_BOUND = 1e18
MIN_SCALING = 1e-4       # osqp MIN_SCALING
MAX_SCALING = 1e4


class ConeStructure(NamedTuple):
    """The full MPC cone matrix A = [F; I] (core/mpc.cone_matrix): F is
    block-diagonal with the 5x3 friction block C per (step, foot), I the
    12N activation identity."""
    n_steps: int
    mu: float

    @property
    def n(self) -> int:
        return 12 * self.n_steps

    @property
    def m(self) -> int:
        return 32 * self.n_steps

    def cone_rows(self) -> np.ndarray:
        """(5, 3) block C (src/MPC.cpp:135-146)."""
        return np.array([
            [1.0, 0.0, -self.mu],
            [-1.0, 0.0, -self.mu],
            [0.0, 1.0, -self.mu],
            [0.0, -1.0, -self.mu],
            [0.0, 0.0, -1.0],
        ])


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


class QPSolution(NamedTuple):
    x: torch.Tensor          # (..., n) primal solution
    y: torch.Tensor          # (..., m) dual solution
    z: torch.Tensor          # (..., m) projected constraint value
    iters: torch.Tensor      # (...,) iterations executed
    pri_res: torch.Tensor    # (...,) final primal residual (inf-norm)
    dua_res: torch.Tensor    # (...,) final dual residual (inf-norm)
    converged: torch.Tensor  # (...,) bool


def rho_vec_for_bounds(l, u, rho):
    """Per-row rho classes as osqp's set_rho_vec: loose rows get
    RHO_MIN, equality rows rho * 1e3, plain inequalities rho."""
    loose = (l < -LOOSE_BOUND) & (u > LOOSE_BOUND)
    eq = (u - l) < 1e-10
    rho = torch.as_tensor(rho, dtype=l.dtype, device=l.device)
    return torch.where(loose, torch.full_like(l, RHO_MIN),
                       torch.where(eq, RHO_EQ_SCALE * rho, rho))


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
