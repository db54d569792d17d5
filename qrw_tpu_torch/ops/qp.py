"""Batched dense QP solver with OSQP ADMM semantics.

Port of qrw_tpu/ops/qp.py: the settings, the OSQP rho classes, the cone
structures, Ruiz equilibration (also used by core/mpc_lane and the
rescue stage's solver in ops/qp_pallas) and the per-problem ADMM
`solve` of the single-robot controller (its MPC and its WBC box QP).

`solve` keeps the JAX solver's semantics over leading batch axes:
modified Ruiz equilibration, the sigma-regularized x-update with
relaxation alpha and per-row rho classes, termination on unscaled
residuals checked every `check_every` iterations per problem, and
residual-based adaptive rho. Converged problems freeze (x, z, y,
iteration count and residuals stop), and the loop runs while any
problem is active: a batch gives what qrw_tpu's `jax.vmap` of the
per-problem `while_loop` gives. The loop reads the device once per
`check_every` block (whether every problem is done, and on adaptation
checks which problems want a new rho); only those problems refactor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qrw_tpu_torch.ops import lin

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
    batch = lin.broadcast_shapes(P.shape[:-2], q.shape[:-1])
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


def _inf_norm(v):
    return torch.amax(torch.abs(v), dim=-1)


def _mv(M, v):
    """(..., a, b) @ (..., b) -> (..., a)."""
    return (M @ v[..., None])[..., 0]


def _cone_block_indices(nb: int):
    """Row / column indices of the nb 3x3 diagonal blocks of an (3nb,
    3nb) matrix, block-major then row-major (unique, so the block
    scatter-add is a gather-add-store)."""
    rows = (3 * np.repeat(np.arange(nb), 9)
            + np.tile(np.repeat(np.arange(3), 3), nb))
    cols = (3 * np.repeat(np.arange(nb), 9)
            + np.tile(np.arange(3), 3 * nb))
    return rows, cols


def solve(P, q, A, l, u, settings: QPSettings = QPSettings(),
          x0=None, y0=None, cone: ConeStructure = None) -> QPSolution:
    """Solve a batch of dense QPs min 1/2 x'Px + q'x s.t. l <= Ax <= u.

    P (..., n, n), q (..., n), A (m, n) shared or (..., m, n), l / u
    (..., m) broadcast over leading batch axes. x0 / y0: warm start (the
    previous solution, as OSQP keeps its workspace between solves).
    cone: a ConeStructure matching A turns on the structured products
    (A = [F; I] applied block by block and A'RA as 3x3 diagonal blocks);
    same semantics, another operation order. Problems are assumed
    feasible."""
    dtype, dev = q.dtype, q.device
    n = q.shape[-1]
    m = l.shape[-1]
    batch = lin.broadcast_shapes(P.shape[:-2], q.shape[:-1], l.shape[:-1],
                                 u.shape[:-1])
    s = settings
    bf = int(np.prod(batch)) if batch else 1
    kw = dict(dtype=dtype, device=dev)

    P = P.expand(batch + (n, n)).reshape(bf, n, n)
    q = q.expand(batch + (n,)).reshape(bf, n)
    l = l.expand(batch + (m,)).reshape(bf, m)
    u = u.expand(batch + (m,)).reshape(bf, m)
    shared_A = A.dim() == 2
    if not shared_A:
        A = A.expand(batch + (m, n)).reshape(bf, m, n)

    # ---- Ruiz equilibration --------------------------------------------
    if s.scaling_iters > 0:
        D, E, c = ruiz_equilibrate(P, q, A, s.scaling_iters)
    else:
        D = torch.ones((bf, n), **kw)
        E = torch.ones((bf, m), **kw)
        c = torch.ones((bf, 1), **kw)
    Ps = P * D[:, None, :] * D[:, :, None] * c[:, :, None]
    qs = q * D * c
    ls = E * l
    us = E * u
    loose = (ls < -LOOSE_BOUND) & (us > LOOSE_BOUND)
    eq = (us - ls) < 1e-10
    eye = torch.eye(n, **kw)

    def rho_vec(rho, lanes=slice(None)):
        return torch.where(loose[lanes], RHO_MIN,
                           torch.where(eq[lanes], RHO_EQ_SCALE * rho, rho))

    if cone is not None:
        nb = 4 * cone.n_steps                          # foot-step blocks
        mc = 20 * cone.n_steps                         # cone rows
        Cb = torch.as_tensor(cone.cone_rows(), **kw)   # (5, 3)
        D4 = D.reshape(bf, nb, 3)
        E_cone = E[:, :mc].reshape(bf, nb, 5)
        idc = E[:, mc:] * D                            # (bf, n)
        Cs = Cb * E_cone[:, :, :, None] * D4[:, :, None, :]   # (bf, nb, 5, 3)
        rows, cols = (torch.as_tensor(i, device=dev)
                      for i in _cone_block_indices(nb))
        diag = torch.arange(n, device=dev)

        def Amul(x):
            yc = torch.einsum("bkca,bka->bkc", Cs, x.reshape(bf, nb, 3))
            return torch.cat([yc.reshape(bf, mc), idc * x], dim=-1)

        def Atmul(y):
            xc = torch.einsum("bkca,bkc->bka", Cs, y[:, :mc].reshape(bf, nb, 5))
            return xc.reshape(bf, n) + idc * y[:, mc:]

        def build_K(rv, lanes):
            Cl = Cs[lanes]
            k = Cl.shape[0]
            blocks = torch.einsum("bkca,bkc,bkcd->bkad", Cl,
                                  rv[:, :mc].reshape(k, nb, 5), Cl)
            K = Ps[lanes] + s.sigma * eye
            K[:, rows, cols] += blocks.reshape(k, 9 * nb)
            K[:, diag, diag] += idc[lanes] * idc[lanes] * rv[:, mc:]
            return K
    else:
        def Amul(x):
            """scaled A' x = E * (A @ (D * x))"""
            if shared_A:
                return E * ((D * x) @ A.T)
            return E * _mv(A, D * x)

        def Atmul(y):
            if shared_A:
                return D * ((E * y) @ A)
            return D * _mv(A.transpose(-1, -2), E * y)

        def build_K(rv, lanes):
            w = rv * E[lanes] * E[lanes]
            if shared_A:
                AtRA = torch.einsum("ma,bm,mc->bac", A, w, A)
            else:
                AtRA = torch.einsum("bma,bm,bmc->bac", A[lanes], w, A[lanes])
            Dl = D[lanes]
            AtRA = AtRA * Dl[:, None, :] * Dl[:, :, None]
            return Ps[lanes] + AtRA + s.sigma * eye

    def factor(rho, lanes=slice(None)):
        """(K^-1, rho vector) of the given lanes at their rho (k, 1).
        Small orders (the 12-variable WBC QP) invert as W'W with
        W = L^-1, as qrw_tpu's ops/lin does; large ones (the MPC) by two
        triangular solves against the identity, as its cho_solve does:
        in float32, W'W squares the factor's conditioning, and the MPC's
        ADMM then stalls on a quarter of the bounding gait's solves."""
        rv = rho_vec(rho, lanes)
        K = build_K(rv, lanes)
        if n <= 32:
            return lin.spd_inverse(K), rv
        return lin.chol_solve(K, eye.expand(K.shape)), rv

    rho = torch.full((bf, 1), s.rho, **kw)
    Kinv, rv = factor(rho)

    # warm start (scaled into the equilibrated space)
    if x0 is None:
        x = torch.zeros((bf, n), **kw)
    else:
        x = x0.to(dtype).expand(batch + (n,)).reshape(bf, n) / D
    if y0 is None:
        y = torch.zeros((bf, m), **kw)
    else:
        y = y0.to(dtype).expand(batch + (m,)).reshape(bf, m) * c / E
    z = Amul(x)

    it = torch.zeros(bf, dtype=torch.int32, device=dev)
    pri = torch.full((bf,), float("inf"), **kw)
    dua = torch.full((bf,), float("inf"), **kw)
    done = torch.zeros(bf, dtype=torch.bool, device=dev)
    cinv = 1.0 / c

    n_checks = (s.max_iter + s.check_every - 1) // s.check_every
    adapt_mod = max(1, s.adaptive_rho_interval // s.check_every)
    any_done = False                    # as last read from the device
    for chk in range(n_checks):
        keep = done[:, None]
        for _ in range(s.check_every):
            b = s.sigma * x - qs + Atmul(rv * z - y)
            xt = _mv(Kinv, b)
            zt = Amul(xt)
            xn = s.alpha * xt + (1 - s.alpha) * x
            z_rel = s.alpha * zt + (1 - s.alpha) * z
            zn = torch.clamp(z_rel + y / rv, ls, us)
            yn = y + rv * (z_rel - zn)
            if any_done:
                xn = torch.where(keep, x, xn)
                zn = torch.where(keep, z, zn)
                yn = torch.where(keep, y, yn)
            x, z, y = xn, zn, yn

        # unscaled residuals and tolerances (osqp scaled_termination=0)
        Ax_u = Amul(x) / E
        z_u = z / E
        Px_u = cinv * _mv(Ps, x) / D
        Aty_u = cinv * Atmul(y) / D
        q_u = qs / D * cinv
        n_Ax, n_z = _inf_norm(Ax_u), _inf_norm(z_u)
        n_Px, n_Aty, n_q = _inf_norm(Px_u), _inf_norm(Aty_u), _inf_norm(q_u)
        pri_k = _inf_norm(Ax_u - z_u)
        dua_k = _inf_norm(Px_u + q_u + Aty_u)
        eps_pri = s.eps_abs + s.eps_rel * torch.maximum(n_Ax, n_z)
        eps_dua = s.eps_abs + s.eps_rel * torch.maximum(
            torch.maximum(n_Px, n_Aty), n_q)
        conv = (pri_k <= eps_pri) & (dua_k <= eps_dua)
        it = torch.where(done, it, it + s.check_every)
        pri = torch.where(done, pri, pri_k)
        dua = torch.where(done, dua, dua_k)
        done = done | conv

        adapting = (chk + 1) % adapt_mod == 0
        if adapting:
            denom_p = torch.clamp(torch.maximum(n_Ax, n_z), min=1e-30)
            denom_d = torch.clamp(torch.maximum(torch.maximum(n_Px, n_Aty),
                                                n_q), min=1e-30)
            ratio = (pri_k / denom_p) / torch.clamp(dua_k / denom_d,
                                                    min=1e-30)
            scale = torch.sqrt(ratio)[:, None]
            want = ((scale > s.adaptive_rho_tolerance)
                    | (scale < 1.0 / s.adaptive_rho_tolerance))[:, 0] & ~done
            flags = torch.cat([done, want]).cpu()      # the block's one read
            want_h = flags[bf:]
        else:
            flags = done.cpu()
        if bool(flags[:bf].all()):
            break
        any_done = bool(flags[:bf].any())
        if adapting and bool(want_h.any()):
            lanes = torch.nonzero(want_h)[:, 0].to(dev)
            rho_l = torch.clamp(rho[lanes] * scale[lanes], RHO_MIN, RHO_MAX)
            Kinv_l, rv_l = factor(rho_l, lanes)
            rho = rho.index_copy(0, lanes, rho_l)
            rv = rv.index_copy(0, lanes, rv_l)
            Kinv = Kinv.index_copy(0, lanes, Kinv_l)

    # unscale the solution
    out = lambda a, tail: a.reshape(batch + tail)
    return QPSolution(x=out(D * x, (n,)), y=out(E * y / c, (m,)),
                      z=out(z / E, (m,)), iters=out(it, ()),
                      pri_res=out(pri, ()), dua_res=out(dua, ()),
                      converged=out(done, ()))
