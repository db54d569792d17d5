"""Lane-major whole-body controller for a fleet.

Port of qrw_tpu/core/wbc_lane.py: task-space IK on the fixed-base model,
the 12-variable contact-force box QP and the feedforward torques, for a
whole fleet at once on the rbd_lane kernels. Same math and quirks as
the JAX package (contact Jacobians base-translation invariant, Y the
diagonal of the zero-configuration base inertia).

The box-QP ADMM (OSQP semantics: relaxation alpha, sigma-regularized
x-update, one uniform rho, residual-based rho adaptation, termination on
unscaled residuals) keeps the JAX package's update equations, but holds
its iterates as (B, 12) / (B, 20) tensors and solves the 12x12 KKT
system with a batched Cholesky factorization instead of unrolled scalar
lists: a handful of tensor ops per iteration instead of hundreds.

The boundary is batch-major (leading batch axis), as in the JAX module.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.wbc import (WBCResult, WBCState, base_inertia_diag,
                                    friction_generators)
from qrw_tpu_torch.ops import rbd_lane as rl
from qrw_tpu_torch.utils.profiling import count, host_read, span, spanned


class LaneQPSol(NamedTuple):
    x: torch.Tensor       # (B, 12)
    y: torch.Tensor       # (B, 20)
    iters: torch.Tensor   # (B,) int32


_G_CACHE: dict = {}


def _G(mu, dtype, device):
    key = (mu, dtype, str(device))
    if key not in _G_CACHE:
        _G_CACHE[key] = torch.as_tensor(friction_generators(mu),
                                        dtype=dtype, device=device)
    return _G_CACHE[key]


def _maxabs(a):
    return torch.amax(torch.abs(a), dim=-1)


@spanned("wbc.qp")
def wbc_qp_solve(cfg: Config, H, g, lo, hi, x0, y0, sigma: float = 1e-6,
                 alpha: float = 1.6, rho0: float = 0.1,
                 check_every: int = 25,
                 adapt_interval: int = 100) -> LaneQPSol:
    """min 1/2 x'Hx + g'x  s.t.  lo <= G x <= hi, for a batch.

    H (B, 12, 12); g (B, 12); lo/hi (B, 20); x0 (B, 12); y0 (B, 20).
    Termination at eps_abs / eps_rel = cfg.wbc_eps_*. Before each check
    round one host read of the batch's termination flags decides whether
    to stop."""
    B = g.shape[0]
    dtype, dev = g.dtype, g.device
    G = _G(cfg.mu, dtype, dev)                               # (20, 12)
    with host_read("wbc_qp_dG"):
        dG = torch.as_tensor([2.0, 2.0, 1.0 + 4.0 * cfg.mu ** 2] * 4,
                             dtype=dtype, device=dev)        # diag(G'G)
    eps_abs, eps_rel = cfg.wbc_eps_abs, cfg.wbc_eps_rel
    eye = torch.eye(12, dtype=dtype, device=dev)

    x, z, y = x0, x0 @ G.T, y0
    rho = torch.full((B,), rho0, dtype=dtype, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    def residuals(x, z, y):
        Gx = x @ G.T
        Hx = (H @ x[..., None])[..., 0]
        Gty = y @ G
        pri = _maxabs(Gx - z)
        dua = _maxabs(Hx + g + Gty)
        denom_p = torch.clamp(torch.maximum(_maxabs(Gx), _maxabs(z)),
                              min=1e-30)
        denom_d = torch.clamp(torch.maximum(
            torch.maximum(_maxabs(Hx), _maxabs(Gty)), _maxabs(g)),
            min=1e-30)
        return (pri, dua, eps_abs + eps_rel * denom_p,
                eps_abs + eps_rel * denom_d, denom_p, denom_d)

    n_checks = (cfg.wbc_max_iter + check_every - 1) // check_every
    adapt_mod = max(1, adapt_interval // check_every)
    chk = 0
    while chk < n_checks:
        with host_read("wbc_qp_done"):
            if bool(done.all()):
                break
        with span("wbc.qp.factor"):
            K = H + (sigma + rho[:, None] * dG)[:, :, None] * eye
            Lk = torch.linalg.cholesky_ex(K).L
        with span("wbc.qp.iterate"):
            keep = done[:, None]
            rr = rho[:, None]
            for _ in range(check_every):
                rhs = (sigma * x - g) + (rr * z - y) @ G
                xt = torch.cholesky_solve(rhs[..., None], Lk)[..., 0]
                zt = xt @ G.T
                xn = alpha * xt + (1 - alpha) * x
                z_rel = alpha * zt + (1 - alpha) * z
                zn = torch.minimum(torch.maximum(z_rel + y / rr, lo), hi)
                yn = y + rr * (z_rel - zn)
                x = torch.where(keep, x, xn)
                z = torch.where(keep, z, zn)
                y = torch.where(keep, y, yn)
            it = torch.where(done, it, it + check_every)
            pri, dua, eps_pri, eps_dua, denom_p, denom_d = residuals(x, z, y)
            done = done | ((pri <= eps_pri) & (dua <= eps_dua))
            if ((chk + 1) % adapt_mod) == 0:
                ratio = (pri / denom_p) / torch.clamp(dua / denom_d,
                                                      min=1e-30)
                scale = torch.sqrt(ratio)
                want = ((scale > 5.0) | (scale < 0.2)) & ~done
                rho = torch.where(want, torch.clamp(rho * scale, 1e-6, 1e6),
                                  rho)
        chk += 1
    count("wbc.qp_rounds", chk)
    return LaneQPSol(x=x, y=y, iters=it)


def _inv3(M):
    """Closed-form inverse of a general 3x3 nested-list matrix."""
    a, b, c = M[0]
    d, e, f = M[1]
    g, h, i = M[2]
    A11 = rl._add(rl._mul(e, i), rl._neg(rl._mul(f, h)))
    A12 = rl._add(rl._mul(c, h), rl._neg(rl._mul(b, i)))
    A13 = rl._add(rl._mul(b, f), rl._neg(rl._mul(c, e)))
    A21 = rl._add(rl._mul(f, g), rl._neg(rl._mul(d, i)))
    A22 = rl._add(rl._mul(a, i), rl._neg(rl._mul(c, g)))
    A23 = rl._add(rl._mul(c, d), rl._neg(rl._mul(a, f)))
    A31 = rl._add(rl._mul(d, h), rl._neg(rl._mul(e, g)))
    A32 = rl._add(rl._mul(b, g), rl._neg(rl._mul(a, h)))
    A33 = rl._add(rl._mul(a, e), rl._neg(rl._mul(b, d)))
    det = rl._add(rl._mul(a, A11), rl._mul(b, A21), rl._mul(c, A31))
    inv = 1.0 / det
    return [[rl._mul(inv, A11), rl._mul(inv, A12), rl._mul(inv, A13)],
            [rl._mul(inv, A21), rl._mul(inv, A22), rl._mul(inv, A23)],
            [rl._mul(inv, A31), rl._mul(inv, A32), rl._mul(inv, A33)]]


@spanned("wbc")
def compute_wbc_lane(cfg: Config, lane: rl.LaneModel, state: WBCState,
                     qj, b_v18, f_cmd, contacts, pgoals, vgoals,
                     agoals) -> WBCResult:
    """Batched WBC tick. Inputs batch-major: state leaves (B, ...),
    qj (B, 12), b_v18 (B, 18), f_cmd (B, 12), contacts (B, 4),
    pgoals/vgoals/agoals (B, 3, 4)."""
    B = qj.shape[0]
    dtype, dev = qj.dtype, qj.device

    def lq(x):
        return x.reshape(B, 4, 3).permute(1, 2, 0)

    def goals_t(x):
        return [x[:, i, :].T for i in range(3)]

    with span("wbc.ik"):
        qj_l = lq(qj)
        vj_l = lq(b_v18[:, 6:])
        cts = contacts.T                                     # (4, B)
        in_c = cts > 0

        ksc = (state.k_since_contact.T + cts) * cts

        # IK on the fixed-base model
        kin = rl.frame_kinematics(lane, rl.ZV3, rl.EYE3, qj_l, None, vj_l)
        J = rl.foot_jacobians(lane, kin, rl.EYE3, rl.ZV3)
        Jleg = J.Jleg

        pg, vg, ag = goals_t(pgoals), goals_t(vgoals), goals_t(agoals)
        perr = rl.vsub(pg, kin.pos)
        afeet = [cfg.kp_flyingfeet * perr[i]
                 - cfg.kd_flyingfeet * (kin.vel[i] - vg[i]) + ag[i]
                 for i in range(3)]
        afeet = [torch.where(in_c, 0.0, afeet[i]) - kin.drift[i]
                 for i in range(3)]

        Jinv = _inv3(Jleg)
        ddq_j = rl.mv(Jinv, afeet)
        dq_cmd = rl.mv(Jinv, vg)
        q_step = rl.mv(Jinv, perr)

    with span("wbc.qp_data"):
        # box QP data: A = Yinv X, gamma = Yinv (X f_cmd - rnea6)
        f_l = lq(f_cmd)
        Ff = [torch.where(in_c, f_l[:, i], 0.0) for i in range(3)]
        Xf_force = [Ff[i].sum(0) for i in range(3)]
        tq = rl.mtv(J.Jb_ang, Ff)
        Xf_torque = [rl._sum0(tq[i]) for i in range(3)]

        vlin = [b_v18[:, i] for i in range(3)]
        wvec = [b_v18[:, 3 + i] for i in range(3)]
        aj = torch.stack(ddq_j, dim=1)
        rnea_f, rnea_n, _ = rl.rnea(lane, rl.EYE3, qj_l, (vlin, wvec, vj_l),
                                    (rl.ZV3, rl.ZV3, aj), cfg.gravity)

        Yinv = 1.0 / base_inertia_diag()
        gam = [float(Yinv[i]) * (Xf_force[i] - rnea_f[i]) for i in range(3)] \
            + [float(Yinv[3 + i]) * (Xf_torque[i] - rnea_n[i])
               for i in range(3)]
        gam = torch.stack(gam, dim=1)                         # (B, 6)

        zero = torch.zeros(B, dtype=dtype, device=dev)
        cols = []
        for f in range(4):
            mask = in_c[f]
            for a in range(3):
                col = [torch.where(mask, float(Yinv[a]), 0.0).to(dtype)
                       if i == a else zero for i in range(3)]
                for i in range(3):
                    e = J.Jb_ang[a][i]
                    if isinstance(e, (int, float)):
                        col.append(zero + float(Yinv[3 + i]) * e)
                    else:
                        col.append(torch.where(mask, float(Yinv[3 + i]) * e[f],
                                               0.0))
                cols.append(torch.stack(col, dim=1))          # (B, 6)
        A = torch.stack(cols, dim=2)                          # (B, 6, 12)

        q1, q2 = cfg.wbc_q1, cfg.wbc_q2
        eye12 = torch.eye(12, dtype=dtype, device=dev)
        H = q1 * (A.transpose(1, 2) @ A) + q2 * eye12
        g_vec = q1 * (A.transpose(1, 2) @ gam[..., None])[..., 0]

        Gf = f_cmd @ _G(cfg.mu, dtype, dev).T                 # (B, 20)
    sol = wbc_qp_solve(cfg, H, g_vec, -Gf, cfg.fz_max - Gf, state.qp_x,
                       state.qp_y)
    with span("wbc.torques"):
        f_with_delta = f_cmd + sol.x
        ddq_delta = gam + (A @ sol.x[..., None])[..., 0]      # (B, 6)

        # feedforward torques
        _, _, tau_rnea = rl.rnea(
            lane, rl.EYE3, qj_l, (vlin, wvec, vj_l),
            ([ddq_delta[:, i] for i in range(3)],
             [ddq_delta[:, 3 + i] for i in range(3)], aj), cfg.gravity)
        fwd_l = lq(f_with_delta)
        Fm = [torch.where(in_c, fwd_l[:, i], 0.0) for i in range(3)]
        jf = rl.mtv(Jleg, Fm)
        tau_ff_l = tau_rnea - torch.stack(jf, dim=1)          # (4, 3, B)

        def bm(x):
            return x.permute(2, 0, 1).reshape(B, 12)

        def bm_vec(v):
            return bm(torch.stack(v, dim=1))

        new_state = WBCState(k_since_contact=ksc.T, qp_x=sol.x, qp_y=sol.y)
        feet_pos = torch.stack([p.T for p in kin.pos], dim=2)
        feet_vel = torch.stack([p.T for p in kin.vel], dim=2)
        ddq_cmd = torch.cat([ddq_delta, bm_vec(ddq_j)], dim=1)
        return WBCResult(
            qdes=qj + bm_vec(q_step), vdes=bm_vec(dq_cmd), tau_ff=bm(tau_ff_l),
            f_with_delta=f_with_delta, ddq_cmd=ddq_cmd, feet_pos=feet_pos,
            feet_vel=feet_vel, state=new_state, qp_iters=sol.iters)
