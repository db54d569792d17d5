"""The centroidal MPC's quadratic program, built and solved from scratch.

The controller's MPC (the reference controller's src/MPC.cpp, condensed
as in its derivation note) predicts N steps of the base state
x = [position, roll-pitch-yaw, linear velocity, angular velocity] under

    x_{k+1} = A x_k + B_k f_k + g,   A = [[I, dt I], [0, I]],

where f_k holds the 3D ground forces of the four feet at step k,
B_k maps them to velocity increments (dt / m for the linear rows,
dt I_k^-1 [lever]x for the angular ones, I_k = Rz(yaw_k)' gI Rz(yaw_k)
and lever = foot - (com + [0, 0, offset_com_z])), and g adds gravity.
With e_k = x_k - xref_k and e_0 = 0, it minimises

    sum_{k=1..N} e_k' W e_k + w_force sum_k |f_k|^2

subject to, for a foot in stance at step k (its footstep's x is
nonzero), the friction pyramid |fx| <= mu fz, |fy| <= mu fz and
0 <= fz <= fz_max; a foot in swing carries no force.

`solve` finds the optimum of each problem with a primal-dual
interior-point method in float64. `plan` turns forces into the
(24, N) plan the controller ships: predicted states, then forces.
`judge` holds a plan to its problem's optimum; `control_plans` is the
reference at TF32 precision, the control of that comparison.
"""

from __future__ import annotations

import math

import torch

f64 = torch.float64


def _rz(yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def dynamics(ctrl: dict, xref, fsteps):
    """Per-step input matrices B (P, N, 12, 12) and the free response of
    the error e (P, N, 12) with zero forces, from xref (P, 12, N+1) and
    fsteps (P, N_gait, 12), in the dtype of xref."""
    N = xref.shape[-1] - 1
    dt = float(ctrl["dt_mpc"])
    dt_ = xref.dtype
    dev = xref.device
    P = xref.shape[0]
    gI = torch.tensor(ctrl["gI"], dtype=dt_, device=dev).reshape(3, 3)
    Rz = _rz(xref[:, 5, :N])                                  # (P, N, 3, 3)
    I_k = Rz.transpose(-1, -2) @ gI @ Rz
    I_inv = torch.linalg.inv(I_k)
    feet = fsteps[:, :N, :].reshape(P, N, 4, 3)
    com = xref[:, 0:3, :N].transpose(1, 2) + torch.tensor(
        [0.0, 0.0, float(ctrl["offset_com_z"])], dtype=dt_, device=dev)
    lever = feet - com[:, :, None, :]
    Bm = torch.zeros((P, N, 12, 12), dtype=dt_, device=dev)
    for i in range(4):
        Bm[:, :, 6:9, 3 * i:3 * i + 3] = (dt / float(ctrl["mass"])) * \
            torch.eye(3, dtype=dt_, device=dev)
        Bm[:, :, 9:12, 3 * i:3 * i + 3] = dt * (I_inv @ _skew(lever[:, :, i]))
    A = torch.eye(12, dtype=dt_, device=dev)
    A[0:6, 6:12] = dt * torch.eye(6, dtype=dt_, device=dev)
    g = torch.zeros(12, dtype=dt_, device=dev)
    g[8] = -float(ctrl["gravity"]) * dt
    xs = xref.transpose(1, 2)                                 # (P, N+1, 12)
    r = xs[:, :N] @ A.T + g - xs[:, 1:]                       # (P, N, 12)
    return A, Bm, r


def stance(fsteps, N):
    """(P, N, 4) bool: the foot is in stance at the step."""
    return fsteps[:, :N, 0::3] != 0.0


def build(ctrl: dict, xref, fsteps):
    """The condensed problem of each of P MPCs: e = G f + h stacked over
    the N steps, H = G'WG + w_force I, q = G'W h, the inequality rows
    C f <= d (six a stance foot: four pyramid faces, fz >= 0 and
    fz <= fz_max) and the stance mask. Swing variables are decoupled
    (unit curvature, zero linear term, no rows), so their optimum is 0."""
    dt_, dev = xref.dtype, xref.device
    P = xref.shape[0]
    N = xref.shape[-1] - 1
    n = 12 * N
    A, Bm, r = dynamics(ctrl, xref, fsteps)
    G = torch.zeros((P, n, n), dtype=dt_, device=dev)
    h = torch.zeros((P, n), dtype=dt_, device=dev)
    Apow = [torch.eye(12, dtype=dt_, device=dev)]
    for _ in range(N):
        Apow.append(A @ Apow[-1])
    e = torch.zeros((P, 12), dtype=dt_, device=dev)
    for k in range(N):
        e = e @ A.T + r[:, k]
        h[:, 12 * k:12 * k + 12] = e
        for j in range(k + 1):
            G[:, 12 * k:12 * k + 12, 12 * j:12 * j + 12] = Apow[k - j] @ Bm[:, j]
    W = torch.tensor(ctrl["w_state"], dtype=dt_, device=dev).repeat(N)
    GW = G * W[None, :, None]
    H = G.transpose(1, 2) @ GW + float(ctrl["w_force"]) * torch.eye(
        n, dtype=dt_, device=dev)
    q = (GW.transpose(1, 2) @ h[..., None])[..., 0]
    st = stance(fsteps, N).reshape(P, 4 * N)
    sv = st.repeat_interleave(3, dim=1)                       # (P, n)
    H = torch.where(sv[:, :, None] & sv[:, None, :], H, 0.0)
    H = H + torch.diag_embed((~sv).to(dt_))
    q = torch.where(sv, q, 0.0)
    mu, fz_max = float(ctrl["mu"]), float(ctrl["fz_max"])
    blk = torch.tensor([[1.0, 0.0, -mu], [-1.0, 0.0, -mu], [0.0, 1.0, -mu],
                        [0.0, -1.0, -mu], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]],
                       dtype=dt_, device=dev)
    C = torch.zeros((P, 6 * 4 * N, n), dtype=dt_, device=dev)
    for s in range(4 * N):
        C[:, 6 * s:6 * s + 6, 3 * s:3 * s + 3] = blk
    d = torch.zeros(6 * 4 * N, dtype=dt_, device=dev)
    d[5::6] = fz_max
    rows = st.repeat_interleave(6, dim=1)
    C = torch.where(rows[:, :, None], C, 0.0)
    d = torch.where(rows, d, 1.0)
    return dict(H=H, q=q, C=C, d=d, G=G, h=h, stance=st)


def solve(qp: dict, iters: int = 60, tol: float = None):
    """Primal-dual interior-point solve of min 1/2 f'Hf + q'f s.t.
    C f <= d for each problem. Stops at `tol` (default: 1e-11 in
    float64, 1e-6 below). Returns (f, max residual)."""
    if tol is None:
        tol = 1e-11 if qp["H"].dtype == f64 else 1e-6
    H, q, C, d = qp["H"], qp["q"], qp["C"], qp["d"]
    P, m, n = C.shape
    dt_ = H.dtype
    f = torch.zeros((P, n), dtype=dt_, device=H.device)
    s = torch.ones((P, m), dtype=dt_, device=H.device)
    lam = torch.ones((P, m), dtype=dt_, device=H.device)
    Ct = C.transpose(1, 2)
    scale = 1.0 + q.abs().amax(dim=1, keepdim=True)
    res = math.inf
    for _ in range(iters):
        rd = (H @ f[..., None])[..., 0] + q + (Ct @ lam[..., None])[..., 0]
        rp = (C @ f[..., None])[..., 0] + s - d
        mu = (s * lam).mean(dim=1, keepdim=True)
        res = float(torch.max((rd.abs() / scale).amax(),
                              torch.max(rp.abs().amax(), mu.amax())))
        if res < tol:
            break
        D = lam / s
        sig = 0.1 * mu
        K = H + Ct @ (D[..., None] * C)
        rhs = -rd - (Ct @ (D * rp + (sig - s * lam) / s)[..., None])[..., 0]
        L, info = torch.linalg.cholesky_ex(K)
        if bool(info.any()):
            break       # the precision's reach (only below float64)
        df = torch.cholesky_solve(rhs[..., None], L)[..., 0]
        dlam = D * ((C @ df[..., None])[..., 0] + rp) + (sig - s * lam) / s
        ds = -(C @ df[..., None])[..., 0] - rp
        # fraction to the boundary
        a_s = torch.where(ds < 0, -s / ds, torch.full_like(s, math.inf))
        a_l = torch.where(dlam < 0, -lam / dlam, torch.full_like(s, math.inf))
        a = torch.clamp(0.99 * torch.minimum(a_s.amin(1), a_l.amin(1)),
                        max=1.0)[:, None]
        f = f + a * df
        s = s + a * ds
        lam = lam + a * dlam
    return f, res


def plan(qp: dict, xref, f):
    """(P, 24, N): the predicted states of forces f (P, 12N), then f."""
    P = xref.shape[0]
    N = xref.shape[-1] - 1
    e = (qp["G"] @ f[..., None])[..., 0] + qp["h"]
    states = e.reshape(P, N, 12).transpose(1, 2) + xref[:, :, 1:]
    return torch.cat([states, f.reshape(P, N, 12).transpose(1, 2)], dim=1)


def judge(ctrl: dict, xref, fsteps, have, block: int = 256) -> dict:
    """How far the plans `have` (P, 24, N) of P problems are from their
    problems' optimum, in float64:

    cost_gap: |J(f) - J*| / |J*| of the plan's forces f, J the QP's
        objective and J* the optimum's;
    grad_gap: |H (f - f*)| / |q| (largest entries): how far the
        objective's gradient at f lies from the optimum's, first order in
        an error of the problem's data where the cost gap is second;
    plan_gap: the largest gap between the plan's states and the states
        that its own forces predict from xref (units of the state).
    """
    cost = pgap = grad = 0.0
    for i in range(0, xref.shape[0], block):
        xr = xref[i:i + block].to(f64)
        fs = fsteps[i:i + block].to(f64)
        hv = have[i:i + block].to(f64)
        P, N = xr.shape[0], xr.shape[-1] - 1
        qp = build(ctrl, xr, fs)
        f_opt, _ = solve(qp)
        f = hv[:, 12:].transpose(1, 2).reshape(P, 12 * N)

        def J(x):
            return 0.5 * (x[:, None, :] @ qp["H"] @ x[:, :, None])[:, 0, 0] \
                + (qp["q"] * x).sum(1)
        j_opt = J(f_opt)
        cost = max(cost, float(((J(f) - j_opt).abs()
                                / j_opt.abs().clamp(min=1e-12)).max()))
        g = ((qp["H"] @ (f - f_opt)[..., None])[..., 0]).abs().amax(1)
        grad = max(grad, float((g / qp["q"].abs().amax(1)
                                .clamp(min=1e-12)).max()))
        pgap = max(pgap, float((plan(qp, xr, f)[:, :12] - hv[:, :12])
                               .abs().max()))
    return {"cost_gap": cost, "grad_gap": grad, "plan_gap": pgap}


def control_plans(ctrl: dict, xref, fsteps, block: int = 256):
    """The control: the reference itself computed at TF32 precision (every
    operand rounded to TF32's 10-bit mantissa, float32 arithmetic, the
    interior-point method stopped at float32's reach)."""
    out = []
    for i in range(0, xref.shape[0], block):
        xr, fs = tf32(xref[i:i + block]), tf32(fsteps[i:i + block])
        qp = build(ctrl, xr, fs)
        qp = {k: tf32(v) if v.is_floating_point() else v
              for k, v in qp.items()}
        f, _ = solve(qp)
        out.append(tf32(plan(qp, xr, tf32(f))))
    return torch.cat(out)


def tf32(x):
    """x rounded to TF32's 10-bit mantissa (to nearest), as float32."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)
