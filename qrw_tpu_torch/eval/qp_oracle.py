"""Independent dense QP oracle for validating the ADMM solver.

A float64 numpy Mehrotra-style primal-dual interior-point method for
    min 1/2 x'Px + q'x   s.t.   l <= Ax <= u
playing the role OSQP plays for the reference (an independent solver the
JAX kernels are checked against). Two-sided rows are split into one-sided
inequalities; equality rows (l == u) get an explicit multiplier block.
Accuracy is verified by KKT residuals, so trust in this oracle does not
rest on its implementation details.
"""

from __future__ import annotations

import numpy as np

LOOSE = 1e18


def solve_qp_oracle(P, q, A, l, u, tol=1e-10, max_iter=100):
    P, q, A = np.asarray(P, float), np.asarray(q, float), np.asarray(A, float)
    l, u = np.asarray(l, float), np.asarray(u, float)
    n = q.size

    eq = (u - l) < 1e-12
    E = A[eq]
    e = u[eq]
    rows = []
    rhs = []
    for i in np.nonzero(~eq)[0]:
        if u[i] < LOOSE:
            rows.append(A[i]); rhs.append(u[i])
        if l[i] > -LOOSE:
            rows.append(-A[i]); rhs.append(-l[i])
    G = np.array(rows) if rows else np.zeros((0, n))
    h = np.array(rhs) if rhs else np.zeros(0)
    mi, me = G.shape[0], E.shape[0]

    # strictly feasible-ish start
    x = np.zeros(n)
    s = np.maximum(h - G @ x, 1.0)
    zi = np.ones(mi)
    y = np.zeros(me)

    for _ in range(max_iter):
        r_dual = P @ x + q + G.T @ zi + E.T @ y
        r_pri = G @ x + s - h
        r_eq = E @ x - e
        mu = s @ zi / max(mi, 1)
        if (np.linalg.norm(r_dual, np.inf) < tol
                and np.linalg.norm(r_pri, np.inf) < tol
                and (me == 0 or np.linalg.norm(r_eq, np.inf) < tol)
                and mu < tol):
            break

        # Newton system via block elimination: dz = (Sigma)(G dx + r terms)
        Sinv_z = zi / s
        H = P + G.T @ (Sinv_z[:, None] * G)
        # assemble KKT with equality block
        KKT = np.zeros((n + me, n + me))
        KKT[:n, :n] = H
        KKT[:n, n:] = E.T
        KKT[n:, :n] = E

        def newton(sig):
            r_cent = zi * s - sig * mu
            rhs1 = -(r_dual + G.T @ (Sinv_z * r_pri - r_cent / s))
            rhs = np.concatenate([rhs1, -r_eq])
            sol = np.linalg.solve(KKT + 1e-14 * np.eye(n + me), rhs)
            dx = sol[:n]
            dy = sol[n:]
            ds = -(r_pri + G @ dx)
            dz = -(r_cent / s) - Sinv_z * ds
            return dx, dy, ds, dz

        # predictor
        dx, dy, ds, dz = newton(0.0)

        def max_step(v, dv):
            neg = dv < 0
            if not np.any(neg):
                return 1.0
            return min(1.0, np.min(-v[neg] / dv[neg]))

        a_p = max_step(s, ds)
        a_d = max_step(zi, dz)
        mu_aff = ((s + a_p * ds) @ (zi + a_d * dz)) / max(mi, 1)
        sigma = (mu_aff / max(mu, 1e-300)) ** 3 if mi else 0.0

        # corrector (centering + Mehrotra second-order term folded into rc)
        r_cent = zi * s + ds * dz - sigma * mu
        rhs1 = -(r_dual + G.T @ (Sinv_z * r_pri - r_cent / s))
        sol = np.linalg.solve(KKT + 1e-14 * np.eye(n + me),
                              np.concatenate([rhs1, -r_eq]))
        dx = sol[:n]
        dy = sol[n:]
        ds = -(r_pri + G @ dx)
        dz = -(r_cent / s) - Sinv_z * ds

        a = 0.99 * min(max_step(s, ds), max_step(zi, dz))
        x += a * dx
        y += a * dy
        s += a * ds
        zi += a * dz

    return x


def kkt_error(P, q, A, l, u, x, tol_act=1e-7):
    """Max KKT violation of x for the two-sided QP (stationarity is checked
    with the best least-squares multipliers on the active set)."""
    P, q, A = np.asarray(P, float), np.asarray(q, float), np.asarray(A, float)
    Ax = A @ x
    viol = np.maximum(Ax - u, 0) + np.maximum(l - Ax, 0)
    act = (Ax > u - tol_act) | (Ax < l + tol_act)
    grad = P @ x + q
    if np.any(act):
        lam, *_ = np.linalg.lstsq(A[act].T, -grad, rcond=None)
        stat = np.linalg.norm(grad + A[act].T @ lam, np.inf)
    else:
        stat = np.linalg.norm(grad, np.inf)
    return max(np.max(viol), stat)
