"""Centroidal convex MPC: condensed-QP assembly and the batched solvers.

Port of qrw_tpu/core/mpc.py: the warm-start state carried by
ControllerState, the constant cone matrix, the shared assembly of input
blocks and free response, the dense condensed-QP build (build_qp, G
materialized) and the per-problem solve_mpc of the single-robot
controller (ops/qp.solve with the cone structure), the structured build
(build_qp_compact), the support selection, the support-reduced QP
assembly (the shared proximal metric of core/mpc_lane.build_phase_data,
and the rescue stage's problems), recover_dx, solve_mpc_batch_reduced
with its warm carry (the solver of the rescue stage), and the full-size
batched path solve_mpc_batch_pallas with its warm carry MPCBatchState
and shift_warm_state.

States are eliminated analytically: dx = G f + h with
G[k, j] = A^(k-1-j) B_j and A^p = I + p dt E (E nilpotent), as in the
JAX package. The assembly takes one problem or a leading batch axis; the
fleet builds its phase-stage problems lane-major in core/mpc_lane.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.ops import qp
from qrw_tpu_torch.ops.rotations import skew
from qrw_tpu_torch.utils.profiling import host_read, span, spanned


@functools.lru_cache(maxsize=8)
def cone_matrix(n_steps: int, mu: float) -> np.ndarray:
    """(32N, 12N) constant constraint matrix: 20N friction rows over
    12N identity (activation) rows."""
    C = np.array([
        [1.0, 0.0, -mu],
        [-1.0, 0.0, -mu],
        [0.0, 1.0, -mu],
        [0.0, -1.0, -mu],
        [0.0, 0.0, -1.0],
    ])
    F = np.zeros((20 * n_steps, 12 * n_steps))
    for k in range(n_steps):
        for i in range(4):
            F[20 * k + 5 * i:20 * k + 5 * i + 5,
              12 * k + 3 * i:12 * k + 3 * i + 3] = C
    return np.vstack([F, np.eye(12 * n_steps)])


class MPCState(NamedTuple):
    """Warm-start carry of the per-problem MPC (ControllerState.mpc)."""
    f: torch.Tensor   # (..., 12N) previous force solution
    y: torch.Tensor   # (..., 32N) previous dual


def init_mpc_state(cfg: Config, dtype=torch.float32,
                   device="cpu") -> MPCState:
    return MPCState(
        f=torch.zeros(12 * cfg.n_steps, dtype=dtype, device=device),
        y=torch.zeros(32 * cfg.n_steps, dtype=dtype, device=device))


class MPCResult(NamedTuple):
    """One solve of the per-problem MPC."""
    x_f_applied: torch.Tensor  # (..., 24, N) predicted states then forces
    state: MPCState
    iters: torch.Tensor        # (...)
    converged: torch.Tensor    # (...)


def gait_from_fsteps(fsteps, n_steps: int):
    """(..., N, 4) contact flags from the footstep matrix (x == 0 is
    swing)."""
    return (fsteps[..., :n_steps, 0::3] != 0.0).to(fsteps.dtype)


def _assemble_common(cfg: Config, xref, fsteps):
    """Per-step input blocks Bl (..., N, 6, 12), free-response blocks
    hblk (..., N, 12), box bounds (l, u) and the lower-triangular
    helpers. xref (..., 12, N+1); fsteps (..., N_gait, 12)."""
    N = cfg.n_steps
    dt = cfg.dt_mpc
    dtype, dev = xref.dtype, xref.device
    bs = tuple(xref.shape[:-2])
    gait = gait_from_fsteps(fsteps, N)
    inf = float("inf")
    with host_read("mpc_constants"):
        gI = torch.as_tensor(np.asarray(cfg.gI).reshape(3, 3), dtype=dtype,
                             device=dev)
        com_z = torch.tensor([0.0, 0.0, cfg.offset_com_z], dtype=dtype,
                             device=dev)
        l_f = torch.tensor([-inf, -inf, -inf, -inf, -cfg.fz_max],
                           dtype=dtype, device=dev)
        gvec = torch.zeros(12, dtype=dtype, device=dev)
        gvec[8] = -cfg.gravity * dt         # a copy of the host scalar

    yaw = xref[..., 5, :N]
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    Rz = torch.stack([torch.stack([c, -s, z], -1),
                      torch.stack([s, c, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    RgIR = torch.einsum("...kji,jl,...klm->...kim", Rz, gI, Rz)
    with host_read("mpc_inv_info"):
        I_inv = torch.linalg.inv(RgIR)

    feet = fsteps[..., :N, :].reshape(bs + (N, 4, 3))
    com = xref[..., 0:3, :N].transpose(-1, -2) + com_z
    lever = feet - com[..., :, None, :]
    tor = dt * torch.einsum("...kab,...kibc->...kaic", I_inv, skew(lever))
    frc = (dt / cfg.mass) * torch.eye(3, dtype=dtype, device=dev)[
        :, None, :].expand(3, 4, 3)
    Bl = torch.cat([frc.expand(bs + (N, 3, 4, 3)), tor],
                   dim=-3).reshape(bs + (N, 6, 12))

    kk = torch.arange(N, device=dev)
    p = kk[:, None] - kk[None, :]
    mask = (p >= 0).to(dtype)

    xj = xref[..., :, :N].transpose(-1, -2)
    Axj = torch.cat([xj[..., 0:6] + dt * xj[..., 6:12], xj[..., 6:12]],
                    dim=-1)
    r = Axj + gvec - xref[..., :, 1:N + 1].transpose(-1, -2)
    rE = torch.cat([r[..., 6:12], torch.zeros_like(r[..., 6:12])], dim=-1)
    hblk = (mask[:, :, None] * (r[..., None, :, :]
                                + (p.to(dtype) * dt)[:, :, None]
                                * rE[..., None, :, :])).sum(dim=-2)

    l_f = l_f.repeat(4 * N).expand(bs + (20 * N,))
    u_f = torch.zeros(bs + (20 * N,), dtype=dtype, device=dev)
    contact = torch.repeat_interleave(gait.reshape(bs + (4 * N,)), 3, dim=-1)
    l_b = torch.where(contact > 0, -inf, 0.0).to(dtype)
    u_b = torch.where(contact > 0, inf, 0.0).to(dtype)
    return (Bl, hblk, torch.cat([l_f, l_b], dim=-1),
            torch.cat([u_f, u_b], dim=-1), mask, p)


def build_qp(cfg: Config, xref, fsteps):
    """Dense condensed QP from the planner outputs: xref (..., 12, N+1)
    reference states (column 0 the current state), fsteps (..., N_gait,
    12) footstep rows. Returns (H, qlin, l, u, G, h); dx = G f + h."""
    N = cfg.n_steps
    dt = cfg.dt_mpc
    dtype, dev = xref.dtype, xref.device
    bs = tuple(xref.shape[:-2])
    Bl, hblk, l, u, mask, p = _assemble_common(cfg, xref, fsteps)

    # row block k holds dx_{k+1} = sum_{j<=k} A^(k-j) (B_j f_j + r_j)
    top = (mask * p.to(dtype) * dt)[:, :, None, None] * Bl[..., None, :, :, :]
    bot = mask[:, :, None, None] * Bl[..., None, :, :, :]
    Gblk = torch.cat([top, bot], dim=-2)                 # (..., N, N, 12, 12)
    G = Gblk.transpose(-3, -2).reshape(bs + (12 * N, 12 * N))
    h = hblk.reshape(bs + (12 * N,))

    W = torch.as_tensor(np.tile(np.asarray(cfg.w_state), N), dtype=dtype,
                        device=dev)
    GW = G * W[:, None]
    H = G.transpose(-1, -2) @ GW + cfg.w_force * torch.eye(
        12 * N, dtype=dtype, device=dev)
    qlin = (GW.transpose(-1, -2) @ h[..., None])[..., 0]
    return H, qlin, l, u, G, h


def mpc_settings(cfg: Config) -> qp.QPSettings:
    """The reference's OSQP settings of the MPC (src/MPC.cpp:501-564)."""
    return qp.QPSettings(
        sigma=cfg.osqp_sigma, alpha=cfg.osqp_alpha, rho=cfg.osqp_rho,
        eps_abs=cfg.osqp_eps_abs, eps_rel=cfg.osqp_eps_rel,
        max_iter=cfg.mpc_max_iter,
        adaptive_rho_interval=cfg.osqp_adaptive_rho_interval,
        adaptive_rho_tolerance=cfg.osqp_adaptive_rho_tolerance)


def solve_mpc(cfg: Config, xref, fsteps, state: Optional[MPCState] = None,
              settings: Optional[qp.QPSettings] = None) -> MPCResult:
    """One MPC solve per problem (MPC::run): xref (..., 12, N+1), fsteps
    (..., N_gait, 12), state the previous solution (warm start). A
    leading batch axis solves each robot's problem on its own, as
    qrw_tpu's jax.vmap of this function does."""
    N = cfg.n_steps
    dtype, dev = xref.dtype, xref.device
    bs = tuple(xref.shape[:-2])
    if settings is None:
        settings = mpc_settings(cfg)
    H, qlin, l, u, G, h = build_qp(cfg, xref, fsteps)
    A = torch.as_tensor(cone_matrix(N, cfg.mu), dtype=dtype, device=dev)
    sol = qp.solve(H, qlin, A, l, u, settings,
                   x0=None if state is None else state.f,
                   y0=None if state is None else state.y,
                   cone=qp.ConeStructure(N, cfg.mu))
    dx = (G @ sol.x[..., None])[..., 0] + h
    states = dx.reshape(bs + (N, 12)).transpose(-1, -2) + xref[..., :, 1:N + 1]
    forces = sol.x.reshape(bs + (N, 12)).transpose(-1, -2)
    return MPCResult(x_f_applied=torch.cat([states, forces], dim=-2),
                     state=MPCState(f=sol.x, y=sol.y), iters=sol.iters,
                     converged=sol.converged)


@functools.lru_cache(maxsize=8)
def _h_coeffs(n_steps: int):
    """S0[j,l] = #{t >= max(j,l)} and S2[j,l] = sum_t (t-j)(t-l)."""
    N = n_steps
    j = np.arange(N)
    mx = np.maximum(j[:, None], j[None, :])
    S0 = (N - mx).astype(np.float64)
    t = np.arange(N)
    tj = (t[None, :] - j[:, None])
    mask = (t[None, :] >= mx[..., None])
    S2 = np.einsum("jlt,jt,lt->jl", mask, tj, tj)
    return S0, S2


def build_qp_compact(cfg: Config, xref, fsteps):
    """Structured condensed-QP build: H (12N, 12N) from two einsums of
    the input blocks with the closed-form coefficients of _h_coeffs, and
    qlin = G' W h, without materializing G. xref (..., 12, N+1); fsteps
    (..., N_gait, 12); every output takes the leading batch axes.
    Returns (H, qlin, l, u, Bl, h); recover_dx(cfg, Bl, x, h) gives the
    state response."""
    N = cfg.n_steps
    dt = cfg.dt_mpc
    dtype, dev = xref.dtype, xref.device
    bs = tuple(xref.shape[:-2])
    Bl, hblk, l, u, mask, p = _assemble_common(cfg, xref, fsteps)
    S0, S2 = _h_coeffs(N)
    with host_read("mpc_weights"):
        w = torch.as_tensor(cfg.w_state, dtype=dtype, device=dev)
        S0 = torch.as_tensor(S0, dtype=dtype, device=dev)
        S2 = torch.as_tensor(S2, dtype=dtype, device=dev)
    wtop, wbot = w[0:6], w[6:12]
    M1 = torch.einsum("...jai,a,...lak->...jlik", Bl, wtop, Bl)
    M2 = torch.einsum("...jai,a,...lak->...jlik", Bl, wbot, Bl)
    Hblk = (dt * dt) * S2[:, :, None, None] * M1 \
        + S0[:, :, None, None] * M2                      # (..., N, N, 12, 12)
    H = Hblk.transpose(-3, -2).reshape(bs + (12 * N, 12 * N))
    H = H + cfg.w_force * torch.eye(12 * N, dtype=dtype, device=dev)

    htop_w = wtop * hblk[..., 0:6]                        # (..., N, 6)
    hbot_w = wbot * hblk[..., 6:12]
    pm = mask.T * p.T.to(dtype)                           # (j, t): (t-j)+
    T1 = pm @ htop_w
    T2 = mask.T @ hbot_w
    qlin = torch.einsum("...jai,...ja->...ji", Bl,
                        dt * T1 + T2).reshape(bs + (12 * N,))
    return H, qlin, l, u, Bl, hblk.reshape(bs + (12 * N,))


def support_indices(stance_flat, cap: int):
    """Up to `cap` stance (step, foot) pairs of the (..., 4N) stance mask
    in (step, foot) order; tail indices point at swing pairs and are
    masked by `valid`."""
    key = torch.where(stance_flat, 0, 1)
    order = torch.argsort(key, dim=-1, stable=True)
    idx = order[..., :cap]
    return idx, torch.gather(stance_flat, -1, idx)


def build_qp_reduced(cfg: Config, xref, fsteps, cap: int):
    """Support-reduced condensed QP at the stance pairs: H_r (3cap,
    3cap), q_r (3cap), plus (Bl, h, idx, valid). xref (12, N+1) and
    fsteps (N_gait, 12) give one problem; with a leading batch axis,
    (B, 12, N+1) and (B, N_gait, 12), every output gains it."""
    if xref.dim() == 2:
        return tuple(o[0] for o in build_qp_reduced(cfg, xref[None],
                                                    fsteps[None], cap))
    N = cfg.n_steps
    dt = cfg.dt_mpc
    dtype, dev = xref.dtype, xref.device
    B = xref.shape[0]
    Bl, hblk, _, _, mask, p = _assemble_common(cfg, xref, fsteps)
    gait = gait_from_fsteps(fsteps, N)
    idx, valid = support_indices(gait.reshape(B, 4 * N) > 0, cap)
    step = idx // 4
    foot = idx % 4
    bi = torch.arange(B, device=dev)[:, None]
    BlS = Bl.reshape(B, N, 6, 4, 3)[bi, step, :, foot, :]  # (B, cap, 6, 3)

    S0, S2 = _h_coeffs(N)
    with host_read("mpc_weights"):
        w = torch.as_tensor(cfg.w_state, dtype=dtype, device=dev)
        S0 = torch.as_tensor(S0, dtype=dtype, device=dev)
        S2 = torch.as_tensor(S2, dtype=dtype, device=dev)
    wtop, wbot = w[0:6], w[6:12]
    S0g = S0[step[:, :, None], step[:, None, :]]            # (B, cap, cap)
    S2g = S2[step[:, :, None], step[:, None, :]]
    M1 = torch.einsum("bsai,a,btak->bstik", BlS, wtop, BlS)
    M2 = torch.einsum("bsai,a,btak->bstik", BlS, wbot, BlS)
    Hblk = (dt * dt) * S2g[..., None, None] * M1 \
        + S0g[..., None, None] * M2
    H_r = Hblk.permute(0, 1, 3, 2, 4).reshape(B, 3 * cap, 3 * cap)
    vm3 = torch.repeat_interleave(valid.to(dtype), 3, dim=1)
    H_r = H_r * vm3[:, :, None] * vm3[:, None, :]
    H_r = H_r + torch.diag_embed(cfg.w_force * vm3 + (1.0 - vm3))

    htop_w = wtop * hblk[..., 0:6]
    hbot_w = wbot * hblk[..., 6:12]
    pm = mask.T * p.T.to(dtype)
    g = (dt * (pm @ htop_w) + mask.T @ hbot_w)[bi, step]   # (B, cap, 6)
    q_r = torch.einsum("bsai,bsa->bsi", BlS, g).reshape(B, 3 * cap) * vm3
    return H_r, q_r, Bl, hblk.reshape(B, 12 * N), idx, valid


def recover_dx(cfg: Config, Bl, x, h):
    """dx = G x + h without materializing G: cumulative sums over the
    block-lower-triangular structure. Bl (..., N, 6, 12); x, h
    (..., 12N)."""
    N = cfg.n_steps
    dt = cfg.dt_mpc
    bs = tuple(x.shape[:-1])
    s = torch.einsum("...jai,...ji->...ja", Bl, x.reshape(bs + (N, 12)))
    cum = torch.cumsum(s, dim=-2)
    j = torch.arange(N, dtype=x.dtype, device=x.device)[:, None]
    cum_js = torch.cumsum(j * s, dim=-2)
    top = dt * (j * cum - cum_js)
    dx = torch.cat([top, cum], dim=-1) + h.reshape(bs + (N, 12))
    return dx.reshape(bs + (12 * N,))


class MPCWarmState(NamedTuple):
    """Warm carry of the support-reduced batched MPC in the FULL layout,
    valid across stance-set changes: forces (B, 12N), cone-row duals
    (B, 20N), adapted rho (B, 1). No factorization is carried: the
    reduced problem is refactored every call."""
    f: torch.Tensor
    y: torch.Tensor
    rho: torch.Tensor


def init_warm_state(cfg: Config, batch: int, dtype=torch.float32,
                    device="cuda") -> MPCWarmState:
    N = cfg.n_steps
    kw = dict(dtype=dtype, device=device)
    return MPCWarmState(f=torch.zeros((batch, 12 * N), **kw),
                        y=torch.zeros((batch, 20 * N), **kw),
                        rho=torch.full((batch, 1), 0.1, **kw))


def shift_warm_state_reduced(state: MPCWarmState,
                             n_steps: int) -> MPCWarmState:
    """Advance the full-layout warm carry one MPC step (gait roll)."""
    return state._replace(f=torch.roll(state.f, -12, dims=1),
                          y=torch.roll(state.y, -20, dims=1))


def reduced_constraints(cfg: Config, cap: int, batch: int, device):
    """The support-reduced QP's constraints: the cone structure, its
    shared matrix A = I (x) C (5cap, 3cap) and the bounds l, u
    (batch, 5cap) of the friction pyramid and the normal-force cap."""
    f32 = torch.float32
    cone = qp.ReducedConeStructure(cap, cfg.mu)
    A = cone.matrix()
    with host_read("mpc_cone"):
        A = torch.as_tensor(A, dtype=f32, device=device)
        l = torch.tensor([-np.inf, -np.inf, -np.inf, -np.inf, -cfg.fz_max],
                         dtype=f32, device=device)
    l = l.repeat(cap).expand(batch, 5 * cap).contiguous()
    u = torch.zeros((batch, 5 * cap), dtype=f32, device=device)
    return cone, A, l, u


@spanned("reduced")
def solve_mpc_batch_reduced(cfg: Config, xrefs, fsteps,
                            state: Optional[MPCWarmState] = None,
                            settings: Optional[qp.QPSettings] = None,
                            schedule=None, tile: int = 64,
                            shift: bool = False, cap: int = None,
                            early_exit: bool = False):
    """Batched MPC solve on the support-reduced QP through
    ops/qp_pallas (kernel K2 on CUDA tensors).

    xrefs (B, 12, N+1); fsteps (B, N_gait, 12); the device of xrefs is
    where it runs. cap = stance-pair capacity (2N for a trot); problems
    with more stance pairs are flagged in `ok`. Every call re-runs Ruiz
    and a fresh batched Cholesky; the carry is (f, y, rho) in full
    layout, and a warm call defaults to one 50-iteration round.
    shift=True advances the carry one MPC step first. Returns
    (x_f_applied (B, 24, N), new_state, sol, ok (B,))."""
    from qrw_tpu_torch.ops import qp_pallas
    N = cfg.n_steps
    if cap is None:
        cap = 2 * N
    dtype = torch.float32
    dev = xrefs.device
    if settings is None:
        settings = qp.QPSettings(
            sigma=cfg.osqp_sigma, alpha=cfg.osqp_alpha, rho=cfg.osqp_rho,
            eps_abs=1e-4, eps_rel=1e-4, max_iter=cfg.mpc_max_iter,
            adaptive_rho_interval=cfg.osqp_adaptive_rho_interval,
            adaptive_rho_tolerance=cfg.osqp_adaptive_rho_tolerance)
    with span("reduced.build"):
        xrefs = xrefs.to(dtype)
        fsteps = fsteps.to(dtype)
        H_r, q_r, Bl, h, idx, valid = build_qp_reduced(cfg, xrefs, fsteps, cap)
        B = H_r.shape[0]
        vidx = (3 * idx[:, :, None]
                + torch.arange(3, device=dev)).reshape(B, 3 * cap)
        ridx = (5 * idx[:, :, None]
                + torch.arange(5, device=dev)).reshape(B, 5 * cap)
        vm3 = torch.repeat_interleave(valid.to(dtype), 3, dim=1)
        rm5 = torch.repeat_interleave(valid.to(dtype), 5, dim=1)
        ok = gait_from_fsteps(fsteps, N).reshape(B, -1).sum(dim=1) <= cap

        cone, A_r, l_r, u_r = reduced_constraints(cfg, cap, B, dev)

        kw = {}
        if state is not None:
            if shift:
                state = shift_warm_state_reduced(state, N)
            kw = dict(x0=torch.gather(state.f, 1, vidx) * vm3,
                      y0=torch.gather(state.y, 1, ridx) * rm5,
                      rho_init=state.rho)
            if schedule is None:
                schedule = [50]
    sol = qp_pallas.solve(H_r, q_r, A_r, l_r, u_r, settings, tile=tile,
                          schedule=schedule, cone=cone,
                          early_exit=early_exit, **kw)

    with span("reduced.plan"):
        zeros = lambda k: torch.zeros((B, k * N), dtype=dtype, device=dev)
        f_full = zeros(12).scatter(1, vidx, sol.x * vm3)
        y_full = zeros(20).scatter(1, ridx, sol.y * rm5)
        dx = recover_dx(cfg, Bl, f_full, h)
        states = dx.reshape(B, N, 12).transpose(1, 2) + xrefs[:, :, 1:N + 1]
        forces = f_full.reshape(B, N, 12).transpose(1, 2)
        x_f = torch.cat([states, forces], dim=1)               # (B, 24, N)
        return x_f, MPCWarmState(f=f_full, y=y_full, rho=sol.rho), sol, ok


class MPCBatchState(NamedTuple):
    """Warm carry of the full-size batched MPC: previous primal / dual,
    adapted rho, the reusable Ruiz preconditioner and the last K^-1 (the
    seed of the Newton-Schulz warm refactorization) with the rho it was
    factored at."""
    f: torch.Tensor            # (B, 12N)
    y: torch.Tensor            # (B, 32N)
    rho: torch.Tensor          # (B, 1)
    D: torch.Tensor            # (B, 12N)
    E: torch.Tensor            # (B, 32N)
    c: torch.Tensor            # (B, 1)
    kinv: torch.Tensor         # (B, 12N, 12N)
    kinv_rho: torch.Tensor     # (B, 1)


def shift_warm_state(state: MPCBatchState, n_steps: int) -> MPCBatchState:
    """Advance the full-size warm carry one MPC step (gait roll): the
    primal by 12 a step, the cone duals by 20 and the identity-row duals
    by 12, and K^-1 by 12 on both axes."""
    mc = 20 * n_steps
    y_cone = torch.roll(state.y[:, :mc], -20, dims=1)
    y_id = torch.roll(state.y[:, mc:], -12, dims=1)
    return state._replace(
        f=torch.roll(state.f, -12, dims=1),
        y=torch.cat([y_cone, y_id], dim=1),
        kinv=torch.roll(state.kinv, (-12, -12), dims=(1, 2)))


@spanned("fullsize")
def solve_mpc_batch_pallas(cfg: Config, xrefs, fsteps,
                           state: Optional[MPCBatchState] = None,
                           settings: Optional[qp.QPSettings] = None,
                           schedule=None, tile: int = 16,
                           shift: bool = False, refactor: str = None):
    """Batched MPC solve on the full-size condensed QP (n = 12N,
    m = 32N, A the constant cone matrix) through ops/qp_pallas (kernels
    K2 and K3 on CUDA tensors).

    xrefs (B, 12, N+1); fsteps (B, N_gait, 12); the device of xrefs is
    where it runs. A cold call (state None) runs Ruiz and the default
    rho-adaptation schedule. A warm call reuses the preconditioner, rho
    and K^-1 of `state` and defaults to one 100-iteration round; shift
    advances the carry one MPC step first. `refactor` is the K^-1 policy
    of a warm call (ops/qp_pallas.solve): "chol" after a shift, "stale"
    otherwise, unless given. `tile` is accepted for the JAX package's
    signature and not used: K2 takes one block per problem (its cone
    variant, which this path runs, 4n threads with K^-1 in registers) and
    K3 one block per problem. Returns
    (x_f_applied (B, 24, N), new_state, sol)."""
    from qrw_tpu_torch.ops import qp_pallas
    N = cfg.n_steps
    dtype = torch.float32
    dev = xrefs.device
    if settings is None:
        settings = qp.QPSettings(
            sigma=cfg.osqp_sigma, alpha=cfg.osqp_alpha, rho=cfg.osqp_rho,
            eps_abs=1e-4, eps_rel=1e-4, max_iter=cfg.mpc_max_iter,
            adaptive_rho_interval=cfg.osqp_adaptive_rho_interval,
            adaptive_rho_tolerance=cfg.osqp_adaptive_rho_tolerance)
    with span("fullsize.build"):
        H, qlin, l, u, Bl, h = build_qp_compact(cfg, xrefs.to(dtype),
                                                fsteps.to(dtype))
        A = cone_matrix(N, cfg.mu)
        with host_read("mpc_cone"):
            A = torch.as_tensor(A, dtype=dtype, device=dev)
        cone = qp.ConeStructure(N, cfg.mu)
        kw = {}
        if state is not None:
            if shift:
                state = shift_warm_state(state, N)
            if refactor is None:
                refactor = "chol" if shift else "stale"
            kw = dict(x0=state.f, y0=state.y, rho_init=state.rho,
                      precond=(state.D, state.E, state.c),
                      kinv_init=state.kinv, kinv_rho=state.kinv_rho,
                      refactor=refactor)
            if schedule is None:
                schedule = [100]
    sol = qp_pallas.solve(H, qlin, A, l, u, settings, tile=tile,
                          schedule=schedule, cone=cone, **kw)
    with span("fullsize.plan"):
        B = H.shape[0]
        dx = recover_dx(cfg, Bl, sol.x, h)
        states = dx.reshape(B, N, 12).transpose(1, 2) + xrefs[:, :, 1:N + 1]
        forces = sol.x.reshape(B, N, 12).transpose(1, 2)
        x_f = torch.cat([states, forces], dim=1)                 # (B, 24, N)
        D, E, c = sol.precond
        new_state = MPCBatchState(f=sol.x, y=sol.y, rho=sol.rho, D=D, E=E, c=c,
                                  kinv=sol.kinv, kinv_rho=sol.kinv_rho)
        return x_f, new_state, sol
