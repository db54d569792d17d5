"""Lane-major (batch-on-last-axis) MPC pipeline around ops/qp_phase.

Port of qrw_tpu/core/mpc_lane.py: problem assembly, the cyclic phase
sets of the steady gaits, the host-built phase structure (metric
inverses in float64), the warm carry with its gait-roll shift, the
support guard, the capacity-bounded rescue stage (core/mpc's
support-reduced solver, kernel K2 on the card), the stale-plan fallback
and `solve_mpc_batch_phase`.

The batch must be PHASE-SORTED: each `tile` of consecutive problems
shares one stance support (one phase class).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.ops import qp, qp_phase
from qrw_tpu_torch.utils.profiling import (active, count, host_read, span,
                                          spanned)

f32 = torch.float32


def assemble_lane(cfg: Config, xrefs, fsteps):
    """Per-step input blocks and free response, lane-major.

    xrefs (12, N+1, B); fsteps (N_gait, 12, B). Returns
    Bl (N, 6, 12, B), hblk (N, 12, B), gait (N, 4, B)."""
    N = cfg.n_steps
    dt = cfg.dt_mpc
    dtype, dev = xrefs.dtype, xrefs.device
    B = xrefs.shape[-1]
    # the constants, copied to the device on every call
    frc = (dt / cfg.mass) * np.tile(np.eye(3, dtype=np.float32)[:, None, :],
                                    (1, 4, 1)).reshape(3, 12)
    L, P2 = qp_phase.time_coupling(N)
    with host_read("mpc_assembly_constants"):
        # (Rz' gI Rz)^-1 = Rz' gI^-1 Rz (Rz orthogonal)
        gI_inv = torch.as_tensor(
            np.linalg.inv(np.asarray(cfg.gI, np.float64).reshape(3, 3))
            .astype(np.float32), dtype=dtype, device=dev)
        com_z = torch.tensor([0.0, 0.0, cfg.offset_com_z], dtype=dtype,
                             device=dev)
        frc = torch.as_tensor(frc, dtype=dtype, device=dev)
        L = torch.as_tensor(L, dtype=dtype, device=dev)
        P2 = torch.as_tensor(P2, dtype=dtype, device=dev)
        gvec = torch.zeros(12, dtype=dtype, device=dev)
        gvec[8] = -cfg.gravity * dt         # a copy of the host scalar
    gait = (fsteps[:N, 0::3, :] != 0.0).to(dtype)

    yaw = xrefs[5, :N, :]
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    Rz = torch.stack([torch.stack([c, -s, z], 1),
                      torch.stack([s, c, z], 1),
                      torch.stack([z, z, o], 1)], 1)        # (N, 3, 3, B)
    I_inv = torch.einsum("nijb,ik,nklb->njlb", Rz, gI_inv, Rz)

    feet = fsteps[:N].reshape(N, 4, 3, B)
    com = xrefs[0:3, :N, :].permute(1, 0, 2) + com_z[None, :, None]
    lever = feet - com[:, None, :, :]
    lx, ly, lz = lever[:, :, 0], lever[:, :, 1], lever[:, :, 2]
    zz = torch.zeros_like(lx)
    sk = torch.stack([torch.stack([zz, -lz, ly], 2),
                      torch.stack([lz, zz, -lx], 2),
                      torch.stack([-ly, lx, zz], 2)], 2)    # (N, 4, 3, 3, B)
    tor = dt * torch.einsum("naib,nfijb->nafjb", I_inv, sk)
    tor = tor.reshape(N, 3, 12, B)
    frc = frc[None, :, :, None].expand(N, 3, 12, B)
    Bl = torch.cat([frc, tor], dim=1)                       # (N, 6, 12, B)

    # free response hblk[k] = sum_{j<=k} A^(k-j) r_j
    xj = xrefs[:, :N, :]
    Axj = torch.cat([xj[0:6] + dt * xj[6:12], xj[6:12]], dim=0)
    r = (Axj + gvec[:, None, None]
         - xrefs[:, 1:N + 1, :]).permute(1, 0, 2)           # (N, 12, B)
    rE = r[:, 6:12, :]
    top = torch.einsum("kj,jab->kab", L, r[:, 0:6, :]) \
        + dt * torch.einsum("kj,jab->kab", P2, rE)
    bot = torch.einsum("kj,jab->kab", L, rE)
    hblk = torch.cat([top, bot], dim=1)
    return Bl, hblk, gait


class PhaseStructure(NamedTuple):
    """Per-phase slot maps + the solver data, on the solver's device."""
    data: qp_phase.PhaseQPData
    onehot2: torch.Tensor   # (P, cap, 4N) slot -> (step, foot) one-hot
    supports: torch.Tensor  # (P, 4N) bool stance masks
    cap: int
    c_scale: float


NOMINAL_XY = np.array([[0.195, 0.195, -0.195, -0.195],
                       [0.147, -0.147, 0.147, -0.147]])


def _support_to_fsteps(cfg: Config, support: np.ndarray) -> np.ndarray:
    """(N_gait, 12) nominal footsteps from an (N, 4) 0/1 support."""
    N = cfg.n_steps
    out = np.zeros((cfg.N_gait, 12), np.float32)
    for i in range(N):
        for j in range(4):
            if support[i, j]:
                out[i, 3 * j:3 * j + 2] = NOMINAL_XY[:, j]
    return out


def gait_phase_fsteps(cfg: Config, kind: str = "trot") -> np.ndarray:
    """(P, N_gait, 12) nominal footsteps, one per distinct gait offset:
    phase p's window row i is pattern row (i - p) mod period, so one
    gait roll advances phase p to (p - 1) mod P."""
    from qrw_tpu_torch.core import gait as gait_mod
    N = cfg.n_steps
    pat = np.asarray(gait_mod._pattern(cfg, kind))
    n_rows = int(np.sum(np.any(pat != 0, axis=1)))
    sups = []
    for p in range(n_rows):
        idx = (np.arange(N) - p) % n_rows
        sups.append(pat[idx] != 0)
    P = n_rows
    for q in range(1, n_rows):
        if all((sups[p] == sups[(p + q) % n_rows]).all()
               for p in range(n_rows)):
            P = q
            break
    return np.stack([_support_to_fsteps(cfg, sups[p]) for p in range(P)])


def transition_phase_fsteps(cfg: Config, kind_a: str,
                            kind_b: str) -> np.ndarray:
    """(P, N_gait, 12) mixed support windows of a switch from gait A to
    gait B: t rolls after the switch from A-phase p, rows 0..N-t-1 still
    hold A and rows N-t..N-1 hold B's prefix. Every (p, t in 1..N-1)
    window, deduplicated. These classes have no cyclic phase arithmetic."""
    from qrw_tpu_torch.core import gait as gait_mod
    N = cfg.n_steps
    pat_a = np.asarray(gait_mod._pattern(cfg, kind_a))
    pat_b = np.asarray(gait_mod._pattern(cfg, kind_b))
    na = int(np.sum(np.any(pat_a != 0, axis=1)))
    nb = int(np.sum(np.any(pat_b != 0, axis=1)))
    seen = set()
    sups = []
    for p in range(na):
        for t in range(1, N):
            win = np.zeros((N, 4), bool)
            for i in range(N):
                if i < N - t:
                    win[i] = pat_a[(i + t - p) % na] != 0
                else:
                    win[i] = pat_b[(i - (N - t)) % nb] != 0
            key = win.tobytes()
            if key not in seen:
                seen.add(key)
                sups.append(win)
    return np.stack([_support_to_fsteps(cfg, s) for s in sups])


def calibrate_phase_fsteps(cfg: Config, phase_fs: np.ndarray,
                           fsteps_captured: np.ndarray) -> np.ndarray:
    """Re-center each phase class's nominal footholds on the mean
    captured foothold of the cycles whose support matches the class
    (the shared metric then fits the operating distribution); classes
    with no matching captured cycle keep their nominal values."""
    N = cfg.n_steps
    phase_fs = np.asarray(phase_fs)
    P = phase_fs.shape[0]
    fsteps_captured = np.asarray(fsteps_captured)
    sups = (phase_fs[:, :N, 0::3] != 0).reshape(P, -1)
    cap_sup = (fsteps_captured[:, :N, 0::3] != 0) \
        .reshape(fsteps_captured.shape[0], -1)
    out = np.array(phase_fs, np.float32, copy=True)
    for p in range(P):
        sel = (cap_sup == sups[p]).all(axis=1)
        if sel.any():
            avg = fsteps_captured[sel].mean(axis=0)
            m = np.zeros(phase_fs.shape[1:], bool)
            m[:N] = np.repeat(sups[p].reshape(N, 4), 3, axis=1)
            out[p] = np.where(m, avg, 0.0).astype(np.float32)
    return out


def union_phase_fsteps(cfg: Config, sets) -> np.ndarray:
    """Concatenate phase-class sets, deduplicated by support, into one
    (P, N_gait, 12) array for a shared PhaseStructure."""
    N = cfg.n_steps
    seen = set()
    out = []
    for s in sets:
        for fs in np.asarray(s):
            key = (fs[:N, 0::3] != 0).tobytes()
            if key not in seen:
                seen.add(key)
                out.append(fs)
    return np.stack(out)


def trot_phase_fsteps(cfg: Config, foothold=None) -> np.ndarray:
    """(P=N, N_gait, 12) nominal trot footsteps, one per gait offset."""
    N = cfg.n_steps
    half = N // 2
    if foothold is None:
        pair1 = np.array([0.195, 0.147, 0., 0., 0., 0.,
                          0., 0., 0., -0.195, -0.147, 0.])
        pair2 = np.array([0., 0., 0., 0.195, -0.147, 0.,
                          -0.195, 0.147, 0., 0., 0., 0.])
    else:
        pair1, pair2 = foothold
    out = np.zeros((N, cfg.N_gait, 12), np.float32)
    for p in range(N):
        for i in range(N):
            out[p, i] = (pair1 if ((i + (half - p)) // half) % 2 == 0
                         else pair2)
    return out


def build_phase_data(cfg: Config, phase_fsteps: np.ndarray,
                     rho: float = 0.015, margin: float = 1.5,
                     diag_margin: float = 0.0, sigma: float = 1e-6,
                     alpha: float = 1.0, cap: int = None,
                     nominal_vx: float = 0.5,
                     device="cuda") -> PhaseStructure:
    """Shared solver data for a set of support phases. The proximal
    metric Kbar_p = margin c Hbar_p + diag_margin c I + sigma I
    + rho A'A is built from the float32 nominal problem and inverted once
    in float64 on the host; the result moves to `device` as float32."""
    from qrw_tpu_torch.core import mpc as mpc_mod

    N = cfg.n_steps
    phase_fsteps = np.asarray(phase_fsteps)
    P = phase_fsteps.shape[0]
    if cap is None:
        max_stance = int((phase_fsteps[:, :N, 0::3] != 0)
                         .reshape(P, -1).sum(axis=1).max())
        cap = max(2 * N, -(-max_stance // 8) * 8)
    n = 3 * cap

    cone = qp.ReducedConeStructure(cap, cfg.mu)
    A = cone.matrix().astype(np.float32)
    l = np.tile([-np.inf, -np.inf, -np.inf, -np.inf, -cfg.fz_max],
                cap).astype(np.float32)
    u = np.zeros(5 * cap, np.float32)
    L, P2 = qp_phase.time_coupling(N)

    onehot = np.zeros((P, N, cap), np.float32)
    onehot2 = np.zeros((P, cap, 4 * N), np.float32)
    supports = np.zeros((P, 4 * N), bool)
    Kbar_inv = np.zeros((P, n, n), np.float32)
    G1 = np.zeros((P, cap, cap), np.float32)
    G2 = np.zeros((P, cap, cap), np.float32)
    P2tP2 = P2.astype(np.float64).T @ P2
    LtL = L.astype(np.float64).T @ L

    xr0 = np.zeros((12, N + 1), np.float32)
    xr0[2, :] = cfg.h_ref
    xr0[6, 1:] = nominal_vx

    c_scale = None
    for p in range(P):
        fs = phase_fsteps[p]
        stance = (fs[:N, 0::3] != 0).reshape(-1)
        ns = int(stance.sum())
        assert ns <= cap, f"phase {p}: {ns} stance pairs > cap {cap}"
        supports[p] = stance
        for s_i, kf in enumerate(np.where(stance)[0]):
            onehot2[p, s_i, kf] = 1.0
            onehot[p, kf // 4, s_i] = 1.0
        Hr, qr, *_ = mpc_mod.build_qp_reduced(
            cfg, torch.as_tensor(xr0), torch.as_tensor(fs, dtype=f32), cap)
        if c_scale is None:
            _, _, cc = qp.ruiz_equilibrate(Hr[None], qr[None],
                                           torch.as_tensor(A), 10)
            c_scale = float(cc[0, 0])
        Hr = Hr.numpy().astype(np.float64)
        Kbar = (margin * c_scale * Hr
                + (sigma + diag_margin * c_scale) * np.eye(n)
                + rho * (A.astype(np.float64).T @ A))
        Kbar_inv[p] = np.linalg.inv(Kbar).astype(np.float32)
        ohp = onehot[p].astype(np.float64)
        G1[p] = (ohp.T @ P2tP2 @ ohp).astype(np.float32)
        G2[p] = (ohp.T @ LtL @ ohp).astype(np.float32)

    w = np.asarray(cfg.w_state, np.float32) * c_scale
    t = lambda a, dt=f32: torch.as_tensor(a, dtype=dt, device=device)
    data = qp_phase.PhaseQPData(
        A=t(A), Kbar_inv=t(Kbar_inv), onehot=t(onehot), L=t(L), P2=t(P2),
        l=t(l), u=t(u), wtop=t(w[0:6]), wbot=t(w[6:12]),
        w_force=float(cfg.w_force * c_scale), dt=float(cfg.dt_mpc),
        rho=float(rho), sigma=float(sigma), alpha=float(alpha),
        c_scale=float(c_scale), G1=t(G1), G2=t(G2), mu=float(cfg.mu),
        dt_m=float(cfg.dt_mpc / cfg.mass))
    return PhaseStructure(data=data, onehot2=t(onehot2),
                          supports=t(supports, torch.bool), cap=cap,
                          c_scale=c_scale)


class MPCLaneState(NamedTuple):
    """Warm carry in the full (step, foot) layout, lane-major. rrho is
    the rescue stage's adapted per-lane rho (osqp keeps its workspace
    rho between solves): a lane that needs the rescue again re-enters it
    at that rho."""
    f: torch.Tensor          # (4N, 3, B) forces
    y: torch.Tensor          # (4N, 5, B) cone-row duals
    rrho: Optional[torch.Tensor] = None   # (B,)


def init_lane_state(cfg: Config, batch: int, device="cuda") -> MPCLaneState:
    N4 = 4 * cfg.n_steps
    return MPCLaneState(
        f=torch.zeros((N4, 3, batch), dtype=f32, device=device),
        y=torch.zeros((N4, 5, batch), dtype=f32, device=device),
        rrho=torch.full((batch,), 0.1, dtype=f32, device=device))


def shift_lane_state(state: MPCLaneState, n_steps: int) -> MPCLaneState:
    """Advance one MPC step (gait roll): shift the (step, foot) axis and
    ZERO the appended terminal step."""
    def roll(a):
        r = torch.roll(a.reshape((n_steps, 4) + tuple(a.shape[1:])), -1, 0)
        r = torch.cat([r[:-1], torch.zeros_like(r[-1:])], dim=0)
        return r.reshape(a.shape)
    return MPCLaneState(f=roll(state.f), y=roll(state.y), rrho=state.rrho)


def _gather_by_phase(arr, phases_of):
    """arr[phases_of] for phases given as numpy / list / tensor."""
    if not torch.is_tensor(phases_of):
        phases_of = torch.as_tensor(np.asarray(phases_of))
    return arr[phases_of.to(device=arr.device, dtype=torch.int64)]


def phase_problem(cfg: Config, xrefs, fsteps, ps: PhaseStructure,
                  phases_of, tile: int):
    """The reduced QP data of a phase-sorted batch: returns (Bl, hblk,
    gait) of assemble_lane, the per-slot input blocks BlS (6, 3cap, B),
    the linear term q_r = Gr' W h (3cap, B) and the per-tile slot maps
    oh2_t (B // tile, cap, 4N)."""
    N = cfg.n_steps
    cap = ps.cap
    d = ps.data
    B = xrefs.shape[-1]
    n_tiles = B // tile
    Bl, hblk, gait = assemble_lane(cfg, xrefs.to(f32), fsteps.to(f32))

    oh2_t = _gather_by_phase(ps.onehot2, phases_of)     # (nt, cap, 4N)
    Blf = Bl.reshape(N, 6, 4, 3, B).permute(0, 2, 1, 3, 4) \
        .reshape(4 * N, 6, 3, B)
    Blf_t = Blf.reshape(4 * N, 6, 3, n_tiles, tile)
    BlS = torch.einsum("tsk,kaitb->asitb", oh2_t, Blf_t) \
        .reshape(6, 3 * cap, B)

    # q = Gr' W h via the shared prefix-sum structure
    htop = hblk[:, 0:6, :] * d.wtop[None, :, None]
    hbot = hblk[:, 6:12, :] * d.wbot[None, :, None]
    vp = d.dt * torch.einsum("kj,kab->jab", d.P2, htop)
    vv = torch.einsum("kj,kab->jab", d.L, hbot)
    oh_t = _gather_by_phase(d.onehot, phases_of)        # (nt, N, cap)
    v_t = (vp + vv).reshape(N, 6, n_tiles, tile)
    vS = torch.einsum("tks,katb->satb", oh_t, v_t)      # (cap, 6, nt, tile)
    q_r = torch.repeat_interleave(vS.permute(1, 0, 2, 3), 3, dim=1) \
        .reshape(6, 3 * cap, B)
    q_r = (BlS * q_r).sum(dim=0)                        # (3cap, B)
    return Bl, hblk, gait, BlS, q_r, oh2_t


def default_rescue_settings() -> qp.QPSettings:
    """The rescue stage's solver settings: OSQP tolerances 1e-4, 450
    iterations, 4 Ruiz passes."""
    return qp.QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=450,
                         adaptive_rho_interval=200, scaling_iters=4)


@spanned("mpc.rescue")
def _rescue_failed_lanes(cfg: Config, xrefs, fsteps, f_full, y_full, sol,
                         rescue_cap: int, rescue_settings=None,
                         c_scale: float = 1.0, qp_cap: int = None,
                         warm_state: Optional[MPCLaneState] = None):
    """Second stage: re-solve up to rescue_cap lanes that failed the
    phase solve through the per-problem support-reduced path
    (core/mpc.solve_mpc_batch_reduced). Returns the patched
    (f_full, y_full, sol, rrho) with rescued lanes marked converged and
    `sol.rescued` the number of failed lanes the stage re-solved (0 when
    it did not run).

    Lanes are taken in a stable rank order: failed lanes with a live
    carry, then cold-restart lanes, then converged padding, which is
    masked out of the patch. With `warm_state` (the SHIFTED lane carry)
    each lane warm-starts from its stale rolled plan at its carried rho,
    with the [50, 150, 150, 100] schedule and the early exit, so a
    first-round convergence costs one 50-iteration round. The stage runs
    only on cycles with failures: one host read a cycle decides."""
    from qrw_tpu_torch.core import mpc as mpc_mod
    N = cfg.n_steps
    B = xrefs.shape[-1]
    dev = xrefs.device
    R = min(rescue_cap, B)
    if rescue_settings is None:
        rescue_settings = default_rescue_settings()
    with span("rescue.select"):
        bad = ~sol.converged
        rrho = (warm_state.rrho if warm_state is not None
                and warm_state.rrho is not None
                else torch.full((B,), rescue_settings.rho, dtype=f32,
                                device=dev))
        with host_read("rescue_any"):
            fire = bool(bad.any())
        if not fire:
            count("mpc.rescued", 0)
            return f_full, y_full, sol._replace(
                rescued=torch.zeros((), dtype=torch.int64, device=dev)), rrho

        if warm_state is not None:
            has_carry = torch.any(warm_state.f.abs() > 0.0, dim=1).any(dim=0)
            rank = torch.where(bad & has_carry, 0, torch.where(bad, 1, 2))
        else:
            rank = torch.where(bad, 0, 1)
        order = torch.argsort(rank, stable=True)[:R]
        sel_bad = bad[order]                                   # (R,)
        xb = xrefs.to(f32)[:, :, order].permute(2, 0, 1)   # (R, 12, N+1)
        fb = fsteps.to(f32)[:, :, order].permute(2, 0, 1)
        wkw = {}
        if warm_state is not None:
            # stale rolled plan -> reduced-path warm start; the duals back
            # to physical units (y_phase = c_scale * y_physical)
            f_w = warm_state.f[:, :, order].permute(2, 0, 1) \
                .reshape(R, 12 * N)
            y_w = warm_state.y[:, :, order].permute(2, 0, 1) \
                .reshape(R, 20 * N) / c_scale
            mi = rescue_settings.max_iter
            sched = [min(50, mi)]
            while sum(sched) < mi:
                sched.append(min(max(100, mi // 3), mi - sum(sched)))
            wkw = dict(state=mpc_mod.MPCWarmState(f=f_w, y=y_w,
                                                  rho=rrho[order, None]),
                       schedule=sched, early_exit=True)
    _, st_r, sol_r, ok_r = mpc_mod.solve_mpc_batch_reduced(
        cfg, xb, fb, settings=rescue_settings, tile=min(R, 64),
        cap=(2 * N if qp_cap is None else qp_cap), **wkw)
    with span("rescue.patch"):
        good = (sel_bad & sol_r.converged & ok_r)[None, None, :]
        f_r = st_r.f.reshape(R, 4 * N, 3).permute(1, 2, 0)
        # back to the phase solver's c-scaled duals
        y_r = c_scale * st_r.y.reshape(R, 4 * N, 5).permute(1, 2, 0)
        f_full = f_full.clone()
        y_full = y_full.clone()
        f_full[:, :, order] = torch.where(good, f_r, f_full[:, :, order])
        y_full[:, :, order] = torch.where(good, y_r, y_full[:, :, order])
        conv = sol.converged.clone()
        conv[order] = conv[order] | good[0, 0]
        rrho = rrho.clone()
        rrho[order] = torch.where(sel_bad, sol_r.rho[:, 0], rrho[order])
        rescued = sel_bad.sum()
        count("mpc.rescued", rescued)
        return f_full, y_full, sol._replace(converged=conv,
                                            rescued=rescued), rrho


@spanned("mpc.phase")
def solve_mpc_batch_phase(cfg: Config, xrefs, fsteps, ps: PhaseStructure,
                          phases_of, state: Optional[MPCLaneState] = None,
                          n_iters: int = None, shift: bool = False,
                          eps_abs: float = 1e-4, eps_rel: float = 1e-4,
                          tile: int = 128, rescue_cap: int = 0,
                          rescue_settings: Optional[qp.QPSettings] = None,
                          stop_at_eps: bool = False):
    """Batched MPC solve over a phase-sorted lane-major batch.

    xrefs (12, N+1, B); fsteps (N_gait, 12, B); phases_of (B // tile,)
    phase of each tile. Returns (x_f (24, N, B), new_state,
    PhaseQPResult). The solve runs through qp_phase.solve: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.

    rescue_cap > 0 enables the second stage: up to rescue_cap lanes that
    failed the phase solve (divergence under the shared metric, or a
    support outside the phase set) are re-solved per problem
    (_rescue_failed_lanes, kernel K2 on the card); lanes beyond the
    capacity, or failing both stages, ship the stale plan."""
    N = cfg.n_steps
    cap = ps.cap
    d = ps.data
    B = xrefs.shape[-1]
    if B % tile:
        raise ValueError("batch must be a multiple of the tile")
    n_tiles = B // tile
    if n_iters is None:
        n_iters = 300 if state is None else 250

    with span("mpc.assemble"):
        Bl, hblk, gait, BlS, q_r, oh2_t = phase_problem(
            cfg, xrefs, fsteps, ps, phases_of, tile)

    x0 = y0 = None
    if state is not None:
        with span("mpc.warm"):
            if shift:
                state = shift_lane_state(state, N)
            f_t = state.f.reshape(4 * N, 3, n_tiles, tile)
            y_t = state.y.reshape(4 * N, 5, n_tiles, tile)
            x0 = torch.einsum("tsk,kitb->sitb", oh2_t, f_t) \
                .reshape(3 * cap, B)
            y0 = torch.einsum("tsk,kitb->sitb", oh2_t, y_t) \
                .reshape(5 * cap, B)

    sol = qp_phase.solve(q_r.contiguous(), BlS.contiguous(), d, phases_of,
                         x0=None if x0 is None else x0.contiguous(),
                         y0=None if y0 is None else y0.contiguous(),
                         n_iters=n_iters, eps_abs=eps_abs, eps_rel=eps_rel,
                         tile=tile, stop_at_eps=stop_at_eps)

    with span("mpc.guard"):
        if active():
            count("mpc.k1_tiles", n_tiles)
            count("mpc.k1_tile_iters",
                  sol.iters.reshape(n_tiles, tile).amax(dim=1).sum())
        # Support guard: a problem whose stance pattern does not match its
        # claimed phase class solved the wrong reduced QP.
        sup_claim = _gather_by_phase(ps.supports, phases_of)
        sup_claim = torch.repeat_interleave(sup_claim, tile, dim=0)
        sup_have = gait.permute(2, 0, 1).reshape(B, 4 * N) != 0
        support_ok = torch.all(sup_have == sup_claim, dim=1)     # (B,)
        sol = sol._replace(converged=sol.converged & support_ok)

        x_t = sol.x.reshape(cap, 3, n_tiles, tile)
        yy_t = sol.y.reshape(cap, 5, n_tiles, tile)
        f_full = torch.einsum("tsk,sitb->kitb", oh2_t, x_t) \
            .reshape(4 * N, 3, B)
        y_full = torch.einsum("tsk,sitb->kitb", oh2_t, yy_t) \
            .reshape(4 * N, 5, B)

        rrho_out = (state.rrho if state is not None
                    and state.rrho is not None
                    else torch.full((B,), 0.1, dtype=f32,
                                    device=xrefs.device))
    if rescue_cap:
        f_full, y_full, sol, rrho_out = _rescue_failed_lanes(
            cfg, xrefs, fsteps, f_full, y_full, sol, rescue_cap,
            rescue_settings, c_scale=d.c_scale, qp_cap=cap,
            warm_state=state)

    with span("mpc.plan"):
        # A failed lane ships its stale (rolled) plan and restarts cold.
        cv = sol.converged[None, None, :]
        if state is not None:
            f_full = torch.where(cv, f_full, state.f)
            y_full = torch.where(cv, y_full, state.y)
            f_carry = torch.where(cv, f_full, torch.zeros_like(f_full))
            y_carry = torch.where(cv, y_full, torch.zeros_like(y_full))
        else:
            f_carry, y_carry = f_full, y_full

        u = torch.einsum("kafib,kfib->kab", Bl.reshape(N, 6, 4, 3, B),
                         f_full.reshape(N, 4, 3, B))
        dxv = torch.einsum("kj,jab->kab", d.L, u)
        dxp = d.dt * torch.einsum("kj,jab->kab", d.P2, u)
        dx = torch.cat([dxp, dxv], dim=1) + hblk
        states = dx.permute(1, 0, 2) + xrefs[:, 1:N + 1, :].to(f32)
        forces = f_full.reshape(N, 12, B).permute(1, 0, 2)
        x_f = torch.cat([states, forces], dim=0)            # (24, N, B)

        new_state = MPCLaneState(f=f_carry, y=y_carry, rrho=rrho_out)
        return x_f, new_state, sol
