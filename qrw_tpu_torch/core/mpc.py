"""Centroidal convex MPC: the condensed-QP builders.

Partial port of qrw_tpu/core/mpc.py (mpc.py:65-376 as the fleet reaches
it): the warm-start state carried by ControllerState, the constant cone
matrix, the shared assembly of input blocks and free response, the
support selection and the support-reduced QP builder that
core/mpc_lane.build_phase_data uses for the shared proximal metric.
The per-problem solvers (solve_mpc, solve_mpc_batch_reduced,
solve_mpc_batch_pallas) are not ported yet.

States are eliminated analytically: dx = G f + h with
G[k, j] = A^(k-1-j) B_j and A^p = I + p dt E (E nilpotent), as in the
JAX package. One problem at a time (no batch axes): the fleet builds its
problems lane-major in core/mpc_lane.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from qrw_tpu.config import Config
from qrw_tpu_torch.ops.rotations import skew


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


def gait_from_fsteps(fsteps, n_steps: int):
    """(N, 4) contact flags from the footstep matrix (x == 0 is swing)."""
    return (fsteps[:n_steps, 0::3] != 0.0).to(fsteps.dtype)


def _assemble_common(cfg: Config, xref, fsteps):
    """Per-step input blocks Bl (N, 6, 12), free-response blocks hblk
    (N, 12), box bounds (l, u) and the lower-triangular helpers."""
    N = cfg.n_steps
    dt = cfg.dt_mpc
    dtype, dev = xref.dtype, xref.device
    gait = gait_from_fsteps(fsteps, N)
    gI = torch.as_tensor(np.asarray(cfg.gI).reshape(3, 3), dtype=dtype,
                         device=dev)

    yaw = xref[5, :N]
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    Rz = torch.stack([torch.stack([c, -s, z], -1),
                      torch.stack([s, c, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    RgIR = torch.einsum("kji,jl,klm->kim", Rz, gI, Rz)
    I_inv = torch.linalg.inv(RgIR)

    feet = fsteps[:N].reshape(N, 4, 3)
    com = xref[0:3, :N].T + torch.tensor([0.0, 0.0, cfg.offset_com_z],
                                         dtype=dtype, device=dev)
    lever = feet - com[:, None, :]
    tor = dt * torch.einsum("kab,kibc->kaic", I_inv, skew(lever))
    frc = (dt / cfg.mass) * torch.eye(3, dtype=dtype, device=dev)[
        :, None, :].expand(3, 4, 3)
    Bl = torch.cat([frc[None].expand(N, 3, 4, 3), tor],
                   dim=1).reshape(N, 6, 12)

    kk = torch.arange(N, device=dev)
    p = kk[:, None] - kk[None, :]
    mask = (p >= 0).to(dtype)

    gvec = torch.zeros(12, dtype=dtype, device=dev)
    gvec[8] = -cfg.gravity * dt
    xj = xref[:, :N].T
    Axj = torch.cat([xj[:, 0:6] + dt * xj[:, 6:12], xj[:, 6:12]], dim=1)
    r = Axj + gvec[None, :] - xref[:, 1:N + 1].T
    rE = torch.cat([r[:, 6:12], torch.zeros_like(r[:, 6:12])], dim=1)
    hblk = (mask[:, :, None] * (r[None] + (p.to(dtype) * dt)[:, :, None]
                                * rE[None])).sum(dim=1)

    inf = float("inf")
    l_f = torch.tensor([-inf, -inf, -inf, -inf, -cfg.fz_max], dtype=dtype,
                       device=dev).repeat(4 * N)
    u_f = torch.zeros(20 * N, dtype=dtype, device=dev)
    contact = torch.repeat_interleave(gait.reshape(-1), 3)
    l_b = torch.where(contact > 0, -inf, 0.0).to(dtype)
    u_b = torch.where(contact > 0, inf, 0.0).to(dtype)
    return (Bl, hblk, torch.cat([l_f, l_b]), torch.cat([u_f, u_b]), mask,
            p)


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


def support_indices(stance_flat, cap: int):
    """Up to `cap` stance (step, foot) pairs of the (4N,) stance mask in
    (step, foot) order; tail indices point at swing pairs and are masked
    by `valid`."""
    key = torch.where(stance_flat, 0, 1)
    order = torch.argsort(key, stable=True)
    idx = order[:cap]
    return idx, stance_flat[idx]


def build_qp_reduced(cfg: Config, xref, fsteps, cap: int):
    """Support-reduced condensed QP at the stance pairs: H_r (3cap,
    3cap), q_r (3cap), plus (Bl, h, idx, valid)."""
    N = cfg.n_steps
    dt = cfg.dt_mpc
    dtype, dev = xref.dtype, xref.device
    Bl, hblk, _, _, mask, p = _assemble_common(cfg, xref, fsteps)
    gait = gait_from_fsteps(fsteps, N)
    idx, valid = support_indices(gait.reshape(4 * N) > 0, cap)
    step = idx // 4
    foot = idx % 4
    BlS = Bl[step].reshape(cap, 6, 4, 3)[torch.arange(cap, device=dev), :,
                                         foot, :]           # (cap, 6, 3)

    w = torch.as_tensor(cfg.w_state, dtype=dtype, device=dev)
    wtop, wbot = w[0:6], w[6:12]
    S0, S2 = _h_coeffs(N)
    S0g = torch.as_tensor(S0, dtype=dtype, device=dev)[step][:, step]
    S2g = torch.as_tensor(S2, dtype=dtype, device=dev)[step][:, step]
    M1 = torch.einsum("sai,a,tak->stik", BlS, wtop, BlS)
    M2 = torch.einsum("sai,a,tak->stik", BlS, wbot, BlS)
    Hblk = (dt * dt) * S2g[:, :, None, None] * M1 \
        + S0g[:, :, None, None] * M2
    H_r = Hblk.permute(0, 2, 1, 3).reshape(3 * cap, 3 * cap)
    vm3 = torch.repeat_interleave(valid.to(dtype), 3)
    H_r = H_r * vm3[:, None] * vm3[None, :]
    H_r = H_r + torch.diag(cfg.w_force * vm3 + (1.0 - vm3))

    htop_w = wtop[None, :] * hblk[:, 0:6]
    hbot_w = wbot[None, :] * hblk[:, 6:12]
    pm = mask.T * p.T.to(dtype)
    g = (dt * (pm @ htop_w) + mask.T @ hbot_w)[step]
    q_r = torch.einsum("sai,sa->si", BlS, g).reshape(3 * cap) * vm3
    return H_r, q_r, Bl, hblk.reshape(12 * N), idx, valid
