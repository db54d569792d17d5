"""Whole-body controller: leg inverse kinematics + 12-var contact-force QP.

Port of qrw_tpu/core/wbc.py: the state, result and constant problem
data, and the per-robot `compute_wbc` of the single-robot controller
(batched over leading robot axes; the fleet runs the lane-major twin
core/wbc_lane.compute_wbc_lane):

  * inverse kinematics on the FIXED-BASE model: task-space PD on the
    feet, per-leg 3x3 Jacobian block inverses (ops/lin.inv3);
  * the box QP over contact-force deltas, H = A' Q1 A + Q2 with
    A = Y^-1 X, X = Jc[:, :6]', friction rows G (f_cmd + df) in
    [0, fz_max], solved by ops/qp.solve with the reference's OSQP
    settings; Y is the diagonal of the mass matrix's base block at the
    zero joint configuration (a constant);
  * tau_ff = rnea(q, dq, ddq + ddq_delta)[6:] - Jc[:, 6:]' f_with_delta.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.ops import lin, qp, rbd


@functools.lru_cache(maxsize=4)
def friction_generators(mu: float) -> np.ndarray:
    """(20, 12) block-diagonal G: per foot rows
    [mu fz - fx; mu fz + fx; mu fz - fy; mu fz + fy; fz]."""
    SC = np.array([
        [-1.0, 0.0, mu],
        [1.0, 0.0, mu],
        [0.0, -1.0, mu],
        [0.0, 1.0, mu],
        [0.0, 0.0, 1.0],
    ])
    G = np.zeros((20, 12))
    for i in range(4):
        G[5 * i:5 * i + 5, 3 * i:3 * i + 3] = SC
    return G


@functools.lru_cache(maxsize=1)
def base_inertia_diag() -> np.ndarray:
    """diag(Y): the base 6x6 block of the mass matrix at the ZERO joint
    configuration (the reference evaluates M at q = 0), computed once in
    float64 from the lane-major CRBA."""
    from qrw_tpu_torch.ops import rbd_lane as rl
    blocks = rl.crba(rl.solo12_lane(),
                     torch.zeros((4, 3, 1), dtype=torch.float64))
    return np.array([float(np.asarray(blocks.Mbb[i][i]).reshape(-1)[0])
                     for i in range(6)])


class WBCState(NamedTuple):
    k_since_contact: torch.Tensor  # (..., 4)
    qp_x: torch.Tensor             # (..., 12) QP warm start (delta-f)
    qp_y: torch.Tensor             # (..., 20) QP dual warm start


def init_wbc_state(dtype=torch.float32, device="cpu") -> WBCState:
    kw = dict(dtype=dtype, device=device)
    return WBCState(k_since_contact=torch.zeros(4, **kw),
                    qp_x=torch.zeros(12, **kw), qp_y=torch.zeros(20, **kw))


class WBCResult(NamedTuple):
    qdes: torch.Tensor          # (..., 12) joint position targets
    vdes: torch.Tensor          # (..., 12) joint velocity targets
    tau_ff: torch.Tensor        # (..., 12) feedforward torques
    f_with_delta: torch.Tensor  # (..., 12) corrected contact forces
    ddq_cmd: torch.Tensor       # (..., 18) commanded accelerations
    feet_pos: torch.Tensor      # (..., 4, 3)
    feet_vel: torch.Tensor      # (..., 4, 3)
    state: WBCState
    qp_iters: torch.Tensor      # (...) ADMM iterations of the box QP


def wbc_settings(cfg: Config) -> qp.QPSettings:
    """The reference's OSQP settings of the WBC QP (src/QPWBC.cpp:239-240)."""
    return qp.QPSettings(eps_abs=cfg.wbc_eps_abs, eps_rel=cfg.wbc_eps_rel,
                         max_iter=cfg.wbc_max_iter)


def compute_wbc(cfg: Config, model: rbd.TorchModel, state: WBCState,
                qj, b_v18, f_cmd, contacts, pgoals, vgoals, agoals,
                settings: Optional[qp.QPSettings] = None) -> WBCResult:
    """One 500 Hz whole-body step (wbc_controller.compute).

    qj (..., 12) reference joint positions; b_v18 (..., 18) generalized
    velocity (base rows the reference base twist, joint rows the
    previous commanded joint velocities); f_cmd (..., 12) MPC contact
    forces; contacts (..., 4) flags; pgoals / vgoals / agoals
    (..., 3, 4) foot references in the base frame."""
    dtype, dev = qj.dtype, qj.device
    batch = qj.shape[:-1]
    kw = dict(dtype=dtype, device=dev)
    vj = b_v18[..., 6:]
    if settings is None:
        settings = wbc_settings(cfg)

    ksc = (state.k_since_contact + contacts) * contacts

    # ---- inverse kinematics on the fixed-base model ----------------------
    zero3 = torch.zeros(batch + (3,), **kw)
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], **kw).expand(batch + (4,))
    kin = rbd.frame_kinematics(model, zero3, ident, qj,
                               torch.zeros(batch + (6,), **kw), vj)
    J = rbd.foot_jacobians(model, zero3, ident, qj, fk=(kin.R, kin.p))
    Jleg = torch.stack([J[..., f, :, 6 + 3 * f:9 + 3 * f]
                        for f in range(4)], dim=-3)          # (..., 4, 3, 3)

    pg, vg, ag = (g.transpose(-1, -2) for g in (pgoals, vgoals, agoals))
    perr = pg - kin.pos                                      # (..., 4, 3)
    afeet = (cfg.kp_flyingfeet * perr
             - cfg.kd_flyingfeet * (kin.vel - vg) + ag)
    afeet = torch.where(contacts[..., :, None] > 0, 0.0, afeet)
    afeet = afeet - kin.drift

    Jinv = lin.inv3(Jleg)                                    # (..., 4, 3, 3)
    ddq_j = rbd._mv(Jinv, afeet).reshape(batch + (12,))
    dq_cmd = rbd._mv(Jinv, vg).reshape(batch + (12,))
    q_step = rbd._mv(Jinv, perr).reshape(batch + (12,))

    # ---- box QP on contact-force deltas ----------------------------------
    # LOCAL_WORLD_ALIGNED linear foot Jacobians do not depend on the base
    # translation, so the reference's base at (0, 0, h_ref) gives J again.
    Jc = torch.where(contacts[..., :, None, None] > 0, J, 0.0).reshape(
        batch + (12, 18))

    ddq_cmd = torch.cat([torch.zeros(batch + (6,), **kw), ddq_j], dim=-1)
    rnea6 = rbd.rnea(model, ident, qj, b_v18, ddq_cmd, cfg.gravity)[..., :6]

    Yinv = torch.as_tensor(1.0 / base_inertia_diag(), **kw)   # (6,)
    X = Jc[..., :, 0:6].transpose(-1, -2)                     # (..., 6, 12)
    A = Yinv[:, None] * X
    gamma = Yinv * (rbd._mv(X, f_cmd) - rnea6)                    # (..., 6)
    At = A.transpose(-1, -2)
    H = (cfg.wbc_q1 * At) @ A + cfg.wbc_q2 * torch.eye(12, **kw)
    g = rbd._mv(cfg.wbc_q1 * At, gamma)

    G = torch.as_tensor(friction_generators(cfg.mu), **kw)
    Gf = f_cmd @ G.T
    sol = qp.solve(H, g, G, -Gf, -Gf + cfg.fz_max, settings,
                   x0=state.qp_x, y0=state.qp_y)
    df = sol.x
    f_with_delta = f_cmd + df
    ddq_delta = rbd._mv(A, df) + gamma                           # (..., 6)

    # ---- feedforward torques ---------------------------------------------
    ddq_final = torch.cat([ddq_cmd[..., 0:6] + ddq_delta, ddq_cmd[..., 6:]],
                          dim=-1)
    tau_ff = (rbd.rnea(model, ident, qj, b_v18, ddq_final,
                       cfg.gravity)[..., 6:]
              - rbd._mv(Jc[..., :, 6:].transpose(-1, -2), f_with_delta))

    new_state = WBCState(k_since_contact=ksc, qp_x=df, qp_y=sol.y)
    return WBCResult(qdes=qj + q_step, vdes=dq_cmd, tau_ff=tau_ff,
                     f_with_delta=f_with_delta, ddq_cmd=ddq_final,
                     feet_pos=kin.pos, feet_vel=kin.vel, state=new_state,
                     qp_iters=sol.iters)
