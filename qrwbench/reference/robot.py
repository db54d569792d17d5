"""Plain per-robot physics step and whole-body controller in float64.

`physics_step` is the simulator's tick: the on-board control law
tau = P (q_des - q) + D (v_des - v) + tau_ff from the start-of-tick
measurement, then `sim_substeps` substeps of whole-robot forward
dynamics (CRBA, RNEA and a Cholesky solve of the frozen `rbd` and
`lin` copies) under the compliant ground contact: a normal
spring-damper and a tangential anchor spring clamped to the friction
cone, the anchor sliding on saturation, over the terrain's height.
It follows qrw_tpu_torch/sim/physics.py's per-robot `step` as frozen
for this benchmark (the fleet runs its lane-major twin).

`wbc_inputs` assembles the whole-body controller's foot targets from
the foot trajectory, as qrw_tpu_torch/core/controller.py's
`wbc_inputs`.

`wbc` is the whole-body controller's tick (the reference controller's
InvKin + QPWBC): inverse kinematics on the fixed-base model, the box QP
over contact-force deltas and the feedforward torques, as
qrw_tpu_torch/core/wbc.py's per-robot `compute_wbc`, except that the box
QP is solved to its optimum by `mpc_qp.solve`'s interior-point method
instead of to the controller's ADMM tolerance.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qrwbench.reference import lin, mpc_qp, rbd
from qrwbench.reference.rotations import quat_integrate, quat_to_rot
from qrwbench.reference.solo12 import make_solo12
from qrwbench.reference.terrain import height_at

_MODEL = []


def model():
    """The Solo-12 model (the frozen copy's own numbers); `rbd` casts it
    to the computation's dtype and device."""
    if not _MODEL:
        _MODEL.append(rbd.to_torch(make_solo12()))
    return _MODEL[0]


class Sim(NamedTuple):
    q: torch.Tensor        # (R, 19)
    v: torch.Tensor        # (R, 18)
    anchors: torch.Tensor  # (R, 4, 2)
    active: torch.Tensor   # (R, 4) bool


def _contact(ctrl, anchors, active, pos, vel, ground_h):
    pen = ground_h - pos[..., 2]
    in_ground = pen > 0.0
    ks, kd = float(ctrl["ground_stiffness"]), float(ctrl["ground_damping"])
    fn = torch.clamp(ks * pen - kd * vel[..., 2], min=0.0)
    fn = torch.where(in_ground, fn, 0.0)
    anchors = torch.where((in_ground & ~active)[..., None], pos[..., 0:2],
                          anchors)
    raw = -ks * (pos[..., 0:2] - anchors) - kd * vel[..., 0:2]
    norm = torch.linalg.vector_norm(raw, dim=-1)
    fmax = float(ctrl["sim_mu"]) * fn
    scale = torch.where(norm > fmax, fmax / torch.clamp(norm, min=1e-9), 1.0)
    ft = torch.where(in_ground[..., None], raw * scale[..., None], 0.0)
    anchors = torch.where((in_ground & (norm > fmax))[..., None],
                          pos[..., 0:2] + (ft + kd * vel[..., 0:2]) / ks,
                          anchors)
    return torch.cat([ft, fn[..., None]], dim=-1), anchors, in_ground


def physics_step(ctrl: dict, sim: Sim, P, D, q_des, v_des, tau_ff, f_ext,
                 terrains) -> Sim:
    """One tick of R robots. terrains: a list of R terrains (None for the
    flat plane), each a frozen `terrain.Terrain`."""
    dtype, dev = sim.q.dtype, sim.q.device
    m = model()
    n_sub = int(ctrl["sim_substeps"])
    dt = float(ctrl["dt_wbc"]) / n_sub
    tau = P * (q_des - sim.q[:, 7:]) + D * (v_des - sim.v[:, 6:]) + tau_ff
    q, v, anchors, active = sim.q, sim.v, sim.anchors, sim.active
    zero18 = torch.zeros_like(v)
    for _ in range(n_sub):
        base_pos, quat, qj = q[:, 0:3], q[:, 3:7], q[:, 7:]
        kin = rbd.frame_kinematics(m, base_pos, quat, qj, v[:, 0:6], v[:, 6:])
        xy = kin.pos[..., 0:2]
        ground_h = torch.stack([
            height_at(t, xy[r]) if t is not None
            else torch.zeros(4, dtype=dtype, device=dev)
            for r, t in enumerate(terrains)])
        forces, anchors, active = _contact(ctrl, anchors, active, kin.pos,
                                           kin.vel, ground_h)
        J = rbd.foot_jacobians(m, base_pos, quat, qj, fk=(kin.R, kin.p))
        f_gen = torch.einsum("...fan,...fa->...n", J, forces)
        R = quat_to_rot(quat)
        f_gen = torch.cat([f_gen[:, 0:3] + rbd._mv(R.transpose(-1, -2),
                                                   f_ext),
                           f_gen[:, 3:]], dim=-1)
        h = rbd.rnea(m, quat, qj, v, zero18, float(ctrl["gravity"]))
        M = rbd.crba(m, qj)
        rhs = f_gen - h
        rhs = torch.cat([rhs[:, :6], rhs[:, 6:] + tau], dim=-1)
        a = lin.chol_solve(M, rhs)
        v = v + dt * a
        q = torch.cat([base_pos + dt * rbd._mv(R, v[:, 0:3]),
                       quat_integrate(quat, v[:, 3:6], dt),
                       qj + dt * v[:, 6:]], dim=-1)
    return Sim(q=q, v=v, anchors=anchors, active=active)


def friction_generators(mu: float) -> np.ndarray:
    """(20, 12): per foot rows [mu fz - fx; mu fz + fx; mu fz - fy;
    mu fz + fy; fz]."""
    SC = np.array([[-1.0, 0.0, mu], [1.0, 0.0, mu], [0.0, -1.0, mu],
                   [0.0, 1.0, mu], [0.0, 0.0, 1.0]])
    G = np.zeros((20, 12))
    for i in range(4):
        G[5 * i:5 * i + 5, 3 * i:3 * i + 3] = SC
    return G


class WBCIn(NamedTuple):
    b_v: torch.Tensor      # (R, 18) base velocity command and joint vdes
    feet_p: torch.Tensor   # (R, 3, 4) foot targets in the base frame
    feet_v: torch.Tensor   # (R, 3, 4)
    feet_a: torch.Tensor   # (R, 3, 4)


def wbc_inputs(ctrl: dict, prev_p, prev_v, vdes, v_ref, pos, vel, acc, oRh,
               oTh) -> WBCIn:
    """The whole-body controller's targets of R robots for one tick, as
    the reference controller assembles them: the foot trajectory's world
    position, velocity and acceleration (R, 3, 4) moved into the
    horizontal frame (oRh (R, 3, 3), oTh (R, 3)) at h_ref, less the
    frame's rotation at the reference yaw rate; the Coriolis terms use
    the previous tick's base-frame commands prev_p, prev_v (R, 3, 4)."""
    Rt = oRh.transpose(-1, -2)
    w = v_ref[:, None, 3:6]
    pp, pv = prev_p.transpose(-1, -2), prev_v.transpose(-1, -2)
    cr = torch.linalg.cross
    feet_a = (Rt @ acc - cr(w, cr(w, pp)).transpose(-1, -2)
              - 2.0 * cr(w, pv).transpose(-1, -2))
    feet_v = (Rt @ vel - v_ref[:, 0:3, None]
              - cr(w, pp).transpose(-1, -2))
    h = torch.tensor([0.0, 0.0, float(ctrl["h_ref"])], dtype=pos.dtype,
                     device=pos.device)
    feet_p = Rt @ (pos - h[:, None] - oTh[:, :, None])
    return WBCIn(b_v=torch.cat([v_ref[:, 0:6], vdes], dim=-1),
                 feet_p=feet_p, feet_v=feet_v, feet_a=feet_a)


class WBCOut(NamedTuple):
    qdes: torch.Tensor     # (R, 12) joint position targets
    vdes: torch.Tensor     # (R, 12) joint velocity targets
    tau_ff: torch.Tensor   # (R, 12) feedforward torques


def wbc(ctrl: dict, qj, b_v18, f_cmd, contacts, pgoals, vgoals, agoals
        ) -> WBCOut:
    """One whole-body controller tick of R robots (batch-major inputs:
    qj (R, 12), b_v18 (R, 18), f_cmd (R, 12), contacts (R, 4), goals
    (R, 3, 4) in the base frame)."""
    dtype, dev = qj.dtype, qj.device
    R_ = qj.shape[0]
    kw = dict(dtype=dtype, device=dev)
    m = model()
    vj = b_v18[:, 6:]
    zero3 = torch.zeros((R_, 3), **kw)
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], **kw).expand(R_, 4)
    kin = rbd.frame_kinematics(m, zero3, ident, qj, torch.zeros((R_, 6), **kw),
                               vj)
    J = rbd.foot_jacobians(m, zero3, ident, qj, fk=(kin.R, kin.p))
    Jleg = torch.stack([J[:, f, :, 6 + 3 * f:9 + 3 * f] for f in range(4)],
                       dim=-3)
    pg, vg, ag = (g.transpose(-1, -2) for g in (pgoals, vgoals, agoals))
    perr = pg - kin.pos
    afeet = (float(ctrl["kp_flyingfeet"]) * perr
             - float(ctrl["kd_flyingfeet"]) * (kin.vel - vg) + ag)
    afeet = torch.where(contacts[:, :, None] > 0, 0.0, afeet)
    afeet = afeet - kin.drift
    Jinv = torch.linalg.inv(Jleg)
    ddq_j = rbd._mv(Jinv, afeet).reshape(R_, 12)
    dq_cmd = rbd._mv(Jinv, vg).reshape(R_, 12)
    q_step = rbd._mv(Jinv, perr).reshape(R_, 12)

    Jc = torch.where(contacts[:, :, None, None] > 0, J, 0.0).reshape(R_, 12,
                                                                    18)
    ddq_cmd = torch.cat([torch.zeros((R_, 6), **kw), ddq_j], dim=-1)
    g = float(ctrl["gravity"])
    rnea6 = rbd.rnea(m, ident, qj, b_v18, ddq_cmd, g)[:, :6]
    M0 = rbd.crba(m, torch.zeros((1, 12), **kw))[0]
    Yinv = 1.0 / torch.diagonal(M0)[:6]
    X = Jc[:, :, 0:6].transpose(-1, -2)
    A = Yinv[:, None] * X
    gamma = Yinv * (rbd._mv(X, f_cmd) - rnea6)
    At = A.transpose(-1, -2)
    q1, q2 = float(ctrl["wbc_q1"]), float(ctrl["wbc_q2"])
    H = (q1 * At) @ A + q2 * torch.eye(12, **kw)
    glin = rbd._mv(q1 * At, gamma)
    Gm = torch.as_tensor(friction_generators(float(ctrl["mu"])), **kw)
    Gf = f_cmd @ Gm.T
    # -Gf <= Gm df <= -Gf + fz_max as C df <= d
    C = torch.cat([Gm, -Gm]).expand(R_, 40, 12)
    d = torch.cat([-Gf + float(ctrl["fz_max"]), Gf], dim=-1)
    df, _ = mpc_qp.solve(dict(H=H, q=glin, C=C, d=d))
    f_with_delta = f_cmd + df
    ddq_delta = rbd._mv(A, df) + gamma
    ddq_final = torch.cat([ddq_cmd[:, 0:6] + ddq_delta, ddq_cmd[:, 6:]], -1)
    tau_ff = (rbd.rnea(m, ident, qj, b_v18, ddq_final, g)[:, 6:]
              - rbd._mv(Jc[:, :, 6:].transpose(-1, -2), f_with_delta))
    return WBCOut(qdes=qj + q_step, vdes=dq_cmd, tau_ff=tau_ff)
