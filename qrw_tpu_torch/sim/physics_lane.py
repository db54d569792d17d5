"""Lane-major fleet physics step.

Port of qrw_tpu/sim/physics_lane.py: one WBC tick (cfg.sim_substeps
substeps) for a whole fleet on the rbd_lane kernels, with the same
compliant contact model (normal spring-damper, tangential anchor spring
clamped to the friction cone, anchor sliding), the same on-board control
law tau = P (q_des - q) + D (v_des - v) + tau_ff and the same
measurement synthesis. `terrain` (a sim/terrain.Terrain shared by the
fleet, or a FleetTerrain, one per robot) sets the ground height under
each foot; None is the flat plane. The envID=1 projectiles are not
ported and raise NotImplementedError.

The boundary is batch-major (leading batch axis), as in the JAX module.
"""

from __future__ import annotations

from typing import Tuple

import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.estimator import DeviceData
from qrw_tpu_torch.ops import rbd_lane as rl
from qrw_tpu_torch.sim.physics import SimState
from qrw_tpu_torch.sim.terrain import height_at
from qrw_tpu_torch.utils.profiling import span, spanned


def _quat_mul_lane(q, r):
    x1, y1, z1, w1 = q
    x2, y2, z2, w2 = r
    return [w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2]


def _quat_integrate_lane(q, omega, dt):
    """Exponential-map integration, lane-major."""
    w2 = omega[0] ** 2 + omega[1] ** 2 + omega[2] ** 2
    th = torch.sqrt(w2) * dt
    half = 0.5 * th
    small = th < 1e-8
    k = torch.where(small, 0.5 * dt,
                    torch.sin(half) * dt / torch.clamp(th, min=1e-30))
    dq = [omega[0] * k, omega[1] * k, omega[2] * k, torch.cos(half)]
    out = _quat_mul_lane(q, dq)
    n = torch.sqrt(out[0] ** 2 + out[1] ** 2 + out[2] ** 2 + out[3] ** 2)
    return [e / n for e in out]


@spanned("physics")
def step_lane(cfg: Config, lane: rl.LaneModel, state: SimState, P, D,
              q_des, v_des, tau_ff, f_ext=None, terrain=None
              ) -> Tuple[SimState, DeviceData]:
    """One WBC tick for the whole fleet. State leaves (B, ...),
    P/D/q_des/v_des/tau_ff (B, 12), f_ext (B, 3) world-frame base force,
    terrain None (flat), a Terrain or a FleetTerrain."""
    if state.proj is not None:
        raise NotImplementedError("projectiles are not supported here")
    dtype = state.q.dtype
    B = state.q.shape[0]
    dt = cfg.dt_wbc / cfg.sim_substeps

    def lq(x):
        return x.reshape(B, 4, 3).permute(1, 2, 0)

    with span("physics.control"):
        if f_ext is None:
            f_ext = torch.zeros((B, 3), dtype=dtype, device=state.q.device)

        q_mes0 = lq(state.q[:, 7:])
        v_mes0 = lq(state.v[:, 6:])
        tau = lq(P) * (lq(q_des) - q_mes0) + lq(D) * (lq(v_des) - v_mes0) \
            + lq(tau_ff)
        fe = [f_ext[:, i] for i in range(3)]

        ks = cfg.ground_stiffness
        kd = cfg.ground_damping
        mu = cfg.sim_mu

        bp = state.q[:, 0:3].T
        quat = state.q[:, 3:7].T
        qj = lq(state.q[:, 7:])
        vlin = state.v[:, 0:3].T
        w = state.v[:, 3:6].T
        vj = lq(state.v[:, 6:])
        ax = state.anchors[:, :, 0].T
        ay = state.anchors[:, :, 1].T
        active = state.active.T

    for _ in range(cfg.sim_substeps):
        with span("physics.contact"):
            bp_v = [bp[i] for i in range(3)]
            quat_v = [quat[i] for i in range(4)]
            R0 = rl.quat_to_mat(quat_v)
            vlin_v = [vlin[i] for i in range(3)]
            w_v = [w[i] for i in range(3)]
            kin = rl.frame_kinematics(lane, bp_v, R0, qj, (vlin_v, w_v), vj)
            px, py, pz = kin.pos
            vx, vy, vz = kin.vel

            # compliant contact (sim/physics._contact_forces)
            if terrain is not None:
                ground_h = height_at(terrain, torch.stack([px, py], dim=-1))
            else:
                ground_h = 0.0
            pen = ground_h - pz
            in_ground = pen > 0.0
            fn = torch.clamp(ks * pen - kd * vz, min=0.0)
            fn = torch.where(in_ground, fn, 0.0)
            new_contact = in_ground & ~active
            axn = torch.where(new_contact, px, ax)
            ayn = torch.where(new_contact, py, ay)
            rx = -ks * (px - axn) - kd * vx
            ry = -ks * (py - ayn) - kd * vy
            norm = torch.sqrt(rx * rx + ry * ry)
            fmax = mu * fn
            scale = torch.where(norm > fmax,
                                fmax / torch.clamp(norm, min=1e-9), 1.0)
            ftx = torch.where(in_ground, rx * scale, 0.0)
            fty = torch.where(in_ground, ry * scale, 0.0)
            slide = in_ground & (norm > fmax)
            axn = torch.where(slide, px + (ftx + kd * vx) / ks, axn)
            ayn = torch.where(slide, py + (fty + kd * vy) / ks, ayn)
            F = [ftx, fty, fn]

        with span("physics.dynamics"):
            # generalized contact forces: f_gen = sum_f J_f' F_f
            J = rl.foot_jacobians(lane, kin, R0, bp_v)
            F_sum = [f.sum(0) for f in F]
            base_force = rl.mtv(R0, F_sum)
            bt = rl.mtv(J.Jb_ang, F)
            base_torque = [rl._sum0(e) for e in bt]
            tau_c = [rl._add(rl._mul(J.Jleg[0][l], F[0]),
                             rl._mul(J.Jleg[1][l], F[1]),
                             rl._mul(J.Jleg[2][l], F[2])) for l in range(3)]
            base_force = rl.vadd(base_force, rl.mtv(R0, fe))

            # forward dynamics
            hf, hn, htau = rl.nonlinear_effects(
                lane, R0, qj, (vlin_v, w_v, vj), cfg.gravity)
            blocks = rl.crba(lane, qj)
            rhs6 = [rl._add(base_force[i], rl._neg(hf[i])) for i in range(3)] \
                + [rl._add(base_torque[i], rl._neg(hn[i])) for i in range(3)]
            rhs_j = torch.stack(tau_c, dim=1) + tau - htau
            a_base, a_j = rl.forward_dynamics(blocks, rhs6, rhs_j)

        with span("physics.integrate"):
            vlin_n = torch.stack([vlin[i] + dt * a_base[i] for i in range(3)])
            w_n = torch.stack([w[i] + dt * a_base[3 + i] for i in range(3)])
            vj_n = vj + dt * a_j
            o_vel = rl.mv(R0, [vlin_n[i] for i in range(3)])
            bp = torch.stack([bp[i] + dt * o_vel[i] for i in range(3)])
            quat = torch.stack(_quat_integrate_lane(
                quat_v, [w_n[i] for i in range(3)], dt))
            qj = qj + dt * vj_n
            vlin, w, vj = vlin_n, w_n, vj_n
            ax, ay, active = axn, ayn, in_ground

    with span("physics.measure"):
        # measurement synthesis (batch-major out)
        quat_v = [quat[i] for i in range(4)]
        R0 = rl.quat_to_mat(quat_v)
        vlin_v = [vlin[i] for i in range(3)]
        w_v = [w[i] for i in range(3)]
        o_base_vel = rl.mv(R0, vlin_v)
        imu_r = [float(c) for c in cfg.imu_offset]
        o_imu_vel = rl.vadd(o_base_vel, rl.mv(R0, rl.cross(imu_r, w_v)))
        prev = [state.prev_o_imu_vel[:, i] for i in range(3)]
        base_lin_acc = rl.mtv(
            R0, [(o_imu_vel[i] - prev[i]) / cfg.dt_wbc for i in range(3)])

        def bm(x):
            return x.permute(2, 0, 1).reshape(B, 12)

        q_out = torch.cat([bp.T, quat.T, bm(qj)], dim=1)
        v_out = torch.cat([vlin.T, w.T, bm(vj)], dim=1)
        anchors = torch.stack([ax.T, ay.T], dim=-1)
        device = DeviceData(
            base_lin_acc=torch.stack(base_lin_acc, dim=1), base_ang_vel=w.T,
            base_quat=quat.T, q_mes=bm(qj), v_mes=bm(vj), dummy_pos=bp.T,
            b_base_vel=vlin.T)
        new_state = SimState(
            q=q_out, v=v_out, anchors=anchors, active=active.T,
            prev_o_imu_vel=torch.stack(o_imu_vel, dim=1),
            joint_torques=bm(tau), proj=None)
        return new_state, device
