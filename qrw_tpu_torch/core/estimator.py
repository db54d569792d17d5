"""State estimator: IMU + leg-odometry complementary filter at 500 Hz.

Port of qrw_tpu/core/estimator.py (complementary-filter cascade,
per-contact-foot base velocity from kinematics, forward-geometry base
position, adaptive IMU/FK trust schedule, output low-pass filters,
perfect-estimator mode), batched over leading robot axes. The fleet
injects the foot kinematics through `fk=`. With cfg.kf_enabled the
18-state Kalman filter (core/kalman.kf18_step) takes the complementary
filters' place, and their states are carried unchanged.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.kalman import KF18State, kf18_init, kf18_step
from qrw_tpu_torch.ops import rbd
from qrw_tpu_torch.ops.rotations import quat_to_rot, quat_to_rpy, rpy_to_quat
from qrw_tpu_torch.utils.profiling import host_read


def filter_alpha(dt: float, fc: float) -> float:
    """Discrete complementary/low-pass gain for cut frequency fc."""
    y = 1.0 - math.cos(2.0 * math.pi * fc * dt)
    return -y + math.sqrt(y * y + 2.0 * y)


class DeviceData(NamedTuple):
    """Per-tick measurements from the device (simulator)."""
    base_lin_acc: torch.Tensor  # (..., 3) IMU linear acceleration, base
    base_ang_vel: torch.Tensor  # (..., 3) gyroscope, base frame
    base_quat: torch.Tensor     # (..., 4) IMU orientation [x, y, z, w]
    q_mes: torch.Tensor         # (..., 12) joint encoder positions
    v_mes: torch.Tensor         # (..., 12) joint encoder velocities
    dummy_pos: torch.Tensor     # (..., 3) ground-truth base position
    b_base_vel: torch.Tensor    # (..., 3) ground-truth base velocity, base


class EstimatorState(NamedTuple):
    yaw_offset: torch.Tensor
    k_since_contact: torch.Tensor  # (..., 4)
    hp_vel: torch.Tensor
    lp_vel: torch.Tensor
    hp_pos: torch.Tensor
    lp_pos: torch.Tensor
    fk_lin_vel: torch.Tensor
    fk_xyz: torch.Tensor
    xyz_mean_feet: torch.Tensor
    v_filt: torch.Tensor        # (..., 18)
    v_secu: torch.Tensor        # (..., 12)
    kf: KF18State


class EstimatorOutput(NamedTuple):
    q_filt: torch.Tensor        # (..., 19)
    v_filt: torch.Tensor        # (..., 18)
    v_secu: torch.Tensor        # (..., 12)
    rpy: torch.Tensor           # (..., 3)
    state: EstimatorState


def init_estimator_state(cfg: Config, h_init: float, dtype=torch.float32,
                         device="cpu") -> EstimatorState:
    kw = dict(dtype=dtype, device=device)
    z3 = torch.zeros(3, **kw)
    hz = torch.tensor([0.0, 0.0, h_init], **kw)
    return EstimatorState(
        yaw_offset=torch.zeros((), **kw), k_since_contact=torch.zeros(4, **kw),
        hp_vel=z3, lp_vel=z3, hp_pos=z3, lp_pos=hz, fk_lin_vel=z3,
        fk_xyz=hz, xyz_mean_feet=z3, v_filt=torch.zeros(18, **kw),
        v_secu=torch.zeros(12, **kw), kf=kf18_init(h_init, dtype, device))


def run_filter(cfg: Config, model: rbd.TorchModel, state: EstimatorState,
               k: int, gait_current, device: DeviceData, goals,
               perfect: bool = False, fk=None) -> EstimatorOutput:
    """One estimator tick (Estimator.run_filter).

    gait_current (..., N_gait, 4); goals (..., 3, 4) foot targets;
    fk: optional precomputed (pos (..., 4, 3), vel (..., 4, 3)) fixed-
    base foot kinematics at (device.q_mes, device.v_mes)."""
    dtype = device.q_mes.dtype
    dev = device.q_mes.device

    feet_status = gait_current[..., 0, :]                     # (..., 4)
    same = torch.all(gait_current[..., 1:, :] == feet_status[..., None, :],
                     dim=-1)
    remaining = 1 + torch.cumprod(same.to(torch.int64), dim=-1).sum(-1)

    # IMU
    rpy_raw = quat_to_rpy(device.base_quat)
    yaw_offset = rpy_raw[..., 2] if k <= 1 else state.yaw_offset
    rpy = torch.cat([rpy_raw[..., 0:2],
                     (rpy_raw[..., 2] - yaw_offset)[..., None]], dim=-1)
    imu_quat = rpy_to_quat(rpy)
    oRb = quat_to_rot(imu_quat)
    with host_read("estimator_imu_offset"):
        imu_r = torch.as_tensor(cfg.imu_offset, dtype=dtype, device=dev)

    ksc = (state.k_since_contact + feet_status) * feet_status

    # forward kinematics (fixed base, identity orientation)
    if fk is None:
        batch = device.q_mes.shape[:-1]
        kin = rbd.frame_kinematics(
            model, torch.zeros(batch + (3,), dtype=dtype, device=dev),
            torch.tensor([0., 0., 0., 1.], dtype=dtype,
                         device=dev).expand(batch + (4,)),
            device.q_mes, torch.zeros(batch + (6,), dtype=dtype, device=dev),
            device.v_mes)
        fk_pos, fk_vel = kin.pos, kin.vel
    else:
        fk_pos, fk_vel = fk
    w = device.base_ang_vel[..., None, :].expand_as(fk_pos)
    vel_feet = torch.linalg.cross(fk_pos, w) - fk_vel          # (..., 4, 3)
    vmes = device.v_mes.reshape(device.v_mes.shape[:-1] + (4, 3))
    with host_read("estimator_sign"):
        sign = torch.tensor([-1.0, -1.0, 1.0, 1.0], dtype=dtype, device=dev)
    vx_corr = vel_feet[..., 0] + cfg.foot_radius * (
        vmes[..., 1] + sign * vmes[..., 2])
    vel_feet = torch.cat([vx_corr[..., None], vel_feet[..., 1:]], dim=-1)
    xyz_feet = -torch.einsum("...ab,...fb->...fa", oRb, fk_pos)

    trust = (feet_status > 0) & (ksc >= cfg.contact_security_ticks)
    cnt = trust.to(dtype).sum(-1, keepdim=True)
    tr = trust[..., None]
    zf = torch.zeros_like(vel_feet)
    fk_lin_vel = torch.where(
        cnt > 0, torch.where(tr, vel_feet, zf).sum(-2)
        / torch.clamp(cnt, min=1.0), state.fk_lin_vel)
    fk_xyz = torch.where(
        cnt > 0, torch.where(tr, xyz_feet, zf).sum(-2)
        / torch.clamp(cnt, min=1.0), state.fk_xyz)

    in_contact = feet_status > 0
    cnt_c = in_contact.to(dtype).sum(-1, keepdim=True)
    xyz_mean_feet = torch.where(
        cnt_c > 0,
        torch.where(in_contact[..., None, :], goals,
                    torch.zeros_like(goals)).sum(-1)
        / torch.clamp(cnt_c, min=1.0),
        state.xyz_mean_feet)

    # adaptive trust schedule
    a = torch.ceil(torch.amax(ksc, dim=-1) / 10.0) - 1.0
    b = remaining.to(dtype)
    n = 1.0
    v_max, v_min = 1.0, 0.97
    c = ((a + b) - 2.0 * n) * 0.5
    near_switch = (a <= (n - 1.0)) | (b <= n)
    alpha = torch.where(near_switch, torch.full_like(a, v_max),
                        v_min + (v_max - v_min) * torch.abs(c - (a - n))
                        / torch.clamp(c, min=1e-9))[..., None]

    w_b = device.base_ang_vel
    cross = torch.linalg.cross(imu_r.expand_as(w_b), w_b)

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    o_acc = mv(oRb, device.base_lin_acc)
    if cfg.kf_enabled:
        # the 18-state Kalman filter
        kf, filt_lin_pos, b_filt_vel = kf18_step(
            cfg, state.kf, oRb, o_acc, fk_pos, feet_status,
            device.base_ang_vel)
        hp_vel, lp_vel = state.hp_vel, state.lp_vel
        hp_pos, lp_pos = state.hp_pos, state.lp_pos
    else:
        # the complementary filter cascade
        i_fk_vel = fk_lin_vel + cross
        oi_fk_vel = mv(oRb, i_fk_vel)
        hp_vel = alpha * (state.hp_vel + o_acc * cfg.dt_wbc)
        lp_vel = alpha * state.lp_vel + (1.0 - alpha) * oi_fk_vel
        oi_filt_vel = hp_vel + lp_vel
        b_filt_vel = mv(oRb.transpose(-1, -2), oi_filt_vel) - cross
        ob_filt_vel = mv(oRb, b_filt_vel)

        with host_read("estimator_alpha_pos"):
            a_pos = torch.as_tensor(cfg.alpha_pos, dtype=dtype, device=dev)
        hp_pos = a_pos * (state.hp_pos + ob_filt_vel * cfg.dt_wbc)
        lp_pos = (a_pos * state.lp_pos
                  + (1.0 - a_pos) * (fk_xyz + xyz_mean_feet))
        filt_lin_pos = hp_pos + lp_pos
        kf = state.kf

    alpha_v = filter_alpha(cfg.dt_wbc, cfg.fc_vel)
    alpha_secu = filter_alpha(cfg.dt_wbc, cfg.fc_secu)

    lin_vel_src = device.b_base_vel if perfect else b_filt_vel
    v_lin = (1.0 - alpha_v) * state.v_filt[..., 0:3] + alpha_v * lin_vel_src
    v_filt = torch.cat([v_lin, device.base_ang_vel, device.v_mes], dim=-1)

    z_out = ((device.dummy_pos[..., 2] - 0.0155) if perfect
             else filt_lin_pos[..., 2])
    q_filt = torch.cat([filt_lin_pos[..., 0:2], z_out[..., None], imu_quat,
                        device.q_mes], dim=-1)
    v_secu = (1.0 - alpha_secu) * device.v_mes + alpha_secu * state.v_secu

    new_state = EstimatorState(
        yaw_offset=yaw_offset, k_since_contact=ksc,
        hp_vel=hp_vel, lp_vel=lp_vel, hp_pos=hp_pos, lp_pos=lp_pos,
        fk_lin_vel=fk_lin_vel, fk_xyz=fk_xyz, xyz_mean_feet=xyz_mean_feet,
        v_filt=v_filt, v_secu=v_secu, kf=kf)
    return EstimatorOutput(q_filt=q_filt, v_filt=v_filt, v_secu=v_secu,
                           rpy=rpy, state=new_state)
