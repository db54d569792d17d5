"""Swing-foot reference trajectories (quintic xy, closed-form z).

Port of qrw_tpu/core/foot_trajectory.py, batched over leading robot
axes. The quintic is fitted in normalized time tau in [0, 1], so its
boundary matrix is a constant whose inverse is computed once here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.gait import GaitState, phase_durations
from qrw_tpu_torch.utils.profiling import host_read

_B = np.zeros((6, 6))
_B[0, 0] = 1.0
_B[1, 1] = 1.0
_B[2, 2] = 2.0
_B[3, :] = 1.0
_B[4, :] = [0, 1, 2, 3, 4, 5]
_B[5, :] = [0, 0, 2, 6, 12, 20]
_BINV = np.linalg.inv(_B)


class FootTrajState(NamedTuple):
    position: torch.Tensor      # (..., 3, 4)
    velocity: torch.Tensor      # (..., 3, 4)
    acceleration: torch.Tensor  # (..., 3, 4)
    coeffs: torch.Tensor        # (..., 4, 2, 6) xy quintic coefficients
    t_fit: torch.Tensor         # (..., 4) swing time at last refit
    s_fit: torch.Tensor         # (..., 4) time span at last refit
    t0s: torch.Tensor           # (..., 4) elapsed swing time
    t_swing: torch.Tensor       # (..., 4) total swing duration


def make_foot_traj_state(p0) -> FootTrajState:
    kw = dict(dtype=p0.dtype, device=p0.device)
    return FootTrajState(
        position=p0, velocity=torch.zeros((3, 4), **kw),
        acceleration=torch.zeros((3, 4), **kw),
        coeffs=torch.zeros((4, 2, 6), **kw), t_fit=torch.zeros(4, **kw),
        s_fit=torch.ones(4, **kw), t0s=torch.zeros(4, **kw),
        t_swing=torch.full((4,), 0.16, **kw))


def update_foot_trajectory(cfg: Config, gait: GaitState,
                           state: FootTrajState, k: int,
                           target) -> FootTrajState:
    """One tick (FootTrajectoryGenerator::update). `target` (..., 3, 4)
    is the touchdown target; `k` the WBC tick (Python int)."""
    dt = cfg.dt_wbc
    k_mpc = cfg.k_mpc
    dtype = state.position.dtype
    swing = gait.current[..., 0, :] == 0.0                   # (..., 4)
    mpc_tick = (k % k_mpc) == 0

    info = phase_durations(gait, 0.0, cfg.dt_mpc)
    t_swing_new = info.duration[..., 0, :]
    remaining = info.remaining[..., 0, :].to(dtype)
    val = (t_swing_new - (remaining * k_mpc - ((k + 1) % k_mpc)) * dt - dt)
    t0_mpc = torch.clamp(val, min=0.0)
    t0_step = torch.clamp(state.t0s + dt, min=0.0)
    if mpc_tick:
        t_swing = torch.where(swing, t_swing_new, state.t_swing)
        t0s = torch.where(swing, t0_mpc, state.t0s)
    else:
        t_swing = state.t_swing
        t0s = torch.where(swing, t0_step, state.t0s)

    t = t0s
    d = t_swing

    # xy quintic refit (unless inside the lock window)
    refit = swing & (t < d - cfg.lock_time)
    s = torch.clamp(d - t, min=1e-6)
    zeros24 = torch.zeros_like(state.position[..., 0:2, :])
    rhs = torch.stack([
        state.position[..., 0:2, :],
        state.velocity[..., 0:2, :] * s[..., None, :],
        state.acceleration[..., 0:2, :] * s[..., None, :] ** 2,
        target[..., 0:2, :], zeros24, zeros24], dim=-3)     # (..., 6, 2, 4)
    with host_read("foot_trajectory_binv"):
        binv = torch.as_tensor(_BINV, dtype=dtype, device=s.device)
    new_coeffs = torch.einsum("ij,...jak->...kai", binv, rhs)
    coeffs = torch.where(refit[..., None, None], new_coeffs, state.coeffs)
    t_fit = torch.where(refit, t, state.t_fit)
    s_fit = torch.where(refit, s, state.s_fit)

    # evaluate xy at ev = t + dt
    ev = t + dt
    tau = (ev - t_fit) / s_fit
    ar6 = torch.arange(6, dtype=dtype, device=s.device)
    powers = tau[..., None] ** ar6                           # (..., 4, 6)
    zcol = torch.zeros_like(powers[..., 0:1])
    dpow = torch.cat([zcol, ar6[1:] * powers[..., :5]], dim=-1)
    ddpow = torch.cat([zcol, zcol, (ar6[2:] * ar6[1:5]) * powers[..., :4]],
                      dim=-1)
    pos_xy = torch.einsum("...fai,...fi->...af", coeffs, powers)
    vel_xy = torch.einsum("...fai,...fi->...af", coeffs, dpow) \
        / s_fit[..., None, :]
    acc_xy = torch.einsum("...fai,...fi->...af", coeffs, ddpow) \
        / s_fit[..., None, :] ** 2

    in_range = ((t >= 0.0) & (t <= d))[..., None, :]
    pos_xy = torch.where(in_range, pos_xy, state.position[..., 0:2, :])
    vel_xy = torch.where(in_range, vel_xy, torch.zeros_like(vel_xy))
    acc_xy = torch.where(in_range, acc_xy, torch.zeros_like(acc_xy))

    h = cfg.max_height
    z = 64.0 * h * ev ** 3 * (d - ev) ** 3 / d ** 6
    dz = 64.0 * h * (3 * ev ** 2 * (d - ev) ** 3
                     - 3 * ev ** 3 * (d - ev) ** 2) / d ** 6
    ddz = 64.0 * h * (6 * ev * (d - ev) ** 3 - 18 * ev ** 2 * (d - ev) ** 2
                      + 6 * ev ** 3 * (d - ev)) / d ** 6

    position = torch.cat([pos_xy, z[..., None, :]], dim=-2)
    velocity = torch.cat([vel_xy, dz[..., None, :]], dim=-2)
    acceleration = torch.cat([acc_xy, ddz[..., None, :]], dim=-2)

    sw = swing[..., None, :]
    position = torch.where(sw, position, state.position)
    velocity = torch.where(sw, velocity, state.velocity)
    acceleration = torch.where(sw, acceleration, state.acceleration)
    return FootTrajState(position=position, velocity=velocity,
                         acceleration=acceleration, coeffs=coeffs,
                         t_fit=t_fit, s_fit=s_fit, t0s=t0s, t_swing=t_swing)
