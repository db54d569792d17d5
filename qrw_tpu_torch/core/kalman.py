"""Kalman-filter state estimation variants (the kf_enabled path).

Port of qrw_tpu/core/kalman.py, batched over leading robot axes:

  * KF6 (`KF6State`, `kf6_init`, `kf6_matrices`, `kf6_step`): the
    6-state filter (base position and linear velocity) with identity
    observation, Q = 1000 I and R = I. Kept for parity; run_filter does
    not use it, as in the reference.
  * KF18 (`KF18State`, `kf18_init`, `kf18_noise`, `kf18_step`): the
    18-state filter (IMU world position, IMU world linear velocity, 4
    world foot positions) with 16 measurements (4 IMU-to-foot relative
    positions in world axes, 4 foot heights), contact-gated noise and a
    prediction driven by the world-frame IMU acceleration. This is the
    filter that `cfg.kf_enabled` selects in core/estimator.run_filter.

Every matrix has a fixed shape and the contact gating is branch-free
(torch.where on the per-foot trust), so a (B, ...) state steps B robots
at once. Inverses go through torch.linalg.inv_ex, which reads no status
back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from qrw_tpu_torch.config import Config

# the 18-state filter's tuning
SIGMA_KIN = 0.1
SIGMA_H = 1.0
SIGMA_A = 0.1
SIGMA_DP = 0.1
GAMMA = 30.0
TRUST_SWING = 0.01


def _mv(M, v):
    """(..., r, c) @ (..., c) -> (..., r)."""
    return (M @ v[..., None])[..., 0]


# ----------------------------------------------------------------------
# 6-state filter
# ----------------------------------------------------------------------

class KF6State(NamedTuple):
    X: torch.Tensor   # (..., 6) [pos; vel]
    P: torch.Tensor   # (..., 6, 6)


def kf6_init(dtype=torch.float32, device="cpu") -> KF6State:
    return KF6State(X=torch.zeros(6, dtype=dtype, device=device),
                    P=torch.eye(6, dtype=dtype, device=device))


def kf6_matrices(dt: float):
    """A, B, Q, R of the 6-state filter (numpy float64)."""
    A = np.eye(6)
    A[0:3, 3:6] = dt * np.eye(3)
    B = np.zeros((6, 3))
    B[0:3, :] = 0.5 * dt * dt * np.eye(3)
    B[3:6, :] = dt * np.eye(3)
    Q = 1000.0 * np.eye(6)
    R = np.eye(6)
    return A, B, Q, R


def kf6_step(dt: float, state: KF6State, accel, meas) -> KF6State:
    """predict(U=accel), then correct(Z=meas)."""
    kw = dict(dtype=state.X.dtype, device=state.X.device)
    A, B, Q, R = (torch.as_tensor(m, **kw) for m in kf6_matrices(dt))
    X = _mv(A, state.X) + _mv(B, accel)
    P = A @ state.P @ A.T + Q
    S = P + R                                  # H = I
    K = P @ torch.linalg.inv_ex(S).inverse
    X = X + _mv(K, meas - X)
    P = P - K @ P
    return KF6State(X=X, P=P)


# ----------------------------------------------------------------------
# 18-state filter
# ----------------------------------------------------------------------

class KF18State(NamedTuple):
    X: torch.Tensor   # (..., 18) [imu pos; imu vel; foot0..3 pos] world
    P: torch.Tensor   # (..., 18, 18)


def kf18_init(h_init: float, dtype=torch.float32,
              device="cpu") -> KF18State:
    """X starts at [0, 0, h_init]."""
    X = torch.zeros(18, dtype=dtype, device=device)
    X[2] = h_init
    return KF18State(X=X, P=torch.eye(18, dtype=dtype, device=device))


def _kf18_const(dt: float):
    """A, B, H of the 18-state filter (numpy float64)."""
    A = np.eye(18)
    A[0:3, 3:6] = dt * np.eye(3)
    B = np.zeros((18, 3))
    B[0:3, :] = 0.5 * dt * dt * np.eye(3)
    B[3:6, :] = dt * np.eye(3)
    H = np.zeros((16, 18))
    for i in range(4):
        for j in range(3):
            H[3 * i + j, j] = 1.0
            H[3 * i + j, j + 6 + 3 * i] = -1.0
        H[12 + i, 6 + 3 * i + 2] = 1.0
    return A, B, H


def kf18_noise(dt: float, feet_status, dtype):
    """Contact-gated diagonals of R (..., 16) and Q (..., 18) from
    feet_status (..., 4)."""
    one = torch.ones((), dtype=dtype, device=feet_status.device)
    trust = torch.where(feet_status > 0, one, one * TRUST_SWING)
    r_kin = SIGMA_KIN ** 2 / trust                         # (..., 4)
    r_h = SIGMA_H ** 2 / trust
    R = torch.cat([torch.repeat_interleave(r_kin, 3, dim=-1), r_h], dim=-1)
    q_feet = (SIGMA_DP ** 2 * (1.0 + torch.exp(GAMMA * (0.5 - trust)))
              * dt * dt)                                   # (..., 4)
    batch = tuple(feet_status.shape[:-1])
    Q = torch.cat([
        torch.zeros(batch + (3,), dtype=dtype, device=feet_status.device),
        torch.full(batch + (3,), SIGMA_A ** 2 * dt * dt, dtype=dtype,
                   device=feet_status.device),
        torch.repeat_interleave(q_feet, 3, dim=-1)], dim=-1)
    return R, Q


def kf18_step(cfg: Config, state: KF18State, oRb, imu_acc_world,
              foot_pos_base, feet_status, imu_ang_vel
              ) -> Tuple[KF18State, torch.Tensor, torch.Tensor]:
    """One predict + correct tick of the kf_enabled path.

    oRb (..., 3, 3) base -> world rotation; imu_acc_world (..., 3) the
    IMU acceleration in world axes; foot_pos_base (..., 4, 3) foot
    positions in the base frame (fixed-base FK); feet_status (..., 4)
    contact flags; imu_ang_vel (..., 3) gyro (base frame). Returns
    (state, filt_lin_pos (world), filt_lin_vel (base frame))."""
    dt = cfg.dt_wbc
    dtype, dev = state.X.dtype, state.X.device
    A, B, H = (torch.as_tensor(m, dtype=dtype, device=dev)
               for m in _kf18_const(dt))
    Rd, Qd = kf18_noise(dt, feet_status, dtype)
    imu_r = torch.as_tensor(cfg.imu_offset, dtype=dtype, device=dev)

    # predict
    X = _mv(A, state.X) + _mv(B, imu_acc_world)
    P = A @ state.P @ A.T + torch.diag_embed(Qd)

    # measurement: world-axis IMU-to-foot relative position, foot height 0
    rel = torch.einsum("...ab,...fb->...fa", oRb, imu_r - foot_pos_base)
    Z = torch.cat([rel.reshape(rel.shape[:-2] + (12,)),
                   torch.zeros(rel.shape[:-2] + (4,), dtype=dtype,
                               device=dev)], dim=-1)

    # correct
    S = H @ P @ H.T + torch.diag_embed(Rd)
    K = P @ H.T @ torch.linalg.inv_ex(S).inverse
    X = X + _mv(K, Z - _mv(H, X))
    P = P - K @ H @ P

    cross = torch.linalg.cross(imu_r.expand_as(imu_ang_vel), imu_ang_vel)
    filt_lin_pos = X[..., 0:3] - imu_r                     # world frame
    # the lever-arm term (base frame) is subtracted before the rotation
    # into the base frame, as in the reference
    filt_lin_vel = _mv(oRb.transpose(-1, -2), X[..., 3:6] - cross)
    return KF18State(X=X, P=P), filt_lin_pos, filt_lin_vel
