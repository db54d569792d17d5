# Frozen copy of qrw_tpu_torch/ops/rotations.py as of the benchmark's first version;
# a plain reference: it imports nothing of the port.
"""Rotation utilities (quaternion / RPY / rotation matrix), batched.

Port of qrw_tpu/ops/rotations.py. Every function works on the trailing
axis and broadcasts over leading batch axes. Quaternions use the
(x, y, z, w) convention.
"""

from __future__ import annotations

import torch


def quat_to_rot(q):
    """Quaternion (..., 4) [x,y,z,w] -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.clamp(n, min=1e-30),
                    torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def quat_to_rpy(q):
    """Quaternion (..., 4) [x,y,z,w] -> roll/pitch/yaw (..., 3)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (qy * qz + qw * qx),
                       qw * qw - qx * qx - qy * qy + qz * qz)
    pitch = torch.asin(torch.clamp(-2.0 * (qx * qz - qw * qy), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (qx * qy + qw * qz),
                      qw * qw + qx * qx - qy * qy - qz * qz)
    return torch.stack([roll, pitch, yaw], dim=-1)


def rpy_to_quat(rpy):
    """Roll/pitch/yaw (..., 3) -> quaternion (..., 4) [x,y,z,w]."""
    half = 0.5 * rpy
    sr, sp, sy = (torch.sin(half[..., 0]), torch.sin(half[..., 1]),
                  torch.sin(half[..., 2]))
    cr, cp, cy = (torch.cos(half[..., 0]), torch.cos(half[..., 1]),
                  torch.cos(half[..., 2]))
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    qw = cr * cp * cy + sr * sp * sy
    return torch.stack([qx, qy, qz, qw], dim=-1)


def rpy_to_rot(rpy):
    """Roll/pitch/yaw (..., 3) -> R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, sr = torch.cos(rpy[..., 0]), torch.sin(rpy[..., 0])
    cp, sp = torch.cos(rpy[..., 1]), torch.sin(rpy[..., 1])
    cy, sy = torch.cos(rpy[..., 2]), torch.sin(rpy[..., 2])
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr,
                     cy * sp * cr + sy * sr], dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr,
                     sy * sp * cr - cy * sr], dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ], dim=-2)


def rot_z(yaw):
    """Yaw angle (...,) -> rotation matrix (..., 3, 3) about z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, z], dim=-1),
        torch.stack([s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def skew(v):
    """Vector (..., 3) -> skew-symmetric matrix (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def quat_mul(q1, q2):
    """Hamilton product of quaternions in [x,y,z,w] convention."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_integrate(q, omega, dt):
    """Integrate body-frame angular velocity omega (..., 3) over dt onto
    quaternion q (..., 4); exponential map, normalized."""
    th = torch.linalg.vector_norm(omega, dim=-1, keepdim=True) * dt
    half = 0.5 * th
    small = th < 1e-8
    k = torch.where(small, torch.full_like(th, 0.5 * dt),
                    torch.sin(half) * dt / torch.clamp(th, min=1e-30))
    dq = torch.cat([omega * k, torch.cos(half)], dim=-1)
    out = quat_mul(q, dq)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
