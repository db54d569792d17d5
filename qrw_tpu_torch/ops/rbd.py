"""Rigid-body model of the Solo-12 and its foot frame kinematics.

Partial port of qrw_tpu/ops/rbd.py: the model conversion (`TorchModel`,
`to_torch`, `_legs_view`, `_np_skew`) and `frame_kinematics`. The rest
(fk_world, foot_jacobians, rnea, crba in the 18x18 form) is not on the
fleet path, which runs the lane-major twins in ops/rbd_lane.py.

Conventions match Pinocchio's free-flyer, as in the JAX package. The
four legs are batched on a leg axis of size 4 (bodies are leg-major,
body 1 + 3*leg + level); any leading axes are robot batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qrw_tpu_torch.models.solo12 import Solo12Model
from qrw_tpu_torch.ops.rotations import quat_to_rot


class TorchModel(NamedTuple):
    """Counterpart of qrw_tpu.ops.rbd.JaxModel. The arrays are kept as
    float64 numpy; `_cast_model` hands out cached tensors per
    (dtype, device)."""
    parent: tuple
    joint_axis: np.ndarray   # (13, 3)
    joint_pos: np.ndarray    # (13, 3)
    mass: np.ndarray         # (13,)
    com: np.ndarray          # (13, 3)
    inertia_o: np.ndarray    # (13, 3, 3) inertia about the body origin
    foot_body: tuple
    foot_pos: np.ndarray     # (4, 3)
    shoulders: np.ndarray    # (3, 4)
    imu_offset: np.ndarray   # (3,)


def _np_skew(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def to_torch(model: Solo12Model) -> TorchModel:
    # inertia about the body origin: I_o = I_com - m [c]x [c]x
    cx = np.stack([_np_skew(c) for c in model.com])
    inertia_o = model.inertia - model.mass[:, None, None] * (cx @ cx)
    return TorchModel(
        parent=tuple(int(p) for p in model.parent),
        joint_axis=np.asarray(model.joint_axis, np.float64),
        joint_pos=np.asarray(model.joint_pos, np.float64),
        mass=np.asarray(model.mass, np.float64),
        com=np.asarray(model.com, np.float64),
        inertia_o=np.asarray(inertia_o, np.float64),
        foot_body=tuple(int(b) for b in model.foot_body),
        foot_pos=np.asarray(model.foot_pos, np.float64),
        shoulders=np.asarray(model.shoulders, np.float64),
        imu_offset=np.asarray(model.imu_offset, np.float64))


_CAST_CACHE: dict = {}


def _cast_model(model: TorchModel, dtype, device) -> TorchModel:
    """Model arrays as tensors of the computation dtype on `device`,
    cached so that a loop does not copy them to the card every tick."""
    key = (id(model), dtype, str(device))
    hit = _CAST_CACHE.get(key)
    if hit is not None and hit[0] is model:
        return hit[1]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    out = model._replace(
        joint_axis=t(model.joint_axis), joint_pos=t(model.joint_pos),
        mass=t(model.mass), com=t(model.com),
        inertia_o=t(model.inertia_o), foot_pos=t(model.foot_pos),
        shoulders=t(model.shoulders), imu_offset=t(model.imu_offset))
    _CAST_CACHE[key] = (model, out)
    return out


def _legs_view(a):
    """(13, ...) body array -> (4 legs, 3 levels, ...) view of bodies
    1..12."""
    return a[1:].reshape((4, 3) + tuple(a.shape[1:]))


def _mv(M, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _axis_rot_legs(axes, q):
    """Rodrigues for (4, 3) unit axes and (..., 4) angles -> (..., 4, 3, 3)."""
    c, s = torch.cos(q), torch.sin(q)
    z = torch.zeros_like(axes[..., 0])
    K = torch.stack([
        torch.stack([z, -axes[..., 2], axes[..., 1]], -1),
        torch.stack([axes[..., 2], z, -axes[..., 0]], -1),
        torch.stack([-axes[..., 1], axes[..., 0], z], -1)], -2)
    K2 = K @ K
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return (eye + s[..., None, None] * K
            + (1.0 - c)[..., None, None] * K2)


class FrameKin(NamedTuple):
    pos: torch.Tensor    # (..., 4, 3) foot position, world
    vel: torch.Tensor    # (..., 4, 3) foot point velocity, world axes
    omega: torch.Tensor  # (..., 4, 3) foot body angular velocity, world
    drift: torch.Tensor  # (..., 4, 3) classical foot acceleration, qdd = 0
    R: torch.Tensor      # (..., 13, 3, 3) body rotations
    p: torch.Tensor      # (..., 13, 3) body origins


def frame_kinematics(model: TorchModel, base_pos, base_quat, qj,
                     base_vel_local, vj) -> FrameKin:
    """Foot frame position / velocity / classical drift acceleration.

    base_pos (..., 3), base_quat (..., 4), qj (..., 12),
    base_vel_local (..., 6) [linear; angular] in the base frame (zeros
    for a fixed base), vj (..., 12). Mirrors rbd.frame_kinematics."""
    dtype, device = qj.dtype, qj.device
    model = _cast_model(model, dtype, device)
    axes = _legs_view(model.joint_axis)
    jpos = _legs_view(model.joint_pos)
    batch = qj.shape[:-1]
    q = qj.reshape(batch + (4, 3))
    qd = vj.reshape(batch + (4, 3))

    R0 = quat_to_rot(base_quat)
    w0 = _mv(R0, base_vel_local[..., 3:6])
    v0 = _mv(R0, base_vel_local[..., 0:3])
    Rp = R0.unsqueeze(-3).expand(batch + (4, 3, 3))
    pp = base_pos.unsqueeze(-2).expand(batch + (4, 3))
    wp = w0.unsqueeze(-2).expand(batch + (4, 3))
    vp = v0.unsqueeze(-2).expand(batch + (4, 3))
    dwp = torch.zeros(batch + (4, 3), dtype=dtype, device=device)
    ap = torch.linalg.cross(w0, v0).unsqueeze(-2).expand(batch + (4, 3))

    Rs, ps = [], []
    for l in range(3):
        Rj = _axis_rot_legs(axes[:, l], q[..., l])
        r_w = _mv(Rp, jpos[:, l])
        a_w = _mv(Rp, axes[:, l])
        qdl = qd[..., l].unsqueeze(-1)
        Ri = Rp @ Rj
        pi = pp + r_w
        wi = wp + a_w * qdl
        vi = vp + torch.linalg.cross(wp, r_w)
        dwi = dwp + qdl * torch.linalg.cross(wp, a_w)
        ai = (ap + torch.linalg.cross(dwp, r_w)
              + torch.linalg.cross(wp, torch.linalg.cross(wp, r_w)))
        Rs.append(Ri)
        ps.append(pi)
        Rp, pp, wp, vp, dwp, ap = Ri, pi, wi, vi, dwi, ai

    rc = _mv(Rp, model.foot_pos)
    pos = pp + rc
    vel = vp + torch.linalg.cross(wp, rc)
    drift = (ap + torch.linalg.cross(dwp, rc)
             + torch.linalg.cross(wp, torch.linalg.cross(wp, rc)))

    def assemble13(x0, xs):
        legs = torch.stack(xs, dim=len(batch) + 1)   # (..., 4, 3, ...)
        legs = legs.reshape(batch + (12,) + tuple(legs.shape[len(batch)
                                                             + 2:]))
        return torch.cat([x0.unsqueeze(len(batch)), legs], dim=len(batch))

    return FrameKin(pos=pos, vel=vel, omega=wp, drift=drift,
                    R=assemble13(R0, Rs), p=assemble13(base_pos, ps))
