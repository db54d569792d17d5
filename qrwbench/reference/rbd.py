# Frozen copy of qrw_tpu_torch/ops/rbd.py as of the benchmark's first version;
# a plain reference: it imports nothing of the port.
"""Rigid-body dynamics of the Solo-12 (the Pinocchio replacement).

Port of qrw_tpu/ops/rbd.py: the model conversion (`TorchModel`,
`to_torch`), forward kinematics (`fk_world`), the foot frame kinematics
(`frame_kinematics`), the LOCAL_WORLD_ALIGNED foot Jacobians
(`foot_jacobians`), RNEA inverse dynamics (`rnea`,
`nonlinear_effects`) and the CRBA joint-space inertia (`crba`, 18 x 18)
of the single-robot controller and simulator. The fleet runs the
lane-major twins in ops/rbd_lane.py.

Conventions match Pinocchio's free-flyer, as in the JAX package. The
four legs are batched on a leg axis of size 4 (bodies are leg-major,
body 1 + 3*leg + level); any leading axes are robot batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qrwbench.reference.solo12 import Solo12Model
from qrwbench.reference.rotations import quat_to_rot


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


# ----------------------------------------------------------------------
# World-frame kinematics and Jacobians (leading robot batch axes)
# ----------------------------------------------------------------------

def _skew_legs(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _assemble13(x0, xs, nb: int):
    """(x0 (..., *e), three (..., 4, *e) levels) -> (..., 13, *e),
    body-ordered (body 1 + 3 * leg + level); nb: the batch rank."""
    legs = torch.stack(xs, dim=nb + 1)         # (..., 4, 3, *e)
    legs = legs.reshape(tuple(legs.shape[:nb]) + (12,)
                        + tuple(legs.shape[nb + 2:]))
    return torch.cat([x0.unsqueeze(nb), legs], dim=nb)


def fk_world(model: TorchModel, base_pos, base_quat, qj):
    """Forward kinematics: world rotation and origin of each body,
    (R (..., 13, 3, 3), p (..., 13, 3))."""
    model = _cast_model(model, qj.dtype, qj.device)
    axes = _legs_view(model.joint_axis)
    jpos = _legs_view(model.joint_pos)
    batch = qj.shape[:-1]
    q = qj.reshape(batch + (4, 3))
    R0 = quat_to_rot(base_quat)
    Rp = R0.unsqueeze(-3).expand(batch + (4, 3, 3))
    pp = base_pos.unsqueeze(-2).expand(batch + (4, 3))
    Rs, ps = [], []
    for l in range(3):
        Rj = _axis_rot_legs(axes[:, l], q[..., l])
        ps.append(pp + _mv(Rp, jpos[:, l]))
        Rs.append(Rp @ Rj)
        Rp, pp = Rs[-1], ps[-1]
    return (_assemble13(R0, Rs, len(batch)),
            _assemble13(base_pos, ps, len(batch)))


def foot_jacobians(model: TorchModel, base_pos, base_quat, qj, fk=None):
    """LOCAL_WORLD_ALIGNED linear foot Jacobians, (..., 4, 3, 18):
    columns 0:6 act on the local base twist [linear; angular], 6:18 on
    the joint rates (block-diagonal per leg). fk: optional (R, p) body
    poses of fk_world / frame_kinematics at the same configuration."""
    dtype, dev = qj.dtype, qj.device
    model = _cast_model(model, dtype, dev)
    if fk is None:
        fk = fk_world(model, base_pos, base_quat, qj)
    R13, p13 = fk
    batch = qj.shape[:-1]
    R0, p0 = R13[..., 0, :, :], p13[..., 0, :]
    R_legs = R13[..., 1:, :, :].reshape(batch + (4, 3, 3, 3))
    p_legs = p13[..., 1:, :].reshape(batch + (4, 3, 3))
    axes = _legs_view(model.joint_axis)

    # world joint axes: parent rotation per level (base, lvl0, lvl1)
    Rpar = torch.cat([R0[..., None, None, :, :].expand(batch + (4, 1, 3, 3)),
                      R_legs[..., :, :2, :, :]], dim=-3)
    axes_w = _mv(Rpar, axes)                                 # (..., 4, 3, 3)
    pf = p_legs[..., :, 2, :] + _mv(R_legs[..., :, 2, :, :], model.foot_pos)
    cols = _cr(axes_w, pf[..., :, None, :] - p_legs)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    Jj = (eye4[:, None, :, None]
          * cols.transpose(-1, -2)[..., :, :, None, :]).reshape(
              batch + (4, 3, 12))
    Jb_lin = R0.unsqueeze(-3).expand(batch + (4, 3, 3))
    Jb_ang = -(_skew_legs(pf - p0[..., None, :]) @ R0.unsqueeze(-3))
    return torch.cat([Jb_lin, Jb_ang, Jj], dim=-1)


# ----------------------------------------------------------------------
# Featherstone spatial algebra (local coordinates, angular-first)
# ----------------------------------------------------------------------

def _cr(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def _xmot_legs(E, r, m):
    """Motion transform child <- parent, legs batched: E (..., 4, 3, 3),
    r (4, 3), m (..., 4, 6) with m = (omega, v)."""
    w, v = m[..., :3], m[..., 3:]
    return torch.cat([_mv(E, w), _mv(E, v - _cr(r, w))], dim=-1)


def _xforce_legs(E, r, f):
    """Force transform child -> parent, legs batched: f = (n, f_lin)."""
    n, fl = f[..., :3], f[..., 3:]
    Et = E.transpose(-1, -2)
    fl_p = _mv(Et, fl)
    n_p = _mv(Et, n) + _cr(r, fl_p)
    return torch.cat([n_p, fl_p], dim=-1)


def _cross_motion(a, b):
    aw, av = a[..., :3], a[..., 3:]
    bw, bv = b[..., :3], b[..., 3:]
    return torch.cat([_cr(aw, bw), _cr(aw, bv) + _cr(av, bw)], dim=-1)


def _cross_force(v, f):
    w, vl = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([_cr(w, n) + _cr(vl, fl), _cr(w, fl)], dim=-1)


def _apply_inertia(mass, com, inertia_o, v6):
    """Spatial inertia applied to motion: mass (...,), com (..., 3),
    inertia_o (..., 3, 3), v6 (..., 6) = (omega, v) -> (n, f)."""
    w, vl = v6[..., :3], v6[..., 3:]
    m = mass[..., None]
    n = _mv(inertia_o, w) + m * _cr(com, vl)
    f = m * vl - m * _cr(com, w)
    return torch.cat([n, f], dim=-1)


def _spatial_inertia(mass, com, inertia_o):
    """6x6 spatial inertias (angular-first): (...,) masses -> (..., 6, 6)."""
    cx = _skew_legs(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com.dtype, device=com.device).expand(
        cx.shape)
    top = torch.cat([inertia_o, m * cx], dim=-1)
    bot = torch.cat([-m * cx, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _xmat_legs(E, r):
    """6x6 motion transforms child <- parent (angular-first),
    (..., 4, 6, 6)."""
    z = torch.zeros_like(E)
    top = torch.cat([E, z], dim=-1)
    bot = torch.cat([-(E @ _skew_legs(r)), E], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _reorder(v6):
    """[a; b] -> [b; a] over the last axis of 6: pinocchio [linear;
    angular] <-> featherstone (angular, linear)."""
    return torch.cat([v6[..., 3:6], v6[..., 0:3]], dim=-1)


def _joint_frames(model: TorchModel, qj):
    """Per-level joint transforms: Es[l] (..., 4, 3, 3) child <- parent
    rotation, rs[l] (4, 3) joint origins, S[l] (4, 6) motion subspaces."""
    axes = _legs_view(model.joint_axis)
    jpos = _legs_view(model.joint_pos)
    q = qj.reshape(qj.shape[:-1] + (4, 3))
    z3 = torch.zeros((4, 3), dtype=qj.dtype, device=qj.device)
    Es = [_axis_rot_legs(axes[:, l], q[..., l]).transpose(-1, -2)
          for l in range(3)]
    rs = [jpos[:, l] for l in range(3)]
    Ss = [torch.cat([axes[:, l], z3], dim=-1) for l in range(3)]
    return Es, rs, Ss


def rnea(model: TorchModel, base_quat, qj, v, a, gravity: float = 9.81):
    """Recursive Newton-Euler inverse dynamics: v, a (..., 18) in the
    Pinocchio free-flyer convention -> tau (..., 18), rows 0:6 the base
    wrench [force; torque] in the base frame, rows 6:18 joint torques."""
    dtype, dev = v.dtype, v.device
    model = _cast_model(model, dtype, dev)
    batch = v.shape[:-1]
    Es, rs, Ss = _joint_frames(model, qj)
    mass = _legs_view(model.mass)                 # (4, 3)
    com = _legs_view(model.com)                   # (4, 3, 3)
    Io = _legs_view(model.inertia_o)              # (4, 3, 3, 3)
    vj = v[..., 6:].reshape(batch + (4, 3))
    aj = a[..., 6:].reshape(batch + (4, 3))

    R0 = quat_to_rot(base_quat)
    v0 = _reorder(v[..., :6])
    gvec = torch.tensor([0.0, 0.0, gravity], dtype=dtype, device=dev)
    # gravity pseudo-acceleration in base coordinates
    a0 = _reorder(a[..., :6]) + torch.cat(
        [torch.zeros(batch + (3,), dtype=dtype, device=dev),
         _mv(R0.transpose(-1, -2), gvec)], dim=-1)

    vp = v0.unsqueeze(-2).expand(batch + (4, 6))
    ap = a0.unsqueeze(-2).expand(batch + (4, 6))
    fs = []
    for l in range(3):
        Sd = Ss[l] * vj[..., l, None]
        vi = _xmot_legs(Es[l], rs[l], vp) + Sd
        ai = (_xmot_legs(Es[l], rs[l], ap) + Ss[l] * aj[..., l, None]
              + _cross_motion(vi, Sd))
        fi = (_apply_inertia(mass[:, l], com[:, l], Io[:, l], ai)
              + _cross_force(vi, _apply_inertia(mass[:, l], com[:, l],
                                                Io[:, l], vi)))
        fs.append(fi)
        vp, ap = vi, ai

    f0 = (_apply_inertia(model.mass[0], model.com[0], model.inertia_o[0], a0)
          + _cross_force(v0, _apply_inertia(model.mass[0], model.com[0],
                                            model.inertia_o[0], v0)))
    tau = [None] * 3
    f_acc = fs[2]
    for l in (2, 1, 0):
        tau[l] = (Ss[l] * f_acc).sum(-1)                     # (..., 4)
        if l > 0:
            f_acc = fs[l - 1] + _xforce_legs(Es[l], rs[l], f_acc)
        else:
            f0 = f0 + _xforce_legs(Es[0], rs[0], f_acc).sum(-2)
    tau_j = torch.stack(tau, dim=-1).reshape(batch + (12,))  # leg-major
    return torch.cat([_reorder(f0), tau_j], dim=-1)


def crba(model: TorchModel, qj):
    """Composite-rigid-body joint-space inertia M (..., 18, 18) in the
    Pinocchio free-flyer coordinates; the base orientation does not
    enter M in local coordinates."""
    dtype, dev = qj.dtype, qj.device
    model = _cast_model(model, dtype, dev)
    batch = qj.shape[:-1]
    Es, rs, Ss = _joint_frames(model, qj)
    mass = _legs_view(model.mass)
    com = _legs_view(model.com)
    Io = _legs_view(model.inertia_o)
    X = [_xmat_legs(Es[l], rs[l]) for l in range(3)]
    Ic = [_spatial_inertia(mass[:, l], com[:, l], Io[:, l]).expand(
        batch + (4, 6, 6)) for l in range(3)]
    XT = [x.transpose(-1, -2) for x in X]
    # composite inertias up the chain (legs batched)
    for l in (2, 1):
        Ic[l - 1] = Ic[l - 1] + XT[l] @ Ic[l] @ X[l]
    from_base = XT[0] @ Ic[0] @ X[0]
    Icb = _spatial_inertia(model.mass[0], model.com[0],
                           model.inertia_o[0]) + from_base.sum(-3)

    # joint-joint block: per-leg 3x3, pairs (i, j <= i) via propagated F
    H = {}
    cols_b = [None] * 3                          # base coupling per level
    for i in (2, 1, 0):
        F = _mv(Ic[i], Ss[i])                     # (..., 4, 6)
        H[i, i] = (Ss[i] * F).sum(-1)
        for j in range(i - 1, -1, -1):
            F = _mv(XT[j + 1], F)                 # X' F
            H[i, j] = H[j, i] = (F * Ss[j]).sum(-1)
        cols_b[i] = _mv(XT[0], F)                 # into the base
    Hleg = torch.stack([torch.stack([H[i, j] for j in range(3)], dim=-1)
                        for i in range(3)], dim=-2)          # (..., 4, 3, 3)
    # (..., 4 legs, 3 levels, 6): featherstone (n, f) -> [force; torque]
    cols_b = _reorder(torch.stack(cols_b, dim=-2))

    eye4 = torch.eye(4, dtype=dtype, device=dev)
    Hjj = (eye4[:, None, :, None] * Hleg[..., :, :, None, :]).reshape(
        batch + (12, 12))
    Hbj = cols_b.reshape(batch + (12, 6)).transpose(-1, -2)  # (..., 6, 12)
    Hbb = _reorder(_reorder(Icb).transpose(-1, -2)).transpose(-1, -2)
    top = torch.cat([Hbb, Hbj], dim=-1)
    bot = torch.cat([Hbj.transpose(-1, -2), Hjj], dim=-1)
    return torch.cat([top, bot], dim=-2)


def nonlinear_effects(model: TorchModel, base_quat, qj, v,
                      gravity: float = 9.81):
    """Coriolis + centrifugal + gravity generalized forces (..., 18):
    rnea(q, v, 0)."""
    return rnea(model, base_quat, qj, v, torch.zeros_like(v), gravity)
