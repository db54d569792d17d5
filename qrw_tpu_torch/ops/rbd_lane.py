"""Lane-major (batch-on-last-axis) Solo-12 rigid-body algebra.

Port of qrw_tpu/ops/rbd_lane.py, same algorithms and layout: every
quantity keeps the BATCH on the last axis and the small structural dims
are Python structure (vectors are 3-lists of (..., B) tensors, matrices
3x3 nested lists). Python-number entries (0.0 / 1.0 / model constants)
fold symbolically through `_mul` / `_add`, so the fixed-base call and
every structurally-zero slot of the Solo-12 tree cost no tensor op.

Shapes: qj (4, 3, B) [leg, level, lane]; per-leg scalars (4, B).
Forward dynamics goes through the block structure of the mass matrix
(per-leg closed-form 3x3 inverses + a 6x6 Schur complement on the base).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch.ops.rbd import TorchModel, _legs_view

# ----------------------------------------------------------------------
# Scalar micro-DSL: python numbers fold symbolically
# ----------------------------------------------------------------------

_NUM = (int, float)


def _mul(a, b):
    if isinstance(a, _NUM):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if isinstance(b, _NUM):
            return a * b
    if isinstance(b, _NUM):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
    return a * b


def _add(*terms):
    out = 0.0
    for t in terms:
        if isinstance(t, _NUM) and t == 0.0:
            continue
        out = t if (isinstance(out, float) and out == 0.0) else out + t
    return out


def _neg(a):
    return -a


def _sum0(e):
    """Sum over the leg axis (numbers pass through x4)."""
    return 4.0 * e if isinstance(e, _NUM) else e.sum(0)


def vec(x, y, z):
    return [x, y, z]


def mat(rows):
    return [list(r) for r in rows]


EYE3 = mat([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
ZV3 = vec(0.0, 0.0, 0.0)


def mv(M, v):
    """M @ v."""
    return [_add(_mul(M[i][0], v[0]), _mul(M[i][1], v[1]),
                 _mul(M[i][2], v[2])) for i in range(3)]


def mtv(M, v):
    """M' @ v."""
    return [_add(_mul(M[0][i], v[0]), _mul(M[1][i], v[1]),
                 _mul(M[2][i], v[2])) for i in range(3)]


def mm(A, B):
    """A @ B."""
    return [[_add(_mul(A[i][0], B[0][j]), _mul(A[i][1], B[1][j]),
                  _mul(A[i][2], B[2][j])) for j in range(3)]
            for i in range(3)]


def vadd(*vs):
    return [_add(*[v[i] for v in vs]) for i in range(3)]


def vsub(a, b):
    return [_add(a[i], _neg(b[i])) for i in range(3)]


def vscale(s, v):
    return [_mul(s, v[i]) for i in range(3)]


def cross(a, b):
    return [_add(_mul(a[1], b[2]), _neg(_mul(a[2], b[1]))),
            _add(_mul(a[2], b[0]), _neg(_mul(a[0], b[2]))),
            _add(_mul(a[0], b[1]), _neg(_mul(a[1], b[0])))]


def dot(a, b):
    return _add(_mul(a[0], b[0]), _mul(a[1], b[1]), _mul(a[2], b[2]))


def rot_x(c, s):
    return mat([[1.0, 0.0, 0.0], [0.0, c, _neg(s)], [0.0, s, c]])


def rot_y(c, s):
    return mat([[c, 0.0, s], [0.0, 1.0, 0.0], [_neg(s), 0.0, c]])


def quat_to_mat(q):
    """Quaternion [x, y, z, w] (each (..., B)) -> Mat (normalized)."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return mat([[1.0 - (yy + zz), xy - wz, xz + wy],
                [xy + wz, 1.0 - (xx + zz), yz - wx],
                [xz - wy, yz + wx, 1.0 - (xx + yy)]])


# ----------------------------------------------------------------------
# Model constants, leg-major
# ----------------------------------------------------------------------

class LaneModel(NamedTuple):
    """Static per-leg constants (numpy float64 at rest; `_cast_lane`
    hands out cached tensors per dtype and device). Legs FL, FR, HL, HR;
    levels 0..2."""
    jpos: tuple          # jpos[level] = Vec of (4,) arrays
    axis_kind: tuple     # ('x', 'y', 'y')
    mass: np.ndarray     # (4, 3) link masses
    com: tuple           # com[level] = Vec of (4,)
    inertia_o: tuple     # inertia_o[level] = Mat of (4,)
    foot_pos: tuple      # Vec of (4,)
    base_mass: float
    base_com: tuple      # Vec of floats
    base_inertia_o: tuple  # Mat of floats


def to_lane(model: TorchModel) -> LaneModel:
    ja = np.asarray(model.joint_axis)
    legs_axis = _legs_view(ja)
    kinds = []
    for l in range(3):
        ax = legs_axis[:, l]
        if np.allclose(np.abs(ax), [1.0, 0.0, 0.0]):
            kinds.append("x")
        elif np.allclose(np.abs(ax), [0.0, 1.0, 0.0]):
            kinds.append("y")
        else:  # pragma: no cover - solo12 is x/y/y
            raise ValueError(f"unsupported joint axis {ax}")
        assert np.allclose(ax, ax[0]), "legs share joint axes"
        assert np.allclose(ax[0].sum(), 1.0), "axes are +x / +y"
    legs_jp = _legs_view(np.asarray(model.joint_pos))
    legs_com = _legs_view(np.asarray(model.com))
    io = np.asarray(model.inertia_o)
    legs_io = _legs_view(io)
    mass = _legs_view(np.asarray(model.mass))
    fp = np.asarray(model.foot_pos)

    def vec_np(a):
        return [a[:, i].copy() for i in range(3)]

    def mat_np(a):
        return [[a[:, i, j].copy() for j in range(3)] for i in range(3)]

    return LaneModel(
        jpos=tuple(vec_np(legs_jp[:, l]) for l in range(3)),
        axis_kind=tuple(kinds),
        mass=mass.copy(),
        com=tuple(vec_np(legs_com[:, l]) for l in range(3)),
        inertia_o=tuple(mat_np(legs_io[:, l]) for l in range(3)),
        foot_pos=vec_np(fp),
        base_mass=float(model.mass[0]),
        base_com=[float(c) for c in np.asarray(model.com)[0]],
        base_inertia_o=[[float(io[0, i, j]) for j in range(3)]
                        for i in range(3)],
    )


_SOLO12_LANE: Optional[LaneModel] = None


def solo12_lane() -> LaneModel:
    """The Solo-12 LaneModel (cached)."""
    global _SOLO12_LANE
    if _SOLO12_LANE is None:
        from qrw_tpu_torch.models.solo12 import make_solo12
        from qrw_tpu_torch.ops.rbd import to_torch
        _SOLO12_LANE = to_lane(to_torch(make_solo12()))
    return _SOLO12_LANE


_CAST_CACHE: dict = {}


def _cast_lane(model: LaneModel, dtype, device) -> LaneModel:
    """The numpy constants as tensors of the lane dtype on `device`,
    cached per (model, dtype, device)."""
    key = (id(model), dtype, str(device))
    hit = _CAST_CACHE.get(key)
    if hit is not None and hit[0] is model:
        return hit[1]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    out = model._replace(
        jpos=tuple([t(e) for e in v] for v in model.jpos),
        mass=t(model.mass),
        com=tuple([t(e) for e in v] for v in model.com),
        inertia_o=tuple([[t(e) for e in row] for row in M]
                        for M in model.inertia_o),
        foot_pos=[t(e) for e in model.foot_pos])
    _CAST_CACHE[key] = (model, out)
    return out


def _np_col(a):
    """(4,) constant -> broadcastable against (4, B) lanes."""
    return a[:, None]


def _level_rot(kind: str, c, s):
    return rot_x(c, s) if kind == "x" else rot_y(c, s)


def _leg_const(v):
    """Vec/Mat of (4,) -> entries shaped (4, 1)."""
    if isinstance(v[0], list):
        return [[_np_col(e) for e in row] for row in v]
    return [_np_col(e) for e in v]


def _axis(kind):
    return vec(1.0, 0.0, 0.0) if kind == "x" else vec(0.0, 1.0, 0.0)


# ----------------------------------------------------------------------
# Forward kinematics (world frame) + foot frame kinematics
# ----------------------------------------------------------------------

class LaneFrameKin(NamedTuple):
    pos: list     # Vec of (4, B) world foot positions
    vel: list     # Vec of (4, B) world foot point velocities
    drift: list   # Vec of (4, B) classical acceleration with qdd = 0
    R: list       # [R0 Mat (B,), R1..R3 Mat (4, B)] body rotations
    p: list       # [p0 Vec (B,), p1..p3 Vec (4, B)] body origins
    omega: list   # Vec of (4, B) foot body angular velocity (world)


def _broadcast_leg(v):
    """Vec of (B,) -> Vec of (4, B) (numbers pass through)."""
    return [e if isinstance(e, _NUM) else e[None, :] for e in v]


def _broadcast_leg_mat(M):
    return [[e if isinstance(e, _NUM) else e[None, :] for e in row]
            for row in M]


def frame_kinematics(model: LaneModel, base_pos, R0, qj, base_vel, vj):
    """Foot positions / velocities / drift, lane-major.

    base_pos: Vec of (B,) (or numbers for a fixed base); R0: Mat of (B,)
    (or EYE3); qj, vj: (4, 3, B); base_vel: (v_lin Vec, omega Vec) in
    the BASE frame, or None for a fixed base."""
    model = _cast_lane(model, qj.dtype, qj.device)
    c = torch.cos(qj)
    s = torch.sin(qj)
    cl = [c[:, l] for l in range(3)]
    sl = [s[:, l] for l in range(3)]

    Rp = _broadcast_leg_mat(R0)
    pp = _broadcast_leg(base_pos)
    if base_vel is None:
        wp, vp, ap = ZV3, ZV3, ZV3
    else:
        vb, wb = base_vel
        w0 = mv(R0, wb)
        v0 = mv(R0, vb)
        wp = _broadcast_leg(w0)
        vp = _broadcast_leg(v0)
        ap = _broadcast_leg(cross(w0, v0))
    dwp = ZV3

    Rs, ps = [], []
    for l in range(3):
        Rj = _level_rot(model.axis_kind[l], cl[l], sl[l])
        jpos = _leg_const(model.jpos[l])
        r_w = mv(Rp, jpos)
        a_w = mv(Rp, _axis(model.axis_kind[l]))
        qdl = vj[:, l]
        Ri = mm(Rp, Rj)
        pi = vadd(pp, r_w)
        wi = vadd(wp, vscale(qdl, a_w))
        vi = vadd(vp, cross(wp, r_w))
        dwi = vadd(dwp, vscale(qdl, cross(wp, a_w)))
        ai = vadd(ap, cross(dwp, r_w), cross(wp, cross(wp, r_w)))
        Rs.append(Ri)
        ps.append(pi)
        Rp, pp, wp, vp, dwp, ap = Ri, pi, wi, vi, dwi, ai

    rc = mv(Rp, _leg_const(model.foot_pos))
    pos = vadd(pp, rc)
    vel = vadd(vp, cross(wp, rc))
    drift = vadd(ap, cross(dwp, rc), cross(wp, cross(wp, rc)))
    return LaneFrameKin(pos=pos, vel=vel, drift=drift,
                        R=[R0] + Rs, p=[base_pos] + ps, omega=wp)


class LaneJacobians(NamedTuple):
    """LOCAL_WORLD_ALIGNED linear foot Jacobians in block form: the
    (3, 18) row block per foot is [R0 | -skew(pf - p0) R0 | leg 3x3]."""
    Jb_lin: list   # Mat of (B,) R0
    Jb_ang: list   # Mat of (4, B)
    Jleg: list     # Mat of (4, B)


def foot_jacobians(model: LaneModel, kin: LaneFrameKin, R0, base_pos
                   ) -> LaneJacobians:
    pf = kin.pos
    p_legs = kin.p[1:]
    R_legs = kin.R[1:]
    Rpars = [_broadcast_leg_mat(R0), R_legs[0], R_legs[1]]
    cols = []
    for l in range(3):
        a_w = mv(Rpars[l], _axis(model.axis_kind[l]))
        cols.append(cross(a_w, vsub(pf, p_legs[l])))
    Jleg = [[cols[l][i] for l in range(3)] for i in range(3)]
    rel = vsub(pf, _broadcast_leg(base_pos))
    sk = mat([[0.0, rel[2], _neg(rel[1])],
              [_neg(rel[2]), 0.0, rel[0]],
              [rel[1], _neg(rel[0]), 0.0]])
    Jb_ang = mm(sk, _broadcast_leg_mat(R0))
    return LaneJacobians(Jb_lin=R0, Jb_ang=Jb_ang, Jleg=Jleg)


# ----------------------------------------------------------------------
# RNEA (inverse dynamics), lane-major
# ----------------------------------------------------------------------

def _joint_rot_T(model: LaneModel, cl, sl, l):
    """E = R_joint' (child <- parent rotation)."""
    Rj = _level_rot(model.axis_kind[l], cl, sl)
    return [[Rj[j][i] for j in range(3)] for i in range(3)]


def _sp_apply_inertia(mass, com, Io, w, v):
    """Spatial inertia applied to a motion (w, v) -> (n, f)."""
    n = vadd(mv(Io, w), vscale(mass, cross(com, v)))
    f = vsub(vscale(mass, v), vscale(mass, cross(com, w)))
    return n, f


def rnea(model: LaneModel, R0, qj, v, a, gravity: float = 9.81,
         base_vel_zero: bool = False):
    """Inverse dynamics, lane-major. R0: base rotation Mat; qj (4, 3, B);
    v = (v_lin Vec, w Vec, vj (4, 3, B)) in Pinocchio convention; a
    likewise. Returns (f_base Vec, n_base Vec, tau (4, 3, B)) with the
    base wrench [force; torque] in the base frame."""
    model = _cast_lane(model, qj.dtype, qj.device)
    v_lin, w_b, vj = v
    a_lin, dw_b, aj = a

    c = torch.cos(qj)
    s = torch.sin(qj)

    gz = vec(0.0, 0.0, gravity)
    g_b = mtv(R0, gz)
    a0_w = dw_b
    a0_v = vadd(a_lin, g_b)
    v0_w = ZV3 if base_vel_zero else w_b
    v0_v = ZV3 if base_vel_zero else v_lin

    wp = _broadcast_leg(v0_w)
    vp = _broadcast_leg(v0_v)
    awp = _broadcast_leg(a0_w)
    avp = _broadcast_leg(a0_v)

    fs = []
    for l in range(3):
        cl, sl = c[:, l], s[:, l]
        E = _joint_rot_T(model, cl, sl, l)
        r = _leg_const(model.jpos[l])
        axis = _axis(model.axis_kind[l])
        qd = vj[:, l]
        qdd = aj[:, l]
        wi_ = mv(E, wp)
        vi_ = mv(E, vsub(vp, cross(r, wp)))
        Sd = vscale(qd, axis)
        wi = vadd(wi_, Sd)
        vi = vi_
        awi_ = mv(E, awp)
        avi_ = mv(E, vsub(avp, cross(r, awp)))
        awi = vadd(awi_, vscale(qdd, axis), cross(wi, Sd))
        avi = vadd(avi_, cross(vi, Sd))
        mass = _np_col(model.mass[:, l])
        com = _leg_const(model.com[l])
        Io = _leg_const(model.inertia_o[l])
        n_a, f_a = _sp_apply_inertia(mass, com, Io, awi, avi)
        n_v, f_v = _sp_apply_inertia(mass, com, Io, wi, vi)
        ni = vadd(n_a, cross(wi, n_v), cross(vi, f_v))
        fi = vadd(f_a, cross(wi, f_v))
        fs.append((ni, fi))
        wp, vp, awp, avp = wi, vi, awi, avi

    bc = model.base_com
    bIo = model.base_inertia_o
    bm = model.base_mass
    n0a = vadd(mv(bIo, a0_w), vscale(bm, cross(bc, a0_v)))
    f0a = vsub(vscale(bm, a0_v), vscale(bm, cross(bc, a0_w)))
    n0v = vadd(mv(bIo, v0_w), vscale(bm, cross(bc, v0_v)))
    f0v = vsub(vscale(bm, v0_v), vscale(bm, cross(bc, v0_w)))
    n0 = vadd(n0a, cross(v0_w, n0v), cross(v0_v, f0v))
    f0 = vadd(f0a, cross(v0_w, f0v))

    taus = [None] * 3
    n_legs = f_legs = None
    n_acc, f_acc = fs[2]
    for l in (2, 1, 0):
        axis_idx = 0 if model.axis_kind[l] == "x" else 1
        taus[l] = n_acc[axis_idx]
        cl, sl = c[:, l], s[:, l]
        E = _joint_rot_T(model, cl, sl, l)
        r = _leg_const(model.jpos[l])
        f_p = mtv(E, f_acc)
        n_p = vadd(mtv(E, n_acc), cross(r, f_p))
        if l > 0:
            n_acc = vadd(fs[l - 1][0], n_p)
            f_acc = vadd(fs[l - 1][1], f_p)
        else:
            n_legs, f_legs = n_p, f_p

    n_base = vadd(n0, [_sum0(e) for e in n_legs])
    f_base = vadd(f0, [_sum0(e) for e in f_legs])
    tau = torch.stack(taus, dim=1)
    return f_base, n_base, tau


def nonlinear_effects(model: LaneModel, R0, qj, v, gravity: float = 9.81):
    """h(q, v) = rnea(q, v, 0)."""
    zero_a = (ZV3, ZV3, torch.zeros_like(qj))
    return rnea(model, R0, qj, v, zero_a, gravity)


# ----------------------------------------------------------------------
# CRBA blocks + block forward dynamics (Schur complement on the base)
# ----------------------------------------------------------------------

class LaneMassBlocks(NamedTuple):
    """Blocks of the free-flyer mass matrix in Pinocchio row order
    [linear; angular; joints]."""
    Mbb: list     # 6x6 nested list of (B,) tensors / numbers
    Mbj: list     # Mbj[l] = (force Vec (4, B), torque Vec (4, B))
    Mleg: list    # 3x3 nested list of (4, B)


def crba(model: LaneModel, qj) -> LaneMassBlocks:
    """Composite-rigid-body mass matrix blocks (lane-major)."""
    model = _cast_lane(model, qj.dtype, qj.device)
    c = torch.cos(qj)
    s = torch.sin(qj)

    Es, rs, axes = [], [], []
    for l in range(3):
        Es.append(_joint_rot_T(model, c[:, l], s[:, l], l))
        rs.append(_leg_const(model.jpos[l]))
        axes.append(0 if model.axis_kind[l] == "x" else 1)

    def transform_inertia(E, r, m, h, Io):
        """Child -> parent transform of a spatial inertia held as
        (m, h = m c, I about the body origin): rotate by E', then shift
        the origin by r (parallel-axis theorem between origins)."""
        Rt = [[E[j][i] for j in range(3)] for i in range(3)]
        c_r = mv(Rt, h)
        I_r = mm(Rt, mm(Io, E))

        def skew_prod(a, b):
            """[a]x [b]x = b a' - (a.b) I."""
            d = dot(a, b)
            return [[_add(_mul(b[i], a[j]), _neg(d) if i == j else 0.0)
                     for j in range(3)] for i in range(3)]

        mr = vscale(m, r)
        t1 = skew_prod(r, c_r)
        t2 = skew_prod(c_r, r)
        t3 = skew_prod(r, mr)
        I_new = [[_add(I_r[i][j], _neg(t1[i][j]), _neg(t2[i][j]),
                       _neg(t3[i][j])) for j in range(3)]
                 for i in range(3)]
        return m, vadd(c_r, mr), I_new

    level_inertia = []
    for l in range(3):
        m = _np_col(model.mass[:, l])
        h = vscale(m, _leg_const(model.com[l]))
        Io = _leg_const(model.inertia_o[l])
        level_inertia.append((m, h, Io))

    Ic = [None] * 3
    Ic[2] = level_inertia[2]
    for l in (2, 1):
        m, h, Io = transform_inertia(Es[l], rs[l], *Ic[l])
        mp, hp, Iop = level_inertia[l - 1]
        Ic[l - 1] = (_add(m, mp), vadd(h, hp),
                     [[_add(Io[i][j], Iop[i][j]) for j in range(3)]
                      for i in range(3)])

    m0, h0, Io0 = transform_inertia(Es[0], rs[0], *Ic[0])
    bm = model.base_mass
    bh = vscale(bm, model.base_com)
    bIo = model.base_inertia_o
    m_tot = _add(bm, _sum0(m0))
    h_tot = [_add(bh[i], _sum0(h0[i])) for i in range(3)]
    I_tot = [[_add(bIo[i][j], _sum0(Io0[i][j])) for j in range(3)]
             for i in range(3)]

    hx = mat([[0.0, _neg(h_tot[2]), h_tot[1]],
              [h_tot[2], 0.0, _neg(h_tot[0])],
              [_neg(h_tot[1]), h_tot[0], 0.0]])
    Mbb = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            Mbb[i][j] = m_tot if i == j else 0.0
            Mbb[i][3 + j] = _neg(hx[i][j])
            Mbb[3 + i][j] = hx[i][j]
            Mbb[3 + i][3 + j] = I_tot[i][j]

    Mleg = [[0.0] * 3 for _ in range(3)]
    Mbj = [None] * 3
    for i in (2, 1, 0):
        m, h, Io = Ic[i]
        ax = axes[i]
        e = [1.0 if k == ax else 0.0 for k in range(3)]
        Fn = [Io[k][ax] for k in range(3)]
        Ff = cross(e, h)
        Mleg[i][i] = Fn[ax]
        for j in range(i - 1, -1, -1):
            E, r = Es[j + 1], rs[j + 1]
            Ff_p = mtv(E, Ff)
            Fn_p = vadd(mtv(E, Fn), cross(r, Ff_p))
            Fn, Ff = Fn_p, Ff_p
            val = Fn[axes[j]]
            Mleg[i][j] = val
            Mleg[j][i] = val
        E, r = Es[0], rs[0]
        Ff_b = mtv(E, Ff)
        Fn_b = vadd(mtv(E, Fn), cross(r, Ff_b))
        Mbj[i] = (Ff_b, Fn_b)
    return LaneMassBlocks(Mbb=Mbb, Mbj=Mbj, Mleg=Mleg)


def _inv3_sym(M):
    """Closed-form inverse of a symmetric 3x3 Mat."""
    a, b, c = M[0][0], M[0][1], M[0][2]
    e, f = M[1][1], M[1][2]
    i = M[2][2]
    A = _add(_mul(e, i), _neg(_mul(f, f)))
    B_ = _add(_mul(c, f), _neg(_mul(b, i)))
    C = _add(_mul(b, f), _neg(_mul(c, e)))
    det = _add(_mul(a, A), _mul(b, B_), _mul(c, C))
    inv_det = 1.0 / det
    E = _add(_mul(a, i), _neg(_mul(c, c)))
    F = _add(_mul(b, c), _neg(_mul(a, f)))
    I_ = _add(_mul(a, e), _neg(_mul(b, b)))
    return [[_mul(inv_det, A), _mul(inv_det, B_), _mul(inv_det, C)],
            [_mul(inv_det, B_), _mul(inv_det, E), _mul(inv_det, F)],
            [_mul(inv_det, C), _mul(inv_det, F), _mul(inv_det, I_)]]


def chol6(M):
    """Unrolled Cholesky of a 6x6 nested-list SPD matrix."""
    n = 6
    A = [[M[i][j] for j in range(n)] for i in range(n)]
    L = [[0.0] * n for _ in range(n)]
    for j in range(n):
        d = torch.sqrt(A[j][j])
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            L[i][j] = _mul(A[i][j], inv_d)
        for i in range(j + 1, n):
            for k in range(j + 1, i + 1):
                A[i][k] = _add(A[i][k], _neg(_mul(L[i][j], L[k][j])))
    return L


def chol6_solve(L, b):
    """Solve L L' x = b for 6-vectors."""
    n = 6
    y = [None] * n
    for i in range(n):
        acc = b[i]
        for j in range(i):
            acc = _add(acc, _neg(_mul(L[i][j], y[j])))
        y[i] = _mul(acc, 1.0 / L[i][i])
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = y[i]
        for j in range(i + 1, n):
            acc = _add(acc, _neg(_mul(L[j][i], x[j])))
        x[i] = _mul(acc, 1.0 / L[i][i])
    return x


def forward_dynamics(blocks: LaneMassBlocks, rhs_base, rhs_j):
    """Solve M a = rhs through the Solo-12 block structure.

    rhs_base: 6 (B,) rows [force; torque]; rhs_j: (4, 3, B).
    Returns (a_base list of 6, a_j (4, 3, B))."""
    Minv = _inv3_sym(blocks.Mleg)
    cols = [blocks.Mbj[l][0] + blocks.Mbj[l][1] for l in range(3)]
    rj = [rhs_j[:, l] for l in range(3)]

    def leg_solve(vecs):
        return [_add(_mul(Minv[i][0], vecs[0]), _mul(Minv[i][1], vecs[1]),
                     _mul(Minv[i][2], vecs[2])) for i in range(3)]

    u = leg_solve(rj)
    srhs = []
    for r in range(6):
        acc = 0.0
        for l in range(3):
            acc = _add(acc, _mul(cols[l][r], u[l]))
        srhs.append(_add(rhs_base[r], _neg(_sum0(acc))))

    MinvB = [leg_solve([cols[0][r], cols[1][r], cols[2][r]])
             for r in range(6)]
    S = [[None] * 6 for _ in range(6)]
    for r in range(6):
        for q in range(r, 6):
            acc = 0.0
            for l in range(3):
                acc = _add(acc, _mul(cols[l][r], MinvB[q][l]))
            val = _add(blocks.Mbb[r][q], _neg(_sum0(acc)))
            S[r][q] = val
            S[q][r] = val

    L = chol6(S)
    a_base = chol6_solve(L, srhs)

    bj = []
    for l in range(3):
        acc = 0.0
        for r in range(6):
            acc = _add(acc, _mul(cols[l][r], a_base[r]))
        bj.append(_add(rj[l], _neg(acc)))
    a_j = torch.stack(leg_solve(bj), dim=1)
    return a_base, a_j
