"""DDP / iLQR centroidal MPC: the Crocoddyl-backend MPC family.

Port of qrw_tpu/core/mpc_ddp.py (the reference's second MPC backend,
scripts/crocoddyl_class/MPC_crocoddyl.py with the `quadruped_walkgen`
action models): a single-rigid-body optimal control problem over the
same N = 16 horizon, solved by the batched iLQR of ops/ilqr.py. The
semantics are the JAX package's:

  * state weights derived from the OSQP MPC weights
    (MPC_crocoddyl.py:44-61), force regularization 0.01 per axis (:64),
    a quadratic friction-cone penalty of weight 1 on the inner cone
    mu/sqrt(2) (:37-41, :66), fz in [0.2, 25] (:73-74), a shoulder
    over-extension penalty of weight 10 beyond 0.27 m (:80-82);
  * 10 DDP iterations, warm-started from the previous solution shifted
    one node (:67, :201-208);
  * the linear variant rotates the inertia and levers by the REFERENCE
    yaw, the nonlinear one by the iterate's (linearModel flag, :20);
  * the MPC_crocoddyl_2 toggles: semi-implicit integration and forces
    regularized about the static gravity distribution;
  * the 500 Hz mode's shrunken first node (`dt_first`) and its warm
    start shifted only on gait boundaries (`shift_warm`).

Every penalty is branch-free (`torch.maximum(r, 0)`, whose derivative
at r = 0 is 1/2 as JAX's `jnp.maximum`), so its exact derivatives come
from `torch.func`. A solve takes leading batch axes: B robots are one
iLQR call of B problems.

On CUDA tensors the iLQR's derivatives (the dynamics' Jacobians, the
running costs' gradients and Hessians on all B N node rows, the
terminal cost's on the B terminal states) come from one launch of the
hand-written kernel qrw_tpu_torch/csrc/ddp_derivs.cu an iteration
(`_srb_derivs`, counted in `kernels.LAUNCHES`), which writes them in the
dense layouts `ilqr._backward` reads; `_srb_derivs_plain` is the same
arithmetic in plain PyTorch. The solve's initial rollout and each
iteration's line search and accept come from one launch each of
qrw_tpu_torch/csrc/ddp_linesearch.cu (`_srb_linesearch`), whose plain
version is `ilqr.plain_linesearch`. On the CPU the solve keeps
`torch.func` and the plain line search, the JAX package's routes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch import kernels
from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.mpc import gait_from_fsteps
from qrw_tpu_torch.ops import ilqr
from qrw_tpu_torch.ops.rotations import rot_z, skew
from qrw_tpu_torch.utils.profiling import count, span, spanned

# Reference weight derivation (MPC_crocoddyl.py:44-66)
STATE_WEIGHTS = np.sqrt(np.array(
    [0.5, 0.5, 2.0, 0.11, 0.11, 0.11,
     2.0 * np.sqrt(0.5), 2.0 * np.sqrt(0.5), 2.0 * np.sqrt(2.0),
     0.05 * np.sqrt(0.11), 0.05 * np.sqrt(0.11), 0.05 * np.sqrt(0.11)]))
FORCE_WEIGHT = 0.01
FRICTION_WEIGHT = 1.0
SHOULDER_WEIGHT = 10.0
SHOULDER_HLIM = 0.27
MIN_FZ = 0.2
SHOULDERS_XY = np.array([[0.1946, 0.1946, -0.1946, -0.1946],
                         [0.14695, -0.14695, 0.14695, -0.14695]])
SHOULDER_EPS = 1e-12         # inside the shoulder distance's square root


class DDPSettings(NamedTuple):
    max_iters: int = 10          # reference max_iteration (:67)
    # crocoddyl-style line search schedule (SolverDDP alphas 2^-k)
    alphas: tuple = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625,
                     0.0078125, 0.00390625)
    reg_init: float = 1e-9       # Quu Levenberg regularization (adapted)
    reg_min: float = 1e-9
    reg_max: float = 1e4
    reg_inc: float = 10.0        # on rejected iteration (crocoddyl regfactor)
    reg_dec: float = 0.1         # on accepted iteration
    nonlinear: bool = False      # linearModel flag (:20)
    # MPC_crocoddyl_2 toggles (MPC_crocoddyl_2.py:45-48, 69-71)
    implicit_integration: bool = False
    relative_forces: bool = False

    def to_ilqr(self) -> ilqr.ILQRSettings:
        return ilqr.ILQRSettings(
            max_iters=self.max_iters, alphas=self.alphas,
            reg_init=self.reg_init, reg_min=self.reg_min,
            reg_max=self.reg_max, reg_inc=self.reg_inc,
            reg_dec=self.reg_dec)


class DDPState(NamedTuple):
    """Warm start: previous (xs, us) trajectories (MPC_crocoddyl.py:201)."""
    xs: torch.Tensor   # (..., N+1, 12)
    us: torch.Tensor   # (..., N, 12)


def init_ddp_state(cfg: Config, dtype=torch.float32,
                   device="cpu") -> DDPState:
    N = cfg.n_steps
    return DDPState(xs=torch.zeros((N + 1, 12), dtype=dtype, device=device),
                    us=torch.zeros((N, 12), dtype=dtype, device=device))


class DDPResult(NamedTuple):
    x_f_applied: torch.Tensor  # (..., 24, N) same contract as the QP MPC
    state: DDPState
    cost: torch.Tensor         # (...)
    cost_trace: torch.Tensor   # (..., max_iters) accepted cost per iteration
    iters: torch.Tensor        # (...) int32


class Consts(NamedTuple):
    """The model's constant tensors, made once per (model, dtype,
    device) and kept there: a tensor made from host data is a copy that
    blocks the host."""
    gI: torch.Tensor        # (3, 3) inertia
    com_off: torch.Tensor   # (3,) CoM offset
    grav: torch.Tensor      # (3,) gravity acceleration
    w: torch.Tensor         # (12,) state weights
    sh: torch.Tensor        # (2, 4) shoulder xy
    ez: torch.Tensor        # (3,) the z axis
    zero: torch.Tensor      # () 0


_CONSTS_CACHE: dict = {}


def make_consts(cfg: Config, dtype, device,
                state_weights=STATE_WEIGHTS) -> Consts:
    w = np.asarray(state_weights, dtype=np.float64)
    key = (tuple(cfg.gI), cfg.offset_com_z, cfg.gravity, w.tobytes(),
           dtype, str(device))
    if key not in _CONSTS_CACHE:
        _CONSTS_CACHE[key] = _new_consts(cfg, w, dtype, device)
    return _CONSTS_CACHE[key]


def _new_consts(cfg: Config, state_weights, dtype, device) -> Consts:
    kw = dict(dtype=dtype, device=device)
    return Consts(
        gI=torch.as_tensor(np.asarray(cfg.gI).reshape(3, 3), **kw),
        com_off=torch.tensor([0.0, 0.0, cfg.offset_com_z], **kw),
        grav=torch.tensor([0.0, 0.0, cfg.gravity], **kw),
        w=torch.as_tensor(state_weights, **kw),
        sh=torch.as_tensor(SHOULDERS_XY, **kw),
        ez=torch.tensor([0.0, 0.0, 1.0], **kw),
        zero=torch.zeros((), **kw))


def _dynamics(cfg: Config, x, u, feet_k, gait_k, yaw_lin, dt, c: Consts,
              implicit: bool = False):
    """SRB discrete step (src/MPC.cpp:89, 213-232). x, u (..., 12),
    feet_k (..., 12), gait_k (..., 4), yaw_lin (...) the yaw that
    rotates the inertia (the reference's for the linear model, x[5] for
    the nonlinear one), dt (...) the node's duration. implicit: the
    semi-implicit Euler of MPC_crocoddyl_2 (P+ = P + dt V+). c: the
    constants (make_consts)."""
    R = rot_z(yaw_lin)
    I_inv = torch.linalg.inv_ex(R @ c.gI @ R.transpose(-1, -2),
                                check_errors=False).inverse
    com = x[..., 0:3] + c.com_off
    lever = feet_k.reshape(feet_k.shape[:-1] + (4, 3)) - com[..., None, :]
    u4 = u.reshape(u.shape[:-1] + (4, 3)) * gait_k[..., None]
    f_tot = u4.sum(-2)
    tau = (skew(lever) @ u4[..., None])[..., 0].sum(-2)
    acc = torch.cat([f_tot / cfg.mass - c.grav,
                     (I_inv @ tau[..., None])[..., 0]], -1)
    dt = dt[..., None]
    v_new = x[..., 6:12] + dt * acc
    return torch.cat([x[..., 0:6] + dt * (v_new if implicit
                                           else x[..., 6:12]), v_new], -1)


def repeat_flags(m, r: int):
    """(..., 4) -> (..., 4 r): each foot's flag on its r components
    (jnp.repeat(m, r, axis=-1))."""
    return m[..., None].expand(m.shape + (r,)).reshape(
        m.shape[:-1] + (4 * r,))


def _u_ref(cfg: Config, gait_k, ez):
    """Static gravity distribution over the stance feet: the
    relative-forces regularization center (MPC_crocoddyl_2.py:69-71)."""
    n_c = torch.clamp(gait_k.sum(-1), min=1.0)
    fz = cfg.mass * cfg.gravity / n_c
    return (ez * (fz[..., None] * gait_k)[..., None]).reshape(
        gait_k.shape[:-1] + (12,))


def relu(r, zero):
    """max(r, 0) with JAX's derivative at the tie r = 0 (1/2)."""
    return torch.maximum(r, zero)


def _stage_cost(cfg: Config, x, u, xref_k, feet_k, gait_k, k: Consts,
                terminal: bool = False, relative_forces: bool = False):
    """Running cost of the action model (weights above); u is not read
    by the terminal cost. k: the constants (make_consts)."""
    c = 0.5 * ((k.w * (x - xref_k)) ** 2).sum(-1)

    # shoulder over-extension penalty (model.shoulderWeights / hlim)
    R2 = rot_z(x[..., 5])[..., 0:2, 0:2]
    p_sh = x[..., 0:2, None] + R2 @ k.sh                     # (..., 2, 4)
    feet = feet_k.reshape(feet_k.shape[:-1] + (4, 3))
    d = torch.sqrt(((p_sh.transpose(-1, -2) - feet[..., 0:2]) ** 2).sum(-1)
                   + x[..., 2:3] ** 2 + SHOULDER_EPS)
    viol_sh = relu(d - SHOULDER_HLIM, k.zero) * gait_k
    c = c + 0.5 * SHOULDER_WEIGHT * (viol_sh ** 2).sum(-1)
    if terminal:
        return c

    u_reg = u - _u_ref(cfg, gait_k, k.ez) if relative_forces else u
    c = c + 0.5 * FORCE_WEIGHT ** 2 * (
        (u_reg * repeat_flags(gait_k, 3)) ** 2).sum(-1)

    # friction cone penalty, inner approximation mu/sqrt(2)
    mu_i = cfg.mu / np.sqrt(2.0)
    u4 = u.reshape(u.shape[:-1] + (4, 3))
    fx, fy, fz = u4[..., 0], u4[..., 1], u4[..., 2]
    r = torch.stack([fx - mu_i * fz, -fx - mu_i * fz,
                     fy - mu_i * fz, -fy - mu_i * fz,
                     MIN_FZ - fz, fz - cfg.fz_max], -1)         # (..., 4, 6)
    viol = relu(r, k.zero) * gait_k[..., None]
    return c + 0.5 * FRICTION_WEIGHT * (viol ** 2).sum((-1, -2))


@spanned("ddp")
def solve_mpc_ddp(cfg: Config, xref, fsteps,
                  state: Optional[DDPState] = None,
                  settings: DDPSettings = DDPSettings(),
                  dt_first=None, shift_warm=None) -> DDPResult:
    """One DDP MPC solve (MPC_crocoddyl.solve, :184-214) per problem:
    xref (..., 12, N+1), fsteps (..., N_gait, 12), state the previous
    solution. Leading batch axes are problems, each solved on its own
    as under qrw_tpu's jax.vmap.

    dt_first: the first node's duration (a float or a tensor over the
    batch axes): the 500 Hz mode shrinks it to the time left until the
    next gait boundary (MPC_crocoddyl_2's dt_tsid first node,
    scripts/crocoddyl_eval/test_5/main.py:85). shift_warm: in that mode
    the warm start is shifted one node only on the boundary (a bool or
    a bool tensor broadcast over the batch axes).

    Under a profiler: the span `qrw.ddp`, in it `qrw.ddp.setup` (the
    gait, the warm start, the constants) and `qrw.ilqr`."""
    with span("ddp.setup"):
        args = _setup(cfg, xref, fsteps, state, settings, dt_first,
                      shift_warm)
    bs = tuple(xref.shape[:-2])
    N = cfg.n_steps
    res = ilqr.solve(**args, settings=settings.to_ilqr())
    x_f = torch.cat([res.xs[:, 1:].transpose(1, 2),
                     res.us.transpose(1, 2)], 1)             # (B, 24, N)
    return DDPResult(
        x_f_applied=x_f.reshape(bs + (24, N)),
        state=DDPState(xs=res.xs.reshape(bs + (N + 1, 12)),
                       us=res.us.reshape(bs + (N, 12))),
        cost=res.cost.reshape(bs),
        cost_trace=res.cost_trace.reshape(bs + (settings.max_iters,)),
        iters=torch.full(bs, settings.max_iters, dtype=torch.int32,
                         device=xref.device))


def _setup(cfg: Config, xref, fsteps, state, settings: DDPSettings,
           dt_first, shift_warm):
    """The iLQR problem of solve_mpc_ddp: ilqr.solve's arguments up to
    its settings."""
    N = cfg.n_steps
    dtype, dev = xref.dtype, xref.device
    bs = tuple(xref.shape[:-2])
    B = int(np.prod(bs, dtype=np.int64))
    if state is None:
        state = init_ddp_state(cfg, dtype, dev)
    xref = xref.reshape(B, 12, N + 1)
    fsteps = fsteps.reshape((B,) + tuple(fsteps.shape[-2:]))
    prev_us = state.us.expand(bs + (N, 12)).reshape(B, N, 12)

    gait = gait_from_fsteps(fsteps, N)                       # (B, N, 4)
    feet = fsteps[:, :N]                                     # (B, N, 12)
    x0 = xref[:, :, 0]
    xref_n = xref[:, :, 1:].transpose(1, 2)                  # (B, N, 12)
    dt = torch.full((B, N), cfg.dt_mpc, dtype=dtype, device=dev)
    if dt_first is not None:
        first = torch.as_tensor(dt_first, dtype=dtype, device=dev)
        dt = torch.cat([first.expand(bs).reshape(B, 1), dt[:, 1:]], 1)

    # warm start: the previous solution shifted one node (:201-208); the
    # appended terminal node reuses the previous terminal control
    # (gait-remasked), as in the JAX package
    us0 = torch.cat([prev_us[:, 1:], prev_us[:, -1:]], 1)
    if shift_warm is not None:
        keep = torch.as_tensor(shift_warm, device=dev).expand(bs)
        us0 = torch.where(keep.reshape(B, 1, 1), us0, prev_us)
    umask = repeat_flags(gait, 3)                            # (B, N, 12)
    us0 = us0 * umask

    nonlinear = settings.nonlinear
    consts = make_consts(cfg, dtype, dev)

    def step(x, u, feet_k, gait_k, xref_k, dt_k):
        yaw = x[..., 5] if nonlinear else xref_k[..., 5]
        return _dynamics(cfg, x, u, feet_k, gait_k, yaw, dt_k,
                         implicit=settings.implicit_integration, c=consts)

    def cost(x, u, feet_k, gait_k, xref_k, dt_k):
        return _stage_cost(cfg, x, u, xref_k, feet_k, gait_k,
                           relative_forces=settings.relative_forces,
                           k=consts)

    def cost_T(x, xref_T, feet_T, gait_T):
        return _stage_cost(cfg, x, None, xref_T, feet_T, gait_T,
                           terminal=True, k=consts)

    node_args = (feet, gait, xref_n, dt)
    term_args = (xref_n[:, -1], feet[:, -1], gait[:, -1])
    derivs = linesearch = None
    if dev.type == "cuda":
        # the kernels read their rows contiguous: made so once a solve
        x0 = x0.contiguous()
        node_args = tuple(a.contiguous() for a in node_args)
        term_args = tuple(a.contiguous() for a in term_args)
        prm, flags = derivs_params(cfg), derivs_flags(settings)
        derivs = functools.partial(_srb_derivs, prm, flags, consts.zero)
        linesearch = functools.partial(
            _srb_linesearch, prm, flags, linesearch_params(settings),
            node_args, term_args)
    return dict(step=step, cost=cost, cost_T=cost_T, x0=x0, us0=us0,
                node_args=node_args, term_args=term_args,
                project_u=lambda u, k: u * umask[:, k], derivs=derivs,
                linesearch=linesearch)


# ----------------------------------------------------------------------
# The SRB model's exact derivatives on the iLQR's rows: the kernel and
# its plain version
# ----------------------------------------------------------------------

def _tie_weight(r):
    """The derivative of torch.maximum(r, 0) in r: 1 above 0, 1/2 at the
    tie, 0 below (forward and reverse mode alike)."""
    return (r > 0).to(r.dtype) + 0.5 * (r == 0).to(r.dtype)


def _shoulder_offsets(x, feet, sx, sy):
    """The shoulder penalty's geometry on rows x (R, 12), feet (R, 12):
    the shoulders' offsets (ax, ay) rotated by the iterate's yaw, each
    foot's (ex, ey, ez) from its shoulder, and their distance d; each
    (R, 4)."""
    R = x.shape[0]
    cs, sn = torch.cos(x[:, 5:6]), torch.sin(x[:, 5:6])
    ax, ay = cs * sx - sn * sy, sn * sx + cs * sy
    f4 = feet.reshape(R, 4, 3)
    ex = x[:, 0:1] + ax - f4[..., 0]
    ey = x[:, 1:2] + ay - f4[..., 1]
    ez = x[:, 2:3].expand(R, 4)
    d = torch.sqrt(ex * ex + ey * ey + ez * ez + SHOULDER_EPS)
    return ax, ay, ex, ey, ez, d


def _state_cost_derivs(x, xref, feet, gait, c: Consts):
    """Gradient (R, 12) and Hessian (R, 12, 12) of `_stage_cost`'s state
    terms: the weighted tracking error and the shoulder penalty, whose
    Hessian in (x, y, z, yaw) keeps the distance's own second
    derivative."""
    R = x.shape[0]
    w2 = c.w * c.w
    lx = w2 * (x - xref)
    lxx = torch.diag_embed(w2.expand(R, 12))
    ax, ay, ex, ey, ez, d = _shoulder_offsets(x, feet, c.sh[0], c.sh[1])
    r = d - SHOULDER_HLIM
    wgt = SHOULDER_WEIGHT * gait * gait
    gd = torch.stack([ex, ey, ez, ey * ax - ex * ay], -1) / d[..., None]
    zero, one = torch.zeros_like(ax), torch.ones_like(ax)
    # J'J + sum_k e_k Hess(e_k), J = d(ex, ey, ez)/d(x, y, z, yaw)
    h0 = torch.stack([
        torch.stack([one, zero, zero, -ay], -1),
        torch.stack([zero, one, zero, ax], -1),
        torch.stack([zero, zero, one, zero], -1),
        torch.stack([-ay, ax, zero, ax * ax + ay * ay - ex * ax - ey * ay],
                    -1)], -2)                               # (R, 4, 4, 4)
    gg = gd[..., :, None] * gd[..., None, :]
    hd = (h0 - gg) / d[..., None, None]                     # Hess d
    rl = torch.clamp(r, min=0.0)
    m = _tie_weight(r)
    lq = (wgt * rl)[..., None] * gd
    hq = wgt[..., None, None] * ((m * m)[..., None, None] * gg
                                 + rl[..., None, None] * hd)
    lq, hq = lq.sum(1), hq.sum(1)                           # (x, y, z, yaw)
    lx[:, 0:3] += lq[:, 0:3]
    lx[:, 5] += lq[:, 3]
    lxx[:, 0:3, 0:3] += hq[:, 0:3, 0:3]
    lxx[:, 0:3, 5] += hq[:, 0:3, 3]
    lxx[:, 5, 0:3] += hq[:, 3, 0:3]
    lxx[:, 5, 5] += hq[:, 3, 3]
    return lx, lxx


def shoulder_kink_margin(x, feet, gait):
    """(R,) the least |d - SHOULDER_HLIM| over each row's stance feet, in
    float64 (inf without one): how far a row of x (R, 12), feet (R, 12),
    gait (R, 4) lies from the shoulder penalty's kink, where its Hessian
    jumps by the weight times grad d grad d'. A row within float32
    rounding of it may take either side in another order of roundings;
    the kernel's checks on the card excuse such rows."""
    sx, sy = torch.as_tensor(SHOULDERS_XY, device=x.device)
    d = _shoulder_offsets(x.double(), feet.double(), sx, sy)[-1]
    gap = (d - SHOULDER_HLIM).abs()
    return torch.where(gait != 0, gap, torch.inf).amin(-1)


def _srb_derivs_plain(cfg: Config, settings: DDPSettings, c: Consts, X, U,
                      flat, xT, term_args):
    """Plain PyTorch version of the derivatives kernel, `ilqr.solve`'s
    `derivs` for the SRB model of `_setup`: what `torch.func` gives on
    its step, cost and cost_T, written out analytically.

    X, U (R, 12) the node rows, flat = (feet (R, 12), gait (R, 4),
    xref (R, 12), dt (R,)), xT (B, 12) the terminal states, term_args =
    (xref (B, 12), feet (B, 12), gait (B, 4)). Returns fx, fu (R, 12,
    12), lx, lu (R, 12), lxx, lux, luu (R, 12, 12), Vx (B, 12), Vxx
    (B, 12, 12); lux is 0 (no running cost term couples x and u) and
    comes as a broadcast of c.zero.

    The dynamics: with a = (f_tot / m - g, I^-1 tau), d(I^-1 tau)/dp =
    I^-1 skew(f_tot), d(I^-1 tau)/du_i = g_i I^-1 skew(lever_i),
    d(f_tot / m)/du_i = g_i / m I3 and, for the nonlinear model (the
    iterate's yaw rotates I), d(I^-1 tau)/dyaw = (S I^-1 - I^-1 S) tau,
    S = skew(e_z); then v+ = v + dt a and p+ = p + dt v (explicit) or
    p + dt v+ (implicit). The costs: each max(r, 0)^2 / 2 term weighs
    grad r grad r' by the square of `_tie_weight` (1/4 at r = 0) and
    adds max(r, 0) times the Hessian of r, nonzero for the shoulder
    distance alone."""
    feet, gait, xref, dt = flat
    R = X.shape[0]
    # dynamics
    yaw = X[:, 5] if settings.nonlinear else xref[:, 5]
    Rz = rot_z(yaw)
    I_inv = torch.linalg.inv_ex(Rz @ c.gI @ Rz.transpose(-1, -2),
                                check_errors=False).inverse
    lever = feet.reshape(R, 4, 3) - (X[:, 0:3] + c.com_off)[:, None]
    u4 = U.reshape(R, 4, 3) * gait[..., None]
    dacc = X.new_zeros(R, 6, 24)                # d a / d(x, u)
    dacc[:, 3:6, 0:3] = I_inv @ skew(u4.sum(1))
    if settings.nonlinear:
        tau = torch.linalg.cross(lever, u4).sum(1)
        S = skew(c.ez)
        dacc[:, 3:6, 5] = ((S @ I_inv - I_inv @ S) @ tau[..., None])[..., 0]
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    for i in range(4):
        gi = gait[:, i, None, None]
        dacc[:, 0:3, 12 + 3 * i:15 + 3 * i] = gi / cfg.mass * eye3
        dacc[:, 3:6, 12 + 3 * i:15 + 3 * i] = gi * (I_inv @ skew(lever[:, i]))
    dt3 = dt[:, None, None]
    J = X.new_zeros(R, 12, 24)                  # d x+ / d(x, u)
    J[:, :, 0:12] = torch.eye(12, dtype=X.dtype, device=X.device)
    J[:, 0:6, 6:12] += dt3 * torch.eye(6, dtype=X.dtype, device=X.device)
    J[:, 6:12] += dt3 * dacc
    if settings.implicit_integration:
        J[:, 0:6] += dt3 * dt3 * dacc
    # running costs
    lx, lxx = _state_cost_derivs(X, xref, feet, gait, c)
    g3 = repeat_flags(gait, 3)
    u_reg = U - _u_ref(cfg, gait, c.ez) if settings.relative_forces else U
    lu = FORCE_WEIGHT ** 2 * g3 * g3 * u_reg
    luu = torch.diag_embed(FORCE_WEIGHT ** 2 * g3 * g3)
    mu_i = cfg.mu / np.sqrt(2.0)
    u4 = U.reshape(R, 4, 3)
    fx_, fy_, fz_ = u4[..., 0], u4[..., 1], u4[..., 2]
    r = torch.stack([fx_ - mu_i * fz_, -fx_ - mu_i * fz_,
                     fy_ - mu_i * fz_, -fy_ - mu_i * fz_,
                     MIN_FZ - fz_, fz_ - cfg.fz_max], -1)   # (R, 4, 6)
    rl, q = torch.clamp(r, min=0.0), _tie_weight(r) ** 2
    wc = FRICTION_WEIGHT * gait * gait                      # (R, 4)
    lu = lu + (wc[..., None] * torch.stack([
        rl[..., 0] - rl[..., 1], rl[..., 2] - rl[..., 3],
        -mu_i * rl[..., 0:4].sum(-1) - rl[..., 4] + rl[..., 5]], -1)
    ).reshape(R, 12)
    xz = wc * mu_i * (q[..., 1] - q[..., 0])
    yz = wc * mu_i * (q[..., 3] - q[..., 2])
    for i in range(4):
        j = 3 * i
        luu[:, j, j] += wc[:, i] * (q[:, i, 0] + q[:, i, 1])
        luu[:, j + 1, j + 1] += wc[:, i] * (q[:, i, 2] + q[:, i, 3])
        luu[:, j + 2, j + 2] += wc[:, i] * (
            mu_i ** 2 * q[:, i, 0:4].sum(-1) + q[:, i, 4] + q[:, i, 5])
        luu[:, j, j + 2] += xz[:, i]
        luu[:, j + 2, j] += xz[:, i]
        luu[:, j + 1, j + 2] += yz[:, i]
        luu[:, j + 2, j + 1] += yz[:, i]
    Vx, Vxx = _state_cost_derivs(xT, *term_args, c)
    return (J[:, :, 0:12], J[:, :, 12:24], lx, lu, lxx,
            c.zero.expand(R, 12, 12), luu, Vx, Vxx)


N_PARAMS = 41        # the doubles of csrc/ddp_derivs.cu's `Params`


def derivs_params(cfg: Config, state_weights=STATE_WEIGHTS):
    """The kernel's model constants as a host array of N_PARAMS doubles
    in the order of its `Params` (mass, gravity, CoM z offset, inertia
    (9), state weights (12), shoulders' x (4) and y (4), inner-cone mu,
    the least fz, fz_max, the shoulder limit, the shoulder, force^2 and
    friction weights, the shoulder distance's epsilon, m g); the kernel
    rounds them to its type. Nothing is copied to the card."""
    vals = np.concatenate([
        [cfg.mass, cfg.gravity, cfg.offset_com_z], np.asarray(cfg.gI),
        np.asarray(state_weights), SHOULDERS_XY[0], SHOULDERS_XY[1],
        [cfg.mu / np.sqrt(2.0), MIN_FZ, cfg.fz_max, SHOULDER_HLIM,
         SHOULDER_WEIGHT, FORCE_WEIGHT ** 2, FRICTION_WEIGHT,
         SHOULDER_EPS, cfg.mass * cfg.gravity]]).astype(np.float64)
    assert vals.shape == (N_PARAMS,)
    return (ctypes.c_double * N_PARAMS)(*vals)


def derivs_flags(settings: DDPSettings) -> int:
    """The model toggles as the kernel's bit mask."""
    return (int(settings.nonlinear) | int(settings.implicit_integration) << 1
            | int(settings.relative_forces) << 2)


def _srb_derivs(params, flags: int, zero, X, U, flat, xT, term_args):
    """`ilqr.solve`'s `derivs` on CUDA tensors: one launch of the
    derivatives kernel (csrc/ddp_derivs.cu) over the R = B N node rows
    and the B terminal rows, on the current stream; nothing is read back.
    Same arguments and results as `_srb_derivs_plain` (params:
    `derivs_params`, flags: `derivs_flags`, zero: a 0-d zero on the
    device, broadcast as lux). float32 or float64. Counts the rows
    ("ddp.derivs_rows", R + B, a host number) while a profiler runs."""
    if X.device.type != "cuda":
        raise ValueError(f"ddp derivs kernel: X on {X.device}, not CUDA")
    if X.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ddp derivs kernel: {X.dtype}, expected float32 "
                         f"or float64")
    R, B = X.shape[0], xT.shape[0]
    if R < 1 or B < 1 or R % B or R >= 2 ** 31:
        raise ValueError(f"ddp derivs kernel: {R} node rows over {B} "
                         f"problems")
    # each a no-op where the tensor is contiguous already, as in a solve
    X, U = X.contiguous(), U.contiguous()
    feet, gait, xref, dt = (a.contiguous() for a in flat)
    xrefT, feetT, gaitT = (a.contiguous() for a in term_args)
    for name, t, shape in (
            ("X", X, (R, 12)), ("U", U, (R, 12)), ("feet", feet, (R, 12)),
            ("gait", gait, (R, 4)), ("xref", xref, (R, 12)), ("dt", dt, (R,)),
            ("xref_T", xrefT, (B, 12)), ("feet_T", feetT, (B, 12)),
            ("gait_T", gaitT, (B, 4))):
        kernels.check(f"ddp derivs kernel: {name}", t, shape, X.dtype,
                      X.device)
    # xT may be a view with a row pitch (ldxT) other than 12
    if ((xT.dtype, xT.device, xT.shape[1:]) != (X.dtype, X.device, (12,))
            or xT.stride(1) != 1):
        raise ValueError(f"ddp derivs kernel: xT is {xT.dtype} "
                         f"{tuple(xT.shape)} on {xT.device} with strides "
                         f"{xT.stride()}, expected {X.dtype} ({B}, 12) on "
                         f"{X.device} with contiguous rows")
    fx, fu, lxx, luu, Vxx = (X.new_empty(r, 12, 12)
                             for r in (R, R, R, R, B))
    lx, lu, Vx = (X.new_empty(r, 12) for r in (R, R, B))
    kernels.launch(
        "qrw_ddp_derivs", X.element_size(), params, flags,
        X.data_ptr(), U.data_ptr(), feet.data_ptr(), gait.data_ptr(),
        xref.data_ptr(), dt.data_ptr(), xT.data_ptr(), xrefT.data_ptr(),
        feetT.data_ptr(), gaitT.data_ptr(),
        fx.data_ptr(), fu.data_ptr(), lx.data_ptr(), lu.data_ptr(),
        lxx.data_ptr(), luu.data_ptr(), Vx.data_ptr(), Vxx.data_ptr(),
        R, B, xT.stride(0),
        torch.cuda.current_stream(X.device).cuda_stream,
        key=X.element_size())
    count("ddp.derivs_rows", R + B)
    return fx, fu, lx, lu, lxx, zero.expand(R, 12, 12), luu, Vx, Vxx


def derivs_blocks_per_sm(itemsize: int) -> int:
    """Blocks of the derivatives kernel an SM holds at once for elements
    of `itemsize` bytes (4: float32, 8: float64)."""
    return kernels.query("qrw_ddp_derivs_blocks", int(itemsize))


# ----------------------------------------------------------------------
# The line search and accept, and the initial rollout: the kernel
# ----------------------------------------------------------------------

# csrc/ddp_linesearch.cu's MAX_N and MAX_A, kept in step by hand: the
# launcher refuses a larger problem in words, the kernel's own check (it
# returns -1) is a backstop
MAX_NODES = 32
MAX_ALPHAS = 32


def linesearch_params(settings: DDPSettings):
    """The line-search kernel's host parameters: 4 + A doubles, reg_min,
    reg_max, reg_inc, reg_dec and the A step sizes; the kernel rounds
    them to its type. Nothing is copied to the card."""
    vals = [settings.reg_min, settings.reg_max, settings.reg_inc,
            settings.reg_dec, *settings.alphas]
    return (ctypes.c_double * len(vals))(*vals)


def _check_rows(name, t, shape, like):
    """kernels.check, and the 16-byte alignment the kernel's vector loads
    need."""
    kernels.check(f"ddp line search kernel: {name}", t, shape, like.dtype,
                  like.device)
    if t.data_ptr() % 16:
        raise ValueError(f"ddp line search kernel: {name} is not 16-byte "
                         f"aligned")


def _srb_linesearch(params, flags: int, ls, node_args, term_args, x0, xs,
                    us, kffs, Ks, cost, reg, trace, it):
    """`ilqr.solve`'s `linesearch` on CUDA tensors (its contract in
    ops/ilqr's docstring): one launch of the line-search kernel
    (csrc/ddp_linesearch.cu) over the B problems, on the current stream;
    nothing is read back. params: `derivs_params`, flags: `derivs_flags`,
    ls: `linesearch_params`; node_args = (feet (B, N, 12), gait (B, N, 4),
    xref (B, N, 12), dt (B, N)), term_args = (xref (B, 12), feet (B, 12),
    gait (B, 4)), contiguous; x0 (B, 12); us (B, N, 12); for the line
    search xs (B, N+1, 12), the N kffs (B, 12) and Ks (B, 12, 12)
    (column-major, as `ilqr._backward`'s solve leaves them: each K.mT
    dense), cost, reg (B,) and trace (B, M) with
    0 <= it < M; kffs and Ks None for the initial rollout. float32 or
    float64. Counts the problems ("ddp.linesearch_problems", B a launch, a
    host number) while a profiler runs. Every argument is checked against
    x0's dtype and device before x0's own device and dtype are."""
    B, N = us.shape[0], us.shape[1]
    A = len(ls) - 4
    if not (1 <= B < 2 ** 31 and 1 <= N <= MAX_NODES
            and 1 <= A <= MAX_ALPHAS):
        raise ValueError(f"ddp line search kernel: {B} problems of {N} "
                         f"nodes, {A} step sizes (at most {MAX_NODES} "
                         f"nodes and {MAX_ALPHAS} step sizes)")
    feet, gait, xref, dt = node_args
    xrefT, feetT, gaitT = term_args
    for name, t, shape in (
            ("x0", x0, (B, 12)), ("us", us, (B, N, 12)),
            ("feet", feet, (B, N, 12)), ("gait", gait, (B, N, 4)),
            ("xref", xref, (B, N, 12)), ("dt", dt, (B, N)),
            ("xref_T", xrefT, (B, 12)), ("feet_T", feetT, (B, 12)),
            ("gait_T", gaitT, (B, 4))):
        _check_rows(name, t, shape, x0)
    if kffs is not None:
        if len(kffs) != N or len(Ks) != N:
            raise ValueError(f"ddp line search kernel: {len(kffs)} kffs and "
                             f"{len(Ks)} Ks for {N} nodes")
        _check_rows("xs", xs, (B, N + 1, 12), x0)
        for k, kff in enumerate(kffs):
            _check_rows(f"kffs[{k}]", kff, (B, 12), x0)
        for k, K in enumerate(Ks):
            _check_rows(f"Ks[{k}].mT", K.mT if torch.is_tensor(K)
                        and K.dim() >= 2 else K,
                        (B, 12, 12), x0)
        for name, t in (("cost", cost), ("reg", reg)):
            kernels.check(f"ddp line search kernel: {name}", t, (B,),
                          x0.dtype, x0.device)
        ld_trace = trace.shape[-1] if trace.dim() == 2 else 0
        kernels.check("ddp line search kernel: trace", trace, (B, ld_trace),
                      x0.dtype, x0.device)
        if not 0 <= it < ld_trace:
            raise ValueError(f"ddp line search kernel: column {it} of a "
                             f"trace of {ld_trace}")
    if x0.device.type != "cuda":
        raise ValueError(f"ddp line search kernel: x0 on {x0.device}, not "
                         f"CUDA")
    if x0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ddp line search kernel: {x0.dtype}, expected "
                         f"float32 or float64")
    xs_out, cost_out = x0.new_empty((B, N + 1, 12)), x0.new_empty((B,))
    if kffs is None:                            # the initial rollout
        us_out = reg_out = accepted = None
        xs_p = kff_p = K_p = cost_p = reg_p = trace_p = None
        us_p = reg_out_p = acc_p = None
        ld_trace = it = 0
    else:
        us_out, reg_out = x0.new_empty((B, N, 12)), x0.new_empty((B,))
        accepted = torch.empty((B,), dtype=torch.bool, device=x0.device)
        xs_p, cost_p, reg_p, trace_p, us_p, reg_out_p, acc_p = (
            t.data_ptr() for t in (xs, cost, reg, trace, us_out, reg_out,
                                   accepted))
        kff_p = (ctypes.c_void_p * N)(*[t.data_ptr() for t in kffs])
        K_p = (ctypes.c_void_p * N)(*[t.data_ptr() for t in Ks])
    kernels.launch(
        "qrw_ddp_linesearch", x0.element_size(), params, flags, ls, A,
        x0.data_ptr(), xs_p, us.data_ptr(), kff_p, K_p,
        feet.data_ptr(), gait.data_ptr(), xref.data_ptr(), dt.data_ptr(),
        xrefT.data_ptr(), feetT.data_ptr(), gaitT.data_ptr(), cost_p, reg_p,
        xs_out.data_ptr(), us_p, cost_out.data_ptr(), reg_out_p, trace_p,
        acc_p, B, N, ld_trace, it,
        torch.cuda.current_stream(x0.device).cuda_stream,
        key=x0.element_size())
    count("ddp.linesearch_problems", B)
    if kffs is None:
        return xs_out, us, cost_out, reg, None
    return xs_out, us_out, cost_out, reg_out, accepted
