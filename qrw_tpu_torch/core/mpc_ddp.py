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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.mpc import gait_from_fsteps
from qrw_tpu_torch.ops import ilqr
from qrw_tpu_torch.ops.rotations import rot_z, skew
from qrw_tpu_torch.utils.profiling import span, spanned

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
                   + x[..., 2:3] ** 2 + 1e-12)
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

    return dict(step=step, cost=cost, cost_T=cost_T, x0=x0, us0=us0,
                node_args=(feet, gait, xref_n, dt),
                term_args=(xref_n[:, -1], feet[:, -1], gait[:, -1]),
                project_u=lambda u, k: u * umask[:, k])
