"""DDP MPC with joint footstep optimization: the MPC_crocoddyl_planner
family.

Port of qrw_tpu/core/mpc_ddp_planner.py (scripts/crocoddyl_class/
MPC_crocoddyl_planner.py with the `quadruped_walkgen` Augmented and
Step action models). The reference augments the 12-dim SRB state with
the xy positions of the four feet (a 20-dim state, :136-141) and
interleaves Step models at gait-phase boundaries, a model list whose
length changes with the gait phase. As in the JAX package every node
carries one 20-dim control u = [forces (12); dp (8)], and the step part
is gated by the landing mask

    land[k, i] = contact[k, i] AND NOT contact[k-1, i]

applied before the SRB dynamics of node k (p_used = p + land * dp):
each Step node folds into the node that follows it, with static shapes,
solved by the batched iLQR of ops/ilqr.py. Weights: state, force and
friction (:50-74), shoulder [0.3, 0.4] per foot (:101), step 0.8
(:108), the last-position lock 2.0 over the final 10% of a flight
(:111-118), a terminal node with only the state cost (:349-352); the
shoulder target has the symmetry and centrifugal Raibert terms
(:103-105; src/FootstepPlanner.cpp:158-186). A solve takes leading
batch axes: B robots are one iLQR call of B problems.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.mpc import gait_from_fsteps
from qrw_tpu_torch.core.mpc_ddp import make_consts, relu, repeat_flags
from qrw_tpu_torch.ops import ilqr
from qrw_tpu_torch.ops.rotations import rot_z, skew

# Reference planner weights (MPC_crocoddyl_planner.py:50-117)
STATE_WEIGHTS = np.array(
    [0.3, 0.3, 2.0, 0.9, 1.0, 0.4,
     1.5 * np.sqrt(0.3), 2.0 * np.sqrt(0.3), 1.0 * np.sqrt(2.0),
     0.05 * np.sqrt(0.9), 0.07 * np.sqrt(1.0), 0.05 * np.sqrt(0.4)])
FORCE_WEIGHT = 0.01          # (:70)
FRICTION_WEIGHT = 0.5        # (:74)
SHOULDER_WEIGHTS = np.tile(np.array([0.3, 0.4]), 4)   # (:101)
STEP_WEIGHT = 0.8            # (:108)
LAST_POSITION_WEIGHT = 2.0   # (:111)
STOP_OPTIM = 0.1             # stop optimizing at 10% of flight left (:117)
MIN_FZ = 0.0                 # (:24 min_fz default)

# default foot xy under the shoulders, local frame (:141)
P0_SHOULDERS = np.array([0.1946, 0.15005, 0.1946, -0.15005,
                         -0.1946, 0.15005, -0.1946, -0.15005])


class PlannerSettings(NamedTuple):
    max_iters: int = 10            # (:77)
    symmetry_term: bool = True     # (:104-105)
    centrifugal_term: bool = True
    nonlinear: bool = True         # augmented models use the state yaw


class PlannerState(NamedTuple):
    """Warm-start carry + cross-cycle foot memory (o_fsteps, :127-128)."""
    xs: torch.Tensor        # (..., N+1, 20)
    us: torch.Tensor        # (..., N, 20)
    last_p: torch.Tensor    # (..., 8) footholds predicted by the last cycle


def init_planner_state(cfg: Config, dtype=torch.float32,
                       device="cpu") -> PlannerState:
    N = cfg.n_steps
    kw = dict(dtype=dtype, device=device)
    return PlannerState(xs=torch.zeros((N + 1, 20), **kw),
                        us=torch.zeros((N, 20), **kw),
                        last_p=torch.as_tensor(P0_SHOULDERS, **kw))


class PlannerResult(NamedTuple):
    x_f_applied: torch.Tensor   # (..., 24, N) same contract as the other MPCs
    fsteps: torch.Tensor        # (..., N, 12) optimized footstep plan
    o_target: torch.Tensor      # (..., 3, 4) optimized next touchdown per foot
    state: PlannerState
    cost: torch.Tensor          # (...)
    cost_trace: torch.Tensor    # (..., max_iters)


def landing_mask(gait, gait_prev0):
    """(..., N, 4) mask of feet that touch down at node k (contact rising
    edge, where the reference inserts a Step model,
    MPC_crocoddyl_planner.py:333-340, 427-432)."""
    prev = torch.cat([gait_prev0[..., None, :], gait[..., :-1, :]], -2)
    return gait * (1.0 - prev)


def _shoulder_target(cfg: Config, x, settings: PlannerSettings, sh):
    """Per-foot xy target of the shoulder cost (..., 4, 2): the shoulder
    projection plus the symmetry and centrifugal Raibert terms
    (src/FootstepPlanner.cpp:158-186). sh: (4, 2) shoulder positions."""
    R2 = rot_z(x[..., 5])[..., 0:2, 0:2]
    base = x[..., None, 0:2] + sh @ R2.transpose(-1, -2)     # (..., 4, 2)
    t_stance = 0.5 * cfg.T_gait
    v = x[..., 6:8]
    if settings.symmetry_term:
        base = base + 0.5 * t_stance * v[..., None, :]
    if settings.centrifugal_term:
        cross = torch.stack([v[..., 1] * x[..., 11],
                             -v[..., 0] * x[..., 11]], -1)
        base = base + 0.5 * np.sqrt(cfg.h_ref / cfg.gravity) * cross[
            ..., None, :]
    return base


def _dynamics(cfg: Config, x, u, gait_k, land_k, yaw_lin, c):
    """Folded Step + Augmented node: feet landing at node k move by the
    step control, then one SRB step with levers from the foot-position
    STATE (the quantity being optimized). c: core/mpc_ddp.Consts."""
    dt = cfg.dt_mpc
    p = x[..., 12:20] + u[..., 12:20] * repeat_flags(land_k, 2)
    R = rot_z(yaw_lin)
    I_inv = torch.linalg.inv_ex(R @ c.gI @ R.transpose(-1, -2),
                                check_errors=False).inverse
    com = x[..., 0:3] + c.com_off
    p2 = p.reshape(p.shape[:-1] + (4, 2))
    feet = torch.cat([p2, torch.zeros_like(p2[..., :1])], -1)
    lever = feet - com[..., None, :]
    f4 = u[..., 0:12].reshape(u.shape[:-1] + (4, 3)) * gait_k[..., None]
    f_tot = f4.sum(-2)
    tau = (skew(lever) @ f4[..., None])[..., 0].sum(-2)
    acc = torch.cat([f_tot / cfg.mass - c.grav,
                     (I_inv @ tau[..., None])[..., 0]], -1)
    return torch.cat([x[..., 0:6] + dt * x[..., 6:12],
                      x[..., 6:12] + dt * acc, p], -1)


def _stage_cost(cfg: Config, x, u, xref_k, gait_k, land_k, lp_w_k, last_p,
                settings: PlannerSettings, consts, terminal: bool = False):
    """consts: (core/mpc_ddp.Consts with the planner's state weights, the
    shoulder positions (4, 2), the shoulder weights (4, 2))."""
    c, sh, w_sh = consts
    cost = 0.5 * ((c.w * (x[..., 0:12] - xref_k)) ** 2).sum(-1)
    if terminal:  # terminal model zeroes every other weight (:349-352)
        return cost

    land2 = repeat_flags(land_k, 2)
    p = x[..., 12:20] + u[..., 12:20] * land2

    # shoulder cost on the optimized foot positions, contact feet only
    tgt = _shoulder_target(cfg, x, settings, sh)             # (..., 4, 2)
    d = (p.reshape(p.shape[:-1] + (4, 2)) - tgt) * gait_k[..., None]
    cost = cost + 0.5 * ((w_sh * d) ** 2).sum((-1, -2))

    # step-magnitude cost at landing feet (stepWeights, :108)
    cost = cost + 0.5 * STEP_WEIGHT ** 2 * ((u[..., 12:20] * land2) ** 2
                                            ).sum(-1)

    # last-position lock near the end of the flight phase (:111-118, 498)
    cost = cost + 0.5 * (lp_w_k * (p - last_p) ** 2).sum(-1)

    # force regularization + friction cone (inner mu/sqrt(2), :45-48)
    f = u[..., 0:12]
    cost = cost + 0.5 * FORCE_WEIGHT ** 2 * (
        (f * repeat_flags(gait_k, 3)) ** 2).sum(-1)
    mu_i = cfg.mu / np.sqrt(2.0)
    f4 = f.reshape(f.shape[:-1] + (4, 3))
    fx, fy, fz = f4[..., 0], f4[..., 1], f4[..., 2]
    r = torch.stack([fx - mu_i * fz, -fx - mu_i * fz,
                     fy - mu_i * fz, -fy - mu_i * fz,
                     MIN_FZ - fz, fz - cfg.fz_max], -1)
    viol = relu(r, c.zero) * gait_k[..., None]
    return cost + 0.5 * FRICTION_WEIGHT * (viol ** 2).sum((-1, -2))


def solve_mpc_planner(cfg: Config, xref, fsteps, feet_p0,
                      state: Optional[PlannerState] = None,
                      settings: PlannerSettings = PlannerSettings(),
                      cycle=0) -> PlannerResult:
    """One footstep-optimizing DDP solve (MPC_crocoddyl_planner.solve,
    :143-161) per problem; leading batch axes are problems.

    xref: (..., 12, N+1); fsteps: (..., N_gait, 12) heuristic plan, used
    only for the contact schedule; feet_p0: (..., 3, 4) measured foot
    positions (local frame); cycle: the MPC cycle counter (an int or a
    tensor over the batch axes): the last-position lock is on after
    cycle 20 (start_stop_optim, :121, 247-249)."""
    N = cfg.n_steps
    dtype, dev = xref.dtype, xref.device
    bs = tuple(xref.shape[:-2])
    B = int(np.prod(bs, dtype=np.int64))
    if state is None:
        state = init_planner_state(cfg, dtype, dev)
    xref = xref.reshape(B, 12, N + 1)
    fsteps = fsteps.reshape((B,) + tuple(fsteps.shape[-2:]))
    feet_p0 = feet_p0.reshape(B, 3, 4)
    prev_us = state.us.expand(bs + (N, 20)).reshape(B, N, 20)
    last_p = state.last_p.expand(bs + (8,)).reshape(B, 8)
    c = make_consts(cfg, dtype, dev, STATE_WEIGHTS)
    p0_sh = torch.as_tensor(P0_SHOULDERS, dtype=dtype, device=dev)
    consts = (c, p0_sh.reshape(4, 2),
              torch.as_tensor(SHOULDER_WEIGHTS.reshape(4, 2), dtype=dtype,
                              device=dev))

    gait = gait_from_fsteps(fsteps, N)                       # (B, N, 4)
    land = landing_mask(gait, gait[:, 0])                    # (B, N, 4)
    xref_n = xref[:, :, 1:].transpose(1, 2)                  # (B, N, 12)

    # initial foot state: measured position for contact feet, shoulder
    # default for swing feet (:182-192)
    g0 = repeat_flags(gait[:, 0], 2)
    p0 = (g0 * feet_p0[:, 0:2].transpose(1, 2).reshape(B, 8)
          + (1.0 - g0) * p0_sh)
    x0 = torch.cat([xref[:, :, 0], p0], -1)

    # last-position lock schedule: for each foot, lock the final
    # STOP_OPTIM share of the swing nodes before its NEXT touchdown
    # (updatePositionWeights, :111-118, 498-507); the distance to the
    # next landing from a reverse pass over the nodes
    nxt = torch.full((B, 4), float(N), dtype=dtype, device=dev)
    dist = [None] * N
    for k in reversed(range(N)):
        nxt = torch.where(land[:, k] > 0, 0.0, nxt + 1.0)
        dist[k] = nxt
    dist = torch.stack(dist, 1)                              # (B, N, 4)
    lock_window = max(1.0, STOP_OPTIM * 0.5 * cfg.T_gait / cfg.dt_mpc)
    lock_on = (torch.as_tensor(cycle, device=dev) > 20).to(dtype).expand(
        bs).reshape(B, 1, 1)
    lp_w = (LAST_POSITION_WEIGHT ** 2 * lock_on
            * repeat_flags((1.0 - gait) * (dist <= lock_window).to(dtype), 2))

    umask = torch.cat([repeat_flags(gait, 3), repeat_flags(land, 2)],
                      -1)                                    # (B, N, 20)
    us0 = torch.cat([prev_us[:, 1:], prev_us[:, -1:]], 1) * umask

    nonlinear = settings.nonlinear

    def step(x, u, gait_k, land_k, xref_k, lp_w_k, last_p_k):
        yaw = x[..., 5] if nonlinear else xref_k[..., 5]
        return _dynamics(cfg, x, u, gait_k, land_k, yaw, c)

    def cost(x, u, gait_k, land_k, xref_k, lp_w_k, last_p_k):
        return _stage_cost(cfg, x, u, xref_k, gait_k, land_k, lp_w_k,
                           last_p_k, settings, consts)

    def cost_T(x, xref_T):
        return _stage_cost(cfg, x, None, xref_T, None, None, None, None,
                           settings, consts, terminal=True)

    res = ilqr.solve(
        step, cost, cost_T, x0, us0,
        node_args=(gait, land, xref_n, lp_w,
                   last_p[:, None].expand(B, N, 8)),
        term_args=(xref_n[:, -1],),
        settings=ilqr.ILQRSettings(max_iters=settings.max_iters),
        project_u=lambda u, k: u * umask[:, k])

    # ---- extraction ------------------------------------------------------
    # optimized foot positions per node (POST-step: the feet state of
    # node k+1 already holds the landing displacement applied at node k)
    p_traj = res.xs[:, 1:, 12:20].reshape(B, N, 4, 2)
    feet3 = torch.cat([p_traj, torch.zeros_like(p_traj[..., :1])], -1)
    fsteps_opt = (feet3 * gait[..., None]).reshape(B, N, 12)  # (:474-483)

    # next touchdown target per foot: the position at its first landing
    first_land = torch.argmax((land > 0).to(dtype), dim=1)      # (B, 4)
    has_land = (land > 0).any(dim=1)
    p_land = torch.gather(p_traj, 1, first_land[:, None, :, None].expand(
        B, 1, 4, 2))[:, 0]                                   # (B, 4, 2)
    p_cur = feet_p0[:, 0:2].transpose(1, 2)                  # (B, 4, 2)
    o_xy = torch.where(has_land[..., None], p_land, p_cur)
    o_target = torch.cat([o_xy.transpose(1, 2),
                          torch.zeros((B, 1, 4), dtype=dtype, device=dev)],
                         1)

    x_f = torch.cat([res.xs[:, 1:, 0:12].transpose(1, 2),
                     res.us[:, :, 0:12].transpose(1, 2)], 1)
    return PlannerResult(
        x_f_applied=x_f.reshape(bs + (24, N)),
        fsteps=fsteps_opt.reshape(bs + (N, 12)),
        o_target=o_target.reshape(bs + (3, 4)),
        state=PlannerState(xs=res.xs.reshape(bs + (N + 1, 20)),
                           us=res.us.reshape(bs + (N, 20)),
                           # o_fsteps memory for the next cycle's lock
                           # cost (:491-495)
                           last_p=o_xy.reshape(bs + (8,))),
        cost=res.cost.reshape(bs),
        cost_trace=res.cost_trace.reshape(bs + (settings.max_iters,)))
