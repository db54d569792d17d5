"""Main controller: the 500 Hz tick, split around the MPC solve.

Port of qrw_tpu/core/controller.py: `make_controller`, `init_state`,
`compute_pre` (joystick -> estimator -> hybrid state update -> gait ->
footsteps -> swing trajectories -> reference states), `wbc_inputs`,
`compute_post` (the per-robot WBC, or a precomputed WBC result: the
fleet's lane-major WBC) and the whole tick `compute`, with the MPC
solved every k_mpc ticks, the `mpc_async` stale roll and the optional
`Telemetry`. The MPC backend is the config's, as in the JAX package:
the QP MPC (core/mpc.solve_mpc) when `type_MPC`, else the DDP MPC
(core/mpc_ddp; with `mpc_every_tick` re-solved every tick with a
shrunken first node), and the footstep-optimizing DDP planner
(core/mpc_ddp_planner) over both when `mpc_planner`, whose optimized
touchdowns drive the swing feet. Every function broadcasts over leading
robot batch axes; the tick index `k` is a Python int shared by the
batch, so the JAX package's `lax.cond` on the solve tick is a Python
branch here.

The reference quirks the JAX package keeps on purpose are kept here
too: the Coriolis terms of the foot references use the PREVIOUS tick's
feet_p_cmd / feet_v_cmd, the x/y/yaw hybrid state is integrated from the
command ("perfect odometry"), and the security envelope reads the
default Config's q_security.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.models.solo12 import H_INIT, make_solo12
from qrw_tpu_torch.core import gait as gait_mod
from qrw_tpu_torch.core import mpc as mpc_mod
from qrw_tpu_torch.core import mpc_ddp
from qrw_tpu_torch.core import mpc_ddp_planner
from qrw_tpu_torch.core import wbc as wbc_mod
from qrw_tpu_torch.core.estimator import (DeviceData, EstimatorOutput,
                                          EstimatorState,
                                          init_estimator_state, run_filter)
from qrw_tpu_torch.core.foot_trajectory import (FootTrajState,
                                                make_foot_traj_state,
                                                update_foot_trajectory)
from qrw_tpu_torch.core.footstep import (FootstepState, make_footstep_state,
                                         update_footsteps)
from qrw_tpu_torch.core.joystick import v_ref_profile
from qrw_tpu_torch.core.state_planner import compute_reference_states
from qrw_tpu_torch.ops import qp, rbd
from qrw_tpu_torch.ops.rotations import rot_z, rpy_to_quat, rpy_to_rot
from qrw_tpu_torch.utils.profiling import host_read, span, spanned

SHOULDERS = np.array([[0.1946, 0.1946, -0.1946, -0.1946],
                      [0.14695, -0.14695, 0.14695, -0.14695],
                      [0.0, 0.0, 0.0, 0.0]])


class Result(NamedTuple):
    """Joint-level command sent to the device."""
    P: torch.Tensor       # (..., 12)
    D: torch.Tensor       # (..., 12)
    q_des: torch.Tensor   # (..., 12)
    v_des: torch.Tensor   # (..., 12)
    tau_ff: torch.Tensor  # (..., 12)


class ControllerState(NamedTuple):
    gait: gait_mod.GaitState
    footstep: FootstepState
    foot_traj: FootTrajState
    estimator: EstimatorState
    mpc: NamedTuple              # MPCState, DDPState or PlannerState
    x_f_mpc: torch.Tensor        # (..., 24, N) latest MPC plan
    x_f_next: torch.Tensor       # (..., 24, N)
    last_xref: torch.Tensor      # (..., 12, N+1)
    last_fsteps: torch.Tensor    # (..., N_gait, 12)
    wbc: wbc_mod.WBCState
    q: torch.Tensor              # (..., 19) hybrid state estimate
    v: torch.Tensor              # (..., 18)
    h_v: torch.Tensor            # (..., 18)
    yaw_estim: torch.Tensor      # (...)
    qdes: torch.Tensor           # (..., 12)
    vdes: torch.Tensor           # (..., 12)
    feet_p_cmd: torch.Tensor     # (..., 3, 4)
    feet_v_cmd: torch.Tensor     # (..., 3, 4)
    planner_target: torch.Tensor  # (..., 3, 4)
    error: torch.Tensor          # (...) bool security latch
    error_code: torch.Tensor     # (...) int32


class Controller(NamedTuple):
    """Static controller context: config + model + solver settings."""
    cfg: Config
    model: rbd.TorchModel
    patterns: np.ndarray
    mpc_settings: qp.QPSettings
    wbc_settings: qp.QPSettings


def make_controller(cfg: Config,
                    mpc_settings: Optional[qp.QPSettings] = None,
                    wbc_settings: Optional[qp.QPSettings] = None
                    ) -> Controller:
    if mpc_settings is None:
        mpc_settings = mpc_mod.mpc_settings(cfg)
    if wbc_settings is None:
        wbc_settings = wbc_mod.wbc_settings(cfg)
    return Controller(cfg=cfg, model=rbd.to_torch(make_solo12()),
                      patterns=gait_mod.gait_patterns(cfg),
                      mpc_settings=mpc_settings, wbc_settings=wbc_settings)


def init_state(ctl: Controller, dtype=torch.float32, gait: str = "trot",
               device="cpu") -> ControllerState:
    """One robot's initial controller state (no batch axis)."""
    cfg = ctl.cfg
    kw = dict(dtype=dtype, device=device)
    q_init = torch.tensor(cfg.q_init, **kw)
    q = torch.cat([torch.tensor([0.0, 0.0, cfg.h_ref, 0.0, 0.0, 0.0, 1.0],
                                **kw), q_init])
    p0 = torch.as_tensor(np.vstack([SHOULDERS[:2], np.zeros((1, 4))]), **kw)
    return ControllerState(
        gait=gait_mod.make_gait(cfg, gait, dtype, device),
        footstep=make_footstep_state(cfg, torch.as_tensor(SHOULDERS, **kw)),
        foot_traj=make_foot_traj_state(p0),
        estimator=init_estimator_state(cfg, H_INIT, dtype, device),
        # type_MPC selects the QP (OSQP-equivalent) or the DDP
        # (Crocoddyl-equivalent) backend (scripts/MPC_Wrapper.py:59-64);
        # mpc_planner the footstep-optimizing DDP over both
        mpc=(mpc_ddp_planner.init_planner_state(cfg, dtype, device)
             if cfg.mpc_planner else
             mpc_mod.init_mpc_state(cfg, dtype, device) if cfg.type_MPC
             else mpc_ddp.init_ddp_state(cfg, dtype, device)),
        x_f_mpc=torch.zeros((24, cfg.n_steps), **kw),
        x_f_next=torch.zeros((24, cfg.n_steps), **kw),
        last_xref=torch.zeros((12, cfg.n_steps + 1), **kw),
        last_fsteps=torch.zeros((cfg.N_gait, 12), **kw),
        wbc=wbc_mod.init_wbc_state(dtype, device),
        q=q, v=torch.zeros(18, **kw), h_v=torch.zeros(18, **kw),
        yaw_estim=torch.zeros((), **kw), qdes=q_init.clone(),
        vdes=torch.zeros(12, **kw), feet_p_cmd=torch.zeros((3, 4), **kw),
        feet_v_cmd=torch.zeros((3, 4), **kw), planner_target=p0.clone(),
        error=torch.tensor(False, device=device),
        error_code=torch.zeros((), dtype=torch.int32, device=device))


class Telemetry(NamedTuple):
    """Extra per-tick signals for structured logging."""
    f_wbc: torch.Tensor         # (..., 12) WBC QP output forces
    feet_pos_mes: torch.Tensor  # (..., 3, 4) foot positions, IK config
    feet_vel_mes: torch.Tensor  # (..., 3, 4) foot velocities (base frame)
    feet_a_cmd: torch.Tensor    # (..., 3, 4) commanded foot accelerations


class PreMPC(NamedTuple):
    """Pipeline values computed BEFORE the MPC solve of one tick."""
    est: EstimatorOutput
    v_ref: torch.Tensor          # (..., 18)
    q: torch.Tensor              # (..., 19)
    v: torch.Tensor              # (..., 18)
    h_v: torch.Tensor            # (..., 18)
    yaw_estim: torch.Tensor
    oRh: torch.Tensor            # (..., 3, 3)
    oTh: torch.Tensor            # (..., 3)
    gait: gait_mod.GaitState
    fs_state: FootstepState
    ft_state: FootTrajState
    fsteps: torch.Tensor         # (..., N_gait, 12) MPC footstep input
    xref: torch.Tensor           # (..., 12, N+1) MPC reference input


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


@spanned("pre")
def compute_pre(ctl: Controller, state: ControllerState, device: DeviceData,
                k: int, v_ref6=None, joystick_code: int = 0,
                perfect_estimator: bool = False, est_fk=None) -> PreMPC:
    """First half of a control tick, up to the MPC inputs. est_fk:
    optional precomputed estimator foot kinematics."""
    cfg = ctl.cfg
    dtype, dev = state.q.dtype, state.q.device
    k_mpc = cfg.k_mpc
    batch = state.q.shape[:-1]

    if v_ref6 is None:
        v_ref6 = v_ref_profile(k, cfg.velID, dtype, dev)
    v_ref6 = v_ref6.to(dtype).expand(batch + (6,))
    v_ref = torch.cat([v_ref6, torch.zeros(batch + (12,), dtype=dtype,
                                           device=dev)], dim=-1)

    est = run_filter(cfg, ctl.model, state.estimator, k, state.gait.current,
                     device, state.foot_traj.position,
                     perfect=perfect_estimator, fk=est_fk)

    # hybrid state update (Controller.updateState)
    cy, sy = torch.cos(state.yaw_estim), torch.sin(state.yaw_estim)
    dxy = torch.stack([cy * v_ref[..., 0] - sy * v_ref[..., 1],
                       sy * v_ref[..., 0] + cy * v_ref[..., 1]],
                      dim=-1) * cfg.dt_wbc
    yaw_estim = state.yaw_estim + v_ref[..., 5] * cfg.dt_wbc
    quat = rpy_to_quat(torch.stack([est.rpy[..., 0], est.rpy[..., 1],
                                    yaw_estim], dim=-1))
    q = torch.cat([state.q[..., 0:2] + dxy, est.q_filt[..., 2:3], quat,
                   est.q_filt[..., 7:]], dim=-1)
    v = est.v_filt
    hRb = rpy_to_rot(torch.stack([est.rpy[..., 0], est.rpy[..., 1],
                                  torch.zeros_like(yaw_estim)], dim=-1))
    h_v = torch.cat([_mv(hRb, v[..., 0:3]), _mv(hRb, v[..., 3:6]),
                     v[..., 6:]], dim=-1)
    oRh = rot_z(yaw_estim)
    oTh = torch.stack([q[..., 0], q[..., 1], torch.zeros_like(q[..., 0])],
                      dim=-1)

    gait = gait_mod.update_gait(state.gait, k, k_mpc, joystick_code,
                                ctl.patterns)

    refresh = (k % k_mpc == 0) and k != 0
    with host_read("pre_shoulders"):
        shoulders = torch.as_tensor(SHOULDERS, dtype=dtype, device=dev)
    fs_state, o_target, fsteps = update_footsteps(
        cfg, shoulders, gait, state.footstep, refresh,
        float(k_mpc - k % k_mpc), q[..., 0:7], h_v[..., 0:6],
        v_ref[..., 0:6])

    swing_target = state.planner_target if cfg.mpc_planner else o_target
    ft_state = update_foot_trajectory(cfg, gait, state.foot_traj, k,
                                      swing_target)

    xref = compute_reference_states(q[..., 0:7], h_v[..., 0:6],
                                    v_ref[..., 0:6], dt_mpc=cfg.dt_mpc,
                                    n_steps=cfg.n_steps, h_ref=cfg.h_ref)
    return PreMPC(est=est, v_ref=v_ref, q=q, v=v, h_v=h_v,
                  yaw_estim=yaw_estim, oRh=oRh, oTh=oTh, gait=gait,
                  fs_state=fs_state, ft_state=ft_state, fsteps=fsteps,
                  xref=xref)


class WBCInputs(NamedTuple):
    """Assembled whole-body-controller inputs of one tick."""
    qj: torch.Tensor          # (..., 12)
    b_v: torch.Tensor         # (..., 18)
    f_cmd: torch.Tensor       # (..., 12)
    contacts: torch.Tensor    # (..., 4)
    feet_p_cmd: torch.Tensor  # (..., 3, 4)
    feet_v_cmd: torch.Tensor  # (..., 3, 4)
    feet_a_cmd: torch.Tensor  # (..., 3, 4)


@spanned("wbc.inputs")
def wbc_inputs(ctl: Controller, state: ControllerState, pre: PreMPC,
               x_f_mpc) -> WBCInputs:
    """WBC target assembly + base-frame foot references. Of the WBC
    target vector only its force rows reach the WBC (f_cmd)."""
    cfg = ctl.cfg
    v_ref, ft_state = pre.v_ref, pre.ft_state
    oRhT = pre.oRh.transpose(-1, -2)
    f_cmd = x_f_mpc[..., 12:24, 0]

    # NOTE: the Coriolis terms intentionally use the PREVIOUS tick's
    # feet_p_cmd / feet_v_cmd, like the reference.
    w_ref = v_ref[..., None, 3:6]                          # (..., 1, 3)
    prev_p = state.feet_p_cmd.transpose(-1, -2)            # (..., 4, 3)
    prev_v = state.feet_v_cmd.transpose(-1, -2)
    cr = torch.linalg.cross
    feet_a_cmd = (oRhT @ ft_state.acceleration
                  - cr(w_ref, cr(w_ref, prev_p)).transpose(-1, -2)
                  - 2.0 * cr(w_ref, prev_v).transpose(-1, -2))
    feet_v_cmd = (oRhT @ ft_state.velocity - v_ref[..., 0:3, None]
                  - cr(w_ref, prev_p).transpose(-1, -2))
    with host_read("wbc_inputs_href"):
        h_ref_vec = torch.tensor([0.0, 0.0, cfg.h_ref], dtype=v_ref.dtype,
                                 device=v_ref.device)
    feet_p_cmd = oRhT @ (ft_state.position - h_ref_vec[:, None]
                         - pre.oTh[..., :, None])
    b_v = torch.cat([v_ref[..., 0:6], state.vdes], dim=-1)
    return WBCInputs(qj=state.qdes, b_v=b_v, f_cmd=f_cmd,
                     contacts=pre.gait.current[..., 0, :],
                     feet_p_cmd=feet_p_cmd, feet_v_cmd=feet_v_cmd,
                     feet_a_cmd=feet_a_cmd)


def _stale_roll(cfg: Config, gait_current, plan, k: int):
    """Staleness compensation of the async MPC path: shift the force
    plan one step left and, on a gait-phase change, rebuild the terminal
    forces by equal weight over the final stance feet. gait_current
    (..., N_gait, 4), plan (..., 24, N)."""
    rolled = torch.cat([plan[..., :12, :],
                        torch.roll(plan[..., 12:, :], -1, dims=-1)], dim=-2)
    if k <= 2:
        return rolled
    g = gait_current
    n_rows = (g > 0).any(dim=-1).sum(dim=-1)                    # (...)
    last = torch.gather(g, -2, torch.clamp(n_rows - 1, min=0)[
        ..., None, None].expand(g.shape[:-2] + (1, 4)))[..., 0, :]
    changed = (last != g[..., 0, :]).any(dim=-1)
    F = cfg.mass * cfg.gravity / torch.clamp(last.sum(-1), min=1.0)
    zero = torch.zeros_like(last)
    term = torch.stack([zero, zero, F[..., None] * last], dim=-1).reshape(
        last.shape[:-1] + (12,)).to(plan.dtype)
    fresh = torch.cat([rolled[..., 12:, :-1], term[..., None]], dim=-1)
    fresh = torch.cat([rolled[..., :12, :], fresh], dim=-2)
    return torch.where(changed[..., None, None], fresh, rolled)


def compute(ctl: Controller, state: ControllerState, device: DeviceData,
            k: int, v_ref6=None, joystick_code: int = 0,
            perfect_estimator: bool = False,
            return_telemetry: bool = False):
    """One control tick (Controller.compute): compute_pre, the MPC on
    every k_mpc-th tick (the latest plan held otherwise), compute_post.
    Returns (new_state, Result), or (new_state, Result, Telemetry) with
    return_telemetry."""
    cfg = ctl.cfg
    k_mpc = cfg.k_mpc
    pre = compute_pre(ctl, state, device, k, v_ref6, joystick_code,
                      perfect_estimator)
    planner_target = state.planner_target
    if cfg.mpc_every_tick or k % k_mpc == 0:
        with span("mpc"):
            if cfg.mpc_planner:
                oRh, oTh = pre.oRh, pre.oTh[..., :, None]
                l_feet = oRh.transpose(-1, -2) @ (
                    state.foot_traj.position - oTh)
                res = mpc_ddp_planner.solve_mpc_planner(
                    cfg, pre.xref, pre.fsteps, l_feet, state.mpc,
                    cycle=k // k_mpc)
                planner_target = oRh @ res.o_target + oTh
            elif cfg.type_MPC:
                res = mpc_mod.solve_mpc(cfg, pre.xref, pre.fsteps,
                                        state.mpc, ctl.mpc_settings)
            elif cfg.mpc_every_tick:
                # 500 Hz MPC (crocoddyl_eval/test_5): the first node
                # covers the time left to the next gait boundary; the warm
                # start is shifted only on the boundary itself
                dt_first = torch.tensor(float(k_mpc - k % k_mpc),
                                        dtype=state.q.dtype) * cfg.dt_wbc
                res = mpc_ddp.solve_mpc_ddp(cfg, pre.xref, pre.fsteps,
                                            state.mpc, dt_first=dt_first,
                                            shift_warm=k % k_mpc == 0)
            else:
                res = mpc_ddp.solve_mpc_ddp(cfg, pre.xref, pre.fsteps,
                                            state.mpc)
            x_f_next = res.x_f_applied
            x_f_mpc = x_f_next
            if cfg.mpc_async and k != 0:
                # one-period-stale consumption: the previous plan, rolled;
                # the fresh solve is applied next period
                x_f_mpc = _stale_roll(cfg, pre.gait.current, state.x_f_next,
                                      k)
            mpc_state = res.state
    else:
        x_f_mpc, x_f_next, mpc_state = (state.x_f_mpc, state.x_f_next,
                                        state.mpc)
    return compute_post(ctl, state, pre, k, x_f_mpc, x_f_next, mpc_state,
                        planner_target, return_telemetry=return_telemetry)


@spanned("post")
def compute_post(ctl: Controller, state: ControllerState, pre: PreMPC,
                 k: int, x_f_mpc, x_f_next, mpc_state, planner_target,
                 wbc_res=None, return_telemetry: bool = False):
    """Second half of a control tick: WBC target assembly, whole-body
    controller, security check, state update. `wbc_res`: a precomputed
    WBCResult for this tick's `wbc_inputs(...)` (the fleet computes it
    lane-major); None runs the per-robot WBC here."""
    cfg = ctl.cfg
    dtype = state.q.dtype
    est = pre.est

    inp = wbc_inputs(ctl, state, pre, x_f_mpc)
    if wbc_res is None:
        with span("wbc"):
            wbc_res = wbc_mod.compute_wbc(
                cfg, ctl.model, state.wbc, inp.qj, inp.b_v, inp.f_cmd,
                inp.contacts, inp.feet_p_cmd, inp.feet_v_cmd,
                inp.feet_a_cmd, ctl.wbc_settings)

    # security check (scripts/Controller.py:341-365)
    with host_read("post_security"):
        q_sec = torch.as_tensor(np.tile(np.asarray(Config().q_security), 4),
                                dtype=dtype, device=state.q.device)
    err_pos = torch.any(torch.abs(est.q_filt[..., 7:]) > q_sec, dim=-1)
    err_vel = torch.any(torch.abs(est.v_secu) > cfg.v_security, dim=-1)
    err_tau = torch.any(torch.abs(wbc_res.tau_ff) > cfg.tau_security, dim=-1)
    new_err = state.error | err_pos | err_vel | err_tau
    code = torch.where(err_pos, 1, torch.where(err_vel, 2, torch.where(
        err_tau, 3, 0))).to(torch.int32)
    code = torch.where(state.error, state.error_code, code)

    e = new_err[..., None]
    zeros = torch.zeros_like(wbc_res.tau_ff)
    ones = torch.ones_like(zeros)
    result = Result(
        P=torch.where(e, zeros, cfg.joint_P * ones),
        D=torch.where(e, cfg.damping_D * ones, cfg.joint_D * ones),
        q_des=torch.where(e, zeros, wbc_res.qdes),
        v_des=torch.where(e, zeros, wbc_res.vdes),
        tau_ff=torch.where(e, zeros, cfg.tau_ff_scale * wbc_res.tau_ff))

    mpc_tick = (k % cfg.k_mpc) == 0
    new_state = ControllerState(
        gait=pre.gait, footstep=pre.fs_state, foot_traj=pre.ft_state,
        estimator=est.state, mpc=mpc_state, x_f_mpc=x_f_mpc,
        x_f_next=x_f_next,
        last_xref=pre.xref if mpc_tick else state.last_xref,
        last_fsteps=pre.fsteps if mpc_tick else state.last_fsteps,
        wbc=wbc_res.state, q=pre.q, v=pre.v, h_v=pre.h_v,
        yaw_estim=pre.yaw_estim, qdes=wbc_res.qdes, vdes=wbc_res.vdes,
        feet_p_cmd=inp.feet_p_cmd, feet_v_cmd=inp.feet_v_cmd,
        planner_target=planner_target, error=new_err, error_code=code)
    if return_telemetry:
        return new_state, result, Telemetry(
            f_wbc=wbc_res.f_with_delta,
            feet_pos_mes=wbc_res.feet_pos.transpose(-1, -2),
            feet_vel_mes=wbc_res.feet_vel.transpose(-1, -2),
            feet_a_cmd=inp.feet_a_cmd)
    return new_state, result
