"""Closed-loop rollout: controller + simulator, tick after tick.

Port of qrw_tpu/sim/rollout.py: the main control loop of the reference
(device measurement -> controller tick -> joint PD command -> physics
step), repeated for n ticks. The JAX package runs it as one jitted
`lax.scan` and batches scenarios with `jax.vmap`; here it is a Python
loop over ticks on tensors whose leading axes are robots, so a carry
broadcast to (B, ...) runs B robots at once (the CLI's `--batch`). The
MPC and WBC solves are per robot, as under vmap: the QP MPC and the WBC
through ops/qp.solve, the DDP backends (type_MPC False, mpc_planner)
as B problems of one ops/ilqr.solve, their warm starts in the carry.

The logs are preallocated on the carry's device, (..., T, *) as the
JAX package's vmapped rollout returns them, and filled in place;
`with_logs=False` allocates none.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from qrw_tpu_torch.core.controller import (Controller, ControllerState,
                                           compute, init_state,
                                           make_controller)
from qrw_tpu_torch.core.estimator import DeviceData
from qrw_tpu_torch.core.joystick import v_ref_profile
from qrw_tpu_torch.sim.physics import SimState, init_sim_state, step
from qrw_tpu_torch.utils.profiling import span


class RolloutCarry(NamedTuple):
    ctl_state: ControllerState
    sim_state: SimState


class RolloutLog(NamedTuple):
    """Per-tick signals, (..., T, *) (the structured-logging core of the
    reference's LoggerControl / LoggerSensors)."""
    base_pos: torch.Tensor      # (..., T, 3) ground-truth base position
    base_quat: torch.Tensor     # (..., T, 4) ground-truth orientation
    base_vel: torch.Tensor      # (..., T, 3) base-frame linear velocity
    rpy_vel: torch.Tensor       # (..., T, 3) angular velocity
    q_mes: torch.Tensor         # (..., T, 12) joint encoder positions
    v_mes: torch.Tensor         # (..., T, 12) joint encoder velocities
    q_des: torch.Tensor         # (..., T, 12) WBC joint position targets
    v_des: torch.Tensor         # (..., T, 12) WBC joint velocity targets
    tau_ff: torch.Tensor        # (..., T, 12) feedforward torques
    tau_applied: torch.Tensor   # (..., T, 12) PD+ff torques applied
    f_mpc: torch.Tensor         # (..., T, 12) first-step MPC forces
    f_wbc: torch.Tensor         # (..., T, 12) WBC QP output forces
    feet_pos_ref: torch.Tensor  # (..., T, 3, 4) swing-trajectory targets
    feet_p_cmd: torch.Tensor    # (..., T, 3, 4) foot position refs (base)
    feet_v_cmd: torch.Tensor    # (..., T, 3, 4) foot velocity refs (base)
    feet_a_cmd: torch.Tensor    # (..., T, 3, 4) foot acceleration refs
    feet_pos_mes: torch.Tensor  # (..., T, 3, 4) IK-model foot positions
    feet_vel_mes: torch.Tensor  # (..., T, 3, 4) IK-model foot velocities
    q_est: torch.Tensor         # (..., T, 19) hybrid state estimate
    v_est: torch.Tensor         # (..., T, 18) estimator velocity
    est_hp_vel: torch.Tensor    # (..., T, 3) velocity filter HP part
    est_lp_vel: torch.Tensor    # (..., T, 3) velocity filter LP part
    est_hp_pos: torch.Tensor    # (..., T, 3) position filter HP part
    est_lp_pos: torch.Tensor    # (..., T, 3) position filter LP part
    est_fk_vel: torch.Tensor    # (..., T, 3) FK velocity filter input
    est_fk_xyz: torch.Tensor    # (..., T, 3) FK position filter input
    x_f_mpc: torch.Tensor       # (..., T, 24, N) full MPC plan
    gait_row0: torch.Tensor     # (..., T, 4) current contact state
    mpc_xref: torch.Tensor      # (..., T, 12, N+1) latest MPC inputs
    mpc_fsteps: torch.Tensor    # (..., T, N_gait, 12)
    v_ref: torch.Tensor         # (..., T, 6) commanded velocity
    error: torch.Tensor         # (..., T) security latch
    error_code: torch.Tensor    # (..., T) int32


def _tick_log(cs, ss, result, telem, v_ref) -> RolloutLog:
    """One tick's log entries, (..., *)."""
    return RolloutLog(
        base_pos=ss.q[..., 0:3], base_quat=ss.q[..., 3:7],
        base_vel=ss.v[..., 0:3], rpy_vel=ss.v[..., 3:6],
        q_mes=ss.q[..., 7:], v_mes=ss.v[..., 6:],
        q_des=result.q_des, v_des=result.v_des, tau_ff=result.tau_ff,
        tau_applied=ss.joint_torques, f_mpc=cs.x_f_mpc[..., 12:, 0],
        f_wbc=telem.f_wbc, feet_pos_ref=cs.foot_traj.position,
        feet_p_cmd=cs.feet_p_cmd, feet_v_cmd=cs.feet_v_cmd,
        feet_a_cmd=telem.feet_a_cmd, feet_pos_mes=telem.feet_pos_mes,
        feet_vel_mes=telem.feet_vel_mes, q_est=cs.q, v_est=cs.v,
        est_hp_vel=cs.estimator.hp_vel, est_lp_vel=cs.estimator.lp_vel,
        est_hp_pos=cs.estimator.hp_pos, est_lp_pos=cs.estimator.lp_pos,
        est_fk_vel=cs.estimator.fk_lin_vel, est_fk_xyz=cs.estimator.fk_xyz,
        x_f_mpc=cs.x_f_mpc, gait_row0=cs.gait.current[..., 0, :],
        mpc_xref=cs.last_xref, mpc_fsteps=cs.last_fsteps, v_ref=v_ref,
        error=cs.error, error_code=cs.error_code)


def _schedule(sched, n_ticks: int, tail: int, dtype, device):
    """A (n_ticks, [robots,] tail) schedule as a tensor on `device`."""
    t = torch.as_tensor(np.asarray(sched) if not torch.is_tensor(sched)
                        else sched)
    if t.shape[0] != n_ticks or t.shape[-1] != tail:
        raise ValueError(f"schedule of shape {tuple(t.shape)} for "
                         f"{n_ticks} ticks")
    return t.to(dtype=dtype, device=device)


def rollout(ctl: Controller, carry: RolloutCarry, n_ticks: int, k0: int = 0,
            v_ref_schedule=None, f_ext_schedule=None,
            perfect_estimator: bool = False, terrain=None,
            joystick_schedule=None, with_logs: bool = True
            ) -> Tuple[RolloutCarry, Optional[RolloutLog]]:
    """Run `n_ticks` closed-loop control ticks from tick `k0`.

    v_ref_schedule: optional (n_ticks, [B,] 6) velocity commands
    (default: the predefined profile cfg.velID). f_ext_schedule:
    optional (n_ticks, [B,] 3) world-frame base force (sim/faults.py).
    terrain: None (flat), a sim.terrain.Terrain or a FleetTerrain.
    joystick_schedule: optional (n_ticks,) gait-switch codes (1 pacing,
    2 bounding, 3 trot, 4 static; 0 no change), shared by the batch.
    Returns (final carry, logs or None)."""
    cfg = ctl.cfg
    ss = carry.sim_state
    dtype, dev = ss.q.dtype, ss.q.device
    batch = tuple(ss.q.shape[:-1])
    nb = len(batch)

    if v_ref_schedule is None:
        v_ref_schedule = np.stack([
            v_ref_profile(k0 + t, cfg.velID, torch.float64).numpy()
            for t in range(n_ticks)]) if n_ticks else np.zeros((0, 6))
    v_refs = _schedule(v_ref_schedule, n_ticks, 6, dtype, dev)
    f_exts = (None if f_ext_schedule is None else
              _schedule(f_ext_schedule, n_ticks, 3, dtype, dev))
    jcodes = ([0] * n_ticks if joystick_schedule is None else
              [int(c) for c in np.asarray(
                  joystick_schedule.cpu() if torch.is_tensor(
                      joystick_schedule) else joystick_schedule)])

    # initial measurements, synthesized from the sim state
    cs = carry.ctl_state
    device = DeviceData(
        base_lin_acc=torch.zeros_like(ss.q[..., 0:3]),
        base_ang_vel=ss.v[..., 3:6], base_quat=ss.q[..., 3:7],
        q_mes=ss.q[..., 7:], v_mes=ss.v[..., 6:], dummy_pos=ss.q[..., 0:3],
        b_base_vel=ss.v[..., 0:3])
    logs = None
    at = (slice(None),) * nb
    for t in range(n_ticks):
        k = k0 + t
        v_ref = v_refs[t].expand(batch + (6,))
        cs, result, telem = compute(ctl, cs, device, k, v_ref6=v_ref,
                                    joystick_code=jcodes[t],
                                    perfect_estimator=perfect_estimator,
                                    return_telemetry=True)
        with span("physics"):
            ss, device = step(cfg, ctl.model, ss, result.P, result.D,
                              result.q_des, result.v_des, result.tau_ff,
                              f_ext=None if f_exts is None else f_exts[t],
                              terrain=terrain)
        if with_logs:
            entry = _tick_log(cs, ss, result, telem, v_ref)
            if logs is None:
                logs = RolloutLog(*[
                    torch.empty(batch + (n_ticks,) + tuple(e.shape[nb:]),
                                dtype=e.dtype, device=dev) for e in entry])
            for buf, e in zip(logs, entry):
                buf[at + (t,)] = e
    return RolloutCarry(ctl_state=cs, sim_state=ss), logs


def make_rollout(cfg=None, dtype=torch.float32, gait: str = "trot",
                 terrain=None, device="cuda", **cfg_kw):
    """(controller, initial carry) of one robot. Pass the `terrain` of
    the rollout so that the robot starts settled on it. The carry is
    built on `device` (cuda unless the caller asks for the CPU)."""
    from qrw_tpu_torch.config import Config
    from qrw_tpu_torch.sim.fleet import _check_device
    device = _check_device(device)
    if cfg is None:
        cfg = Config(**cfg_kw)
    ctl = make_controller(cfg)
    carry = RolloutCarry(
        ctl_state=init_state(ctl, dtype, gait=gait, device=device),
        sim_state=init_sim_state(cfg, terrain=terrain, dtype=dtype,
                                 device=device))
    return ctl, carry
