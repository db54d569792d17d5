"""Articulated rigid-body simulator with compliant contact.

Port of qrw_tpu/sim/physics.py, batched over leading robot axes: the
simulator state, its initialization (on the flat plane or settled onto
a sim/terrain height field), the envID=1 thrown spheres (`Projectiles`)
and the per-robot `step` of the single-robot rollout. Each WBC tick
computes the on-board control law tau = P (q_des - q) + D (v_des - v)
+ tau_ff once from the start-of-tick measurements, then takes
cfg.sim_substeps substeps of whole-robot forward dynamics (CRBA / RNEA
of ops/rbd, a Cholesky solve of ops/lin) under the compliant ground
contact: a normal spring-damper and a tangential anchor spring clamped
to the friction cone, the anchor sliding on saturation. The fleet steps
its robots lane-major (sim/physics_lane.step_lane).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.estimator import DeviceData
from qrw_tpu_torch.ops import lin, rbd
from qrw_tpu_torch.ops.rotations import quat_integrate, quat_to_rot
from qrw_tpu_torch.sim.terrain import FleetTerrain, height_at


class Projectiles(NamedTuple):
    """The envID=1 thrown spheres: 0.4 kg balls parked beside the
    course, launched at a fixed velocity when the robot's y crosses a
    per-sphere trigger, then ballistic with ground bounce and a
    compliant sphere-base contact that pushes on the robot."""
    pos: torch.Tensor         # (..., S, 3) world position
    vel: torch.Tensor         # (..., S, 3) world velocity
    launched: torch.Tensor    # (..., S) bool
    trigger_y: torch.Tensor   # (..., S) robot-y threshold that launches
    launch_vel: torch.Tensor  # (..., S, 3)


def init_projectiles(dtype=torch.float32, device="cpu") -> Projectiles:
    """The reference's two spheres (scripts/PyBulletSimulator.py:160-173,
    289-298)."""
    kw = dict(dtype=dtype, device=device)
    return Projectiles(
        pos=torch.tensor([[-0.6, 0.9, 0.1], [0.6, 1.1, 0.1]], **kw),
        vel=torch.zeros((2, 3), **kw),
        launched=torch.zeros(2, dtype=torch.bool, device=device),
        trigger_y=torch.tensor([0.9, 1.1], **kw),
        launch_vel=torch.tensor([[2.5, 0.0, 2.0], [-2.5, 0.0, 2.0]], **kw))


PROJ_MASS = 0.4        # kg (scripts/PyBulletSimulator.py:160)
PROJ_RADIUS = 0.05     # sphere_smooth.obj at meshScale 0.1
BASE_RADIUS = 0.15     # effective robot-body contact radius
PROJ_STIFF = 2000.0    # compliant sphere-body contact stiffness [N/m]


def step_projectiles(cfg: Config, proj: Projectiles, base_pos, dt):
    """One dt of projectile dynamics: (new proj, force on the base
    (..., 3))."""
    launched = proj.launched | (base_pos[..., 1:2] >= proj.trigger_y)
    vel = torch.where(proj.launched[..., None], proj.vel, 0.0)
    vel = torch.where((launched & ~proj.launched)[..., None],
                      proj.launch_vel, vel)
    # gravity + ground bounce while launched
    vz = vel[..., 2] + torch.where(launched, -cfg.gravity * dt, 0.0)
    hit_ground = (proj.pos[..., 2] <= PROJ_RADIUS) & (vz < 0)
    vz = torch.where(hit_ground, -0.5 * vz, vz)
    vel = torch.cat([vel[..., 0:2], vz[..., None]], dim=-1)
    # compliant contact with the robot body
    d = proj.pos - base_pos[..., None, :]
    dist = torch.linalg.vector_norm(d, dim=-1)
    overlap = (PROJ_RADIUS + BASE_RADIUS) - dist
    n = d / torch.clamp(dist, min=1e-6)[..., None]
    fmag = torch.clamp(overlap, min=0.0) * PROJ_STIFF
    f_sphere = fmag[..., None] * n                  # pushes the sphere away
    f_base = -f_sphere.sum(-2)                      # reaction on the robot
    vel = vel + torch.where(launched[..., None], f_sphere / PROJ_MASS * dt,
                            0.0)
    pos = proj.pos + torch.where(launched[..., None], vel * dt, 0.0)
    pos = torch.cat([pos[..., 0:2],
                     torch.clamp(pos[..., 2:3], min=PROJ_RADIUS)], dim=-1)
    return (proj._replace(pos=pos, vel=vel, launched=launched),
            f_base.to(proj.pos.dtype))


class SimState(NamedTuple):
    q: torch.Tensor               # (..., 19) base pos + quat + joints
    v: torch.Tensor               # (..., 18) local base twist + joint rates
    anchors: torch.Tensor         # (..., 4, 2) tangential contact anchors
    active: torch.Tensor          # (..., 4) contact active flags
    prev_o_imu_vel: torch.Tensor  # (..., 3) previous IMU-point velocity
    joint_torques: torch.Tensor   # (..., 12) applied torques
    proj: Optional[Projectiles] = None  # envID=1 thrown spheres


def init_sim_state(cfg: Config, q_init=None, height: Optional[float] = None,
                   terrain=None, dtype=torch.float32,
                   device="cpu") -> SimState:
    """Initial simulator state. On a terrain the base is raised by the
    highest ground under the feet's neutral (shoulder) positions, so the
    lowest foot just touches: the reference's startup settling."""
    from qrw_tpu_torch.models.solo12 import H_INIT, make_solo12
    kw = dict(dtype=dtype, device=device)
    if q_init is None:
        q_init = torch.tensor(cfg.q_init, **kw)
    h = torch.tensor(H_INIT if height is None else height, **kw)
    if terrain is not None:
        sh = torch.as_tensor(make_solo12().shoulders[0:2].T, **kw)
        h = h + torch.max(height_at(terrain, sh)).to(dtype)
    zero = torch.zeros((), **kw)
    q = torch.cat([torch.stack([zero, zero, h, zero, zero, zero,
                                torch.ones((), **kw)]), q_init.to(**kw)])
    return SimState(
        q=q, v=torch.zeros(18, **kw), anchors=torch.zeros((4, 2), **kw),
        active=torch.zeros(4, dtype=torch.bool, device=device),
        prev_o_imu_vel=torch.zeros(3, **kw),
        joint_torques=torch.zeros(12, **kw),
        proj=init_projectiles(dtype, device) if cfg.envID == 1 else None)


def _ground_height(terrain, xy):
    """Terrain height under the feet xy (..., 4, 2); a FleetTerrain
    takes the robot axis last, so the foot axis moves in front."""
    if isinstance(terrain, FleetTerrain):
        return height_at(terrain, xy.movedim(-2, 0)).movedim(0, -1)
    return height_at(terrain, xy)


def _contact_forces(cfg: Config, state: SimState, pos, vel, ground_h=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World-frame ground forces at the 4 feet (..., 4, 3), the updated
    anchors (..., 4, 2) and the contact flags (..., 4). pos / vel
    (..., 4, 3) world foot positions / velocities; ground_h (..., 4)
    terrain height under each foot (None: the plane z = 0)."""
    if ground_h is None:
        ground_h = torch.zeros_like(pos[..., 2])
    pen = ground_h - pos[..., 2]                       # penetration depth
    in_ground = pen > 0.0
    fn = torch.clamp(cfg.ground_stiffness * pen
                     - cfg.ground_damping * vel[..., 2], min=0.0)
    fn = torch.where(in_ground, fn, 0.0)

    # tangential anchor spring, clamped to the friction cone
    anchors = torch.where((in_ground & ~state.active)[..., None],
                          pos[..., 0:2], state.anchors)
    raw = (-cfg.ground_stiffness * (pos[..., 0:2] - anchors)
           - cfg.ground_damping * vel[..., 0:2])
    norm = torch.linalg.vector_norm(raw, dim=-1)
    fmax = cfg.sim_mu * fn
    scale = torch.where(norm > fmax, fmax / torch.clamp(norm, min=1e-9), 1.0)
    ft = torch.where(in_ground[..., None], raw * scale[..., None], 0.0)
    # slide the anchor when the cone saturates (keeps the spring consistent)
    anchors = torch.where((in_ground & (norm > fmax))[..., None],
                          pos[..., 0:2]
                          + (ft + cfg.ground_damping * vel[..., 0:2])
                          / cfg.ground_stiffness,
                          anchors)
    forces = torch.cat([ft, fn[..., None]], dim=-1)
    return forces, anchors, in_ground


def step(cfg: Config, model: rbd.TorchModel, state: SimState, P, D, q_des,
         v_des, tau_ff, f_ext=None, terrain=None
         ) -> Tuple[SimState, DeviceData]:
    """Advance one WBC tick (dt_wbc) with cfg.sim_substeps substeps.
    State leaves (..., *), P / D / q_des / v_des / tau_ff (..., 12),
    f_ext (..., 3) world-frame base force (None: none), terrain None
    (flat), a Terrain or a FleetTerrain (a leading robot axis)."""
    dtype, dev = state.q.dtype, state.q.device
    batch = state.q.shape[:-1]
    dt = cfg.dt_wbc / cfg.sim_substeps
    if f_ext is None:
        f_ext = torch.zeros(batch + (3,), dtype=dtype, device=dev)

    tau = (P * (q_des - state.q[..., 7:]) + D * (v_des - state.v[..., 6:])
           + tau_ff)

    q, v, anchors, active, proj = (state.q, state.v, state.anchors,
                                   state.active, state.proj)
    zero18 = torch.zeros(batch + (18,), dtype=dtype, device=dev)
    for _ in range(cfg.sim_substeps):
        base_pos, quat, qj = q[..., 0:3], q[..., 3:7], q[..., 7:]
        kin = rbd.frame_kinematics(model, base_pos, quat, qj, v[..., 0:6],
                                   v[..., 6:])
        ground_h = (_ground_height(terrain, kin.pos[..., 0:2])
                    if terrain is not None else None)
        forces, anchors, active = _contact_forces(
            cfg, SimState(q, v, anchors, active, state.prev_o_imu_vel, tau),
            kin.pos, kin.vel, ground_h)
        J = rbd.foot_jacobians(model, base_pos, quat, qj, fk=(kin.R, kin.p))
        f_gen = torch.einsum("...fan,...fa->...n", J, forces)
        f_world = f_ext
        if proj is not None:
            proj, f_proj = step_projectiles(cfg, proj, base_pos, dt)
            f_world = f_world + f_proj
        R = quat_to_rot(quat)
        f_gen = torch.cat([f_gen[..., 0:3] + rbd._mv(R.transpose(-1, -2), f_world),
                           f_gen[..., 3:]], dim=-1)
        h = rbd.rnea(model, quat, qj, v, zero18, cfg.gravity)
        M = rbd.crba(model, qj)
        rhs = f_gen - h
        rhs = torch.cat([rhs[..., :6], rhs[..., 6:] + tau], dim=-1)
        a = lin.chol_solve(M, rhs)
        v = v + dt * a
        q = torch.cat([base_pos + dt * rbd._mv(R, v[..., 0:3]),
                       quat_integrate(quat, v[..., 3:6], dt),
                       qj + dt * v[..., 6:]], dim=-1)

    # ---- measurement synthesis -------------------------------------------
    R = quat_to_rot(q[..., 3:7])
    o_base_vel = rbd._mv(R, v[..., 0:3])
    omega_b = v[..., 3:6]
    imu_r = torch.tensor(cfg.imu_offset, dtype=dtype, device=dev)
    # the r x omega lever-arm convention of the reference device facade
    o_imu_vel = o_base_vel + rbd._mv(R, torch.linalg.cross(
        imu_r.expand(omega_b.shape), omega_b))
    base_lin_acc = rbd._mv(R.transpose(-1, -2),
                       o_imu_vel - state.prev_o_imu_vel) / cfg.dt_wbc

    device = DeviceData(
        base_lin_acc=base_lin_acc, base_ang_vel=omega_b,
        base_quat=q[..., 3:7], q_mes=q[..., 7:], v_mes=v[..., 6:],
        dummy_pos=q[..., 0:3], b_base_vel=v[..., 0:3])
    new_state = SimState(q=q, v=v, anchors=anchors, active=active,
                         prev_o_imu_vel=o_imu_vel, joint_torques=tau,
                         proj=proj)
    return new_state, device
