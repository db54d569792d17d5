"""Typed configuration of the reactive walking stack.

The port's own copy of qrw_tpu/config.py (the port imports nothing of
the JAX package); tests/test_torch_import.py holds the two equal, field
by field. It centralizes the 17 YAML keys of the reference config
(the reference's src/config_solo12.yaml, parsed by src/Params.cpp:38-87) plus
every physical constant the reference hard-codes at point of use
(SURVEY.md section 5.6), so a single frozen dataclass parameterizes the whole
controller. The dataclass is frozen and hashable; all fields are Python
scalars/tuples (no arrays).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

try:  # optional — only needed when loading .yaml files
    import yaml  # type: ignore
except Exception:  # pragma: no cover
    yaml = None


@dataclasses.dataclass(frozen=True)
class Config:
    # ------------------------------------------------------------------
    # The 17 reference YAML keys (src/config_solo12.yaml:1-19)
    # ------------------------------------------------------------------
    interface: str = "enp2s0"          # network interface of the real robot
    SIMULATION: bool = True            # simulator device vs real masterboard
    LOGGING: bool = False              # enable per-tick logging
    PLOTTING: bool = True              # plot at the end of a run
    dt_wbc: float = 0.002              # whole-body control period [s] (500 Hz)
    N_gait: int = 20                   # rows in the gait matrices
    envID: int = 0                     # environment id (0 flat, 1 stairs)
    velID: int = 2                     # predefined velocity profile id
    dt_mpc: float = 0.02               # MPC period [s] (50 Hz)
    T_gait: float = 0.32               # gait period [s]
    T_mpc: float = 0.32                # MPC horizon [s]
    N_SIMULATION: int = 3000           # number of WBC ticks to simulate
    type_MPC: bool = True              # True: convex QP MPC, False: DDP MPC
    # Footstep-optimizing DDP MPC (MPC_crocoddyl_planner): jointly
    # optimizes footstep locations with contact forces; its touchdown
    # targets override the Raibert heuristic for the swing trajectories.
    # Takes precedence over type_MPC when set.
    mpc_planner: bool = False
    use_flat_plane: bool = True        # flat vs bumpy terrain
    predefined_vel: bool = True        # velocity profile vs gamepad
    kf_enabled: bool = False           # Kalman (True) vs complementary filter
    enable_pyb_GUI: bool = False       # GUI flag (no-op on TPU; kept for parity)
    # Async MPC semantics (enable_multiprocessing, scripts/Controller.py:143;
    # stale-plan roll scripts/MPC_Wrapper.py:89-103): the controller
    # consumes the plan computed one MPC period earlier, deterministically
    # reproduced in-graph via a double-buffered plan + staleness roll.
    mpc_async: bool = False
    # 500 Hz MPC (crocoddyl_eval/test_5: DDP re-solved at the WBC rate
    # with the first node shrunk to the time remaining before the next
    # gait boundary — MPC_crocoddyl_2 dt_tsid semantics). DDP backend
    # only (type_MPC=False); incompatible with mpc_async/mpc_planner.
    mpc_every_tick: bool = False

    # ------------------------------------------------------------------
    # Physical constants hard-coded by the reference, centralized here
    # ------------------------------------------------------------------
    # Single-rigid-body model used by the MPC (src/MPC.cpp:17-29)
    mass: float = 2.50000279           # total robot mass [kg]
    mu: float = 0.9                    # friction coefficient (MPC pyramid)
    # body-frame rotational inertia of the whole robot (src/MPC.cpp:25-26)
    gI: Tuple[float, ...] = (
        3.09249e-2, -8.00101e-7, 1.865287e-5,
        -8.00101e-7, 5.106100e-2, 1.245813e-4,
        1.865287e-5, 1.245813e-4, 6.939757e-2,
    )
    # Reference base height [m]. The reference sets h_ref = h_init, the
    # standing height of the robot model in q_init (scripts/Controller.py:
    # 116, scripts/utils_mpc.py:114-150); for the qrw_tpu Solo-12 model
    # that is 2*0.16*cos(0.7) (models/solo12.py H_INIT), keeping the
    # initial state and the regulation target consistent so the startup
    # security check (scripts/main_solo12_control.py:190-195) is clean.
    h_ref: float = 0.24474949993103629
    offset_com_z: float = -0.03        # CoM vertical offset from base (src/MPC.cpp:21)
    fz_max: float = 25.0               # max vertical contact force [N] (src/MPC.cpp:295-297)
    gravity: float = 9.81

    # MPC cost weights (src/MPC.cpp:330,346-349)
    w_state: Tuple[float, ...] = (2.0, 2.0, 20.0, 0.25, 0.25, 10.0,
                                  0.2, 0.2, 0.2, 0.0, 0.0, 0.3)
    w_force: float = 5e-5

    # OSQP-equivalent ADMM settings for the MPC QP (src/MPC.cpp:527-540)
    osqp_sigma: float = 1e-6
    osqp_eps_abs: float = 1e-6
    osqp_eps_rel: float = 1e-6
    osqp_alpha: float = 1.6
    osqp_rho: float = 0.1
    osqp_adaptive_rho_interval: int = 200
    osqp_adaptive_rho_tolerance: float = 5.0
    mpc_max_iter: int = 1000           # hard cap (fixed-shape scan bound)

    # WBC box-QP settings (src/QPWBC.cpp:239-240, include/qrw/QPWBC.hpp:26-27)
    wbc_eps_abs: float = 1e-5
    wbc_eps_rel: float = 1e-5
    wbc_q1: float = 0.1                # weight on base-acceleration deltas
    wbc_q2: float = 5.0                # weight on force deltas
    wbc_max_iter: int = 400

    # Footstep planner constants (src/FootstepPlanner.cpp:5-7)
    k_feedback: float = 0.03           # Raibert feedback gain
    step_limit: float = 0.155          # max footstep deviation L [m]

    # Swing-foot trajectory (scripts/Controller.py:138)
    max_height: float = 0.05           # swing apex [m]
    lock_time: float = 0.07            # target lock window before touchdown [s]

    # Inverse kinematics gains (include/qrw/InvKin.hpp:56-57)
    kp_flyingfeet: float = 100.0
    kd_flyingfeet: float = 20.0        # 2 * sqrt(kp)

    # Joint PD gains + feedforward scaling (scripts/Controller.py:306-310)
    joint_P: float = 3.0
    joint_D: float = 0.2
    tau_ff_scale: float = 0.8

    # Safety envelopes (scripts/Controller.py:184,341-355)
    q_security: Tuple[float, float, float] = (math.pi * 0.4,
                                              math.pi * 80.0 / 180.0,
                                              math.pi)
    v_security: float = 50.0           # filtered joint velocity limit [rad/s]
    tau_security: float = 8.0          # feedforward torque limit [N m]
    damping_D: float = 0.1             # fallback pure-damping gain

    # Estimator constants (scripts/Estimator.py:245-324)
    fc_vel: float = 50.0               # velocity low-pass cut frequency [Hz]
    fc_secu: float = 6.0               # security-filter cut frequency [Hz]
    # NOTE: the reference constructs its ComplementaryFilters with fc 3/500 Hz
    # (scripts/Estimator.py:266-267) but always overrides alpha at compute
    # time (adaptive trust / alpha_pos), so those cutoffs are dead there too
    # and are intentionally not part of this config.
    imu_offset: Tuple[float, float, float] = (0.1163, 0.0, 0.02)
    foot_radius: float = 0.025         # rolling correction (Estimator.py:434)
    contact_security_ticks: int = 16   # FK trust margin after contact switch
    alpha_pos: Tuple[float, float, float] = (0.995, 0.995, 0.9)

    # Joystick (scripts/Joystick.py:22-51)
    joy_tc: float = 0.02               # gamepad low-pass time constant [s]
    vx_scale: float = 0.6
    vy_scale: float = 1.2
    vyaw_scale: float = 1.6

    # Simulator (sim/physics.py) — replaces PyBullet world constants
    sim_substeps: int = 4              # physics substeps per WBC tick
    ground_stiffness: float = 4000.0   # compliant contact normal stiffness
    ground_damping: float = 40.0       # normal damping
    ground_friction_vel: float = 0.02  # tangential stick velocity scale [m/s]
    sim_mu: float = 0.9                # ground friction coefficient

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------
    @property
    def k_mpc(self) -> int:
        """WBC ticks per MPC step (scripts/main_solo12_control.py:122-124)."""
        return int(round(self.dt_mpc / self.dt_wbc))

    @property
    def n_steps(self) -> int:
        """MPC horizon length N (src/MPC.cpp:8-12); 16 by default."""
        return int(round(self.T_mpc / self.dt_mpc))

    @property
    def q_init(self) -> Tuple[float, ...]:
        """Default joint configuration (scripts/main_solo12_control.py:111)."""
        return (0.0, 0.7, -1.4, -0.0, 0.7, -1.4,
                0.0, -0.7, 1.4, -0.0, -0.7, 1.4)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def load_config(path: str | None = None, **overrides) -> Config:
    """Build a Config, optionally from a YAML file with the reference's
    `robot:` section layout (src/config_solo12.yaml), plus overrides."""
    fields = {}
    if path is not None:
        if yaml is None:  # pragma: no cover
            raise RuntimeError("pyyaml not available")
        with open(path) as f:
            raw = yaml.safe_load(f)
        robot = raw.get("robot", raw)
        valid = {f.name for f in dataclasses.fields(Config)}
        fields.update({k: v for k, v in robot.items() if k in valid})
    fields.update(overrides)
    return Config(**fields)
