# Frozen copy of qrw_tpu_torch/models/solo12.py as of the benchmark's first version;
# a plain reference: it imports nothing of the port.
"""Solo-12 quadruped model: kinematic tree + inertial parameters.

The port's own copy of qrw_tpu/models/solo12.py (numpy only; the port
imports nothing of the JAX package). tests/test_torch_import.py holds
every array of make_solo12() and H_INIT equal to the original's.

The reference obtains its model from the `example_robot_data` Solo-12 URDF at
runtime (scripts/utils_mpc.py:114-150). Neither that package nor Pinocchio is
a dependency here; instead the tree is reconstructed from the authoritative
geometric constants the reference hard-codes:

  * shoulder (neutral footstep) positions (+-0.1946, +-0.14695)
    (scripts/Controller.py:131-133, src/MPC.cpp:24)
  * total mass 2.50000279 kg and whole-body rotational inertia gI
    (src/MPC.cpp:17,25-26)
  * IMU lever arm (0.1163, 0, 0.02) (scripts/Estimator.py:323-324)
  * foot frame order [FL, FR, HL, HR] (scripts/QP_WBC.py:50)

Topology (13 bodies, 12 revolute joints): a free-flyer base and four
identical 3-DoF legs HAA (x-axis) -> HFE (y-axis) -> KFE (y-axis), segment
lengths 0.16 m + 0.16 m, with lateral offsets 0.0875 + 0.014 + 0.03745 +
0.008 = 0.14695 m — which reproduces the reference's shoulder constant
exactly.

Link inertias: vendored from the Open Dynamic Robot Initiative solo12 URDF
(the `example_robot_data` model the reference loads at runtime,
scripts/solo12InvKin.py:12-13, scripts/QP_WBC.py:91-104). Cross-validated
against the reference's own hard-coded aggregates: the link masses sum to
the reference total 2.50000279 kg to 9 significant digits (src/MPC.cpp:17),
and the whole-robot composite inertia at q_init reproduces the hard-coded
gI (src/MPC.cpp:25-26) within 0.5% / 3.7% / 1.2% per axis and the CoM
z-offset -0.026 vs the reference's own "-0.03 approximation"
(src/MPC.cpp:21) — see tests/test_rbd.py::test_aggregate_matches_reference.
The MPC itself keeps using the reference's hard-coded aggregate (cfg.gI),
mirroring the reference's hardcoded-MPC vs URDF-WBC split; these per-link
values feed the CRBA/RNEA/FK path (WBC + estimator), as the URDF does
there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NUM_BODIES = 13     # base + 4 legs x 3 links
NUM_JOINTS = 12
NUM_FEET = 4

# leg order: FL, FR, HL, HR  (scripts/QP_WBC.py:50)
_LEG_SIGNS = [(+1.0, +1.0), (+1.0, -1.0), (-1.0, +1.0), (-1.0, -1.0)]

# segment geometry [m]
_HAA_X = 0.1946        # fore/aft offset of the hip from base center
_HAA_Y = 0.0875        # lateral offset base -> HAA
_HFE_Y = 0.014         # lateral offset HAA -> HFE
_KFE_Y = 0.03745       # lateral offset HFE -> KFE
_FOOT_Y = 0.008        # lateral offset KFE -> foot
_UPPER_L = 0.16        # upper leg length (HFE -> KFE, along -z)
_LOWER_L = 0.16        # lower leg length (KFE -> foot, along -z)

# link masses [kg], ODRI solo12 URDF; base + 4*(shoulder + upper + lower
# + foot) = 2.50000279 exactly (src/MPC.cpp:17)
_M_BASE = 1.16115091
_M_HAA = 0.14853845       # shoulder link (HAA->HFE actuator module)
_M_UPPER = 0.14853845     # upper leg (identical actuator module + structure)
_M_LOWER = 0.03070001     # lower leg (carbon tube + KFE output)
_M_FOOT = 0.00693606      # foot (fixed joint at the tube end)

# actuator-module principal inertias [kg m^2] about its CoM; the same
# module appears as the shoulder (long axis x) and the upper leg (long
# axis z)
_I_MOD_LONG = 0.00003024
_I_MOD_T1 = 0.00041193
_I_MOD_T2 = 0.00041107

# base link inertia about its CoM (at the base frame origin)
_I_BASE = (0.00578574, 0.01938108, 0.02476124)

# reference aggregate constants (src/MPC.cpp:17-26)
TOTAL_MASS = 2.50000279
GI = np.array([[3.09249e-2, -8.00101e-7, 1.865287e-5],
               [-8.00101e-7, 5.106100e-2, 1.245813e-4],
               [1.865287e-5, 1.245813e-4, 6.939757e-2]])
COM_OFFSET = np.array([0.0, 0.0, -0.03])   # CoM relative to base origin
Q_INIT = np.array([0.0, 0.7, -1.4, -0.0, 0.7, -1.4,
                   0.0, -0.7, 1.4, -0.0, -0.7, 1.4])


class Solo12Model(NamedTuple):
    """Static model data (numpy; converted lazily by jnp ops).

    Joint/body i (1..12) is connected to `parent[i]` by a revolute joint with
    axis `joint_axis[i]` and frame translation `joint_pos[i]` (no fixed
    rotation: all joint frames are axis-aligned with the base).
    Index 0 is the free-flyer base. Arrays are indexed by body (0..12).
    """
    parent: np.ndarray          # (13,) int, parent[0] = -1
    joint_axis: np.ndarray      # (13, 3), row 0 unused
    joint_pos: np.ndarray       # (13, 3), row 0 unused
    mass: np.ndarray            # (13,)
    com: np.ndarray             # (13, 3) CoM in body frame
    inertia: np.ndarray         # (13, 3, 3) rotational inertia about CoM
    foot_body: np.ndarray       # (4,) int — body index carrying each foot
    foot_pos: np.ndarray        # (4, 3) foot frame translation in body frame
    shoulders: np.ndarray       # (3, 4) neutral footstep positions
    imu_offset: np.ndarray      # (3,)
    foot_joints: np.ndarray     # (4, 3) int — joint indices (0..11) per leg

    @property
    def nv(self) -> int:
        return 6 + NUM_JOINTS


def _leg_link_params(sx: float, sy: float):
    """Per-leg link (mass, com, inertia) for shoulder / upper / lower
    links, URDF values mirrored by the leg's (sx, sy) quadrant signs.

    The foot body (mass 0.00693606 at the tube end) is attached to the
    lower leg by a fixed joint in the URDF; it is folded into the lower
    link here exactly (combined CoM + parallel-axis inertia), keeping the
    13-body tree while preserving the full inertial model."""
    haa = (_M_HAA, np.array([-sx * 0.078707, sy * 0.01, 0.0]),
           np.diag([_I_MOD_LONG, _I_MOD_T1, _I_MOD_T2]))
    upper = (_M_UPPER,
             np.array([sx * 0.00001377, sy * 0.01935853, -0.078707]),
             np.diag([_I_MOD_T2, _I_MOD_T1, _I_MOD_LONG]))
    # lower leg + foot, combined about the merged CoM
    c_lo = np.array([0.0, sy * 0.005, -0.0787])
    I_lo = np.diag([6.5e-5, 6.5e-5, 3e-6])
    c_ft = np.array([0.0, sy * _FOOT_Y, -_LOWER_L])
    I_ft = np.eye(3) * 1e-7
    m = _M_LOWER + _M_FOOT
    c = (_M_LOWER * c_lo + _M_FOOT * c_ft) / m
    def _shift(I, mass, d):
        return I + mass * (np.eye(3) * (d @ d) - np.outer(d, d))
    I = _shift(I_lo, _M_LOWER, c_lo - c) + _shift(I_ft, _M_FOOT, c_ft - c)
    lower = (m, c, I)
    return [haa, upper, lower]


def make_solo12() -> Solo12Model:
    parent = np.full(NUM_BODIES, -1, dtype=np.int32)
    joint_axis = np.zeros((NUM_BODIES, 3))
    joint_pos = np.zeros((NUM_BODIES, 3))
    mass = np.zeros(NUM_BODIES)
    com = np.zeros((NUM_BODIES, 3))
    inertia = np.zeros((NUM_BODIES, 3, 3))
    foot_body = np.zeros(NUM_FEET, dtype=np.int32)
    foot_pos = np.zeros((NUM_FEET, 3))
    foot_joints = np.zeros((NUM_FEET, 3), dtype=np.int32)
    shoulders = np.zeros((3, NUM_FEET))

    # --- legs --------------------------------------------------------
    for leg, (sx, sy) in enumerate(_LEG_SIGNS):
        base_idx = 1 + 3 * leg
        links = _leg_link_params(sx, sy)
        # haa
        parent[base_idx] = 0
        joint_axis[base_idx] = [1.0, 0.0, 0.0]
        joint_pos[base_idx] = [sx * _HAA_X, sy * _HAA_Y, 0.0]
        # hfe
        parent[base_idx + 1] = base_idx
        joint_axis[base_idx + 1] = [0.0, 1.0, 0.0]
        joint_pos[base_idx + 1] = [0.0, sy * _HFE_Y, 0.0]
        # kfe
        parent[base_idx + 2] = base_idx + 1
        joint_axis[base_idx + 2] = [0.0, 1.0, 0.0]
        joint_pos[base_idx + 2] = [0.0, sy * _KFE_Y, -_UPPER_L]
        for k, (m, c, ic) in enumerate(links):
            mass[base_idx + k] = m
            com[base_idx + k] = c
            inertia[base_idx + k] = ic
        foot_body[leg] = base_idx + 2
        foot_pos[leg] = [0.0, sy * _FOOT_Y, -_LOWER_L]
        foot_joints[leg] = [3 * leg, 3 * leg + 1, 3 * leg + 2]
        shoulders[:, leg] = [sx * _HAA_X, sy * 0.14695, 0.0]

    # --- base (URDF values; CoM at the base frame origin) -------------
    mass[0] = _M_BASE
    com[0] = np.zeros(3)
    inertia[0] = np.diag(_I_BASE)

    return Solo12Model(
        parent=parent, joint_axis=joint_axis, joint_pos=joint_pos,
        mass=mass, com=com, inertia=inertia,
        foot_body=foot_body, foot_pos=foot_pos, shoulders=shoulders,
        imu_offset=np.array([0.1163, 0.0, 0.02]),
        foot_joints=foot_joints,
    )


# Neutral base height at Q_INIT: distance base origin -> foot z
# (scripts/utils_mpc.py:147). Both segments fold by 0.7 rad.
H_INIT = _UPPER_L * np.cos(0.7) + _LOWER_L * np.cos(0.7)
