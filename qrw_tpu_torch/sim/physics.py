"""Simulator state of the articulated rigid-body simulator.

Partial port of qrw_tpu/sim/physics.py: `SimState` and `init_sim_state`
on flat ground. The fleet steps its robots lane-major
(sim/physics_lane.step_lane); the per-robot `step`, terrain and the
envID=1 projectiles are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from qrw_tpu_torch.config import Config


class SimState(NamedTuple):
    q: torch.Tensor               # (..., 19) base pos + quat + joints
    v: torch.Tensor               # (..., 18) local base twist + joint rates
    anchors: torch.Tensor         # (..., 4, 2) tangential contact anchors
    active: torch.Tensor          # (..., 4) contact active flags
    prev_o_imu_vel: torch.Tensor  # (..., 3) previous IMU-point velocity
    joint_torques: torch.Tensor   # (..., 12) applied torques
    proj: Optional[tuple] = None  # envID=1 thrown spheres (not ported)


def init_sim_state(cfg: Config, q_init=None, height: Optional[float] = None,
                   terrain=None, dtype=torch.float32,
                   device="cpu") -> SimState:
    """Initial simulator state standing on the flat ground."""
    from qrw_tpu_torch.models.solo12 import H_INIT
    if terrain is not None:
        raise NotImplementedError("terrain is not ported yet (flat only)")
    if cfg.envID == 1:
        raise NotImplementedError("envID=1 projectiles are not ported yet")
    kw = dict(dtype=dtype, device=device)
    if q_init is None:
        q_init = torch.tensor(cfg.q_init, **kw)
    h = H_INIT if height is None else height
    q = torch.cat([torch.tensor([0.0, 0.0, h, 0.0, 0.0, 0.0, 1.0], **kw),
                   q_init.to(**kw)])
    return SimState(
        q=q, v=torch.zeros(18, **kw), anchors=torch.zeros((4, 2), **kw),
        active=torch.zeros(4, dtype=torch.bool, device=device),
        prev_o_imu_vel=torch.zeros(3, **kw),
        joint_torques=torch.zeros(12, **kw), proj=None)
