"""Simulator state of the articulated rigid-body simulator.

Partial port of qrw_tpu/sim/physics.py: `SimState` and `init_sim_state`
(on the flat plane or settled onto a sim/terrain height field). The
fleet steps its robots lane-major (sim/physics_lane.step_lane); the
per-robot `step` and the envID=1 projectiles are not ported yet.
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
    """Initial simulator state. On a terrain the base is raised by the
    highest ground under the feet's neutral (shoulder) positions, so the
    lowest foot just touches: the reference's startup settling."""
    from qrw_tpu_torch.models.solo12 import H_INIT, make_solo12
    if cfg.envID == 1:
        raise NotImplementedError("envID=1 projectiles are not ported yet")
    kw = dict(dtype=dtype, device=device)
    if q_init is None:
        q_init = torch.tensor(cfg.q_init, **kw)
    h = torch.tensor(H_INIT if height is None else height, **kw)
    if terrain is not None:
        from qrw_tpu_torch.sim.terrain import height_at
        sh = torch.as_tensor(make_solo12().shoulders[0:2].T, **kw)
        h = h + torch.max(height_at(terrain, sh)).to(dtype)
    zero = torch.zeros((), **kw)
    q = torch.cat([torch.stack([zero, zero, h, zero, zero, zero,
                                torch.ones((), **kw)]), q_init.to(**kw)])
    return SimState(
        q=q, v=torch.zeros(18, **kw), anchors=torch.zeros((4, 2), **kw),
        active=torch.zeros(4, dtype=torch.bool, device=device),
        prev_o_imu_vel=torch.zeros(3, **kw),
        joint_torques=torch.zeros(12, **kw), proj=None)
