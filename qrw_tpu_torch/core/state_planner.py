"""Reference base-state trajectory over the MPC horizon.

Port of qrw_tpu/core/state_planner.py, batched over leading axes:
q7 (..., 7), h_v6 / vref6 (..., 6) -> xref (..., 12, N+1).
"""

from __future__ import annotations

import torch

from qrw_tpu_torch.ops.rotations import quat_to_rpy


def compute_reference_states(q7, h_v6, vref6, *, dt_mpc: float,
                             n_steps: int, h_ref: float, z_average=0.0):
    dtype = q7.dtype
    rpy = quat_to_rpy(q7[..., 3:7])
    vx, vy, wz = vref6[..., 0:1], vref6[..., 1:2], vref6[..., 5:6]

    z2 = torch.zeros_like(q7[..., 0:2])
    col0 = torch.cat([z2, q7[..., 2:3], rpy[..., 0:2], z2[..., 0:1],
                      h_v6[..., 0:3], h_v6[..., 3:6]], dim=-1)

    t = torch.arange(1, n_steps + 1, dtype=dtype,
                     device=q7.device) * dt_mpc
    yaw = wz * t
    s, c = torch.sin(yaw), torch.cos(yaw)
    wz0 = wz == 0
    wz_safe = torch.where(wz0, torch.ones_like(wz), wz)
    x = torch.where(wz0, vx * t, (vx * s + vy * (c - 1.0)) / wz_safe)
    y = torch.where(wz0, vy * t, (vy * s - vx * (c - 1.0)) / wz_safe)

    zeros = torch.zeros_like(x)
    cols = torch.stack([
        x, y, torch.full_like(x, h_ref + z_average), zeros, zeros, yaw,
        vx * c - vy * s, vx * s + vy * c, zeros, zeros, zeros,
        wz.expand_as(x)], dim=-2)                            # (..., 12, N)
    return torch.cat([col0[..., None], cols], dim=-1)
