"""Raibert-heuristic footstep planner.

Port of qrw_tpu/core/footstep.py, batched over leading robot axes:
state (..., 3, 4) and (..., N_gait, 3, 4), gait (..., N_gait, 4).
`refresh` and `k_remaining` are Python values (the tick index is a
Python int in the port).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.gait import GaitState, phase_durations
from qrw_tpu_torch.ops.rotations import quat_to_rpy


class FootstepState(NamedTuple):
    current: torch.Tensor    # (..., 3, 4) stance anchors, horizontal frame
    footsteps: torch.Tensor  # (..., N_gait, 3, 4) last horizon footsteps


def make_footstep_state(cfg: Config, shoulders) -> FootstepState:
    return FootstepState(
        current=shoulders,
        footsteps=torch.zeros((cfg.N_gait, 3, 4), dtype=shoulders.dtype,
                              device=shoulders.device))


def update_footsteps(cfg: Config, shoulders, gait: GaitState,
                     state: FootstepState, refresh: bool,
                     k_remaining: float, q7, b_v6, b_vref6
                     ) -> Tuple[FootstepState, torch.Tensor, torch.Tensor]:
    """One planner tick (FootstepPlanner::updateFootsteps).

    Returns (new_state, o_target (..., 3) world frame of the next
    touchdown per foot (..., 3, 4), fsteps (..., N_gait, 12))."""
    n = cfg.N_gait
    dt, dt_wbc = cfg.dt_mpc, cfg.dt_wbc
    cur_gait = gait.current
    contact0 = (cur_gait[..., 0, :] == 1.0)[..., None, :]   # (..., 1, 4)
    dtype = q7.dtype

    # refresh anchors on a new phase (uses last tick's footsteps row 1)
    if refresh:
        sel = gait.new_phase[..., None, None] & contact0
        cf = torch.where(sel, state.footsteps[..., 1, :, :], state.current)
    else:
        cf = state.current

    # drag stance feet in the horizontal frame
    rot = dt_wbc * b_vref6[..., 5]
    c, s = torch.cos(rot)[..., None], torch.sin(rot)[..., None]
    px = cf[..., 0, :] - dt_wbc * b_vref6[..., 0:1]
    py = cf[..., 1, :] - dt_wbc * b_vref6[..., 1:2]
    dragged = torch.stack([c * px + s * py, -s * px + c * py,
                           cf[..., 2, :]], dim=-2)
    cf = torch.where(contact0, dragged, cf)

    # cumulative time / yaw / arc displacement per gait row
    nz = torch.any(cur_gait != 0.0, dim=-1)                 # (..., N)
    inc = nz.to(dtype).clone()
    inc[..., 0] = 0.0
    dt_cum = dt_wbc * k_remaining + dt * torch.cumsum(inc, dim=-1)
    wz = b_vref6[..., 5:6]
    yaws = wz * dt_cum
    sy, cy = torch.sin(yaws), torch.cos(yaws)
    wz0 = wz == 0
    wz_safe = torch.where(wz0, torch.ones_like(wz), wz)
    vx, vy = b_v6[..., 0:1], b_v6[..., 1:2]
    dx = torch.where(wz0, vx * dt_cum, (vx * sy + vy * (cy - 1.0)) / wz_safe)
    dy = torch.where(wz0, vy * dt_cum, (vy * sy - vx * (cy - 1.0)) / wz_safe)

    # Raibert touchdown offset, per (row, foot)
    t_stance = phase_durations(gait, 1.0, dt).duration      # (..., N, 4)
    sym = 0.5 * t_stance[..., :, None, :] * b_v6[..., None, 0:3, None]
    fb = cfg.k_feedback * (b_v6[..., 0:3] - b_vref6[..., 0:3])
    cross = torch.stack([
        b_v6[..., 1] * b_vref6[..., 5] - b_v6[..., 2] * b_vref6[..., 4],
        b_v6[..., 2] * b_vref6[..., 3] - b_v6[..., 0] * b_vref6[..., 5],
        torch.zeros_like(b_v6[..., 0])], dim=-1)
    cent = 0.5 * (cfg.h_ref / cfg.gravity) ** 0.5 * cross
    next_fs = sym + (fb + cent)[..., None, :, None]         # (..., N, 3, 4)
    L = cfg.step_limit
    next_fs = torch.cat([torch.clamp(next_fs[..., 0:2, :], -L, L),
                         next_fs[..., 2:3, :]], dim=-2)
    next_fs = next_fs + shoulders
    next_fs = torch.cat([next_fs[..., 0:2, :],
                         torch.zeros_like(next_fs[..., 2:3, :])], dim=-2)

    # rotate into the frame of row i-1 and add the arc displacement
    cp, sp = cy[..., None], sy[..., None]                   # (..., N, 1)
    rot_fs = torch.stack([cp * next_fs[..., 0, :] - sp * next_fs[..., 1, :],
                          sp * next_fs[..., 0, :] + cp * next_fs[..., 1, :],
                          next_fs[..., 2, :]], dim=-2)
    disp = torch.stack([dx, dy, torch.zeros_like(dx)], dim=-1)
    cand = rot_fs + disp[..., None]
    cand = torch.cat([cand[..., 0:1, :, :], cand[..., :-1, :, :]], dim=-3)

    # forward propagation over gait rows
    zero = torch.zeros_like(cf)
    rows = [torch.where(contact0, cf, zero)]
    for i in range(1, n):
        g0 = cur_gait[..., i - 1, :][..., None, :]
        g1 = cur_gait[..., i, :][..., None, :]
        stay = (g0 * g1) > 0
        new = ((1.0 - g0) * g1) > 0
        rows.append(torch.where(stay, rows[i - 1],
                                torch.where(new, cand[..., i, :, :], zero)))
    footsteps = torch.stack(rows, dim=-3)                   # (..., N, 3, 4)
    footsteps = torch.where(nz[..., None, None], footsteps,
                            torch.zeros_like(footsteps))

    # next touchdown target per foot (first row with nonzero x)
    has = (footsteps[..., :, 0, :] != 0.0).to(torch.int64)  # (..., N, 4)
    first = torch.argmax(has, dim=-2)                       # (..., 4)
    idx = first[..., None, None, :].expand(
        footsteps.shape[:-3] + (1, 3, 4))
    target = torch.gather(footsteps, -3, idx)[..., 0, :, :]  # (..., 3, 4)
    target = torch.cat([target[..., 0:2, :],
                        torch.zeros_like(target[..., 2:3, :])], dim=-2)

    # world frame
    yaw = quat_to_rpy(q7[..., 3:7])[..., 2:3]
    cw, sw = torch.cos(yaw), torch.sin(yaw)
    o_target = torch.stack(
        [cw * target[..., 0, :] - sw * target[..., 1, :] + q7[..., 0:1],
         sw * target[..., 0, :] + cw * target[..., 1, :] + q7[..., 1:2],
         target[..., 2, :]], dim=-2)

    new_state = FootstepState(current=cf, footsteps=footsteps)
    fsteps12 = footsteps.transpose(-1, -2).reshape(
        footsteps.shape[:-3] + (n, 12))
    return new_state, o_target, fsteps12
