"""Whole-body controller: state, result and constant problem data.

Partial port of qrw_tpu/core/wbc.py: `WBCState`, `WBCResult`,
`init_wbc_state`, `base_inertia_diag` and `friction_generators`. The
fleet runs the WBC lane-major (core/wbc_lane.compute_wbc_lane); the
per-robot `compute_wbc` is not ported yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


@functools.lru_cache(maxsize=4)
def friction_generators(mu: float) -> np.ndarray:
    """(20, 12) block-diagonal G: per foot rows
    [mu fz - fx; mu fz + fx; mu fz - fy; mu fz + fy; fz]."""
    SC = np.array([
        [-1.0, 0.0, mu],
        [1.0, 0.0, mu],
        [0.0, -1.0, mu],
        [0.0, 1.0, mu],
        [0.0, 0.0, 1.0],
    ])
    G = np.zeros((20, 12))
    for i in range(4):
        G[5 * i:5 * i + 5, 3 * i:3 * i + 3] = SC
    return G


@functools.lru_cache(maxsize=1)
def base_inertia_diag() -> np.ndarray:
    """diag(Y): the base 6x6 block of the mass matrix at the ZERO joint
    configuration (the reference evaluates M at q = 0), computed once in
    float64 from the lane-major CRBA."""
    from qrw_tpu_torch.ops import rbd_lane as rl
    blocks = rl.crba(rl.solo12_lane(),
                     torch.zeros((4, 3, 1), dtype=torch.float64))
    return np.array([float(np.asarray(blocks.Mbb[i][i]).reshape(-1)[0])
                     for i in range(6)])


class WBCState(NamedTuple):
    k_since_contact: torch.Tensor  # (..., 4)
    qp_x: torch.Tensor             # (..., 12) QP warm start (delta-f)
    qp_y: torch.Tensor             # (..., 20) QP dual warm start


def init_wbc_state(dtype=torch.float32, device="cpu") -> WBCState:
    kw = dict(dtype=dtype, device=device)
    return WBCState(k_since_contact=torch.zeros(4, **kw),
                    qp_x=torch.zeros(12, **kw), qp_y=torch.zeros(20, **kw))


class WBCResult(NamedTuple):
    qdes: torch.Tensor          # (..., 12) joint position targets
    vdes: torch.Tensor          # (..., 12) joint velocity targets
    tau_ff: torch.Tensor        # (..., 12) feedforward torques
    f_with_delta: torch.Tensor  # (..., 12) corrected contact forces
    ddq_cmd: torch.Tensor       # (..., 18) commanded accelerations
    feet_pos: torch.Tensor      # (..., 4, 3)
    feet_vel: torch.Tensor      # (..., 4, 3)
    state: WBCState
    qp_iters: torch.Tensor      # (...) ADMM iterations of the box QP
