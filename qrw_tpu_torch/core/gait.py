"""Contact-sequence gait scheduler over a state tuple.

Port of qrw_tpu/core/gait.py. The three N_gait x 4 contact matrices
(past / current / desired) live in GaitState; every function broadcasts
over leading robot batch axes (..., N_gait, 4). The tick index `k` and
the joystick code are Python ints: the roll / no-roll choice is made in
Python instead of with a traced select.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qrw_tpu_torch.config import Config

CODE_NONE = 0
CODE_PACING = 1
CODE_BOUNDING = 2
CODE_TROT = 3
CODE_STATIC = 4


class GaitState(NamedTuple):
    past: torch.Tensor       # (..., N_gait, 4) rows: most recent first
    current: torch.Tensor    # (..., N_gait, 4) row 0 = current MPC step
    desired: torch.Tensor    # (..., N_gait, 4) future pattern
    new_phase: torch.Tensor  # (...) bool: contact set changed at last roll
    is_static: torch.Tensor  # (...) bool: static gait requested


def _pattern(cfg: Config, kind: str) -> np.ndarray:
    """Desired-gait matrix for one gait type (same as the JAX package)."""
    n_rows = cfg.N_gait
    steps_period = int(round(cfg.T_gait / cfg.dt_mpc))
    out = np.zeros((n_rows, 4))
    if kind == "walk":
        n = steps_period // 4
        seqs = [(0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 0, 1), (1, 1, 1, 0)]
    elif kind == "trot":
        n = steps_period // 2
        seqs = [(1, 0, 0, 1), (0, 1, 1, 0)]
    elif kind == "pacing":
        n = steps_period // 2
        seqs = [(1, 0, 1, 0), (0, 1, 0, 1)]
    elif kind == "bounding":
        n = steps_period // 2
        seqs = [(1, 1, 0, 0), (0, 0, 1, 1)]
    elif kind == "static":
        n = steps_period
        seqs = [(1, 1, 1, 1)]
    else:
        raise ValueError(kind)
    for i, s in enumerate(seqs):
        out[i * n:(i + 1) * n] = s
    return out


def make_gait(cfg: Config, kind: str = "trot", dtype=torch.float32,
              device="cpu") -> GaitState:
    """Initial gait state, one row earlier in the cycle than the first
    planned window (the controller rolls once at k = 0)."""
    n_steps = cfg.n_steps
    steps_gait = int(round(cfg.T_gait / cfg.dt_mpc))
    if n_steps > cfg.N_gait or steps_gait > cfg.N_gait:
        raise ValueError(
            f"N_gait={cfg.N_gait} too small for T_mpc/T_gait "
            f"({n_steps}/{steps_gait} rows needed); increase N_gait")
    des = _pattern(cfg, kind)
    n_rows = int(np.sum(np.any(des != 0, axis=1)))
    cur = np.zeros_like(des)
    for j in range(n_steps):
        cur[j] = des[(j - 1) % n_rows]
    wrap = (n_steps - 1) % n_rows
    des[:n_rows] = np.roll(des[:n_rows], -wrap, axis=0)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return GaitState(
        past=t(np.zeros((cfg.N_gait, 4))), current=t(cur),
        desired=t(des),
        new_phase=torch.tensor(False, device=device),
        is_static=torch.tensor(kind == "static", device=device))


def gait_patterns(cfg: Config) -> np.ndarray:
    """(5, N_gait, 4) desired matrices indexed by joystick code 0..4."""
    kinds = ["trot", "pacing", "bounding", "trot", "static"]
    return np.stack([_pattern(cfg, k) for k in kinds])


def _prefix_len(m):
    """Number of leading nonzero rows of (..., n, 4) -> (...)."""
    nz = torch.any(m != 0.0, dim=-1)
    return torch.cumprod(nz.to(torch.int64), dim=-1).sum(-1)


def _take_rows(m, idx):
    """m[..., idx, :] for a static index vector."""
    return m[..., idx, :]


def roll_gait(state: GaitState) -> GaitState:
    """One MPC step: current row 0 is pushed onto past, the current
    window shifts by one row and consumes desired row 0, desired shifts
    its nonzero prefix circularly."""
    cur0 = state.current
    n = cur0.shape[-2]
    idx = torch.arange(n, device=cur0.device)
    nxt = torch.clamp(idx + 1, max=n - 1)

    past = torch.cat([cur0[..., 0:1, :], state.past[..., :-1, :]], dim=-2)
    new_phase = torch.any(cur0[..., 0, :] != cur0[..., 1, :], dim=-1)

    n_cur = _prefix_len(cur0)[..., None, None]
    i2 = idx[:, None]
    cur = torch.where(i2 < n_cur - 1, _take_rows(cur0, nxt), cur0)
    cur = torch.where(i2 == n_cur - 1,
                      state.desired[..., 0:1, :].expand_as(cur0), cur)

    des0 = state.desired
    n_des = _prefix_len(des0)[..., None, None]
    des = torch.where(i2 < n_des - 1, _take_rows(des0, nxt), des0)
    des = torch.where(i2 == n_des - 1, des0[..., 0:1, :].expand_as(des0),
                      des)
    return state._replace(past=past, current=cur, desired=des,
                          new_phase=new_phase)


def change_gait(state: GaitState, code: int, patterns) -> GaitState:
    """Replace the desired gait for joystick code 1..4; any other code
    leaves it untouched. is_static tracks the last code."""
    des = state.desired
    if 1 <= code <= 4:
        des = torch.as_tensor(patterns[code], dtype=des.dtype,
                              device=des.device).expand_as(des)
    return state._replace(
        desired=des,
        is_static=torch.full_like(state.is_static, code == CODE_STATIC))


def update_gait(state: GaitState, k: int, k_mpc: int, code: int,
                patterns) -> GaitState:
    """Per-tick gait update: apply the gait switch, roll once per k_mpc
    ticks."""
    state = change_gait(state, code, patterns)
    if k % k_mpc == 0:
        return roll_gait(state)
    return state


class PhaseInfo(NamedTuple):
    duration: torch.Tensor   # (..., N_gait, 4) phase length [s]
    remaining: torch.Tensor  # (..., N_gait, 4) steps to phase end (incl.)


def phase_durations(state: GaitState, value: float,
                    dt_mpc: float) -> PhaseInfo:
    """For every (row i, foot j): the duration of the contiguous phase
    (gait coefficient == value) containing row i and the remaining step
    count, continuing into the desired / past matrices at the window
    ends (Gait::getPhaseDuration)."""
    cur, des, past = state.current, state.desired, state.past
    n = cur.shape[-2]
    idx = torch.arange(n, device=cur.device)
    n_cur = _prefix_len(cur)[..., None, None]
    i2 = idx[:, None]
    mc = (i2 < n_cur) & (cur == value)
    md = (i2 < _prefix_len(des)[..., None, None]) & (des == value)
    mp = (i2 < _prefix_len(past)[..., None, None]) & (past == value)

    zero = torch.zeros(cur.shape[:-2] + (4,), dtype=torch.int64,
                       device=cur.device)
    F = [zero] * n
    for i in range(n - 2, -1, -1):
        F[i] = torch.where(mc[..., i + 1, :], 1 + F[i + 1], zero)
    F = torch.stack(F, dim=-2)

    run_d = torch.cumprod(md.to(torch.int64), dim=-2).sum(-2)
    run_p = torch.cumprod(mp.to(torch.int64), dim=-2).sum(-2)

    end_idx = i2 + 1 + F
    hit_end = end_idx >= n_cur
    remaining = 1 + F + torch.where(hit_end, run_d[..., None, :],
                                    torch.zeros_like(F))

    Bk = [zero] * n
    for i in range(1, n):
        Bk[i] = torch.where(mc[..., i - 1, :], 1 + Bk[i - 1], zero)
    Bk = torch.stack(Bk, dim=-2)

    hit_start = (i2 - Bk) == 0
    total = remaining + Bk + torch.where(hit_start, run_p[..., None, :],
                                         torch.zeros_like(Bk))
    return PhaseInfo(duration=total.to(cur.dtype) * dt_mpc,
                     remaining=remaining)
