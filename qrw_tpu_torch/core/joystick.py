"""Reference-velocity command source: predefined profiles and the gamepad.

Port of qrw_tpu/core/joystick.py: the keyframe tables of the 7
predefined velocity profiles and their cubic-bell interpolation
(`v_ref_profile`, `v_ref_from_tables`), the multi-simulation ramp
(`v_ref_multi_simu`), the speed-envelope analysis tables
(`analysis_tables`) and the gamepad's low-pass filter and gait code
(`GamepadState`, `gamepad_update`). The tables are repeated here because
the JAX module that holds them imports jax;
tests/test_torch_controller.py asserts that both copies are equal. The
tick index is a Python int, so the profile math runs in numpy (in the
requested precision, as the JAX package computes it in the requested
dtype) and only its result becomes a tensor on `device`. The gamepad
filter runs on tensors on the state's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qrw_tpu_torch.config import Config

# velID -> (k_switch, {row: v_switch}) (scripts/Joystick.py:200-285)
_PROFILES = {}
_PROFILES[0] = (
    [0, 500, 2000, 3000, 4000, 13000, 20000, 30000],
    {0: [0.0, 0.0, 0.25, 0.25, 0.0, 0.0, 0.0, 0.0]},
)
_V1, _R1 = 1.0, 0.3
_PROFILES[1] = (
    [0, 1000, 3000, 8000, 12000, 16000, 20000, 22000, 23000, 26000,
     30000, 33000, 34000, 40000, 41000, 43000, 44000, 45000],
    {0: [0.0, 0.0, _V1, _V1, 0.0, 0.0, 0.0, 0.0, -_V1, -_V1, 0.0, 0.0,
         0.0, _V1, _V1, _V1, _V1, _V1],
     1: [0.0, 0.0, 0.0, 0.0, -_V1 * 0.5, -_V1 * 0.5, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
     5: [0.0, 0.0, _R1, _R1, _R1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         _R1, _R1, 0.0, 0.0, -_R1, 0.0]},
)
_PROFILES[2] = (
    [0, 7000, 14000, 20000, 30000],
    {0: [0.0, 0.7, 1.3, 1.3, 1.3]},
)
_PROFILES[3] = (
    [0, 1000, 2000, 7000, 26000, 30000],
    {0: [0.0, 0.0, 0.0, 0.3, 0.3, 0.0],
     5: [0.0, 0.0, 0.3, 0.0, 0.0, 0.0]},
)
_PROFILES[4] = (
    [0, 1000, 3000, 7000, 9000, 30000],
    {0: [0.0, 0.0, 1.5, 1.5, 1.5, 1.5],
     5: [0.0, 0.0, 0.0, 0.0, 0.4, 0.4]},
)
_PROFILES[5] = (
    [0, 500, 1500, 2600, 5000, 6500, 7000, 8000, 9000],
    {0: [0.0, 0.0, 0.5, 0.6, 0.3, 0.6, -0.5, 0.7, 0.0],
     5: [0.0, 0.0, 0.2, 0.7, 0.7, 0.0, -0.4, -0.6, 0.0]},
)
_PROFILES[6] = (
    [0, 1000, 2500, 5000, 7500, 8000, 10000],
    {0: [0.0, 0.0, 0.8, 0.4, 0.8, 0.8, 0.0],
     5: [0.0, 0.0, 0.0, 0.55, 0.3, 0.0, 0.0]},
)


def profile_tables(vel_id: int):
    """(k_switch (n,), v_switch (6, n)) numpy tables for one velID."""
    ks, rows = _PROFILES[vel_id]
    v = np.zeros((6, len(ks)))
    for r, vals in rows.items():
        v[r] = vals
    return np.asarray(ks), v


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def v_ref_profile(k: int, vel_id: int, dtype=torch.float64,
                  device="cpu") -> torch.Tensor:
    """Reference 6-dof velocity at tick k for a predefined profile
    (Joystick.handle_v_switch + apply_velocity_change)."""
    ks, v = profile_tables(vel_id)
    return v_ref_from_tables(k, ks, v, dtype, device)


def v_ref_multi_simu(k_loop: int, vx_ref, vy_ref, wyaw_ref, k_mpc: int,
                     dtype=torch.float64, device="cpu") -> torch.Tensor:
    """Multi-simulation ramp mode (scripts/Joystick.py:289-315): after a
    48-MPC-cycle standstill, each commanded component ramps linearly to
    its target at a slope set by the target magnitude (beta = max(|v| *
    1e4, 100) ticks for x/y, |w| * 2500 for yaw), saturating at 1."""
    npd = _np_dtype(dtype)
    k0 = k_mpc * 16 * 3
    k_loop = npd(k_loop)

    def alpha(v, scale):
        # the reference truncates: beta = int(max(|v|*scale, 100.0))
        beta = np.floor(np.maximum(np.abs(npd(v)) * npd(scale), npd(100.0)))
        return np.clip((k_loop - npd(k0)) / beta, npd(0.0), npd(1.0))

    out = np.array([alpha(vx_ref, 1e4) * npd(vx_ref),
                    alpha(vy_ref, 1e4) * npd(vy_ref), 0.0, 0.0, 0.0,
                    alpha(wyaw_ref, 2.5e3) * npd(wyaw_ref)], npd)
    return torch.as_tensor(out, dtype=dtype, device=device)


def analysis_tables(des_vel_analysis, n_analysis: int, n_steady: int):
    """Keyframe tables for the speed-envelope analysis mode
    (scripts/Joystick.py:317-326 update_for_analysis): ramp 500 ticks
    after start to the analysed 6-dof velocity, hold through n_analysis,
    stay steady for n_steady more. Feed the result through
    `v_ref_from_tables`."""
    des = np.asarray(des_vel_analysis, np.float64).reshape(6)
    ks = np.array([0, 500, n_analysis, n_analysis + n_steady])
    v = np.zeros((6, 4))
    v[:, 2] = des
    v[:, 3] = des
    return ks, v


def v_ref_from_tables(k: int, ks_np, v_np, dtype=torch.float64,
                      device="cpu") -> torch.Tensor:
    """Cubic keyframe interpolation over explicit tables (k_switch (n,),
    v_switch (6, n)): the handle_v_switch math of `v_ref_profile`, for
    caller-built tables (analysis mode, custom scenarios)."""
    ks = np.asarray(ks_np)
    v = np.asarray(v_np, np.float64)
    n = ks.shape[0]
    i = int(np.sum(ks <= k))
    i = min(max(i, 1), n - 1)
    if k >= ks[n - 1]:
        out = v[:, n - 1]
    else:
        # float32 callers get the f32 rounding of every step
        npd = _np_dtype(dtype)
        ev = npd(k - ks[i - 1])
        t1 = npd(ks[i] - ks[i - 1])
        v0 = v[:, i - 1].astype(npd)
        v1 = v[:, i].astype(npd)
        A3 = npd(2.0) * (v0 - v1) / t1 ** 3
        A2 = npd(-1.5) * t1 * A3
        out = v0 + A2 * ev ** 2 + A3 * ev ** 3
    return torch.as_tensor(np.asarray(out), dtype=dtype, device=device)


class GamepadState(NamedTuple):
    v_ref: torch.Tensor      # (6,) filtered reference velocity
    gait_code: torch.Tensor  # () int32: pending gait-switch code


def init_gamepad_state(dtype=torch.float64, device="cpu") -> GamepadState:
    return GamepadState(
        v_ref=torch.zeros(6, dtype=dtype, device=device),
        gait_code=torch.zeros((), dtype=torch.int32, device=device))


def gamepad_update(cfg: Config, state: GamepadState, axes, buttons,
                   orientation_mode: bool = False) -> GamepadState:
    """Low-pass filtered gamepad command (scripts/Joystick.py:81-158).

    axes: (4,) [vX, vY, vYaw, vZ-ish] raw in [-1, 1]; buttons: (4,)
    one-hot-ish [pacing, bounding, trot, static]. Both go to the state's
    dtype and device; the gait code stays a tensor (0: no switch)."""
    dtype, dev = state.v_ref.dtype, state.v_ref.device
    axes = torch.as_tensor(axes, dtype=dtype, device=dev)
    buttons = torch.as_tensor(buttons, dtype=dtype, device=dev)
    vx = axes[0] * cfg.vx_scale
    vy = axes[1] * cfg.vy_scale
    wyaw = axes[2] * cfg.vyaw_scale
    zero = torch.zeros((), dtype=dtype, device=dev)
    if orientation_mode:
        target = torch.stack([zero, zero, zero, vy, -vx, wyaw])
    else:
        target = torch.stack([vx, vy, zero, zero, zero, wyaw])
    alpha = cfg.dt_wbc / cfg.joy_tc
    v_ref = state.v_ref * (1.0 - alpha) + target * alpha
    code = torch.where(buttons.max() > 0, torch.argmax(buttons) + 1, 0)
    return GamepadState(v_ref=v_ref, gait_code=code.to(torch.int32))
