"""Reference-velocity command source: the predefined velocity profiles.

Partial port of qrw_tpu/core/joystick.py: the keyframe tables and the
cubic-bell interpolation of `v_ref_profile`. The tables are repeated
here because the JAX module that holds them imports jax;
tests/test_torch_controller.py asserts that both copies are equal. The
tick index is a Python int, so the interpolation runs in numpy (float64)
and only its result becomes a tensor.
"""

from __future__ import annotations

import numpy as np
import torch

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


def v_ref_profile(k: int, vel_id: int, dtype=torch.float64,
                  device="cpu") -> torch.Tensor:
    """Reference 6-dof velocity at tick k for a predefined profile
    (Joystick.handle_v_switch + apply_velocity_change)."""
    ks, v = profile_tables(vel_id)
    n = ks.shape[0]
    i = int(np.sum(ks <= k))
    i = min(max(i, 1), n - 1)
    if k >= ks[n - 1]:
        out = v[:, n - 1]
    else:
        # float32 callers get the f32 rounding of every step, as the
        # JAX package computes the cubic in the requested dtype
        npd = np.float32 if dtype == torch.float32 else np.float64
        ev = npd(k - ks[i - 1])
        t1 = npd(ks[i] - ks[i - 1])
        v0 = v[:, i - 1].astype(npd)
        v1 = v[:, i].astype(npd)
        A3 = npd(2.0) * (v0 - v1) / t1 ** 3
        A2 = npd(-1.5) * t1 * A3
        out = v0 + A2 * ev ** 2 + A3 * ev ** 3
    return torch.as_tensor(np.asarray(out), dtype=dtype, device=device)
