"""18-state Kalman filter state (shapes only).

Partial port of qrw_tpu/core/kalman.py: `KF18State` and `kf18_init`,
which EstimatorState carries. The filter step itself is not ported yet;
core/estimator.run_filter raises NotImplementedError when
cfg.kf_enabled is set.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KF18State(NamedTuple):
    X: torch.Tensor   # (..., 18) [imu pos; imu vel; foot0..3 pos] world
    P: torch.Tensor   # (..., 18, 18)


def kf18_init(h_init: float, dtype=torch.float32,
              device="cpu") -> KF18State:
    X = torch.zeros(18, dtype=dtype, device=device)
    X[2] = h_init
    return KF18State(X=X, P=torch.eye(18, dtype=dtype, device=device))
