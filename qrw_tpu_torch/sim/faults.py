"""Fault injection: scripted external-force perturbation schedules.

Port of qrw_tpu/sim/faults.py (numpy only, this package's own copy):
the reference's push and projectile fault injection as precomputed
world-frame force schedules, consumed by the simulator through
sim/rollout.py's f_ext_schedule.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def bell_profile(n_ticks: int, start: int, duration: int) -> np.ndarray:
    """(n_ticks,) 4th-order bell: zero value and slope at both ends,
    peak 1 at the midpoint (apply_external_force,
    scripts/PyBulletSimulator.py:402-427)."""
    k = np.arange(n_ticks)
    ev = k - start
    t1 = duration
    A4 = 16.0 / t1 ** 4
    A3 = -2.0 * t1 * A4
    A2 = t1 ** 2 * A4
    alpha = A2 * ev ** 2 + A3 * ev ** 3 + A4 * ev ** 4
    return np.where((k < start) | (k > start + duration), 0.0, alpha)


def force_schedule(n_ticks: int,
                   events: Sequence[Tuple[int, int, Sequence[float]]]
                   ) -> np.ndarray:
    """(n_ticks, 3) world-frame base force from (start, duration, F3)
    events, each shaped by the bell profile."""
    out = np.zeros((n_ticks, 3))
    for start, duration, F in events:
        out += bell_profile(n_ticks, start, duration)[:, None] \
            * np.asarray(F, float)[None, :]
    return out


def default_perturbations(cfg, n_ticks: int) -> np.ndarray:
    """The reference's scripted pushes: velID 4 gets a -3 N downward push
    at tick 4250 and a +3 N lateral push at 5250, each 500 ticks
    (scripts/PyBulletSimulator.py:353-356)."""
    if cfg.velID == 4:
        return force_schedule(n_ticks, [(4250, 500, [0.0, 0.0, -3.0]),
                                        (5250, 500, [0.0, 3.0, 0.0])])
    return np.zeros((n_ticks, 3))


def projectile_impulses(n_ticks: int,
                        hits: Sequence[Tuple[int, Sequence[float]]],
                        duration: int = 15) -> np.ndarray:
    """Impulse-equivalent stand-in for the envID=1 thrown spheres: a
    0.4 kg sphere at ~5 m/s carries ~2 N s; each hit is a short bell
    force pulse delivering it over `duration` ticks."""
    return force_schedule(n_ticks, [(start, duration, F)
                                    for start, F in hits])
