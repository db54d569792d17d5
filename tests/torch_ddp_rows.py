"""Not a test: the rows on which tests/test_torch_ddp_derivs.py (CPU) and
tests/test_torch_ddp_derivs_card.py (card) hold the DDP derivatives.
Imports no JAX.

`inputs(kind, seed, B)` draws core/mpc_ddp's problem for B problems and
node and terminal rows on it, in float64:
  * "random": iterates and forces drawn about the reference, feet drawn
    far enough from the shoulders that the shoulder penalty is active
    on some rows and not on others, forces inside and outside the cone;
  * "cold": u = 0 on every node (the cold solve), so each stance foot's
    four cone rows sit exactly at their tie r = 0, and some feet at the
    other rows' ties (fz = 0.2, fz = fz_max, fx = mu_i fz);
  * "dt_first": the 500 Hz mode's shrunken first node (dt_first).
"""

import itertools

import numpy as np

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core import mpc_ddp

CFG = Config()
N = CFG.n_steps
H0 = 0.2447
MU_I = CFG.mu / np.sqrt(2.0)
SHOULDERS = np.stack([mpc_ddp.SHOULDERS_XY[0], mpc_ddp.SHOULDERS_XY[1],
                      np.zeros(4)], 1)                       # (4, 3)

TOGGLES = [dict(nonlinear=a, implicit_integration=b, relative_forces=c)
           for a, b, c in itertools.product((False, True), repeat=3)]
KINDS = ("random", "cold", "dt_first")
NAMES = ("fx", "fu", "lx", "lu", "lxx", "lux", "luu", "Vx", "Vxx")


def toggle_name(t):
    return "-".join(k for k, v in t.items() if v) or "linear"


def inputs(kind, seed=0, B=3):
    """(xref (B, 12, N+1), fsteps (B, N_gait, 12), X (B N, 12), U (B N,
    12), xT (B, 12), dt_first) in float64."""
    rng = np.random.default_rng(seed)
    xref = np.zeros((B, 12, N + 1))
    xref[:, 2] = H0
    xref[:, 5] = rng.uniform(-0.6, 0.6, (B, 1)) + np.linspace(0, 0.2, N + 1)
    xref[:, 6] = rng.uniform(0, 0.5, (B, 1))
    # trot, each problem with its own phase, feet drawn about the shoulders
    fsteps = np.zeros((B, CFG.N_gait, 12))
    for b in range(B):
        for k in range(CFG.N_gait):
            stance = ((k + 5 * b) // 8) % 2
            for i in range(4):
                if (i in (0, 3)) == bool(stance):
                    fsteps[b, k, 3 * i:3 * i + 3] = SHOULDERS[i] + np.r_[
                        rng.uniform(-0.2, 0.2, 2), 0.0]
    fsteps[0, :, :] = np.tile(SHOULDERS.reshape(12), (CFG.N_gait, 1))
    fsteps[0, :, 0::3] += rng.uniform(-0.2, 0.2, (CFG.N_gait, 4))
    X = (xref[:, :, 1:].transpose(0, 2, 1)
         + 0.05 * rng.standard_normal((B, N, 12))).reshape(B * N, 12)
    X[:, 2] += rng.uniform(-0.1, 0.12, B * N)
    U = rng.normal(0.0, 4.0, (B * N, 4, 3))
    U[..., 2] = rng.uniform(-2.0, 30.0, (B * N, 4))
    U = U.reshape(B * N, 12)
    if kind == "cold":
        U = np.zeros((B * N, 12))
        U[1, 2] = mpc_ddp.MIN_FZ                  # r = MIN_FZ - fz = 0
        U[2, 5] = CFG.fz_max                      # r = fz - fz_max = 0
        U[3, 6:9] = [MU_I * 10.0, 0.0, 10.0]      # r = fx - mu_i fz = 0
        U[4, 9:12] = [0.0, -MU_I * 7.0, 7.0]      # r = -fy - mu_i fz = 0
    xT = xref[:, :, -1] + 0.05 * rng.standard_normal((B, 12))
    xT[:, 2] += rng.uniform(-0.1, 0.12, B)
    dt_first = (rng.uniform(0.002, CFG.dt_mpc, B) if kind == "dt_first"
                else None)
    return xref, fsteps, X, U, xT, dt_first

