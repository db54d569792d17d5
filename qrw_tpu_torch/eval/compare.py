"""Solver comparison: the QP MPC against the DDP MPC on the same inputs.

Port of qrw_tpu/eval/compare.py, the re-design of the reference's
crocoddyl_eval experiments (scripts/crocoddyl_eval/test_1: run the
stack, log every control cycle, re-solve each cycle offline with both
solvers and compare, scripts/crocoddyl_eval/README.md:1-24). The
per-cycle MPC inputs come from the rollout log (RolloutLog.mpc_xref /
mpc_fsteps); the cold comparison re-solves every cycle as ONE batched
call per solver (the QP per problem, core/mpc.solve_mpc, and the DDP,
core/mpc_ddp.solve_mpc_ddp, along a leading cycle axis), the warm one
chains each solver over the cycles as it runs in the controller.

    python -m qrw_tpu_torch.eval.compare          # on the card
    python -m qrw_tpu_torch.eval.compare --cpu

Everything runs in float64 on the card unless --cpu is given. Prints
one JSON dict.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, NamedTuple

import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core import mpc as mpc_mod
from qrw_tpu_torch.core import mpc_ddp
from qrw_tpu_torch.ops import qp as qp_ops


class CycleComparison(NamedTuple):
    x_f_qp: torch.Tensor      # (C, 24, N)
    x_f_ddp: torch.Tensor     # (C, 24, N)
    force_rmse: torch.Tensor  # (C,) per-cycle RMS force difference [N]
    state_rmse: torch.Tensor  # (C,) per-cycle RMS predicted-state diff


def capture_cycles(cfg: Config, n_ticks: int, dtype=torch.float64,
                   device="cuda"):
    """Run the closed loop and extract one (xref, fsteps) per MPC cycle:
    (C, 12, N+1) and (C, N_gait, 12) on `device`."""
    from qrw_tpu_torch.sim.rollout import make_rollout, rollout
    ctl, carry = make_rollout(cfg, dtype=dtype, device=device)
    _, logs = rollout(ctl, carry, n_ticks)
    ticks = torch.arange(0, n_ticks, cfg.k_mpc, device=logs.error.device)
    return logs.mpc_xref[ticks], logs.mpc_fsteps[ticks]


def _comparison(x_f_qp, x_f_ddp) -> CycleComparison:
    df = x_f_qp[:, 12:, :] - x_f_ddp[:, 12:, :]
    dx = x_f_qp[:, :12, :] - x_f_ddp[:, :12, :]
    return CycleComparison(
        x_f_qp=x_f_qp, x_f_ddp=x_f_ddp,
        force_rmse=torch.sqrt(torch.mean(df ** 2, dim=(1, 2))),
        state_rmse=torch.sqrt(torch.mean(dx ** 2, dim=(1, 2))))


def compare_solvers(cfg: Config, xrefs, fsteps) -> CycleComparison:
    """Batched re-solve of all captured cycles with both backends,
    cold-started for a like-for-like comparison."""
    x_f_qp = mpc_mod.solve_mpc(cfg, xrefs, fsteps).x_f_applied
    # offline analysis is not bound by the 20 ms budget: the DDP runs
    # past the real-time 10-iteration cap so cold starts fully converge
    x_f_ddp = mpc_ddp.solve_mpc_ddp(
        cfg, xrefs, fsteps,
        settings=mpc_ddp.DDPSettings(max_iters=40)).x_f_applied
    return _comparison(x_f_qp, x_f_ddp)


def compare_solvers_warm(cfg: Config, xrefs, fsteps) -> CycleComparison:
    """Warm, in-loop comparison: both backends solve the captured cycle
    SEQUENCE as they run in the controller, warm-started from their own
    previous cycle under their production budgets (the reference's
    test_1 compares the solvers mid-run, scripts/crocoddyl_eval/test_1/
    run_scenarios.py:46-66). QP: eps 1e-4, max_iter 450, rho adapted
    every 200 iterations. DDP: the real-time 10-iteration cap with the
    xs/us warm start (MPC_crocoddyl.py:201-208)."""
    settings = qp_ops.QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=450,
                                 adaptive_rho_interval=200)
    ddp_settings = mpc_ddp.DDPSettings(max_iters=10)
    dtype, dev = xrefs.dtype, xrefs.device
    st_qp = mpc_mod.init_mpc_state(cfg, dtype, dev)
    st_ddp = mpc_ddp.init_ddp_state(cfg, dtype, dev)
    qp_out, ddp_out = [], []
    for x, f in zip(xrefs, fsteps):
        res = mpc_mod.solve_mpc(cfg, x, f, st_qp, settings)
        st_qp = res.state
        qp_out.append(res.x_f_applied)
        res = mpc_ddp.solve_mpc_ddp(cfg, x, f, st_ddp, ddp_settings)
        st_ddp = res.state
        ddp_out.append(res.x_f_applied)
    return _comparison(torch.stack(qp_out), torch.stack(ddp_out))


def summarize(cmp: CycleComparison) -> Dict[str, float]:
    return {
        "cycles": int(cmp.force_rmse.shape[0]),
        "force_rmse_mean": float(torch.mean(cmp.force_rmse)),
        "force_rmse_max": float(torch.max(cmp.force_rmse)),
        "state_rmse_mean": float(torch.mean(cmp.state_rmse)),
        "fz_qp_mean": float(torch.mean(cmp.x_f_qp[:, 14::3, 0])),
        "fz_ddp_mean": float(torch.mean(cmp.x_f_ddp[:, 14::3, 0])),
    }


def run(cfg: Config = None, n_ticks: int = 500, warm: bool = True,
        device="cuda") -> Dict[str, float]:
    """End-to-end harness (run_scenarios + analyse_simu equivalent).
    warm=True (default) compares the solvers as they run in the loop
    (warm-started, production budgets); warm=False is the cold
    like-for-like re-solve."""
    if cfg is None:
        cfg = Config()
    xrefs, fsteps = capture_cycles(cfg, n_ticks, device=device)
    fn = compare_solvers_warm if warm else compare_solvers
    out = summarize(fn(cfg, xrefs, fsteps))
    out["mode"] = "warm-in-loop" if warm else "cold"
    return out


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(
        description="QP MPC against DDP MPC on a captured closed-loop run")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    out = run(device="cpu" if args.cpu else "cuda")
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":  # pragma: no cover
    main()
