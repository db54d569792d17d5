"""Command-line entry point of the port: the closed-loop trot fleet.

Port of the `--fleet` mode of qrw_tpu/runtime/main.py. B robots walk
the trot in closed loop; every 50 Hz cycle their MPC problems are
solved in ONE batched phase-solver launch (the CUDA kernel K1 of
ops/qp_phase on the card), and the lanes that fail it are re-solved by
the rescue stage (kernel K2 of ops/qp_pallas), whose capacity defaults
to max(4, B // 32) lanes as in the JAX entry point.

    python -m qrw_tpu_torch.runtime.main --fleet 1024

Only `--fleet` is ported; every other mode of the JAX entry point exits
with "not yet ported".
"""

from __future__ import annotations

import argparse
import sys
import time

TILE = 128      # robots per solver tile: the unit of the early exit


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="qrw_tpu_torch closed-loop fleet runner")
    p.add_argument("--fleet", type=int, default=0, metavar="B",
                   help="closed-loop fleet of B robots (rounded down to a "
                        "multiple of the 128-robot solver tile)")
    p.add_argument("--rescue", type=int, default=None,
                   help="rescue-stage capacity in lanes (default "
                        "max(4, B // 32); 0 turns the stage off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the fleet (default cuda)")
    p.add_argument("--ticks", type=int, default=None)
    p.add_argument("--velID", type=int, default=None)
    # modes of the JAX entry point that the port does not have yet
    for flag in ("--batch", "--fleet-mpc", "--hetero"):
        p.add_argument(flag, type=int, default=0)
    for flag in ("--host-loop", "--sweep", "--estimator-demo", "--kf",
                 "--ddp", "--bumpy", "--mesh", "--f64", "--cpu"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--envID", type=int, default=None)
    return p


def rescue_capacity(rescue, batch: int) -> int:
    """The `--rescue` value, or the JAX entry point's default
    max(4, B // 32) when it is not given."""
    return max(4, batch // 32) if rescue is None else rescue


def run_fleet(cfg, batch: int, tile: int, seed: int, device: str,
              n_cycles: int, rescue: int):
    """Build and run the fleet once; returns (carry, logs, cycle logs,
    wall seconds) with the device synchronized."""
    import torch

    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.sim import fleet as fl

    ps = ml.build_phase_data(cfg, ml.trot_phase_fsteps(cfg), device=device)
    ctl, carry = fl.make_fleet(cfg, batch, ps, tile=tile, seed=seed,
                               device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fl.fleet_rollout(ctl, carry, n_cycles, ps, tile=tile,
                           n_iters=300, rescue_cap=rescue,
                           perfect_estimator=True, stop_at_eps=True)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out + (time.perf_counter() - t0,)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    unported = [name for name, on in [
        ("--batch", args.batch), ("--fleet-mpc", args.fleet_mpc),
        ("--hetero", args.hetero), ("--host-loop", args.host_loop),
        ("--sweep", args.sweep), ("--estimator-demo", args.estimator_demo),
        ("--kf", args.kf), ("--ddp", args.ddp), ("--bumpy", args.bumpy),
        ("--mesh", args.mesh), ("--f64", args.f64), ("--cpu", args.cpu),
        ("--envID", args.envID not in (None, 0))] if on]
    if not args.fleet:
        unported.append("single-robot rollout (no --fleet)")
    if unported:
        print(f"not yet ported: {', '.join(unported)}", file=sys.stderr)
        return 2

    import numpy as np

    from qrw_tpu_torch.config import load_config
    overrides = {}
    if args.velID is not None:
        overrides["velID"] = args.velID
    if args.ticks is not None:
        overrides["N_SIMULATION"] = args.ticks
    cfg = load_config(None, **overrides)
    n_cycles = max(1, cfg.N_SIMULATION // cfg.k_mpc)
    B = max(TILE, (args.fleet // TILE) * TILE)
    rescue = rescue_capacity(args.rescue, B)
    carry, logs, cyc, wall = run_fleet(cfg, B, TILE, args.seed, args.device,
                                       n_cycles, rescue)
    n_ticks = n_cycles * cfg.k_mpc
    h = logs.base_pos[:, :, 2].cpu().numpy()
    err = logs.error.cpu().numpy()
    conv = cyc.converged.cpu().numpy()
    fired = int((cyc.rescued > 0).sum())
    print(f"fleet: {B} robots x {n_ticks} ticks in {wall:.2f}s on "
          f"{args.device} ({B * n_ticks / wall:.0f} ticks/s aggregate, "
          f"{B * n_cycles / wall:.0f} in-loop MPC solves/s); MPC conv "
          f"{conv.mean():.4f} (rescue cap {rescue}, fired in {fired} of "
          f"{n_cycles} cycles); errors {int(err[-1].sum())}/{B}; "
          f"final height mean {h[-1].mean():.4f} min {h[-1].min():.4f}"
          f"{'' if np.isfinite(h).all() else ' NON-FINITE'}")
    return 0 if not err[-1].any() else 1


if __name__ == "__main__":
    raise SystemExit(main())
