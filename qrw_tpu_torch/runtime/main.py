"""Command-line entry point of the port: the closed-loop fleets.

Port of the `--fleet` and `--hetero` modes of qrw_tpu/runtime/main.py.
B robots walk in closed loop; every 50 Hz cycle their MPC problems are
solved in ONE batched phase-solver launch (the CUDA kernel K1 of
ops/qp_phase on the card), and the lanes that fail it are re-solved by
the rescue stage (kernel K2 of ops/qp_pallas), whose capacity defaults
to max(4, B // 32) lanes as in the JAX entry point.

    python -m qrw_tpu_torch.runtime.main --fleet 1024
    python -m qrw_tpu_torch.runtime.main --hetero 4096

`--fleet` is the trot fleet on flat ground, with the complementary-
filter estimator unless `--perfect` is given. `--hetero` is the
heterogeneous fleet: gaits {trot, walk, bounding} per 128-robot tile,
velocity profiles velID 0-6 and terrains {flat, bumpy, stairs} per
robot, the real estimator in the loop. Both run once (the kernel build
and warm-up) and then time a second run from the same initial carry.
Every other mode of the JAX entry point exits with "not yet ported".
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
                   help="closed-loop trot fleet of B robots (rounded down "
                        "to a multiple of the 128-robot solver tile)")
    p.add_argument("--hetero", type=int, default=0, metavar="B",
                   help="heterogeneous closed-loop fleet of B robots "
                        "(at least 3 tiles): gaits {trot, walk, bounding} "
                        "per tile x velID 0-6 x terrains {flat, bumpy, "
                        "stairs}, real estimator")
    p.add_argument("--rescue", type=int, default=None,
                   help="rescue-stage capacity in lanes (default "
                        "max(4, B // 32); 0 turns the stage off)")
    p.add_argument("--perfect", action="store_true",
                   help="--fleet: perfect estimator (simulator ground "
                        "truth) instead of the complementary filter")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the fleet (default cuda)")
    p.add_argument("--ticks", type=int, default=None)
    p.add_argument("--velID", type=int, default=None)
    # modes of the JAX entry point that the port does not have yet
    for flag in ("--batch", "--fleet-mpc"):
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


def _timed_twice(device, run):
    """Run `run()` once (kernel build, warm-up), then again timed;
    returns (second run's output, its wall seconds, the first's)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    walls = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        out = run()
        sync()
        walls.append(time.perf_counter() - t0)
    return out, walls[1], walls[0]


def run_fleet(cfg, batch: int, tile: int, seed: int, device: str,
              n_cycles: int, rescue: int, perfect: bool = False):
    """Build the trot fleet and run it twice from the same initial carry;
    returns (carry, logs, cycle logs, wall seconds of the second run,
    wall seconds of the first)."""
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.sim import fleet as fl

    ps = ml.build_phase_data(cfg, ml.trot_phase_fsteps(cfg), device=device)
    ctl, carry = fl.make_fleet(cfg, batch, ps, tile=tile, seed=seed,
                               device=device)
    out, wall, first = _timed_twice(device, lambda: fl.fleet_rollout(
        ctl, carry, n_cycles, ps, tile=tile, n_iters=300,
        rescue_cap=rescue, perfect_estimator=perfect, stop_at_eps=True))
    return out + (wall, first)


def run_hetero(cfg, batch: int, tile: int, seed: int, device: str,
               n_cycles: int, rescue: int):
    """Build the heterogeneous fleet (uncalibrated metric) and run it
    twice from the same initial carry, without tick logs; returns
    (carry, cycle logs, meta, wall seconds of the second run, wall
    seconds of the first)."""
    from qrw_tpu_torch.sim import fleet as fl

    ctl, carry, ps, terrain, meta = fl.make_hetero_fleet(
        cfg, batch, tile=tile, seed=seed, device=device)
    sched = fl.hetero_v_ref_schedule(cfg, meta.velID, n_cycles * cfg.k_mpc,
                                     device=device)
    (c2, _, cyc), wall, first = _timed_twice(device, lambda: fl.fleet_rollout(
        ctl, carry, n_cycles, ps, tile=tile, n_iters=300,
        rescue_cap=rescue, terrain=terrain,
        phase_offsets=meta.phase_offsets, phase_periods=meta.phase_periods,
        perfect_estimator=False, v_ref_schedule=sched, with_logs=False,
        stop_at_eps=True))
    return c2, cyc, meta, wall, first


def hetero_summary(carry, cyc, meta, tile: int) -> dict:
    """The heterogeneous fleet's health: MPC conv, upright share
    (z > 0.15 m) overall, per gait and per terrain, latched robots and
    whether every height is finite."""
    import numpy as np

    z = carry.sim_states.q[:, 2].cpu().numpy()
    up = z > 0.15
    scen_gait = np.repeat(meta.tile_gait, tile)
    return dict(
        conv=float(cyc.converged.float().mean()),
        upright=float(up.mean()),
        per_gait={meta.gait_names[g]: float(up[scen_gait == g].mean())
                  for g in range(len(meta.gait_names))},
        per_terrain={n: float(up[meta.tid == t].mean())
                     for t, n in enumerate(["flat", "bumpy", "stairs"])
                     if (meta.tid == t).any()},
        latched=int(carry.ctl_states.error.sum()),
        finite=bool(np.isfinite(z).all()),
        rescued=int(cyc.rescued.sum()))


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    unported = [name for name, on in [
        ("--batch", args.batch), ("--fleet-mpc", args.fleet_mpc),
        ("--host-loop", args.host_loop),
        ("--sweep", args.sweep), ("--estimator-demo", args.estimator_demo),
        ("--kf", args.kf), ("--ddp", args.ddp), ("--bumpy", args.bumpy),
        ("--mesh", args.mesh), ("--f64", args.f64), ("--cpu", args.cpu),
        ("--envID", args.envID not in (None, 0))] if on]
    if not (args.fleet or args.hetero):
        unported.append("single-robot rollout (no --fleet or --hetero)")
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
    cfg = load_config(args.config, **overrides)
    n_cycles = max(1, cfg.N_SIMULATION // cfg.k_mpc)
    n_ticks = n_cycles * cfg.k_mpc
    if args.hetero:
        B = (max(args.hetero, 3 * TILE) // TILE) * TILE
        rescue = rescue_capacity(args.rescue, B)
        carry, cyc, meta, wall, first = run_hetero(
            cfg, B, TILE, args.seed, args.device, n_cycles, rescue)
        s = hetero_summary(carry, cyc, meta, TILE)
        per_gait = " ".join(f"{g} {v:.2f}" for g, v in s["per_gait"].items())
        per_ter = " ".join(f"{t} {v:.2f}"
                           for t, v in s["per_terrain"].items())
        print(f"hetero fleet: {B} robots x {n_ticks} ticks in {wall:.2f}s "
              f"on {args.device} ({B * n_ticks / wall:.0f} ticks/s; first "
              f"run {first:.1f}s); MPC conv {s['conv']:.4f} (rescue cap "
              f"{rescue}); upright {s['upright']:.3f} [{per_gait} | "
              f"{per_ter}]; bounding's metric uncalibrated (no shakedown "
              f"capture); errors {s['latched']}/{B}"
              f"{'' if s['finite'] else ' NON-FINITE'}")
        return 0 if s["finite"] and not s["latched"] else 1
    B = max(TILE, (args.fleet // TILE) * TILE)
    rescue = rescue_capacity(args.rescue, B)
    carry, logs, cyc, wall, first = run_fleet(
        cfg, B, TILE, args.seed, args.device, n_cycles, rescue,
        args.perfect)
    h = logs.base_pos[:, :, 2].cpu().numpy()
    err = logs.error.cpu().numpy()
    conv = cyc.converged.cpu().numpy()
    fired = int((cyc.rescued > 0).sum())
    print(f"fleet: {B} robots x {n_ticks} ticks in {wall:.2f}s on "
          f"{args.device} ({B * n_ticks / wall:.0f} ticks/s aggregate, "
          f"{B * n_cycles / wall:.0f} in-loop MPC solves/s; first run "
          f"{first:.1f}s; {'perfect' if args.perfect else 'real'} "
          f"estimator); MPC conv {conv.mean():.4f} (rescue cap {rescue}, "
          f"fired in {fired} of {n_cycles} cycles); errors "
          f"{int(err[-1].sum())}/{B}; final height mean {h[-1].mean():.4f} "
          f"min {h[-1].min():.4f}"
          f"{'' if np.isfinite(h).all() else ' NON-FINITE'}")
    return 0 if not err[-1].any() else 1


if __name__ == "__main__":
    raise SystemExit(main())
