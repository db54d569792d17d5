"""Command-line entry point of the port: closed-loop walking runs.

Port of qrw_tpu/runtime/main.py. With no mode flag it runs the
reference's main control loop for one robot (sim/rollout: the
controller with its per-robot MPC and WBC against the simulator), or
`--batch B` robots at once along a leading axis, each perturbed in its
joint angles by np.random.default_rng(seed).normal(scale=0.01) exactly
as the JAX entry point draws them; `--gait`, `--velID`, `--envID`
(1: the stairs course with its thrown spheres), `--bumpy`, `--perfect`,
`--kf` (the 18-state Kalman estimator), `--f64` and `--ticks` select
the scenario, as there; `--ddp` runs the DDP (Crocoddyl-equivalent) MPC
backend in place of the QP MPC (type_MPC = False). The planner
(`mpc_planner`) and the every-tick DDP (`mpc_every_tick`) are chosen
in the YAML of `--config`. `--save [PATH]` writes the logs (robot 0 of a
batch) to an npz that either package loads, and `--plot [PREFIX]` saves
the 13 figures of utils/logger.plot_all.

`--fleet` is the trot fleet on flat ground, with the complementary-
filter estimator unless `--perfect` (or `--kf`) is given. `--hetero` is
the heterogeneous fleet: gaits {trot, walk, bounding} per 128-robot
tile, velocity profiles velID 0-6 and terrains {flat, bumpy, stairs}
per robot, the real estimator in the loop; on the card bounding's phase
classes are calibrated from a single-robot shakedown capture first, as
the JAX entry point does on an accelerator. Every 50 Hz cycle the
fleets solve their MPC problems in ONE batched phase-solver launch (the
CUDA kernel K1 of ops/qp_phase on the card), and the lanes that fail it
are re-solved by the rescue stage (kernel K2 of ops/qp_pallas), whose
capacity defaults to max(4, B // 32) lanes as in the JAX entry point.
Both fleets run once (the kernel build and warm-up) and then time a
second run from the same initial carry.

`--fleet-mpc B` is the MPC-fleet service demo: B trot problems sorted
over the 16 gait offsets, solved cold and then warm-cycled through K1
in the JAX entry point's layout (tiles of 512 on the card, 4 on the
CPU: `fleet_mpc_layout`), printing solves/s and convergence. `--sweep` runs the
velocity-envelope sweep (eval/speed_sweep: a 9 x 5 grid of (vx, wyaw)
commands as one batched rollout), `--estimator-demo` the estimator-only
evaluation (eval/estimator_eval.run_demo).

`--host-loop` drives the masterboard-style device facade from the host
(runtime/host_loop.run_host_loop against sim/device.SimDevice) for
`--ticks` ticks, then the damping shutdown: `--clone` mirrors every
command to a second simulated robot, `--gamepad` reads a physical
gamepad (runtime/gamepad.GamepadReader; needs the `inputs` package),
`--realtime` paces each tick to 2 ms with the native pacer. `--mesh`
shards `--batch` (and `--sweep`) over one process per GPU
(parallel/mesh: world size 1 on the one card, or every process of a
`torchrun` launch; each rank prints nothing, rank 0 the summary). The
fleets run without reading `--batch`, `--bumpy` or `--envID`, as the
JAX entry point's do (with `--envID 1` the lane-major physics refuses
the thrown spheres, where qrw_tpu asserts).

    python -m qrw_tpu_torch.runtime.main
    python -m qrw_tpu_torch.runtime.main --batch 256 --ticks 500
    python -m qrw_tpu_torch.runtime.main --cpu --ticks 20 --batch 2
    python -m qrw_tpu_torch.runtime.main --ddp --ticks 400
    python -m qrw_tpu_torch.runtime.main --ticks 500 --kf --save run.npz
    python -m qrw_tpu_torch.runtime.main --fleet 1024
    python -m qrw_tpu_torch.runtime.main --hetero 4096
    python -m qrw_tpu_torch.runtime.main --fleet-mpc 4096
    python -m qrw_tpu_torch.runtime.main --sweep --ticks 1500
    python -m qrw_tpu_torch.runtime.main --estimator-demo --kf --ticks 500
    python -m qrw_tpu_torch.runtime.main --host-loop --clone --ticks 500
    python -m qrw_tpu_torch.runtime.main --host-loop --realtime --ticks 50
    python -m qrw_tpu_torch.runtime.main --batch 8 --mesh --ticks 100
    torchrun --nproc-per-node 4 -m qrw_tpu_torch.runtime.main --batch 64 --mesh

Everything runs on the card (`--device cuda`) unless `--cpu` or
`--device cpu` asks for the CPU. The fleets and `--fleet-mpc` run the
phase solver whatever the MPC backend, as the JAX entry point's do
(they never read type_MPC).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import time

TILE = 128      # robots per solver tile: the unit of the early exit
FLEET_MPC_TILE = 512    # --fleet-mpc's tile on the card (the JAX entry
                        # point's on its accelerator, bench.py's tile)
CPU_TILE = 4    # --fleet-mpc's tile on the CPU (the JAX entry point's)


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
                   help="perfect estimator (simulator ground truth) "
                        "instead of the complementary filter")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (same as --device cpu)")
    p.add_argument("--f64", action="store_true", help="run in float64")
    p.add_argument("--ticks", type=int, default=None,
                   help="number of 2 ms control ticks (default from "
                        "config)")
    p.add_argument("--velID", type=int, default=None,
                   help="predefined velocity profile 0..6")
    p.add_argument("--batch", type=int, default=0,
                   help="single-robot mode: run N perturbed robots at "
                        "once (0 = one)")
    p.add_argument("--gait", default="trot",
                   choices=["trot", "walk", "pacing", "bounding", "static"])
    p.add_argument("--envID", type=int, default=None,
                   help="single-robot mode: 0 flat, 1 the stairs course")
    p.add_argument("--bumpy", action="store_true",
                   help="single-robot mode: procedural bumpy terrain")
    p.add_argument("--kf", action="store_true",
                   help="use the 18-state Kalman estimator")
    p.add_argument("--save", nargs="?", const="", default=None,
                   metavar="PATH", help="single-robot mode: save the logs "
                                        "to .npz (robot 0 of a batch)")
    p.add_argument("--plot", nargs="?", const="qrw_run", default=None,
                   metavar="PREFIX",
                   help="single-robot mode: save the plot_all figures as "
                        "PNGs (with --sweep: the envelope)")
    p.add_argument("--sweep", action="store_true",
                   help="run the batched velocity-envelope sweep and exit")
    p.add_argument("--estimator-demo", action="store_true",
                   help="estimator-only evaluation run and exit")
    p.add_argument("--fleet-mpc", type=int, default=0, metavar="B",
                   help="MPC-fleet service demo: solve B phase-sorted trot "
                        "problems per 50 Hz cycle on the lane-major phase "
                        "solver and report solves/s and convergence")
    p.add_argument("--fleet-cycles", type=int, default=10,
                   help="warm cycles for --fleet-mpc")
    p.add_argument("--ddp", action="store_true",
                   help="use the DDP (Crocoddyl-equivalent) MPC backend")
    p.add_argument("--host-loop", action="store_true",
                   help="drive the masterboard-style device facade from "
                        "the host instead of the batched rollout")
    p.add_argument("--clone", action="store_true",
                   help="mirror commands to a second simulated robot "
                        "(host-loop mode; reference -c option)")
    p.add_argument("--gamepad", action="store_true",
                   help="read a physical gamepad (host-loop mode; "
                        "requires the `inputs` package)")
    p.add_argument("--realtime", action="store_true",
                   help="pace the host loop to 500 Hz real time")
    p.add_argument("--mesh", action="store_true",
                   help="shard --batch / --sweep over one process per GPU "
                        "(torch.distributed; world size 1 without torchrun)")
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


def shakedown_calibration(cfg, device: str):
    """make_hetero_fleet's calibration, as the JAX entry point chooses
    it: bounding's footholds from a single-robot shakedown capture on
    the card, None (the nominal metric) on the CPU."""
    import torch

    from qrw_tpu_torch.sim import fleet as fl

    if torch.device(device).type == "cpu":
        return None
    return {"bounding": fl.hetero_shakedown_capture(cfg, "bounding",
                                                    device=device)}


def run_hetero(cfg, batch: int, tile: int, seed: int, device: str,
               n_cycles: int, rescue: int, calibration=None):
    """Build the heterogeneous fleet and run it twice from the same
    initial carry, without tick logs. calibration: make_hetero_fleet's
    {gait: captured fsteps}, or None for shakedown_calibration's
    choice. Returns (carry, cycle logs, meta, wall seconds of the second
    run, wall seconds of the first)."""
    from qrw_tpu_torch.sim import fleet as fl

    if calibration is None:
        calibration = shakedown_calibration(cfg, device)
    ctl, carry, ps, terrain, meta = fl.make_hetero_fleet(
        cfg, batch, tile=tile, seed=seed, device=device,
        calibration=calibration)
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
    """The heterogeneous fleet's health: MPC conv overall and per gait,
    upright share (z > 0.15 m) overall, per gait and per terrain,
    latched robots and whether every height is finite."""
    import numpy as np

    z = carry.sim_states.q[:, 2].cpu().numpy()
    up = z > 0.15
    conv = cyc.converged.float().cpu().numpy()             # (C, B)
    scen_gait = np.repeat(meta.tile_gait, tile)
    return dict(
        conv=float(conv.mean()),
        conv_per_gait={meta.gait_names[g]: float(conv[:, scen_gait == g]
                                                 .mean())
                       for g in range(len(meta.gait_names))},
        upright=float(up.mean()),
        per_gait={meta.gait_names[g]: float(up[scen_gait == g].mean())
                  for g in range(len(meta.gait_names))},
        per_terrain={n: float(up[meta.tid == t].mean())
                     for t, n in enumerate(["flat", "bumpy", "stairs"])
                     if (meta.tid == t).any()},
        latched=int(carry.ctl_states.error.sum()),
        finite=bool(np.isfinite(z).all()),
        rescued=int(cyc.rescued.sum()))


def fleet_mpc_layout(batch: int, n_phases: int, tile: int):
    """--fleet-mpc's batch layout, as the JAX entry point computes it
    (qrw_tpu/runtime/main.py, _run_fleet_mpc): `per` problems for each
    phase, a whole number of tiles of it; every phase of the gait when
    the batch holds a tile of each, else phases 0 and n_phases // 2.
    Returns (B, per, phase_ids, phases_of): the batch actually solved
    and the phase of each of its tiles."""
    import numpy as np

    per = max(tile, (batch // (n_phases * tile)) * tile)
    phase_ids = (list(range(n_phases)) if batch >= n_phases * tile
                 else [0, n_phases // 2])
    B = per * len(phase_ids)
    return B, per, phase_ids, np.repeat(phase_ids, per // tile)


def run_fleet_mpc(cfg, batch: int, seed: int, device: str,
                  n_cycles: int = 10) -> dict:
    """The MPC-fleet service demo: `batch` trot problems sorted over the
    gait's 16 offsets in the JAX entry point's layout
    (`fleet_mpc_layout`), solved cold on ops/qp_phase at 300 iterations,
    then warm-cycled `n_cycles` times on a 1 mm moving state, as the JAX
    entry point does. The tile is the JAX entry point's: 512 on the card
    (FLEET_MPC_TILE), 4 on the CPU. So --fleet-mpc 4096 solves 1024
    problems over phases 0 and 8, and --fleet-mpc 8192 all 16 phases at
    512 each. Returns the batch actually solved, the tile, the phases,
    solves/s and the mean warm conv."""
    import numpy as np
    import torch

    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.sim.fleet import _check_device

    cuda = torch.device(_check_device(device)).type == "cuda"
    tile = FLEET_MPC_TILE if cuda else CPU_TILE
    B, per, phase_ids, phases_of = fleet_mpc_layout(batch, cfg.n_steps,
                                                    tile)
    rng = np.random.default_rng(seed)
    phase_fs = ml.trot_phase_fsteps(cfg)
    xr = np.zeros((12, cfg.n_steps + 1, B), np.float32)
    xr[2] = cfg.h_ref
    xr[:, 0, :] += rng.normal(scale=0.01, size=(12, B))
    xr[6, 1:, :] = rng.uniform(0, 1.0, size=B)
    fs = np.zeros((cfg.N_gait, 12, B), np.float32)
    for i, p_id in enumerate(phase_ids):
        fs[:, :, i * per:(i + 1) * per] = phase_fs[p_id][:, :, None]
    ps = ml.build_phase_data(cfg, phase_fs, device=device)
    xrt = torch.as_tensor(xr, device=device)
    fst = torch.as_tensor(fs, device=device)
    _, st, sol = ml.solve_mpc_batch_phase(cfg, xrt, fst, ps, phases_of,
                                          n_iters=300, tile=tile)
    cold = float(sol.converged.float().mean())
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    convs = []
    for _ in range(n_cycles):
        xrt = xrt.clone()
        xrt[:, 0, :] += 0.001
        _, st, sol = ml.solve_mpc_batch_phase(cfg, xrt, fst, ps, phases_of,
                                              state=st, n_iters=300,
                                              tile=tile)
        convs.append(sol.converged.float().mean())
    sync()
    dt = (time.perf_counter() - t0) / n_cycles
    return dict(B=B, tile=tile, phases=phase_ids, solves_s=B / dt,
                s_per_cycle=dt,
                conv=float(torch.stack(convs).mean()), cold_conv=cold,
                n_cycles=n_cycles)


def run_single(cfg, args, device: str, dtype, mesh=None):
    """The single-robot closed loop (or --batch robots, sharded over
    `mesh`'s processes when one is given): returns (final carry, logs,
    wall seconds); with a mesh every rank gets the whole batch's."""
    import numpy as np
    import torch

    from qrw_tpu_torch.convert import tree_map
    from qrw_tpu_torch.sim.faults import default_perturbations
    from qrw_tpu_torch.sim.rollout import make_rollout, rollout
    from qrw_tpu_torch.sim.terrain import make_terrain

    n_ticks = cfg.N_SIMULATION
    terrain = make_terrain(cfg, dtype, device)
    f_ext = default_perturbations(cfg, n_ticks)
    ctl, carry = make_rollout(cfg, dtype=dtype, gait=args.gait,
                              terrain=terrain, device=device)
    cuda = torch.device(device).type == "cuda"
    print(f"backend={torch.device(device).type} devices="
          f"{torch.cuda.device_count() if cuda else 1} ticks={n_ticks} "
          f"velID={cfg.velID} gait={args.gait} batch={args.batch or 1}")
    if args.batch:
        B = args.batch
        rng = np.random.default_rng(args.seed)
        carry = tree_map(lambda a: a.expand((B,) + tuple(a.shape)).clone(),
                         carry)
        # perturb the initial joint configurations per robot
        dq = torch.as_tensor(rng.normal(scale=0.01, size=(B, 12)),
                             dtype=dtype, device=device)
        sim = carry.sim_state
        q = sim.q.clone()
        q[:, 7:] += dq
        carry = carry._replace(sim_state=sim._replace(q=q))
    run = lambda c: rollout(ctl, c, n_ticks, f_ext_schedule=f_ext,
                            terrain=terrain, perfect_estimator=args.perfect)
    if mesh is not None and args.batch:
        from qrw_tpu_torch.parallel.mesh import sharded_vmap
        run = sharded_vmap(run, mesh)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out, logs = run(carry)
    sync()
    return out, logs, time.perf_counter() - t0


def single_summary(cfg, args, logs, wall: float) -> int:
    """qrw_tpu's summary lines of the single-robot mode; returns the
    exit code (1 if a robot latched its security stop)."""
    import numpy as np

    n_runs = args.batch or 1
    sim_s = cfg.N_SIMULATION * cfg.dt_wbc
    print(f"rollout done: {wall:.2f}s wall for {n_runs} x {sim_s:.1f}s sim "
          f"({n_runs * sim_s / wall:.1f}x realtime aggregate)")
    bp = logs.base_pos.cpu().numpy()
    err = logs.error.cpu().numpy()
    ec = logs.error_code.cpu().numpy()
    finite = bool(np.isfinite(bp).all())
    if args.batch:
        n_err = int(err[:, -1].sum())
        codes = np.unique(ec[err > 0]) if n_err else "[]"
        print(f"final height mean={bp[:, -1, 2].mean():.4f} "
              f"min={bp[:, -1, 2].min():.4f}; errors {n_err}/{n_runs} "
              f"(codes {codes}){'' if finite else ' NON-FINITE'}")
        return 0 if finite and not n_err else 1
    print(f"final pos [{bp[-1, 0]:.3f} {bp[-1, 1]:.3f} {bp[-1, 2]:.3f}]"
          f" error={bool(err[-1])} code={int(ec[-1])}"
          f"{'' if finite else ' NON-FINITE'}")
    return 0 if finite and not err[-1] else 1


def save_and_plot(cfg, args, logs) -> None:
    """--save / --plot of the single-robot mode (robot 0 of a batch)."""
    from qrw_tpu_torch.convert import tree_map
    from qrw_tpu_torch.utils import logger as qlog

    one = tree_map(lambda a: a[0], logs) if args.batch else logs
    if args.save is not None:
        path = qlog.save_npz(one, args.save or None, cfg)
        print(f"logs saved to {path}")
    if args.plot is not None:
        qlog.plot_all(qlog.log_to_dict(one, cfg), dt=cfg.dt_wbc, show=False,
                      save_prefix=args.plot)
        print(f"figures saved as {args.plot}_fig*.png")


def run_host_loop_cli(cfg, args, device: str, dtype) -> int:
    """--host-loop: qrw_tpu's host-driven loop with the damping shutdown,
    its two summary lines and exit code (1 on an abort, latch or
    timeout)."""
    import numpy as np

    from qrw_tpu_torch.runtime.host_loop import run_host_loop
    from qrw_tpu_torch.sim.device import SimDevice

    clone = None
    if args.clone:
        clone = SimDevice(cfg, dtype=dtype, device=device)
        clone.Init(q_init=cfg.q_init)
    gamepad = None
    if args.gamepad:
        from qrw_tpu_torch.runtime.gamepad import GamepadReader
        gamepad = GamepadReader()
    try:
        res = run_host_loop(cfg, n_ticks=cfg.N_SIMULATION, clone=clone,
                            gamepad=gamepad, realtime=args.realtime,
                            shutdown=True, gait=args.gait, dtype=dtype,
                            torch_device=device)
    finally:
        if gamepad is not None:
            gamepad.stop()
    print(f"host loop: {res.n_ticks} ticks, startup_abort="
          f"{res.startup_abort}, error={res.error}, timeout={res.timeout}")
    if res.n_ticks:
        bp = res.q_log[-1]
        print(f"final pos [{bp[0]:.3f} {bp[1]:.3f} {bp[2]:.3f}], "
              f"max |tau_ff| {np.abs(res.tau_log).max():.2f}")
    return 0 if not (res.startup_abort or res.error or res.timeout) else 1


def _run_batch_modes(cfg, args, device: str, dtype, mesh=None) -> int:
    """--sweep, or the single-robot mode (one robot or --batch), with
    their summaries; `mesh` shards the batch."""
    if args.sweep:
        from qrw_tpu_torch.eval.speed_sweep import plot_envelope, run_sweep
        t0 = time.perf_counter()
        res = run_sweep(cfg, n_ticks=cfg.N_SIMULATION, dtype=dtype,
                        device=device, mesh=mesh)
        print(f"sweep: {int(res.success.sum())}/{res.success.size} cells "
              f"succeeded; max vx err {res.vx_err.max():.3f} m/s "
              f"({cfg.N_SIMULATION} ticks in "
              f"{time.perf_counter() - t0:.1f}s on {device})")
        if args.plot is not None:
            plot_envelope(res, show=False,
                          save_path=args.plot + "_envelope.png")
            print(f"envelope saved as {args.plot}_envelope.png")
        return 0
    _, logs, wall = run_single(cfg, args, device, dtype, mesh)
    code = single_summary(cfg, args, logs, wall)
    if args.save is not None or args.plot is not None:
        save_and_plot(cfg, args, logs)
    return code


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    fleets = bool(args.fleet or args.hetero)

    import numpy as np
    import torch

    from qrw_tpu_torch.config import load_config
    overrides = {}
    if args.velID is not None:
        overrides["velID"] = args.velID
    if args.ticks is not None:
        overrides["N_SIMULATION"] = args.ticks
    if args.kf:
        overrides["kf_enabled"] = True
    if args.ddp:
        overrides["type_MPC"] = False
    if args.envID is not None:
        overrides["envID"] = args.envID
    if args.bumpy:
        overrides["use_flat_plane"] = False
    cfg = load_config(args.config, **overrides)
    device = "cpu" if args.cpu else args.device
    dtype = torch.float64 if args.f64 else torch.float32
    if args.fleet_mpc:
        r = run_fleet_mpc(cfg, args.fleet_mpc, args.seed, device,
                          args.fleet_cycles)
        print(f"fleet MPC service: {r['B']} scenarios/cycle (tile "
              f"{r['tile']}, on {device}) over phases {r['phases']}, "
              f"{r['solves_s']:.0f} solves/s, "
              f"conv {r['conv']:.4f} (cold {r['cold_conv']:.4f}; "
              f"{r['n_cycles']} warm cycles, synchronized per run)")
        return 0
    if not fleets:
        if args.host_loop:
            return run_host_loop_cli(cfg, args, device, dtype)
        if args.estimator_demo and not args.sweep:
            from qrw_tpu_torch.eval.estimator_eval import run_demo
            m = run_demo(cfg, n_ticks=cfg.N_SIMULATION, kf=args.kf,
                         dtype=dtype, device=device)
            print("estimator metrics:",
                  {k: round(v, 5) for k, v in m.items()})
            return 0
        if not (args.mesh and (args.sweep or args.batch)):
            return _run_batch_modes(cfg, args, device, dtype)
        from qrw_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(device=device)
        try:
            # rank 0 reports; the others run their shard silently
            with (contextlib.nullcontext() if mesh.rank == 0 else
                  contextlib.redirect_stdout(io.StringIO())):
                return _run_batch_modes(cfg, args, str(mesh.device), dtype,
                                        mesh)
        finally:
            mesh.close()
    n_cycles = max(1, cfg.N_SIMULATION // cfg.k_mpc)
    n_ticks = n_cycles * cfg.k_mpc
    if args.hetero:
        B = (max(args.hetero, 3 * TILE) // TILE) * TILE
        rescue = rescue_capacity(args.rescue, B)
        carry, cyc, meta, wall, first = run_hetero(
            cfg, B, TILE, args.seed, device, n_cycles, rescue)
        s = hetero_summary(carry, cyc, meta, TILE)
        per_gait = " ".join(f"{g} {v:.2f}" for g, v in s["per_gait"].items())
        conv_gait = " ".join(f"{g} {v:.4f}"
                             for g, v in s["conv_per_gait"].items())
        per_ter = " ".join(f"{t} {v:.2f}"
                           for t, v in s["per_terrain"].items())
        cal = ("calibrated from the shakedown capture"
               if torch.device(device).type != "cpu" else
               "nominal on the CPU")
        print(f"hetero fleet: {B} robots x {n_ticks} ticks in {wall:.2f}s "
              f"on {device} ({B * n_ticks / wall:.0f} ticks/s; first "
              f"run {first:.1f}s); MPC conv {s['conv']:.4f} [{conv_gait}] "
              f"(rescue cap {rescue}; bounding's metric {cal}); upright "
              f"{s['upright']:.3f} [{per_gait} | {per_ter}]; errors "
              f"{s['latched']}/{B}{'' if s['finite'] else ' NON-FINITE'}")
        return 0 if s["finite"] and not s["latched"] else 1
    B = max(TILE, (args.fleet // TILE) * TILE)
    rescue = rescue_capacity(args.rescue, B)
    carry, logs, cyc, wall, first = run_fleet(
        cfg, B, TILE, args.seed, device, n_cycles, rescue,
        args.perfect)
    h = logs.base_pos[:, :, 2].cpu().numpy()
    err = logs.error.cpu().numpy()
    conv = cyc.converged.cpu().numpy()
    fired = int((cyc.rescued > 0).sum())
    estimator = ("perfect" if args.perfect else
                 "Kalman" if args.kf else "complementary")
    print(f"fleet: {B} robots x {n_ticks} ticks in {wall:.2f}s on "
          f"{device} ({B * n_ticks / wall:.0f} ticks/s aggregate, "
          f"{B * n_cycles / wall:.0f} in-loop MPC solves/s; first run "
          f"{first:.1f}s; {estimator} estimator); MPC conv {conv.mean():.4f} (rescue cap {rescue}, "
          f"fired in {fired} of {n_cycles} cycles); errors "
          f"{int(err[-1].sum())}/{B}; final height mean {h[-1].mean():.4f} "
          f"min {h[-1].min():.4f}"
          f"{'' if np.isfinite(h).all() else ' NON-FINITE'}")
    return 0 if not err[-1].any() else 1


if __name__ == "__main__":
    raise SystemExit(main())
