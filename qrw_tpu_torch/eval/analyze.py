"""Offline analysis CLI for saved run logs.

Port of qrw_tpu/eval/analyze.py: the reference's post-hoc analysis
entry points (plotAll from a LoggerControl .npz dump, the estimator
studies of plot_IMU_mocap_result.py) on a saved .npz rollout log, which
either package may have written (utils/logger keeps the JAX package's
keys). The figures and metrics are made on the host CPU; `--compare`
(the solver comparison of the reference's analyse_simu scripts,
eval/compare: every logged MPC cycle re-solved with the QP and the DDP
backends, warm in the loop and cold) re-solves in float64 on the card
unless `--cpu` is given, and so do `--forces` (utils/viz.force_monitor:
the feet from one batched kinematics call) and `--slider` (utils/viz.
slider_replay: every MPC cycle re-solved in one batched call).

    python -m qrw_tpu_torch.eval.analyze run.npz --plot out     # plotAll
    python -m qrw_tpu_torch.eval.analyze run.npz --estimator    # metrics
    python -m qrw_tpu_torch.eval.analyze run.npz --fk-feet
    python -m qrw_tpu_torch.eval.analyze run.npz --tracking b.npz
    python -m qrw_tpu_torch.eval.analyze run.npz --compare      # QP vs DDP
    python -m qrw_tpu_torch.eval.analyze run.npz --forces 500   # GRF snapshot
    python -m qrw_tpu_torch.eval.analyze run.npz --slider       # interactive
"""

from __future__ import annotations

import argparse


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="qrw_tpu_torch offline run analysis")
    p.add_argument("npz", help="saved rollout log (.npz)")
    p.add_argument("--plot", nargs="?", const="qrw_analysis", default=None,
                   metavar="PREFIX", help="save the plotAll figure set")
    p.add_argument("--slider", action="store_true",
                   help="interactive MPC-prediction scrubber (needs a GUI)")
    p.add_argument("--forces", nargs="?", const=-1, type=int, default=None,
                   metavar="TICK", help="ground-reaction-force snapshot")
    p.add_argument("--estimator", action="store_true",
                   help="estimator-vs-ground-truth metrics (+figure with "
                        "--plot)")
    p.add_argument("--compare", action="store_true",
                   help="re-solve every MPC cycle with the QP and DDP "
                        "backends and report the divergence")
    p.add_argument("--cpu", action="store_true",
                   help="--compare, --forces and --slider on the CPU "
                        "(default: the card)")
    p.add_argument("--fk-feet", action="store_true",
                   help="per-foot leg-odometry velocity study")
    p.add_argument("--tracking", nargs="*", default=None, metavar="NPZ",
                   help="velocity-command tracking figure; extra .npz "
                        "paths overlay multiple runs")
    p.add_argument("--show", action="store_true",
                   help="show figures interactively instead of saving")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from qrw_tpu_torch.config import Config
    from qrw_tpu_torch.utils.logger import load_npz

    data = load_npz(args.npz)
    cfg = Config()
    device = "cpu" if args.cpu else "cuda"
    if "_dt_wbc" in data:
        assert abs(float(data["_dt_wbc"]) - cfg.dt_wbc) < 1e-9, \
            "log was recorded at a different control rate"
    print(f"loaded {args.npz}: {data['base_pos'].shape[0]} ticks, "
          f"{len(data)} arrays")

    if args.plot is not None and not (args.estimator or args.slider
                                      or args.forces is not None):
        from qrw_tpu_torch.utils.logger import plot_all
        plot_all(data, dt=cfg.dt_wbc, show=args.show,
                 save_prefix=None if args.show else args.plot)
        if not args.show:
            print(f"figures saved as {args.plot}_fig*.png")

    if args.forces is not None:
        from qrw_tpu_torch.utils.viz import force_monitor
        tick = None if args.forces < 0 else args.forces
        save = None if args.show else (args.plot or "qrw_analysis") \
            + "_forces.png"
        force_monitor(data, tick=tick, show=args.show, save_path=save,
                      device=device)
        if save:
            print(f"force snapshot saved as {save}")

    if args.slider:
        from qrw_tpu_torch.utils.viz import slider_replay
        slider_replay(data, cfg, show=True, device=device)

    if args.estimator:
        import numpy as np
        from qrw_tpu_torch.eval.estimator_eval import (plot as est_plot,
                                                       plot_bis, score,
                                                       windowed_drift)
        m = score(data, cfg)
        print("estimator metrics:",
              {k: round(v, 5) for k, v in m.items()})
        _, drift = windowed_drift(data, cfg)
        print("windowed drift per 0.5 s [m]: max",
              round(float(np.abs(drift).max()), 5), "mean",
              round(float(np.abs(drift).mean()), 5))
        if args.plot is not None:
            prefix = None if args.show else args.plot
            est_plot(data, cfg, show=args.show, save_prefix=prefix)
            # the deep-study panels (windowed drift, error FFT,
            # complementary-filter internals)
            plot_bis(data, cfg, show=args.show, save_prefix=prefix)

    if args.fk_feet:
        from qrw_tpu_torch.eval.estimator_eval import plot_fk_feet
        prefix = args.plot or "qrw_analysis"
        plot_fk_feet(data, cfg, show=args.show,
                     save_prefix=None if args.show else prefix)
        if not args.show:
            print(f"per-foot odometry figure saved as {prefix}_fk_feet.png")

    if args.tracking is not None:
        from qrw_tpu_torch.eval.estimator_eval import plot_tracking
        runs = [data] + [load_npz(p) for p in args.tracking]
        labels = [args.npz] + list(args.tracking)
        prefix = args.plot or "qrw_analysis"
        plot_tracking(runs, labels, cfg, show=args.show,
                      save_prefix=None if args.show else prefix)
        if not args.show:
            print(f"tracking figure saved as {prefix}_tracking.png")

    if args.compare:
        import torch
        from qrw_tpu_torch.eval.compare import (compare_solvers,
                                                compare_solvers_warm,
                                                summarize)
        from qrw_tpu_torch.sim.fleet import _check_device
        device = _check_device(device)
        ticks = slice(0, data["mpc_xref"].shape[0], cfg.k_mpc)
        xr = torch.as_tensor(data["mpc_xref"][ticks], dtype=torch.float64,
                             device=device)
        fs = torch.as_tensor(data["mpc_fsteps"][ticks], dtype=torch.float64,
                             device=device)
        # warm in-loop (production budgets, the reference's test_1
        # methodology) and the cold like-for-like re-solve
        for name, fn in (("warm-in-loop", compare_solvers_warm),
                         ("cold", compare_solvers)):
            print(f"solver comparison ({name}):",
                  {k: round(v, 5)
                   for k, v in summarize(fn(cfg, xr, fs)).items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
