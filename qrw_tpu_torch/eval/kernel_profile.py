"""Warm-cycle time decomposition of the full-size batched MPC path.

Port of qrw_tpu/eval/kernel_profile.py. It measures where the warm-cycle
wall time of core/mpc.solve_mpc_batch_pallas goes, by differencing
configurations:

  * schedule=[1] vs schedule=[50]: the pure in-kernel iteration cost
    (49 extra ADMM iterations) vs the fixed per-cycle overhead
    (QP build + refactorization + residual/termination glue);
  * refactor "chol" vs "ns" vs "stale": the refactorization share.

One cold solve first (Ruiz and the default schedule), then warm solves
from its carry under every refactor policy, each timed over `--reps`
calls after one warm-up call.

    python -m qrw_tpu_torch.eval.kernel_profile [--batch 4096]    # card
    python -m qrw_tpu_torch.eval.kernel_profile --cpu --batch 4 --reps 1

Prints one JSON dict of {config: seconds-per-cycle | solves/s | conv},
with the JAX tool's keys. The default device is cuda (kernels K2 and K3);
--cpu runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def build_batch(cfg, batch: int, rng: np.random.Generator):
    """Distinct trot scenarios: perturbed current state + rolling stance
    (bench.py::build_batch in numpy). Returns xrefs (batch, 12, N+1),
    fsteps (batch, N_gait, 12), float32."""
    h0 = 0.24474949993103629
    pair1 = np.array([0.195, 0.147, 0., 0., 0., 0.,
                      0., 0., 0., -0.195, -0.147, 0.])
    pair2 = np.array([0., 0., 0., 0.195, -0.147, 0.,
                      -0.195, 0.147, 0., 0., 0., 0.])
    N = cfg.n_steps
    half = N // 2
    xrefs = np.zeros((batch, 12, N + 1), np.float32)
    xrefs[:, 2, :] = h0
    xrefs[:, :, 0] += rng.normal(scale=0.02, size=(batch, 12))
    xrefs[:, 6, 1:] = rng.uniform(0.0, 1.0, size=(batch, 1))
    fsteps = np.zeros((batch, cfg.N_gait, 12), np.float32)
    for b in range(batch):
        off = b % N
        for i in range(N):
            fsteps[b, i] = (pair1 if ((i + (half - off)) // half) % 2 == 0
                            else pair2)
    return xrefs, fsteps


def build_argparser():
    ap = argparse.ArgumentParser(
        prog="python -m qrw_tpu_torch.eval.kernel_profile",
        description="Warm-cycle time decomposition of the full-size "
                    "batched MPC path (solve_mpc_batch_pallas).")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiles", type=int, nargs="*", default=[16, 32],
                    help="kept from the JAX tool: the port's kernels take "
                         "one block per problem and have no tile, so each "
                         "value only labels the keys and repeats the run")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain versions "
                         "(default: the card, device cuda)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from qrw_tpu_torch.config import Config
    from qrw_tpu_torch.core import mpc as mpc_mod
    from qrw_tpu_torch.ops import qp

    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kernel_profile: no CUDA device; pass --cpu to "
                           "run the plain versions on the CPU")
    cfg = Config()
    rng = np.random.default_rng(0)
    x_np, f_np = build_batch(cfg, args.batch, rng)
    xs = torch.as_tensor(x_np, device=device)
    fs = torch.as_tensor(f_np, device=device)
    ST = qp.QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=450,
                       adaptive_rho_interval=200)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = {}

    def clock(fn):
        _, _, sol = fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            _, _, sol = fn()
        sync()
        dt = (time.perf_counter() - t0) / args.reps
        return dt, float(sol.converged.float().mean())

    for tile in args.tiles:
        sync()
        t0 = time.perf_counter()
        _, st, sol = mpc_mod.solve_mpc_batch_pallas(cfg, xs, fs, settings=ST,
                                                    tile=tile)
        sync()
        t_cold = time.perf_counter() - t0
        for policy, iters in (("ns", 50), ("ns", 1), ("chol", 50),
                              ("stale", 50)):
            dt, conv = clock(
                lambda: mpc_mod.solve_mpc_batch_pallas(
                    cfg, xs, fs, state=st, settings=ST, refactor=policy,
                    schedule=[iters], tile=tile))
            key = f"tile{tile}_{policy}_{iters}it"
            results[key] = {
                "s_per_cycle": round(dt, 5),
                "solves_per_s": round(args.batch / dt, 1),
                "conv": round(conv, 4),
            }
            print(f"{key}: {dt * 1e3:.1f} ms/cycle = "
                  f"{args.batch / dt:.0f} solves/s (conv {conv:.3f})",
                  file=sys.stderr)
        # the JAX tool's key: there the cold call's wall time is mostly
        # XLA's compile; here it is the cold solve (and, on the first
        # call on a card, the kernels' build)
        results[f"tile{tile}_compile_s"] = round(t_cold, 1)
        results[f"tile{tile}_cold_conv"] = round(
            float(sol.converged.float().mean()), 4)

    # decomposition from the tile entries: kernel-iteration share vs
    # fixed overhead (build + factor + glue)
    for tile in args.tiles:
        a = results.get(f"tile{tile}_ns_50it")
        b = results.get(f"tile{tile}_ns_1it")
        if a and b:
            per_iter = (a["s_per_cycle"] - b["s_per_cycle"]) / 49.0
            results[f"tile{tile}_per_admm_iter_us"] = round(
                per_iter * 1e6, 2)
            results[f"tile{tile}_fixed_overhead_ms"] = round(
                b["s_per_cycle"] * 1e3, 3)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
