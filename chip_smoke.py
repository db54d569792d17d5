"""Smoke run of the PyTorch + CUDA port on one card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
1. The card, its power limit, torch / CUDA versions, and the build of
   the hand-written kernels from qrw_tpu_torch/csrc (nvcc, first use).
2. Kernel K1 (qrw_tpu_torch/csrc/qp_phase.cu) against its plain PyTorch
   version on the card: the bench's phase-sorted trot batch at B = 1024,
   tile 128, cold and warm, stop_at_eps off and on. Converged flags and
   iteration counts must be equal, x / y / z close. Both are timed with
   CUDA events (median of 7 windows, with the spread).
3. The closed-loop trot fleet through the entry point's functions
   (qrw_tpu_torch.runtime.main.run_fleet): B = 1024, 10 cycles = 100
   ticks, no rescue stage. All heights finite, no security latch, every
   robot upright over the last 50 ticks, MPC convergence above the bar,
   and exactly one kernel launch per cycle.
4. The whole slice with the kernel against the whole slice with the
   plain solver: B = 128, 2 cycles, from one carry.

The second-to-last line of output is one JSON object describing the
kernels; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

B_KERNEL = 1024
TILE = 128
FLEET_B = 1024
FLEET_CYCLES = 10
SLICE_B = 128
SLICE_CYCLES = 2
# Convergence bar of the in-loop MPC without the rescue stage. The JAX
# package's no-rescue warm convergence is 0.97 (BENCH_full.json,
# warm_conv_no_rescue); the fleet's first cycle is a cold start, so the
# bar leaves that margin.
CONV_BAR = 0.9
# Kernel vs plain version, both float32 on the card: the same update
# equations with a different summation order in the two dense products.
# The iteration is contractive, so the rounding difference stays near
# float32 epsilon times the iterate scale (2e-6 measured for the plain
# version against the Pallas kernel in tests/test_torch_qp_phase.py);
# 1e-4 of each array's largest entry leaves a wide margin.
REL_TOL = 1e-4


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_batch(cfg, phase_ids, per_phase, rng):
    """bench.py::phase_batch in numpy: xrefs (12, N+1, B), fsteps
    (N_gait, 12, B), B = len(phase_ids) * per_phase."""
    from qrw_tpu_torch.core import mpc_lane as ml
    N = cfg.n_steps
    phase_fs = ml.trot_phase_fsteps(cfg)
    B = len(phase_ids) * per_phase
    xrefs = np.zeros((12, N + 1, B), np.float32)
    xrefs[2, :, :] = 0.24474949993103629
    xrefs[:, 0, :] += rng.normal(scale=0.02, size=(12, B))
    xrefs[6, 1:, :] = rng.uniform(0.0, 1.0, size=B)
    fsteps = np.zeros((cfg.N_gait, 12, B), np.float32)
    for i, p in enumerate(phase_ids):
        fsteps[:, :, i * per_phase:(i + 1) * per_phase] = \
            phase_fs[p][:, :, None]
    return xrefs, fsteps


def time_ms(fn, windows=7, reps=1):
    """CUDA-event time of `fn` (ms per call): median and spread of
    `windows` windows of `reps` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    out = np.asarray(out)
    return float(np.median(out)), float(out.min()), float(out.max())


def check_kernel(cfg, ps, device, B, tile):
    """Phase 2. Returns (max_abs_err, (ms, lo, hi), (plain_ms, lo, hi))
    of the main path's configuration (warm, stop_at_eps on)."""
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.ops import qp_phase

    n_phases = B // tile
    phase_ids = [(2 * i) % cfg.n_steps for i in range(n_phases)]
    xr, fs = phase_batch(cfg, phase_ids, tile, np.random.default_rng(0))
    phases_of = torch.as_tensor(phase_ids, dtype=torch.int32, device=device)
    t = lambda a: torch.as_tensor(a, device=device)
    _, _, _, BlS, q, _ = ml.phase_problem(cfg, t(xr), t(fs), ps, phases_of,
                                          tile)
    q, BlS = q.contiguous(), BlS.contiguous()
    cold = qp_phase.solve_plain(q, BlS, ps.data, phases_of, tile=tile)
    xr2 = xr.copy()
    xr2[:, 0, :] += 0.001
    _, _, _, BlS2, q2, _ = ml.phase_problem(cfg, t(xr2), t(fs), ps,
                                            phases_of, tile)
    q2, BlS2 = q2.contiguous(), BlS2.contiguous()
    worst = 0.0
    timing = None
    for warm in (False, True):
        for stop in (False, True):
            args = ((q2, BlS2) if warm else (q, BlS)) + (ps.data, phases_of)
            kw = dict(n_iters=300, tile=tile, stop_at_eps=stop,
                      x0=cold.x.contiguous() if warm else None,
                      y0=cold.y.contiguous() if warm else None)
            got = qp_phase.solve(*args, **kw)
            want = qp_phase.solve_plain(*args, **kw)
            torch.cuda.synchronize()
            n_conv = int((got.converged != want.converged).sum())
            n_it = int((got.iters != want.iters).sum())
            errs = {}
            for f in ("x", "y", "z"):
                g, w = getattr(got, f), getattr(want, f)
                assert torch.isfinite(g).all(), f"kernel {f} not finite"
                e = float((g - w).abs().max())
                scale = max(1.0, float(w.abs().max()))
                errs[f] = e
                worst = max(worst, e)
                assert e <= REL_TOL * scale, (
                    f"kernel vs plain {f}: {e:.3e} > {REL_TOL} * {scale:.3g}")
            k_ms = time_ms(lambda: qp_phase.solve(*args, **kw), reps=3)
            p_ms = time_ms(lambda: qp_phase.solve_plain(*args, **kw))
            log(f"K1 qp_phase B={B} tile={tile} warm={warm} "
                f"stop_at_eps={stop}: conv kernel "
                f"{float(got.converged.float().mean()):.4f} plain "
                f"{float(want.converged.float().mean()):.4f}, mean iters "
                f"{float(got.iters.float().mean()):.1f}; flag mismatches "
                f"conv {n_conv} iters {n_it}; max|dx| {errs['x']:.2e} "
                f"max|dy| {errs['y']:.2e} max|dz| {errs['z']:.2e}; "
                f"kernel {k_ms[0]:.3f} ms [{k_ms[1]:.3f}, {k_ms[2]:.3f}] "
                f"plain {p_ms[0]:.3f} ms [{p_ms[1]:.3f}, {p_ms[2]:.3f}] "
                f"(median [min, max] of 7 windows)")
            assert n_conv == 0, f"{n_conv} converged flags differ"
            assert n_it == 0, f"{n_it} iteration counts differ"
            if warm and stop:
                timing = (k_ms, p_ms)
    return worst, timing[0], timing[1]


def run_main_path(cfg, device):
    """Phase 3: the fleet through the entry point's functions."""
    from qrw_tpu_torch.ops import qp_phase
    from qrw_tpu_torch.runtime.main import run_fleet

    qp_phase.KERNEL_LAUNCHES = 0
    carry, logs, cyc, wall = run_fleet(cfg, FLEET_B, TILE, 0, device,
                                       FLEET_CYCLES)
    launches = qp_phase.KERNEL_LAUNCHES
    n_ticks = FLEET_CYCLES * cfg.k_mpc
    h = logs.base_pos[:, :, 2].cpu().numpy()
    err = logs.error.cpu().numpy()
    conv = cyc.converged.float().cpu().numpy()
    iters = cyc.iters.float().cpu().numpy()
    ticks_s = FLEET_B * n_ticks / wall
    log(f"fleet B={FLEET_B} tile={TILE} {FLEET_CYCLES} cycles = {n_ticks} "
        f"ticks in {wall:.3f} s: {ticks_s:.1f} ticks/s aggregate, "
        f"{FLEET_B * FLEET_CYCLES / wall:.1f} in-loop MPC solves/s, "
        f"MPC conv {conv.mean():.4f} (per cycle "
        f"{np.round(conv.mean(axis=1), 4).tolist()}), mean iters "
        f"{iters.mean():.1f}; final height mean {h[-1].mean():.4f} "
        f"min {h[-1].min():.4f}; latched {int(err.any(axis=0).sum())}; "
        f"kernel launches {launches}")
    assert np.isfinite(h).all(), "non-finite base height"
    assert not err.any(), "security latch"
    up = np.abs(h[-50:] - cfg.h_ref) < 0.05
    assert up.all(), f"{int((~up.all(axis=0)).sum())} robots not upright"
    assert conv.mean() >= CONV_BAR, f"MPC conv {conv.mean():.4f}"
    assert launches == FLEET_CYCLES, (
        f"{launches} kernel launches for {FLEET_CYCLES} cycles")
    return launches, ticks_s


def check_slice(cfg, ps, device):
    """Phase 4: kernel path against plain path for the whole slice."""
    from qrw_tpu_torch.ops import qp_phase
    from qrw_tpu_torch.sim import fleet as fl

    ctl, carry = fl.make_fleet(cfg, SLICE_B, ps, tile=TILE, seed=1,
                               device=device)
    kw = dict(tile=TILE, n_iters=300, stop_at_eps=True)
    _, lk, ck = fl.fleet_rollout(ctl, carry, SLICE_CYCLES, ps, **kw)
    kernel_solve = qp_phase.solve
    qp_phase.solve = qp_phase.solve_plain       # the plain path, on purpose
    try:
        _, lp, cp = fl.fleet_rollout(ctl, carry, SLICE_CYCLES, ps, **kw)
    finally:
        qp_phase.solve = kernel_solve
    tol = {"base_pos": 1e-4, "base_quat": 1e-4, "f_mpc": 1e-2,
           "tau_ff": 1e-2}
    parts = []
    for f, rel in tol.items():
        a, b = getattr(lk, f), getattr(lp, f)
        e = float((a - b).abs().max())
        lim = rel * max(1.0, float(b.abs().max()))
        parts.append(f"{f} {e:.2e} (limit {lim:.2e})")
        assert e <= lim, f"slice kernel vs plain {f}: {e:.3e} > {lim:.3e}"
    n_flag = int((ck.converged != cp.converged).sum()
                 + (ck.iters != cp.iters).sum())
    log(f"slice B={SLICE_B} {SLICE_CYCLES} cycles, kernel vs plain: "
        + ", ".join(parts) + f"; solver flag mismatches {n_flag}")
    assert n_flag == 0, "converged/iters differ between kernel and plain"
    assert not bool(lk.error.any()), "security latch in the slice run"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from qrw_tpu.config import Config
    from qrw_tpu_torch import kernels
    from qrw_tpu_torch.core import mpc_lane as ml

    device = "cuda"
    card = card_line()
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.BUILD_SECONDS if kernels.BUILD_SECONDS is None else round(kernels.BUILD_SECONDS, 2)} s)")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    cfg = Config()
    ps = ml.build_phase_data(cfg, ml.trot_phase_fsteps(cfg), device=device)

    err, k_ms, p_ms = check_kernel(cfg, ps, device, B_KERNEL, TILE)
    launches, _ = run_main_path(cfg, device)
    check_slice(cfg, ps, device)

    log(json.dumps({"kernels": [{
        "name": "qp_phase", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_phase.cu",
        "replaces": "qrw_tpu/ops/qp_phase.py:233",
        "launches": launches, "max_abs_err": err,
        "ms": k_ms[0], "plain_ms": p_ms[0]}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
