"""Smoke run of the PyTorch + CUDA port on one card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
1. The card, its power limit, torch / CUDA versions, and the build of
   the hand-written kernels from qrw_tpu_torch/csrc (one nvcc for each
   source, all started together, at first use).
2. Kernel K1 (qrw_tpu_torch/csrc/qp_phase.cu) against its plain PyTorch
   version on the card: the bench's phase-sorted trot batch at B = 1024,
   tile 128, cold and warm, stop_at_eps off and on. Converged flags and
   iteration counts must be equal, x / y / z close. Both are timed with
   CUDA events (median of 7 windows, with the spread).
3. Kernel K2 (qrw_tpu_torch/csrc/qp_admm.cu) against its plain version
   on the card, on rescue problems assembled as
   core/mpc.solve_mpc_batch_reduced assembles them from the same phase
   batch, at R = 32 and R = 128 problems: one 50-iteration round cold
   and warm, and the whole rescue solve (schedule [50, 150, 150, 100],
   early exit) from a cold-restart and from a warm carry. Flags and
   iteration counts must be equal, x / y / z close; timed as in 2.
4. The rescue stage firing on the main path: a B = 1024 fleet through
   the entry point's functions at the CLI's rescue capacity (32), a few
   normal cycles, ONE crippled cycle (a 1-iteration phase solve, so
   every lane fails) in which exactly 32 lanes come back converged
   through K2, then recovery cycles: upright, no latch, convergence
   above the bar. Both kernels' counts are set to 0 just before this
   run and read just after it; K2 must have launched.
5. The closed-loop trot fleet through qrw_tpu_torch.runtime.main
   .run_fleet at the CLI defaults: B = 1024, 10 cycles = 100 ticks,
   rescue capacity 32. All heights finite, no latch, every robot upright
   over the last 50 ticks, MPC convergence above the bar, and exactly
   one K1 launch per cycle (counts set to 0 just before, read after).
6. The whole slice with the kernel against the whole slice with the
   plain solver: B = 128, 2 cycles, from one carry.

The second-to-last line of output is one JSON object describing the
kernels, the line before it the card's name and power limit; the last
line is {"ok": true, "device": {...}}.
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
RESCUE_R = (32, 128)            # K2 batch sizes: B // 32 at B = 1024, 4096
RESCUE_SCHEDULE = [50, 150, 150, 100]
RESCUE_CYCLES = (2, 1, 5)       # normal, crippled, recovery cycles
# Convergence bar of the in-loop MPC. The JAX package's no-rescue warm
# convergence is 0.97 (BENCH_full.json, warm_conv_no_rescue); the fleet's
# first cycle is a cold start, so the bar leaves that margin.
CONV_BAR = 0.9
# Recovery after the crippled cycle: the JAX package's own recovery test
# (tests/test_fleet.py:95-98) holds the mean over the recovery cycles
# above 0.99, with a rescue capacity of B. Here the capacity is the
# CLI's B // 32 and 992 of the 1024 lanes restart from a zeroed carry,
# but a cold phase solve converges the trot fleet (the fleet's own first
# cycles reach conv 1.0 on an H100, PERF.md) and this phase measured 1.0
# in every recovery cycle there, so the JAX test's bar holds here too.
RECOVERY_BAR = 0.99
# Published peaks of one H100 SXM:
# float32 outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# Kernel vs plain version, both float32 on the card: the same update
# equations with a different summation order in the two dense products.
# The iteration is contractive, so the rounding difference stays near
# float32 epsilon times the iterate scale (2e-6 measured for the plain
# version against the Pallas kernel in tests/test_torch_qp_phase.py);
# 1e-4 of each array's largest entry leaves a wide margin.
REL_TOL = 1e-4
# Whole rescue solves, kernel path against plain path: a few rounds, each
# from its own Cholesky of K, and an OSQP rho adaptation between rounds
# that reads the primal residual at its float32 round-off floor, so the
# two paths may adapt rho differently (tests/test_torch_qp_pallas.py).
# Both end at the same optimum within the 1e-4 termination tolerance;
# 1e-3 of each array's largest entry holds them to a tenth of it.
SOLVE_TOL = 1e-3


def log(msg):
    print(msg, flush=True)


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operation time at the
    float32 peak and the byte time at the memory rate."""
    t_op = flops / PEAK_F32_FLOPS * 1e3
    t_b = nbytes / PEAK_BYTES_S * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def k1_work(B, cap, P, tile, iters, converged, n_iters=300,
            check_every=25):
    """Operations and bytes of one K1 solve. Operations: those of
    qp_phase.admm_iter at alpha = 1 (the metric step 2n^2, the two Gram
    products of hx_matfree 2 * 2 cap^2 6, the slab, cone and elementwise
    passes: ~48 kflop a problem-iteration at cap 32) and of the
    termination test every `check_every` iterations, over the iterations
    each tile actually ran (with the early exit: its last problem's
    first passing check, or the budget). Bytes: every input read once,
    every output written once."""
    n, m = 3 * cap, 5 * cap
    hx = 24 * cap * cap + 63 * cap + 2 * n
    per_it = 12 * m + 13 * cap + 5 * n + 2 * n * n + hx
    per_check = hx + 7 * cap + 6 * m + 6 * n
    it = iters.reshape(-1, tile).float()
    cv = converged.reshape(-1, tile)
    ran = torch.where(cv.all(dim=1), it.max(dim=1).values,
                      torch.full_like(it[:, 0], float(n_iters)))
    total_it = float(ran.sum()) * tile
    flops = total_it * per_it + (total_it / check_every + B) * per_check
    nbytes = 4 * (B * (n + 9 * cap + n + m)          # q, slabs, x0, y0
                  + P * (n * n + 2 * cap * cap) + 2 * m + B // tile
                  + B * (n + 3 * m + 5))             # x, y, z, A x, res
    return flops, nbytes


def k2_work(R, n, m, n_iters):
    """Operations and bytes of one K2 launch: per problem-iteration the
    products A'w, K^-1 b and A xt (2mn + 2n^2 + 2mn) and the elementwise
    updates (~82 kflop at n = 96, m = 160), plus z = A x0 and the
    residual pass (A x, A'y, P x); bytes: K^-1 and P per problem, A once,
    the vectors in and out."""
    per_it = 2 * m + 2 * m * n + 3 * n + 2 * n * n + 2 * m * n + 3 * m \
        + 4 * m + 3 * m + 3 * n
    once = m + 2 * m * n + (2 * m * n + 2 * m * n + 2 * n * n + 4 * m + 4 * n)
    flops = R * (n_iters * per_it + once)
    nbytes = 4 * (R * (2 * n * n + 3 * n + 4 * m + n + 2 * m + 4) + m * n)
    return flops, nbytes


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
    """Phase 2. Returns (max_abs_err, (ms, lo, hi), (plain_ms, lo, hi),
    (bound_ms, bound_by)) of the main path's configuration (warm,
    stop_at_eps on)."""
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
                timing = (k_ms, p_ms, bound(*k1_work(
                    B, ps.cap, ps.data.Kbar_inv.shape[0], tile, got.iters,
                    got.converged)))
    return worst, timing[0], timing[1], timing[2]


def rescue_problems(cfg, R, device, shift=0.0):
    """R support-reduced rescue QPs from the bench's phase batch (8
    problems a phase), assembled as core/mpc.solve_mpc_batch_reduced
    assembles them: (H, q, A, l, u, cone)."""
    from qrw_tpu_torch.core import mpc as tm
    N = cfg.n_steps
    phase_ids = [(3 * i) % N for i in range(R // 8)]
    xr, fs = phase_batch(cfg, phase_ids, 8, np.random.default_rng(R))
    xr[:, 0, :] += shift
    t = lambda a: torch.as_tensor(np.ascontiguousarray(
        a.transpose(2, 0, 1)), device=device)
    H, q, *_ = tm.build_qp_reduced(cfg, t(xr), t(fs), 2 * N)
    cone, A, l, u = tm.reduced_constraints(cfg, 2 * N, R, device)
    return H, q, A, l, u, cone


def round_inputs(H, q, A, l, u, cone, s, rho):
    """K^-1, rho' and sigma' of a round, as ops/qp_pallas.solve makes
    them (Ruiz with the rescue's settings, then the fresh Cholesky)."""
    from qrw_tpu_torch.ops import qp_pallas as qpp
    _, sig, rho_to_vec = qpp.precondition(H, q, A, l, u, s)
    rho_vec = rho_to_vec(rho)
    return qpp._chol_inv(qpp._build_K(H, A, rho_vec, sig, cone)), \
        rho_vec, sig


def check_rescue_kernel(cfg, device):
    """Phase 3: K2 against its plain version. Returns (max_abs_err,
    (ms, lo, hi), (plain_ms, lo, hi), (bound_ms, bound_by)) of one warm
    50-iteration round at R = 32, the rescue's shape on the main path."""
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.ops import qp_pallas as qpp
    s = ml.default_rescue_settings()
    kernel_round = qpp._run_kernel

    def plain_round(*args, tile=16):
        return qpp._run_kernel_plain(*args)

    def solve_with(round_fn, *args, **kw):
        qpp._run_kernel = round_fn           # the plain path, on purpose
        try:
            return qpp.solve(*args, **kw)
        finally:
            qpp._run_kernel = kernel_round

    worst, out = 0.0, None
    for R in RESCUE_R:
        H, q, A, l, u, cone = rescue_problems(cfg, R, device)
        H2, q2, _, _, _, _ = rescue_problems(cfg, R, device, shift=0.001)
        n, m = q.shape[1], A.shape[0]
        zeros = (torch.zeros_like(q), torch.zeros_like(l))
        rho0 = torch.full((R, 1), s.rho, device=device)
        skw = dict(cone=cone, schedule=RESCUE_SCHEDULE, early_exit=True)
        # whole rescue solves: a cold-restart lane, then a warm carry
        cold = solve_with(kernel_round, H, q, A, l, u, s, x0=zeros[0],
                          y0=zeros[1], rho_init=rho0, **skw)
        cold_p = solve_with(plain_round, H, q, A, l, u, s, x0=zeros[0],
                            y0=zeros[1], rho_init=rho0, **skw)
        wkw = dict(x0=cold.x, y0=cold.y, rho_init=cold.rho, **skw)
        warm = solve_with(kernel_round, H2, q2, A, l, u, s, **wkw)
        warm_p = solve_with(plain_round, H2, q2, A, l, u, s, **wkw)
        # single rounds on the same K^-1: cold from zero, warm from the
        # cold solution on the shifted problems
        rounds = []
        for name, P_, q_, rho, x0, y0 in [
                ("cold", H, q, rho0, *zeros),
                ("warm", H2, q2, cold.rho, cold.x, cold.y)]:
            Kinv, rho_vec, sig = round_inputs(P_, q_, A, l, u, cone, s, rho)
            args = (Kinv, P_, A, q_, l, u, rho_vec, sig, x0, y0, s.alpha,
                    RESCUE_SCHEDULE[0])
            rounds.append((name, args, kernel_round(*args),
                           qpp._run_kernel_plain(*args)))
        torch.cuda.synchronize()
        for name, got, want in [("solve cold-restart", cold, cold_p),
                                ("solve warm", warm, warm_p)]:
            n_conv = int((got.converged != want.converged).sum())
            n_it = int((got.iters != want.iters).sum())
            errs = []
            for f in ("x", "y", "z"):
                g, w = getattr(got, f), getattr(want, f)
                assert torch.isfinite(g).all(), f"K2 {name} {f} not finite"
                e = float((g - w).abs().max())
                errs.append(e)
                worst = max(worst, e)
                lim = SOLVE_TOL * max(1.0, float(w.abs().max()))
                assert e <= lim, f"K2 {name} R={R} {f}: {e:.3e} > {lim:.3e}"
            rr = (got.rho / want.rho).flatten()
            log(f"K2 qp_admm R={R} {name}: conv kernel "
                f"{float(got.converged.float().mean()):.4f} plain "
                f"{float(want.converged.float().mean()):.4f}, mean iters "
                f"{float(got.iters.float().mean()):.1f}; flag mismatches "
                f"conv {n_conv} iters {n_it}; max|dx| {errs[0]:.2e} "
                f"max|dy| {errs[1]:.2e} max|dz| {errs[2]:.2e}; rho ratio "
                f"[{float(rr.min()):.4f}, {float(rr.max()):.4f}]")
            assert n_conv == 0, f"{n_conv} converged flags differ"
            assert n_it == 0, f"{n_it} iteration counts differ"
        for name, args, got, want in rounds:
            errs = []
            for f, g, w in zip(("x", "y", "z"), got[:3], want[:3]):
                assert torch.isfinite(g).all(), f"K2 round {f} not finite"
                e = float((g - w).abs().max())
                errs.append(e)
                worst = max(worst, e)
                lim = REL_TOL * max(1.0, float(w.abs().max()))
                assert e <= lim, f"K2 round R={R} {f}: {e:.3e} > {lim:.3e}"
            flag = lambda r: ((r[3] <= s.eps_abs + s.eps_rel * r[5])
                              & (r[4] <= s.eps_abs + s.eps_rel * torch.maximum(
                                  r[6], args[3].abs().amax(dim=1))))
            n_flag = int((flag(got) != flag(want)).sum())
            k_ms = time_ms(lambda: kernel_round(*args), reps=5)
            p_ms = time_ms(lambda: qpp._run_kernel_plain(*args))
            b = bound(*k2_work(R, n, m, RESCUE_SCHEDULE[0]))
            log(f"K2 qp_admm R={R} one {RESCUE_SCHEDULE[0]}-iteration round "
                f"{name}: converged kernel {int(flag(got).sum())} plain "
                f"{int(flag(want).sum())} (mismatches {n_flag}); max|dx| "
                f"{errs[0]:.2e} max|dy| {errs[1]:.2e} max|dz| {errs[2]:.2e}; "
                f"kernel {k_ms[0]:.4f} ms [{k_ms[1]:.4f}, {k_ms[2]:.4f}] "
                f"plain {p_ms[0]:.3f} ms [{p_ms[1]:.3f}, {p_ms[2]:.3f}]; "
                f"bound {b[0]:.5f} ms ({b[1]})")
            assert n_flag == 0, f"{n_flag} round flags differ"
            if R == RESCUE_R[0] and name == "warm":
                out = (k_ms, p_ms, b)
        k_ms = time_ms(lambda: solve_with(kernel_round, H2, q2, A, l, u, s,
                                          **wkw))
        p_ms = time_ms(lambda: solve_with(plain_round, H2, q2, A, l, u, s,
                                          **wkw))
        log(f"K2 qp_admm R={R} whole warm rescue solve (Ruiz, Cholesky, "
            f"rounds): with the kernel {k_ms[0]:.3f} ms [{k_ms[1]:.3f}, "
            f"{k_ms[2]:.3f}], with the plain version {p_ms[0]:.3f} ms "
            f"[{p_ms[1]:.3f}, {p_ms[2]:.3f}]")
    return (worst,) + out


def run_rescue_path(cfg, device):
    """Phase 4: the rescue stage firing on the main path. Returns the
    K2 launches of this run."""
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.ops import qp_pallas, qp_phase
    from qrw_tpu_torch.runtime.main import rescue_capacity
    from qrw_tpu_torch.sim import fleet as fl

    cap = rescue_capacity(None, FLEET_B)
    ps = ml.build_phase_data(cfg, ml.trot_phase_fsteps(cfg), device=device)
    ctl, carry = fl.make_fleet(cfg, FLEET_B, ps, tile=TILE, seed=2,
                               device=device)
    kw = dict(tile=TILE, rescue_cap=cap, stop_at_eps=True)
    n_norm, n_crip, n_rec = RESCUE_CYCLES
    torch.cuda.synchronize()
    qp_phase.KERNEL_LAUNCHES = 0
    qp_pallas.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    carry, l1, c1 = fl.fleet_rollout(ctl, carry, n_norm, ps, n_iters=300,
                                     **kw)
    k2_0 = qp_pallas.KERNEL_LAUNCHES
    carry, l2, c2 = fl.fleet_rollout(ctl, carry, n_crip, ps, n_iters=1, **kw)
    k2_crip = qp_pallas.KERNEL_LAUNCHES - k2_0
    carry, l3, c3 = fl.fleet_rollout(ctl, carry, n_rec, ps, n_iters=300, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = qp_phase.KERNEL_LAUNCHES, qp_pallas.KERNEL_LAUNCHES
    conv = [c.converged.float().mean(dim=1).cpu().numpy() for c in
            (c1, c2, c3)]
    n_conv_crip = int(c2.converged.sum())
    h = torch.cat([l.base_pos[:, :, 2] for l in (l1, l2, l3)]).cpu().numpy()
    err = torch.cat([l.error for l in (l1, l2, l3)]).cpu().numpy()
    rescued = torch.cat([c.rescued for c in (c1, c2, c3)]).cpu().numpy()
    n_cyc = sum(RESCUE_CYCLES)
    log(f"rescue on the main path: B={FLEET_B} rescue cap {cap}, "
        f"{n_norm} normal + {n_crip} crippled (1 phase iteration) + {n_rec} "
        f"recovery cycles in {wall:.3f} s; conv per cycle normal "
        f"{np.round(conv[0], 4).tolist()} crippled "
        f"{np.round(conv[1], 4).tolist()} ({n_conv_crip} lanes converged) "
        f"recovery {np.round(conv[2], 4).tolist()}; lanes rescued per "
        f"cycle {rescued.tolist()}; K2 launches {k2} ({k2_crip} in the "
        f"crippled cycle), K1 launches {k1}; final height mean "
        f"{h[-1].mean():.4f} min {h[-1].min():.4f}; latched "
        f"{int(err.any(axis=0).sum())}")
    assert n_conv_crip == cap, f"{n_conv_crip} lanes rescued, not {cap}"
    assert int(c2.rescued[0]) == cap
    assert k2_crip >= 1, "K2 did not launch in the crippled cycle"
    assert k1 == n_cyc, f"{k1} K1 launches for {n_cyc} cycles"
    assert np.isfinite(h).all(), "non-finite base height"
    assert not err.any(), "security latch"
    up = np.abs(h[-50:] - cfg.h_ref) < 0.05
    assert up.all(), f"{int((~up.all(axis=0)).sum())} robots not upright"
    assert conv[2].mean() >= RECOVERY_BAR, f"recovery conv {conv[2].mean()}"
    return k2


def run_main_path(cfg, device):
    """Phase 5: the fleet through the entry point's functions at the
    CLI's default rescue capacity."""
    from qrw_tpu_torch.ops import qp_pallas, qp_phase
    from qrw_tpu_torch.runtime.main import rescue_capacity, run_fleet

    cap = rescue_capacity(None, FLEET_B)
    qp_phase.KERNEL_LAUNCHES = 0
    qp_pallas.KERNEL_LAUNCHES = 0
    carry, logs, cyc, wall = run_fleet(cfg, FLEET_B, TILE, 0, device,
                                       FLEET_CYCLES, cap)
    launches = qp_phase.KERNEL_LAUNCHES
    k2 = qp_pallas.KERNEL_LAUNCHES
    n_ticks = FLEET_CYCLES * cfg.k_mpc
    h = logs.base_pos[:, :, 2].cpu().numpy()
    err = logs.error.cpu().numpy()
    conv = cyc.converged.float().cpu().numpy()
    iters = cyc.iters.float().cpu().numpy()
    fired = int((cyc.rescued > 0).sum())
    ticks_s = FLEET_B * n_ticks / wall
    log(f"fleet B={FLEET_B} tile={TILE} rescue cap {cap}: {FLEET_CYCLES} "
        f"cycles = {n_ticks} ticks in {wall:.3f} s: {ticks_s:.1f} ticks/s "
        f"aggregate, {FLEET_B * FLEET_CYCLES / wall:.1f} in-loop MPC "
        f"solves/s, MPC conv {conv.mean():.4f} (per cycle "
        f"{np.round(conv.mean(axis=1), 4).tolist()}), mean iters "
        f"{iters.mean():.1f}; rescue fired in {fired} cycles; final height "
        f"mean {h[-1].mean():.4f} min {h[-1].min():.4f}; latched "
        f"{int(err.any(axis=0).sum())}; K1 launches {launches}, K2 "
        f"launches {k2}")
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
    from qrw_tpu_torch.config import Config
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

    err, k_ms, p_ms, k_bound = check_kernel(cfg, ps, device, B_KERNEL, TILE)
    err2, k2_ms, p2_ms, k2_bound = check_rescue_kernel(cfg, device)
    k2_launches = run_rescue_path(cfg, device)
    launches, _ = run_main_path(cfg, device)
    check_slice(cfg, ps, device)

    log(json.dumps({"kernels": [{
        "name": "qp_phase", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_phase.cu",
        "replaces": "qrw_tpu/ops/qp_phase.py:233",
        "launches": launches, "max_abs_err": err,
        "ms": k_ms[0], "plain_ms": p_ms[0], "bound_ms": k_bound[0],
        "bound_by": k_bound[1], "library_ms": None}, {
        "name": "qp_admm", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_admm.cu",
        "replaces": "qrw_tpu/ops/qp_pallas.py:55",
        "launches": k2_launches, "max_abs_err": err2,
        "ms": k2_ms[0], "plain_ms": p2_ms[0], "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": None}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
