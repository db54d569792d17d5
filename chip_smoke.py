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
   CUDA events (median of 7 windows, with the spread). The launch
   geometry is printed first: the grid, the cluster (blocks a tile) and
   the SMs the launch covers. The plain version is timed warm with
   stop_at_eps on. 2b: the same at cap 48 (n = 144, m = 240) on a
   phase-sorted batch of the heterogeneous fleet's union phase set
   (trot, walk, bounding), with the clusters the card holds at once.
   2c: the same at cap 64 (n = 192, m = 320, tile 32 over a cluster of
   8) on the trot -> static union set (201 classes: parity_320 --switch
   static) at B = 1024.
   2d. K1 at the JAX package's own accelerator tile, 512 problems over a
   cluster of 16 blocks: bench.py's phase-mode batch (phases 0-7 x 512,
   seed 0, B = 4096, cap 32), checked and timed as in 2, with the
   clusters the card holds at once. Then, warm with stop_at_eps on, K1
   at tile 512 and at tile 128 each against the plain version at its
   own tile, and the two tiles against each other: every lane's first
   passing check (`iters`) is the same, but a tile of 128 whose problems
   all pass stops where the tile of 512 runs on, so the tiles leave
   other iterates; the lanes and tiles that differ are counted (at
   least one). 2e: the other two shapes only a cluster of 16 holds, at
   B = 1024: cap 48 at tile 256 on the union set of 2b, cap 64 at tile
   64 on the set of 2c, checked and timed as there.
3. Kernel K2 (qrw_tpu_torch/csrc/qp_admm.cu) against its plain version
   on the card, on rescue problems assembled as
   core/mpc.solve_mpc_batch_reduced assembles them from the same phase
   batch, at R = 32 and R = 128 problems: one 50-iteration round cold
   and warm (its cone variant, which applies A by its structure, and its
   dense variant, which reads A), and the whole rescue solve (schedule
   [50, 150, 150, 100], early exit) from a cold-restart and from a warm
   carry. Flags and iteration counts must be equal, x / y / z close;
   both variants timed as in 2. Then, at both shapes (R = 128, n = 96
   and B = 1024, n = 192), the cone variant against the dense variant:
   rounds of 0 and 1 iterations that only the A products shape must be
   equal bit for bit; and whole solves from NaN- and inf-poisoned warm
   starts, kernel path against plain path, flags and counts equal.
   3d: the same K2 checks at n = 144, m = 240 (the reduced cone at
   cap 48) on rescue problems assembled from walk phases, with a K_ref
   round beside every round; the bit check and the poisoned warm starts
   run at this shape too.
   3e. The K^-1 kernel (qrw_tpu_torch/csrc/qp_kinv.cu: Cholesky and two
   triangular solves, the factor of every K2 round) on KKT matrices at
   its three shapes on the port's paths, (R, n) = (1024, 96), (2048,
   144), (256, 192): its error against the float64 inverse at most
   KINV_ERR_RATIO times the library's float32 route's; one problem made
   not positive definite all NaN and flagged, the others bit-equal;
   kernel, plain version and library timed as in 2, with the blocks an
   SM holds.
4. The rescue stage firing on the main path: a B = 1024 fleet through
   the entry point's functions at the CLI's rescue capacity (32), a few
   normal cycles, ONE crippled cycle (a 1-iteration phase solve, so
   every lane fails) in which exactly 32 lanes come back converged
   through K2, then recovery cycles: upright, no latch, convergence
   above the bar. Both kernels' counts are set to 0 just before this
   run and read just after it; K2 must have launched, and only its cone
   variant.
5. The closed-loop trot fleet through qrw_tpu_torch.runtime.main
   .run_fleet at the CLI defaults: B = 1024, 10 cycles = 100 ticks,
   rescue capacity 32, the real estimator; run_fleet runs the fleet
   twice from the same carry (warm-up, then the timed run). All heights
   finite, no latch, every robot upright over the last 50 ticks, MPC
   convergence above the bar, and exactly one K1 launch per cycle
   (counts set to 0 just before, read after).
   S1. The single-robot closed loop on the card: sim/fleet.
   hetero_shakedown_capture(cfg, "bounding") at its full 1200 ticks
   (bounding ramping to 0.4 m/s; the per-robot MPC at n = 192, m = 512
   through the per-problem ADMM of ops/qp, the per-robot WBC and
   physics). Wall time and ticks/s, MPC iterations and converged share
   per solve, the WBC QP's iterations; upright, no latch, and no launch
   of K1-K3 (the path has no kernel, as in the JAX package). Its
   capture calibrates bounding's phase classes for 5b and 6b.
   5b. The heterogeneous fleet through runtime.main.run_hetero: B = 4096,
   tile 128, 10 cycles (twice, as in 5), rescue capacity 128, the real
   estimator on flat, bumpy and stairs terrain, bounding calibrated from
   S1's capture. Every state finite, no latch, every robot upright
   (z > 0.15 m), MPC conv >= 0.85 (printed per gait), one K1 launch per
   cycle, all at cap 48, and no K2 launch but the cone variant's at
   n = 144. Then one crippled cycle from its carry fires the rescue (128
   lanes, K2 at n = 144; counts set to 0 just before) and two recovery
   cycles follow.
6. The whole slice with the kernel against the whole slice with the
   plain solver: B = 128, 2 cycles, from one carry. 6b: the same for
   the heterogeneous slice at B = 384 (3 tiles, one a gait) on S1's
   calibrated phase set.
   S2. The CLI's default mode (runtime.main.run_single) at --batch 256
   for 300 ticks with the default perturbations: robot-ticks/s, the
   final height (mean, minimum), no latch, no kernel launch.
   S3. One 20-tick rollout of 2 robots from one carry on the card and
   on the CPU through the port, float32 and float64, every log leaf
   compared with the CPU parity tests' tolerances.
   E1. The solver parity tool, python -m qrw_tpu_torch.eval.parity_320,
   in-process on the card: --cycles 32 (the trot), then --cycles 32
   --switch static (the union phase set at cap 64); a cut in depth from
   320 cycles, at the tool's own width (B = 1, N = 16). Each run's JSON
   is printed; relaxed conv >= 0.95, the torque error under its budget,
   every cycle matched to a phase class, K2 (cone variant, n = 192) and
   K3 launched at least once a warm cycle, K1 at cap 32 (trot) or only
   at cap 64 (switch).
   E2. The CLI's --fleet-mpc 4096 and --fleet-mpc 8192 (10 warm cycles
   each) in the JAX entry point's layout at its tile of 512: 1024
   problems over phases 0 and 8, then all 16 phases at 512 each.
   solves/s and conv >= 0.9, one K1 launch a cycle plus the cold solve,
   every one at tile 512.
   E3. The CLI's --sweep on its full 9 x 5 grid for 600 ticks (cut from
   1500): cells that succeeded, the largest vx error, no kernel launch.
   E4. S3 with the 18-state Kalman estimator (cfg.kf_enabled), and the
   card's ms a tick.
   E5. The CLI's --estimator-demo --kf for 200 ticks: the metrics.
   D0-D6, the DDP MPC backends (ops/ilqr, core/mpc_ddp,
   core/mpc_ddp_planner, eval/compare; each phase asserts that it
   launched none of K1-K3, as in qrw_tpu, where they reach no
   pl.pallas_call; on the card solve_mpc_ddp takes its derivatives from
   one launch of csrc/ddp_derivs.cu an iteration and its initial rollout
   and line searches from one launch each of csrc/ddp_linesearch.cu, the
   planner keeps torch.func and the plain line search).
   D0. The DDP derivatives kernel at the DDP cell's shape (B = 32,768 x
   N = 16 rows): the rows of a warm solve's first iteration, its float32
   outputs against the plain version's (DERIVS_TOL32 of scale, off the
   shoulder penalty's kink) and both against float64; the kernel, the
   plain version and the torch.func route timed, the bound in bytes.
   D0b. The DDP line-search kernel at the same shape (9 step sizes): a
   warm solve's first iteration, its float32 result and the plain
   version's against the float64 plain version (cost error, share of
   trajectories within 1e-4 of scale, the same accept as the plain
   version on 99% of problems and wherever rounding cannot decide, the
   new iterate within 1e-4 of scale of the plain version's there, the
   old one kept bit for bit on a reject, the states the rollout of the
   controls and the cost theirs); the kernel and the plain version
   timed, the bound in bytes.
   D1. bench.py::run_ddp_bench through the port: B = 1024 trot problems
   of build_batch(cfg, B, default_rng(11)), one warm-started batched
   DDP solve a cycle, 1 warm-up and 10 timed cycles: solves/s, ms a
   solve, one derivatives kernel launch an iteration, torch ops a solve
   (non-view ops: launches), the mean total fz
   of the last cycle's first node within 2 N of qrw_tpu's value for the
   cell (DDP_FZ_REF), all finite; a B = 8 slice cold and warm on the
   card and on the CPU, float64 and float32 (DDP_TOL).
   D2. The CLI's --ddp (type_MPC = False) through runtime.main, 100
   ticks (cut from 400): ms a tick; final |h - h_ref| < 0.05 and no
   latch (the JAX package's tests/test_mpc_ddp.py:175-187).
   D3. The planner (mpc_planner) through runtime.main.run_single, 100
   ticks, the same bars (tests/test_mpc_planner.py:97-109).
   D4. The every-tick DDP (mpc_every_tick), 20 ticks (cut from the JAX
   test's 300), one DDP solve a tick, the same bars
   (tests/test_mpc_ddp.py:144-158).
   D5. S3 for the DDP backend and for the planner, 11 ticks (cut from
   20): card against CPU, every log leaf, the CPU parity tests' bars
   (the plan in float64 at 1e-7 of scale: tests/test_torch_ddp_loop.py;
   the planner run's every leaf, PLANNER_TOL64).
   D6. eval/compare on the card: a float64 capture of 150 ticks (cut
   from 400), the cycles from 10 on re-solved by both backends, cold
   and warm in the loop: fz means within 2 N of mg/4 and
   force_rmse_mean < 3 N (tests/test_aux.py:62-85).
   H1-H7, the host runtime, and U1-U4, the utilities (no kernel on
   these paths in either package; each phase asserts K1-K3 launched 0
   times).
   H1. runtime/ipc: the library built with g++ from
   qrw_tpu_torch/csrc/qrw_ipc.cpp; 200 mailbox round trips across a
   spawned process (median, max); the pacer's lateness over 200 periods
   of 2 ms and its overruns, at its default spin tail (100 us) and then
   at spin tails of 100 us, 500 us and 1 ms with no work in the loop.
   H2. sim/device.SimDevice on the card, float32 and float64: a 50-tick
   PD hold of q_init (height within 0.05 of 0.24 m), put_on_the_floor
   for 0.2 s (gap < 0.15 rad), the float64 hold against the CPU (S3's
   float64 bar); ms a tick.
   H3. runtime/host_loop.run_host_loop, 120 ticks (trot, default
   Config): no abort, latch or timeout, |z - h_ref| < 0.06 m, |tau_ff|
   < tau_security; ms a tick. The startup abort (joints 0.8 rad off:
   one tick), and 40 ticks driven by a SyntheticGamepad through the
   spawned reader with a clone device (clone q = primary q).
   H4. run_host_loop_pipelined(depth=2), 120 ticks: upright, the
   periods' p50 and p99.
   H5. runtime.main --host-loop --realtime --ticks 50 in-process (with
   its 2.5 s damping shutdown): the pacer's overruns and lateness. No
   real-time bar: the tick is host-bound at ~100 ms (PERF.md section 5).
   H6. runtime/mpc_service.MPCService on the card: the spawned worker's
   start-up seconds, three round trips, the plan against a direct
   float64 solve_mpc on the card (1e-9 of scale), the stale read, stop.
   H7. A 120-tick float32 rollout replayed from its logged commands
   (runtime/replay.replay): base_pos against the rollout's (REPLAY_TOL32).
   U1. utils/profiling.stage_timings on the card: ms per stage.
   U2. A checkpoint at tick 20 (utils/checkpoint), resumed 20 ticks:
   bit-equal to the run without the round trip.
   U3. utils/viz.mpc_predictions of H7's logs (12 cycles, float64) on
   the card against the CPU (1e-9 of scale).
   U4. runtime.main --batch 8 --mesh --ticks 50 (parallel/mesh, NCCL,
   world size 1) against the unsharded --batch 8, every log leaf equal;
   scenario_metrics through the NCCL all-reduce against the plain
   reductions.
7. Kernel K3 against its plain version on full-size problems (n = 192)
   of the entry point's build_batch at B = 1024, both variants: the
   resident one (qrw_tpu_torch/csrc/qp_ns_refine_tc.cu, 3xTF32 on the
   tensor cores, a cluster of two blocks a problem), which n = 192
   takes, and the general one (qrw_tpu_torch/csrc/qp_ns_refine.cu).
   Three Newton-Schulz steps from a good seed (the inverse of a 0.1 mm
   earlier state) and from rolled-stance seeds (they diverge), no step
   from the good seed. X, resid, the finite pattern and the bad flags
   compared; both variants, the plain version and the chain of torch.bmm
   products timed at B = 4096 with CUDA events.
8. Kernel K2 at the full shape n = 192, m = 512 against its plain
   version at B = 1024: one 50-iteration round cold and warm, one K_ref
   round, and whole solves, cold, then warm under "ns", "chol" and
   "stale". Flags and iteration counts equal except on the problems,
   counted and printed, whose K3 bad flag differed between the paths,
   whose adapted rho differs (cold solves), or whose termination
   residual lies within 2x of its threshold ("stale" and "ns"); timed
   at B = 4096.
9. The whole full-size path (core/mpc.solve_mpc_batch_pallas) with the
   kernels against it with the plain versions at B = 512: cold, then
   warm "ns" and "stale" from the kernel path's carry, compared as in 8.
10. The entry point at full width: qrw_tpu_torch.eval.kernel_profile at
   B = 4096, reps 5, tiles 16. Cold and warm-"ns" conv >= 0.99, K2 and
   K3 launch counts as worked out (counts set to 0 just before, read
   just after; no launch of K2's dense variant nor of K3's general
   variant), then one call per policy with every output finite (and,
   for "ns" 1, the plain path's conv beside the kernels'). Then
   one warm "ns" 50-iteration call at B = 4096 split into its stages
   (build, cone check, K assembly, K3, top-k and Cholesky, K2, recovery,
   glue), each between synchronizations, timed with CUDA events.

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

from qrw_tpu_torch import kernels

B_KERNEL = 1024
TILE = 128
FLEET_B = 1024
FLEET_CYCLES = 10
SLICE_B = 128
SLICE_CYCLES = 2
HETERO_B = 4096                 # the heterogeneous fleet at full width
HETERO_CYCLES = 10              # bench.py's hetero cell (bench.py:440)
HETERO_SLICE_B = 384            # 3 tiles, one a gait
HETERO_GAITS = ("trot", "walk", "bounding")     # make_hetero_fleet's
# MPC convergence bar of the heterogeneous fleet: the JAX package's own
# test (tests/test_fleet_hetero.py:39) holds its mixed fleet above 0.85.
HETERO_CONV_BAR = 0.85
BATCH_B = 256                   # S2: the CLI's --batch at full width
BATCH_TICKS = 300               # S2: 30 MPC cycles
S3_TICKS = 20                   # S3: card against CPU
DERIVS_B = 32768                # D0: the DDP cell's batch (B N rows)
LS_TIE = 4e-6                   # D0b: a tie of costs, a share of their scale
# D0: the derivatives kernel's float32 outputs against the plain
# version's, as a share of each output's scale, on the rows farther than
# DERIVS_KINK_M from the shoulder penalty's kink (tests/
# test_torch_ddp_derivs_card.py states the bar)
DERIVS_TOL32 = 4e-6
DERIVS_KINK_M = 1e-5
DDP_B = 1024                    # D1: bench.py::run_ddp_bench's batch
DDP_CYCLES = 10                 # D1: its warm cycles (bench.py:499)
DDP_SLICE_B = 8                 # D1: card against CPU
# D1's mean total fz of the first node after the 11 cycles: qrw_tpu's
# own value for this cell, 28.83 N (`python tests/torch_ddp_cell.py`,
# float32 on the CPU; the port gives 28.831 N there). Not mg
# (24.52 N): the cell's references ask for forward speeds up to 1 m/s,
# and the traction that takes inside the inner friction cone needs
# normal force. Bar: within 2 N of it.
DDP_FZ_REF = 28.83
# The DDP phases are host-bound (0.7-1.2 s a DDP solve on the card,
# PERF.md §6), so their depth is cut to keep the script inside its time
# limit:
DDP_TICKS = 100                 # D2, D3: cut from the JAX tests' 400
EVERY_TICK_TICKS = 20           # D4: cut from the JAX test's 300 ticks
D5_TICKS = 11                   # D5: cut from S3's 20 (2 MPC solves)
COMPARE_TICKS = 150             # D6: cut from tests/test_aux.py's 400 ...
COMPARE_SKIP = 10               # ... compared from its cycle 10 on
# D1's card-against-CPU bars on the B = 8 slice, as fractions of each
# leaf's scale (plans and warm starts; costs): float64 plans at
# 1e-8, costs at the CPU tests' 1e-9 (tests/test_torch_ddp.py: a
# one-ulp accept flip moved a plan by 1.3e-8 of scale at most there);
# float32 plans at the CPU tests' 1e-3 (measured there 3.0e-4), costs
# at 1e-4: the first card run measured 1.04e-5 of scale on cost_trace
# (NVIDIA H100 80GB HBM3, 700.00 W), where the two devices' float32
# reductions let the line search take another alpha
DDP_TOL = {torch.float64: (1e-8, 1e-9), torch.float32: (1e-3, 1e-4)}
# the float64 bars of the card-against-CPU rollouts (D5): the DDP run's
# plan at 1e-7 of scale, as in tests/test_torch_ddp_loop.py; the
# planner's every leaf at 1e-7: its plan sets the swing feet's targets,
# so a one-ulp accept flip of its iLQR reaches every leaf downstream
# (the first card run measured 2.55e-9 of scale on feet_a_cmd; NVIDIA
# H100 80GB HBM3, 700.00 W)
DDP_PLAN_TOL64 = {"x_f_mpc": 1e-7}
PLANNER_TOL64 = {"default": 1e-7}
CAP64_TILE = 32                 # K1's tile at cap 64 over a cluster of 8
# The shapes that only a cluster of 16 blocks holds: cap 32 at the JAX
# package's accelerator tile (bench.py's phase mode and --fleet-mpc),
# checked on bench.py's phase-mode batch (run_phase_mode: phases 0-7 x
# 512 at B = 4096); cap 48 at tile 256 and cap 64 at tile 64 at B = 1024.
TILE512 = 512
TILE512_B = 4096
TILE512_PHASES = list(range(8))
CAP48_TILE16 = 256
CAP64_TILE16 = 64
PARITY_CYCLES = 32              # E1: parity_320 cut from 320 cycles
PARITY_ARGV = (["--cycles", str(PARITY_CYCLES)],
               ["--cycles", str(PARITY_CYCLES), "--switch", "static"])
# E1's bars: the JAX tool's own budget on the torque error (its JSON's
# torque_budget_Nm), and the relaxed chain's convergence over a capture
# (qrw_tpu's 320-cycle trot measured 1.0, PARITY.md, TPU v5e history)
PARITY_CONV_BAR = 0.95
FLEET_MPC_BS = (4096, 8192)     # E2: --fleet-mpc at the bench's width,
                                # and the first batch with all 16 phases
FLEET_MPC_CYCLES = 10           # the CLI's --fleet-cycles default
SWEEP_TICKS = 600               # E3: --sweep cut from 1500 ticks
DEMO_TICKS = 200                # E5: --estimator-demo cut from 3000 ticks
RESCUE_R = (32, 128)            # K2 batch sizes: B // 32 at B = 1024, 4096
RESCUE_SCHEDULE = [50, 150, 150, 100]
RESCUE_CYCLES = (2, 1, 5)       # normal, crippled, recovery cycles
FULL_B = 1024                   # full-size K3 / K2 comparisons
# the K^-1 kernel's shapes on the port's paths: the rolled batch's rescue
# (R = B // 32 at 32,768), the fleet's (n = 144 at 65,536), the full-size
# batch's Cholesky fallback (max(8, B // 32) at 8,192)
KINV_SHAPES = (("rolled rescue", 1024, 96), ("fleet rescue", 2048, 144),
               ("full-size fallback", 256, 192))
# its float32 error against float64 may be at most this many times the
# library's float32 Cholesky and solves' on the same problems
KINV_ERR_RATIO = 4.0
FULL_TIME_B = 4096              # the entry point's batch: kernel timings
PATH_B = 512                    # whole full-size path, kernels vs plain
PROFILE_ARGV = ["--batch", "4096", "--reps", "5", "--tiles", "16"]
# Launches of the entry point at PROFILE_ARGV, per --tiles label
# (qrw_tpu_torch/eval/kernel_profile.py): the cold solve's 3 rounds
# (schedule [50, 200, 200] at max_iter 450, interval 200), then 4
# policies x (1 warm-up + 5 timed) one-round warm calls, each one K2
# launch; "ns" 50, "ns" 1 and "stale" seed round 0 from the carried
# K^-1, one K3 launch each (ns_iters 3, 3 and 0), "chol" none.
PROFILE_K2_LAUNCHES = 3 + 4 * 6
PROFILE_K3_LAUNCHES = 3 * 6
# Cold and warm-"ns" conv of the entry point at B = 4096. The JAX
# package's own full-size run measured cold 0.9983 and warm 0.9959
# (BENCH_r02.json, conv only, TPU v5e history).
FULL_CONV_BAR = 0.99
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
# Dense TF32 on the tensor cores: K3's resident variant takes each float32
# product as three TF32 products (3xTF32), so its bound counts 3 TF32
# operations for every float32 one at this rate.
PEAK_TF32_FLOPS = 495e12
# Kernel vs plain version, both float32 on the card: the same update
# equations with a different summation order in the two dense products.
# The iteration is contractive, so the rounding difference stays near
# float32 epsilon times the iterate scale (2e-6 measured for the plain
# version against the Pallas kernel in tests/test_torch_qp_phase.py);
# 1e-4 of each array's largest entry leaves a wide margin.
REL_TOL = 1e-4
# K1's early iterates, kernel against plain on every lane. At cap 48 the
# lanes that diverge into the safeguard box (check_kernel) are chaotic:
# on the CPU a 1e-7 relative change of q moves their x after 300
# iterations by 91 N in the plain version alone, and by 6.3e-4 N after 10
# iterations, where it moves the other lanes by 1.5e-5 N (B = 1024 of
# phase 2b; tests/test_torch_qp_phase.py::test_diverging_lanes_are_chaotic
# holds a smaller batch to the same picture). After 10 iterations every
# lane is held to REL_TOL, 16x that change.
EARLY_ITERS = 10
# Whole rescue solves, kernel path against plain path: a few rounds, each
# from its own Cholesky of K, and an OSQP rho adaptation between rounds
# that reads the primal residual at its float32 round-off floor, so the
# two paths may adapt rho differently (tests/test_torch_qp_pallas.py).
# Both end at the same optimum within the 1e-4 termination tolerance;
# 1e-3 of each array's largest entry holds them to a tenth of it.
SOLVE_TOL = 1e-3
# Whole COLD full-size solves, kernel path against plain path: the two
# rho adaptations read primal residuals at the float32 round-off floor
# (ROADMAP queue 3), so the paths take different iterates; each ends
# within OSQP's 1e-4 tolerances, which on these KKT systems (condition
# ~1e7) leave low-curvature force directions free by a few percent of the
# ~12 N stance force. tests/test_qp_pallas.py holds two converged solvers
# of the same problems to 0.25 N; 1e-2 of the largest entry (25 N) is
# that bound. Warm solves from one carry (no adaptation) keep SOLVE_TOL.
COLD_SOLVE_TOL = 1e-2
# Whole warm "ns" solves, kernel path against plain path: K3's resident
# variant rounds K^-1 as 3xTF32 (within 1.4e-6 of its scale of cuBLAS's,
# phase 7, both at the round-off floor of max|K X - I|), and from two
# inverses that differ by rounding the round's ADMM iterations take
# different iterates: max|dx| 3.6e-2 of a 25 N scale (1.4e-3) at
# B = 1024 and 3.0e-2 at B = 512 on the card, over SOLVE_TOL. Neither
# path is the more accurate, so they are held to the bound for two
# solvers of the same problems, COLD_SOLVE_TOL (0.25 N).
NS_SOLVE_TOL = COLD_SOLVE_TOL
# K3 against its plain version (torch.matmul, cuBLAS in float32). The
# resident variant takes each float32 product as three TF32 products
# (3xTF32), which round differently from a float32 FMA chain. A CPU
# emulation of its operand rounding (tests/test_torch_qp_full.py::
# test_ns_refine_3xtf32_emulation) measured max|dX| 1.3e-6 of max|X| from
# good seeds (the same at B = 256) and 3.0e-6 (4.3e-6 at B = 256) from the
# rolled-stance seeds, whose divergence amplifies it over three steps;
# the kernel adds each k-step's products into its sums in float32, so
# the card matches it (1.4e-6 and 2.9e-6 at B = 1024). 1e-5 of max|X| is
# 2.3x the worst; the general variant (float32 FMAs in k order, found
# bit-equal to cuBLAS on the card) is held to the same bound.
NS_TOL = 1e-5
# The residual max|K X - I|: after three steps from a good seed it sits at
# the float32 round-off floor (~7e-7), where any other rounding moves it
# by its own size (emulation: 7.2e-7 absolute, 0.75 relative; 1.0e-6 at
# B = 256). It is held to 1e-4 relative or 1e-5 absolute, whichever is
# larger: 10x the emulated difference, 1000x below _factor's 1e-2 guard.
NS_RESID_REL = 1e-4
NS_RESID_ABS = 1e-5


def log(msg):
    print(msg, flush=True)


class Clock:
    """The script's wall time, printed as each group of phases ends."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def lap(self, what):
        now = time.perf_counter()
        log(f"wall: {what} {now - self.t:.1f} s (script {now - self.t0:.1f}"
            " s)")
        self.t = now


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operation time at the
    float32 peak and the byte time at the memory rate."""
    t_op = flops / PEAK_F32_FLOPS * 1e3
    t_b = nbytes / PEAK_BYTES_S * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def bound_3xtf32(flops, nbytes):
    """(bound_ms, bound_by) of a float32-accurate product chain on the
    tensor cores: 3 TF32 operations per float32 operation at the TF32
    peak, or the bytes at the memory rate, whichever is larger."""
    t_op = 3 * flops / PEAK_TF32_FLOPS * 1e3
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


def k2_work(R, n, m, n_iters, k_ref=False):
    """Operations and bytes of one K2 launch: per problem-iteration the
    products A'w, K^-1 b and A xt (2mn + 2n^2 + 2mn) and the elementwise
    updates (~82 kflop at n = 96, m = 160, ~0.47 Mflop at n = 192,
    m = 512), with k_ref two refinement steps more (K xt and K^-1 r,
    2n^2 each, twice: 8n^2, and their 4n elementwise operations), plus
    z = A x0 and the residual pass (A x, A'y, P x); bytes: K^-1 and P
    (and K) per problem, A once, the vectors in and out."""
    per_it = 2 * m + 2 * m * n + 3 * n + 2 * n * n + 2 * m * n + 3 * m \
        + 4 * m + 3 * m + 3 * n
    if k_ref:
        per_it += 8 * n * n + 4 * n
    once = m + 2 * m * n + (2 * m * n + 2 * m * n + 2 * n * n + 4 * m + 4 * n)
    flops = R * (n_iters * per_it + once)
    mats = 3 if k_ref else 2
    nbytes = 4 * (R * (mats * n * n + 3 * n + 4 * m + n + 2 * m + 4)
                  + m * n)
    return flops, nbytes


def k2_cone_work(R, n, m, n_iters, cone, k_ref=False):
    """Operations and bytes of one K2 launch when A is the cone matrix,
    the least work for the function: per problem-iteration K^-1 b (2n^2),
    the two structured products A'w and A xt (2 flop for each of the 9
    nonzeros of a 5 x 3 block, and 1 an identity row) and the elementwise
    updates, with k_ref 8n^2 + 4n more; plus z = A x0 and the residual
    pass (A x, A'y, P x); bytes: K^-1 and P (and K) per problem, the
    vectors in and out, no A."""
    from qrw_tpu_torch.ops import qp_pallas as qpp
    desc = qpp.cone_description(cone)
    a_prod = 18 * desc.n_blocks + (n if desc.kind == qpp.CONE_FULL else 0)
    per_it = 2 * n * n + 2 * a_prod + 12 * m + 6 * n
    if k_ref:
        per_it += 8 * n * n + 4 * n
    once = a_prod + (2 * a_prod + 2 * n * n + 4 * m + 4 * n)
    flops = R * (n_iters * per_it + once)
    mats = 3 if k_ref else 2
    nbytes = 4 * R * (mats * n * n + 3 * n + 4 * m + n + 2 * m + 4)
    return flops, nbytes


def k3_work(B, n, ns_iters):
    """Operations and bytes of one K3 launch: 2 ns_iters + 1 products of
    n x n matrices (2 n^3 each) and the 2 n^2 of the update and the
    residual; bytes: K and X0 read, X and resid written."""
    flops = B * ((2 * ns_iters + 1) * 2 * n ** 3 + 2 * ns_iters * n * n
                 + 2 * n * n)
    return flops, 4 * B * (3 * n * n + 1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_batch(cfg, phase_ids, per_phase, rng, phase_fs=None):
    """bench.py::phase_batch in numpy: xrefs (12, N+1, B), fsteps
    (N_gait, 12, B), B = len(phase_ids) * per_phase; phase_fs: the phase
    set's footsteps (default the trot's)."""
    from qrw_tpu_torch.core import mpc_lane as ml
    N = cfg.n_steps
    if phase_fs is None:
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


def k1_near_threshold(args, kw, got, want, lanes):
    """Of `lanes`, those whose termination test, at the earlier of the
    kernel's and the plain version's passing checks, reads the plain
    version's residual within a factor 2 of its threshold: the lane
    passes at twice OSQP's tolerances and fails at half of them. A lane
    there may pass one check earlier with one rounding than with the
    other (on the CPU a 1e-7 relative change of q moves 0-3 of B = 4096
    lanes of phase 2b by one check)."""
    from qrw_tpu_torch.ops import qp_phase
    c = torch.minimum(got.iters, want.iters)
    near = torch.zeros_like(lanes)
    for ci in sorted(set(c[lanes].tolist())):
        kc = dict(kw, n_iters=int(ci), stop_at_eps=False)
        wide = qp_phase.solve_plain(*args, eps_abs=2e-4, eps_rel=2e-4, **kc)
        tight = qp_phase.solve_plain(*args, eps_abs=5e-5, eps_rel=5e-5,
                                     **kc)
        near |= lanes & (c == ci) & wide.converged & ~tight.converged
    return near


def check_kernel(cfg, ps, device, B, tile, phase_fs=None, phase_ids=None):
    """Phase 2 (and 2b at cap 48 with the union set's phase_fs; phase_ids,
    one a tile, default every second class, or every seventh of a union
    set so that it reaches every gait). Returns
    (max_abs_err, (ms, lo, hi), (plain_ms, lo, hi), (bound_ms, bound_by),
    extra) of the main path's configuration (warm, stop_at_eps on);
    extra holds the launch geometry, the warm stop_at_eps-off time, the
    most lanes excused and the early iterates' largest error. The plain
    version is timed in that configuration only.

    At cap 48 the bench's speeds (up to 1 m/s) take some walk problems
    out of the shared metric's reach: they diverge into the safeguard
    box, where the iteration is chaotic, so that two roundings of the
    same problem end tens of newtons apart (EARLY_ITERS says how far).
    Lanes that neither path converged are then excused from the
    300-iteration value comparison and counted (at most 5% of B); every
    lane, those included, is compared after EARLY_ITERS iterations.
    Converged flags stay equal on every lane; iteration counts on every
    lane but those excused and those near the tolerance
    (k1_near_threshold), counted."""
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.ops import qp_phase

    geo = qp_phase.launch_geometry(ps.cap, tile, B)
    n_cl = qp_phase.max_active_clusters(tile, B, ps.cap)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sms = min(geo.grid, n_cl * geo.cluster)     # one block an SM
    log(f"K1 launch geometry cap={ps.cap} B={B} tile={tile}: grid "
        f"{geo.grid} blocks in "
        f"clusters of {geo.cluster} (one cluster a tile), "
        f"{geo.problems_per_block} problems and {geo.threads} threads a "
        f"block, {geo.smem_bytes} B of shared memory a block; the card "
        f"holds {n_cl} such clusters at once: {sms} of {n_sm} SMs covered")
    assert sms >= min(geo.grid, 64), f"K1 covers {sms} SMs"
    extra = {"grid": geo.grid, "cluster": geo.cluster, "sms": sms,
             "clusters_resident": n_cl, "threads": geo.threads,
             "smem_bytes": geo.smem_bytes}
    n_phases = B // tile
    n_set = ps.data.Kbar_inv.shape[0]
    step = 2 if phase_fs is None else 7     # the union set: every gait
    if phase_ids is None:
        phase_ids = [(step * i) % n_set for i in range(n_phases)]
    assert len(phase_ids) == n_phases, (phase_ids, n_phases)
    xr, fs = phase_batch(cfg, phase_ids, tile, np.random.default_rng(0),
                         phase_fs)
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
            keep = (got.converged | want.converged
                    if phase_fs is not None else
                    torch.ones_like(got.converged))
            n_exc = int((~keep).sum())
            # iteration counts that differ: on lanes neither path
            # converged (chaotic), or where the earlier passing check
            # read a residual near its threshold
            it_diff = (got.iters != want.iters) & keep
            near = k1_near_threshold(args, kw, got, want, it_diff)
            n_near = int(near.sum())
            n_it_bad = int((it_diff & ~near).sum())
            extra["excused"] = max(extra.get("excused", 0), n_exc)
            assert n_exc <= 0.05 * B, f"{n_exc} lanes diverged"
            for f in ("x", "y", "z"):
                g, w = getattr(got, f), getattr(want, f)
                assert torch.isfinite(g).all(), f"kernel {f} not finite"
                g, w = g[:, keep], w[:, keep]
                e = float((g - w).abs().max())
                scale = max(1.0, float(w.abs().max()))
                errs[f] = e
                worst = max(worst, e)
                assert e <= REL_TOL * scale, (
                    f"kernel vs plain {f}: {e:.3e} > {REL_TOL} * {scale:.3g}")
            early = ""
            if not stop:        # no termination check before 25 iterations
                e_kw = dict(kw, n_iters=EARLY_ITERS)
                ge = qp_phase.solve(*args, **e_kw)
                we = qp_phase.solve_plain(*args, **e_kw)
                torch.cuda.synchronize()
                for f in ("x", "y", "z"):
                    g, w = getattr(ge, f), getattr(we, f)
                    e = float((g - w).abs().max())
                    scale = max(1.0, float(w.abs().max()))
                    early += f" max|d{f}| {e:.2e}"
                    extra["early_max_abs_err"] = max(
                        extra.get("early_max_abs_err", 0.0), e)
                    assert e <= REL_TOL * scale, (
                        f"kernel vs plain {f} after {EARLY_ITERS} "
                        f"iterations: {e:.3e} > {REL_TOL} * {scale:.3g}")
                early = (f"; after {EARLY_ITERS} iterations, every lane:"
                         + early)
            k_ms = time_ms(lambda: qp_phase.solve(*args, **kw), reps=3)
            p_ms = (time_ms(lambda: qp_phase.solve_plain(*args, **kw))
                    if warm and stop else (float("nan"),) * 3)
            log(f"K1 qp_phase cap={ps.cap} B={B} tile={tile} warm={warm} "
                f"stop_at_eps={stop}: conv kernel "
                f"{float(got.converged.float().mean()):.4f} plain "
                f"{float(want.converged.float().mean()):.4f}, mean iters "
                f"{float(got.iters.float().mean()):.1f}; flag mismatches "
                f"conv {n_conv} iters {n_it} (near the tolerance {n_near}, "
                f"unexcused {n_it_bad}); lanes excused (neither "
                f"path converged) {n_exc}; max|dx| {errs['x']:.2e} "
                f"max|dy| {errs['y']:.2e} max|dz| {errs['z']:.2e}{early}; "
                f"kernel {k_ms[0]:.3f} ms [{k_ms[1]:.3f}, {k_ms[2]:.3f}] "
                f"plain {p_ms[0]:.3f} ms [{p_ms[1]:.3f}, {p_ms[2]:.3f}] "
                f"(median [min, max] of 7 windows)")
            assert n_conv == 0, f"{n_conv} converged flags differ"
            assert n_it_bad == 0, f"{n_it_bad} iteration counts differ"
            extra["iters_near"] = extra.get("iters_near", 0) + n_near
            if warm and stop:
                timing = (k_ms, p_ms, bound(*k1_work(
                    B, ps.cap, ps.data.Kbar_inv.shape[0], tile, got.iters,
                    got.converged)))
            elif warm:
                extra["stop_off_ms"] = k_ms[0]
    return worst, timing[0], timing[1], timing[2], extra


def check_tile_answer(cfg, ps, device, B=TILE512_B, small=TILE):
    """Phase 2d, second part: on bench.py's phase-mode batch, warm from a
    cold plain solve on a 1 mm shift, stop_at_eps on, K1 at tile 512
    (a cluster of 16) and at tile `small` (a cluster of 8), each against
    the plain version at its own tile (flags equal, iteration counts
    equal but for k1_near_threshold's, x / y / z within REL_TOL). Then
    the two tiles against each other. A lane's `iters` is its first
    passing check, which the tile does not change; what the tile changes
    is where a tile stops: a tile of `small` whose problems all pass
    exits there, while the tile of 512 that holds it runs on for the
    problems that have not passed. Counted: the lanes whose x moved by
    more than REL_TOL of the largest entry, and the small tiles that
    exited early; at least one lane must differ. Returns the counts."""
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.ops import qp_phase

    xr, fs = phase_batch(cfg, TILE512_PHASES, B // len(TILE512_PHASES),
                         np.random.default_rng(0))
    xr2 = xr.copy()
    xr2[:, 0, :] += 0.001
    t = lambda a: torch.as_tensor(a, device=device)
    sols = {}
    for tile in (TILE512, small):
        phases_of = torch.as_tensor(
            np.repeat(TILE512_PHASES, B // len(TILE512_PHASES) // tile),
            dtype=torch.int32, device=device)
        prob = lambda x: [a.contiguous() for a in ml.phase_problem(
            cfg, t(x), t(fs), ps, phases_of, tile)[3:5]]
        if tile == TILE512:
            BlS, q = prob(xr)
            cold = qp_phase.solve_plain(q, BlS, ps.data, phases_of,
                                        tile=tile)
        BlS, q = prob(xr2)
        args = (q, BlS, ps.data, phases_of)
        kw = dict(n_iters=300, tile=tile, stop_at_eps=True,
                  x0=cold.x.contiguous(), y0=cold.y.contiguous())
        got = qp_phase.solve(*args, **kw)
        want = qp_phase.solve_plain(*args, **kw)
        torch.cuda.synchronize()
        it_diff = got.iters != want.iters
        near = k1_near_threshold(args, kw, got, want, it_diff)
        errs = {f: float((getattr(got, f) - getattr(want, f)).abs().max())
                for f in ("x", "y", "z")}
        log(f"K1 tile {tile} vs plain at tile {tile}, B={B} warm "
            f"stop_at_eps=True: conv {float(got.converged.float().mean()):.4f}"
            f"; flag mismatches conv "
            f"{int((got.converged != want.converged).sum())} iters "
            f"{int(it_diff.sum())} (near the tolerance {int(near.sum())}); "
            + " ".join(f"max|d{f}| {e:.2e}" for f, e in errs.items()))
        assert bool((got.converged == want.converged).all())
        assert not bool((it_diff & ~near).any())
        for f, e in errs.items():
            scale = max(1.0, float(getattr(want, f).abs().max()))
            assert e <= REL_TOL * scale, (tile, f, e, scale)
        sols[tile] = got
    a, b = sols[TILE512], sols[small]
    exited = b.converged.reshape(-1, small).all(dim=1)
    one_exited = a.converged.reshape(-1, TILE512).all(dim=1)
    dx = (a.x - b.x).abs().amax(dim=0)
    moved = dx > REL_TOL * max(1.0, float(a.x.abs().max()))
    n_it = int((a.iters != b.iters).sum())
    n_moved = int(moved.sum())
    log(f"K1 tile {TILE512} vs tile {small} on the same {B} problems (warm, "
        f"stop_at_eps): lanes whose iters differ {n_it} (the first "
        f"passing check does not depend on the tile); tiles that exited "
        f"early: {int(one_exited.sum())} of {len(one_exited)} at tile "
        f"{TILE512}, {int(exited.sum())} of {len(exited)} at tile {small}; "
        f"lanes whose x differs by more than {REL_TOL} of its scale "
        f"{n_moved} (max {float(dx.max()):.3e}), in tiles of {small} that "
        f"exited early {int(moved.reshape(-1, small)[exited].sum())}")
    assert n_it == 0 and n_moved >= 1, (n_it, n_moved)
    return dict(lanes_differ=n_moved, iters_differ=n_it,
                small_tiles_exited=int(exited.sum()),
                tiles512_exited=int(one_exited.sum()))


def rescue_problems(cfg, R, device, shift=0.0, gait="trot"):
    """R support-reduced rescue QPs from the bench's phase batch (8
    problems a phase), assembled as core/mpc.solve_mpc_batch_reduced
    assembles them: (H, q, A, l, u, cone). gait "trot": cap 2N (n = 96,
    m = 160); "walk": walk phases at the union set's cap 3N (n = 144,
    m = 240), the rescue of the heterogeneous fleet."""
    from qrw_tpu_torch.core import mpc as tm
    from qrw_tpu_torch.core import mpc_lane as ml
    N = cfg.n_steps
    cap = 2 * N if gait == "trot" else 3 * N
    phase_ids = [(3 * i) % N for i in range(R // 8)]
    xr, fs = phase_batch(cfg, phase_ids, 8, np.random.default_rng(R),
                         ml.gait_phase_fsteps(cfg, gait))
    xr[:, 0, :] += shift
    t = lambda a: torch.as_tensor(np.ascontiguousarray(
        a.transpose(2, 0, 1)), device=device)
    H, q, *_ = tm.build_qp_reduced(cfg, t(xr), t(fs), cap)
    cone, A, l, u = tm.reduced_constraints(cfg, cap, R, device)
    return H, q, A, l, u, cone


def round_inputs(H, q, A, l, u, cone, s, rho):
    """K^-1, rho' and sigma' of a round, as ops/qp_pallas.solve makes
    them (Ruiz with the rescue's settings, then the fresh Cholesky)."""
    from qrw_tpu_torch.ops import qp_pallas as qpp
    _, sig, rho_to_vec = qpp.precondition(H, q, A, l, u, s)
    rho_vec = rho_to_vec(rho)
    return qpp._chol_inv(qpp._build_K(H, A, rho_vec, sig, cone)), \
        rho_vec, sig


def check_rescue_kernel(cfg, device, gait="trot"):
    """Phase 3 (3d with gait "walk": n = 144): K2 against its plain
    version. Returns (max_abs_err, (ms, lo, hi), (plain_ms, lo, hi),
    (bound_ms, bound_by), variants) of one warm 50-iteration round at
    R = 32, the rescue's shape on the main path. With gait "walk" every
    round is also run as a K_ref round (variants["k_ref"])."""
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.ops import qp_pallas as qpp
    s = ml.default_rescue_settings()
    kernel_round = qpp._run_kernel

    def plain_round(*args, tile=16, K=None, cone=None):
        return qpp._run_kernel_plain(*args, K=K)

    def solve_with(round_fn, *args, **kw):
        qpp._run_kernel = round_fn           # the plain path, on purpose
        try:
            return qpp.solve(*args, **kw)
        finally:
            qpp._run_kernel = kernel_round

    worst, out, variants = 0.0, None, {}
    k_ref = gait != "trot"
    for R in RESCUE_R:
        H, q, A, l, u, cone = rescue_problems(cfg, R, device, gait=gait)
        H2, q2, _, _, _, _ = rescue_problems(cfg, R, device, shift=0.001,
                                             gait=gait)
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
            rounds.append((name, args, kernel_round(*args, cone=cone),
                           qpp._run_kernel_plain(*args),
                           kernel_round(*args)))
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
            log(f"K2 qp_admm n={n} R={R} {name}: conv kernel "
                f"{float(got.converged.float().mean()):.4f} plain "
                f"{float(want.converged.float().mean()):.4f}, mean iters "
                f"{float(got.iters.float().mean()):.1f}; flag mismatches "
                f"conv {n_conv} iters {n_it}; max|dx| {errs[0]:.2e} "
                f"max|dy| {errs[1]:.2e} max|dz| {errs[2]:.2e}; rho ratio "
                f"[{float(rr.min()):.4f}, {float(rr.max()):.4f}]")
            assert n_conv == 0, f"{n_conv} converged flags differ"
            assert n_it == 0, f"{n_it} iteration counts differ"
        for name, args, got, want, dense in rounds:
            errs = []
            for f, g, w, d in zip(("x", "y", "z"), got[:3], want[:3],
                                  dense[:3]):
                assert torch.isfinite(g).all(), f"K2 round {f} not finite"
                e = float((g - w).abs().max())
                e_d = float((d - w).abs().max())
                errs.append(e)
                worst = max(worst, e)
                lim = REL_TOL * max(1.0, float(w.abs().max()))
                assert e <= lim, f"K2 round R={R} {f}: {e:.3e} > {lim:.3e}"
                assert e_d <= lim, f"K2 dense R={R} {f}: {e_d:.3e} > {lim:.3e}"
            flag = lambda r: ((r[3] <= s.eps_abs + s.eps_rel * r[5])
                              & (r[4] <= s.eps_abs + s.eps_rel * torch.maximum(
                                  r[6], args[3].abs().amax(dim=1))))
            n_flag = int((flag(got) != flag(want)).sum())
            n_flag_d = int((flag(dense) != flag(want)).sum())
            k_ms = time_ms(lambda: kernel_round(*args, cone=cone), reps=5)
            d_ms = time_ms(lambda: kernel_round(*args), reps=5)
            p_ms = time_ms(lambda: qpp._run_kernel_plain(*args))
            b = bound(*k2_cone_work(R, n, m, RESCUE_SCHEDULE[0], cone))
            b_d = bound(*k2_work(R, n, m, RESCUE_SCHEDULE[0]))
            log(f"K2 qp_admm n={n} R={R} one {RESCUE_SCHEDULE[0]}-iteration round "
                f"{name}: converged cone kernel {int(flag(got).sum())} plain "
                f"{int(flag(want).sum())} (mismatches {n_flag}, dense "
                f"kernel {n_flag_d}); max|dx| {errs[0]:.2e} max|dy| "
                f"{errs[1]:.2e} max|dz| {errs[2]:.2e}; cone kernel "
                f"{k_ms[0]:.4f} ms [{k_ms[1]:.4f}, {k_ms[2]:.4f}] (bound "
                f"{b[0]:.5f} ms, {b[1]}), dense kernel {d_ms[0]:.4f} ms "
                f"[{d_ms[1]:.4f}, {d_ms[2]:.4f}] (bound {b_d[0]:.5f} ms), "
                f"plain {p_ms[0]:.3f} ms [{p_ms[1]:.3f}, {p_ms[2]:.3f}]")
            assert n_flag == 0, f"{n_flag} round flags differ"
            assert n_flag_d == 0, f"{n_flag_d} dense round flags differ"
            if name == "warm":
                variants[R] = {"cone": variant(k_ms, b),
                               "dense": variant(d_ms, b_d)}
            if k_ref:
                # the refinement variant on the same round, K as built
                Kmat = qpp._build_K(args[1], A, args[6], args[7], cone)
                gr = kernel_round(*args, K=Kmat, cone=cone)
                wr = qpp._run_kernel_plain(*args, K=Kmat)
                torch.cuda.synchronize()
                er = [float((g - w).abs().max()) for g, w in
                      zip(gr[:3], wr[:3])]
                for f, e, w in zip("xyz", er, wr[:3]):
                    lim = REL_TOL * max(1.0, float(w.abs().max()))
                    assert e <= lim, f"K2 K_ref R={R} {f}: {e:.3e} > {lim:.3e}"
                    worst = max(worst, e)
                n_flag_r = int((flag(gr) != flag(wr)).sum())
                r_ms = time_ms(lambda: kernel_round(*args, K=Kmat,
                                                    cone=cone), reps=5)
                rp_ms = time_ms(lambda: qpp._run_kernel_plain(*args,
                                                              K=Kmat))
                b_r = bound(*k2_cone_work(R, n, m, RESCUE_SCHEDULE[0], cone,
                                          k_ref=True))
                log(f"K2 qp_admm n={n} R={R} K_ref round {name}: converged "
                    f"kernel {int(flag(gr).sum())} plain "
                    f"{int(flag(wr).sum())} (mismatches {n_flag_r}); "
                    f"max|dx| {er[0]:.2e} max|dy| {er[1]:.2e} max|dz| "
                    f"{er[2]:.2e}; kernel {r_ms[0]:.4f} ms [{r_ms[1]:.4f}, "
                    f"{r_ms[2]:.4f}] (bound {b_r[0]:.5f} ms, {b_r[1]}), "
                    f"plain {rp_ms[0]:.3f} ms")
                assert n_flag_r == 0, f"{n_flag_r} K_ref round flags differ"
                if name == "warm":
                    variants[R]["k_ref"] = variant(r_ms, b_r)
                    variants[R]["k_ref"]["plain_ms"] = rp_ms[0]
            if R == RESCUE_R[0] and name == "warm":
                out = (k_ms, p_ms, b)
        k_ms = time_ms(lambda: solve_with(kernel_round, H2, q2, A, l, u, s,
                                          **wkw))
        p_ms = time_ms(lambda: solve_with(plain_round, H2, q2, A, l, u, s,
                                          **wkw))
        log(f"K2 qp_admm n={n} R={R} whole warm rescue solve (Ruiz, Cholesky, "
            f"rounds): with the kernel {k_ms[0]:.3f} ms [{k_ms[1]:.3f}, "
            f"{k_ms[2]:.3f}], with the plain version {p_ms[0]:.3f} ms "
            f"[{p_ms[1]:.3f}, {p_ms[2]:.3f}]")
    return (worst,) + out + (variants,)


def variant(ms, b):
    """A kernel variant's entry of the kernels line: time, bound, share."""
    return {"ms": ms[0], "bound_ms": b[0], "bound_by": b[1],
            "share": b[0] / ms[0]}


def check_cone_bits(cfg, device):
    """Phase 3b: K2's cone variant against its dense variant on the same
    inputs, at both shapes. Rounds of 0 and 1 iterations (and 1 with
    K_ref) with K^-1 = K = I, P = 0, sigma' = q = 0 and alpha = 1, so that
    z = A x0 (0 iterations) and x = A'(-y0) (1 iteration from x0 = 0) and
    every other output are made by the A products alone: all must be
    equal bit for bit on these finite inputs. Then one real 50-iteration
    round: the two variants' largest difference."""
    from qrw_tpu_torch.ops import qp_pallas as qpp
    rng = np.random.default_rng(7)
    for label, (H, q, A, l, u, cone) in [
            ("R=128 n=96 m=160", rescue_problems(cfg, 128, device)),
            ("R=128 n=144 m=240", rescue_problems(cfg, 128, device,
                                                  gait="walk")),
            (f"B={FULL_B} n=192 m=512", full_problems(cfg, FULL_B, device))]:
        B, n = q.shape
        m = A.shape[0]
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        eye = torch.eye(n, device=device).expand(B, n, n).contiguous()
        P0 = torch.zeros((B, n, n), device=device)
        z_n = torch.zeros((B, n), device=device)
        rho = t(rng.uniform(0.05, 2.0, (B, m)))
        x0 = t(rng.normal(scale=10.0, size=(B, n)))
        y0 = t(rng.normal(scale=10.0, size=(B, m)))
        n_out = 0
        for iters, xw, Kr in ((0, x0, None), (1, z_n, None), (1, z_n, eye)):
            args = (eye, P0, A, z_n, l, u, rho, z_n, xw, y0, 1.0, iters)
            got = qpp._run_kernel(*args, K=Kr, cone=cone)
            want = qpp._run_kernel(*args, K=Kr)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert bool(torch.isfinite(w).all()), "non-finite output"
                n_diff = int((g != w).sum())
                assert n_diff == 0, (f"cone vs dense {label} {iters} it: "
                                     f"{n_diff} outputs differ")
                n_out += g.numel()
        # z = A x0 against the float64 product, as a check of the inputs
        z64 = x0.double() @ A.double().T
        got0 = qpp._run_kernel(eye, P0, A, z_n, l, u, rho, z_n, x0, y0, 1.0,
                               0, cone=cone)
        e64 = float((got0[2].double() - z64).abs().max())
        # a real round: the two variants sum K^-1 b in different orders
        s = full_settings()
        Kinv, rho_vec, sig = round_inputs(H, q, A, l, u, cone, s, torch.full(
            (B, 1), s.rho, device=device))
        args = (Kinv, H, A, q, l, u, rho_vec, sig, torch.zeros_like(q),
                torch.zeros_like(l), s.alpha, 50)
        got = qpp._run_kernel(*args, cone=cone)
        want = qpp._run_kernel(*args)
        torch.cuda.synchronize()
        errs = [float((g - w).abs().max()) for g, w in zip(got[:3], want[:3])]
        scale = max(1.0, max(float(w.abs().max()) for w in want[:3]))
        log(f"K2 cone vs dense {label}: rounds of 0, 1 and 1 (K_ref) "
            f"iterations through the A products alone: {n_out} outputs, "
            f"all bit-equal; |A x0 - float64| {e64:.2e}; a real 50-iteration "
            f"round: max|dx| {errs[0]:.2e} max|dy| {errs[1]:.2e} max|dz| "
            f"{errs[2]:.2e} (scale {scale:.3g})")
        assert max(errs) <= REL_TOL * scale, f"cone vs dense round {errs}"


def check_cone_nonfinite(cfg, device):
    """Phase 3c: whole solves from a NaN-poisoned and an inf-poisoned warm
    start, K2's cone path against the plain path, at both shapes: solve
    resets the non-finite entries to zero, so converged flags and
    iteration counts must agree as on a clean start."""
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.ops import qp_pallas as qpp
    rs = ml.default_rescue_settings()
    rescues = []
    for gait in ("trot", "walk"):
        H, q, A, l, u, cone = rescue_problems(cfg, RESCUE_R[0], device,
                                              gait=gait)
        R, n = q.shape
        rescues.append((
            f"R={R} n={n} rescue solve", (H, q, A, l, u), rs,
            dict(cone=cone, schedule=RESCUE_SCHEDULE, early_exit=True,
                 rho_init=torch.full((R, 1), rs.rho, device=device)),
            torch.zeros_like(q), torch.zeros_like(l)))
    fs = full_settings()
    H, q, A, l, u, cone = full_problems(cfg, FULL_B, device)
    with solver_path("kernel"):
        cold = qpp.solve(H, q, A, l, u, fs, cone=cone)
    full = (f"B={FULL_B} n=192 warm \"chol\" solve", (H, q, A, l, u), fs,
            dict(cone=cone, schedule=[50], rho_init=cold.rho,
                 precond=cold.precond, kinv_init=cold.kinv,
                 kinv_rho=cold.kinv_rho, refactor="chol"),
            cold.x, cold.y)
    for label, prob, s, kw, x0, y0 in rescues + [full]:
        for poison in (float("nan"), float("inf")):
            xp, yp = x0.clone(), y0.clone()
            xp[::3, 0] = poison
            xp[1::3, -1] = -poison
            yp[::2, 1] = poison
            with solver_path("kernel") as kp:
                got = qpp.solve(*prob, s, x0=xp, y0=yp, **kw)
            with solver_path("plain") as pp:
                want = qpp.solve(*prob, s, x0=xp, y0=yp, **kw)
            torch.cuda.synchronize()
            compare_solves(f"K2 cone {label} from a {poison}-poisoned warm "
                           f"start", got, want, kp, pp, SOLVE_TOL)


def kinv_work(B, n):
    """Operations and bytes of one K^-1 launch: n^3 flop a problem (an SPD
    inverse as LAPACK counts potrf + potri); K read and K^-1 written."""
    return B * n ** 3, 8 * B * n * n


def kinv_problems(cfg, B, n, device):
    """B KKT matrices (B, n, n) at the settings' rho, assembled as
    qp_pallas.solve assembles them: the trot rescue's (n = 96), the walk
    rescue's (n = 144) or the full-size batch's (n = 192)."""
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.ops import qp_pallas as qpp
    if n == 192:
        return full_kkt(*full_problems(cfg, B, device))[0]
    H, q, A, l, u, cone = rescue_problems(
        cfg, B, device, gait="trot" if n == 96 else "walk")
    s = ml.default_rescue_settings()
    _, sig, rho_to_vec = qpp.precondition(H, q, A, l, u, s)
    rho = torch.full((B, 1), s.rho, device=device)
    return qpp._build_K(H, A, rho_to_vec(rho), sig, cone).contiguous()


def check_kinv_kernel(cfg, device):
    """Phase 3e: the K^-1 kernel (csrc/qp_kinv.cu) at the three shapes the
    port gives it, on KKT matrices. Its error against the float64 inverse
    of (K + K') / 2 is held to KINV_ERR_RATIO times the library's float32
    error (torch.linalg.cholesky + cholesky_solve, the port's route before
    the kernel); one problem made not positive definite comes back all NaN
    and flagged while the others keep their bits. Times the kernel, its
    plain version and the library. Returns {"B<B>_n<n>": entry}."""
    from qrw_tpu_torch.ops import qp_pallas as qpp
    out = {}
    for label, B, n in KINV_SHAPES:
        K = kinv_problems(cfg, B, n, device)
        launches = launched(KINV)
        X, nonpd = qpp._kinv_launch(K)
        assert launched(KINV) == launches + 1
        K64 = K.double()
        K64 = (K64 + K64.transpose(1, 2)) / 2
        eye = torch.eye(n, device=device).expand(B, n, n)
        X64 = torch.cholesky_solve(eye.double(), torch.linalg.cholesky(K64))
        library = lambda: torch.cholesky_solve(  # noqa: E731
            eye, torch.linalg.cholesky((K + K.transpose(1, 2)) / 2))
        scale = X64.abs().amax(dim=(1, 2))
        err = lambda Y: float(((Y.double() - X64).abs().amax(dim=(1, 2))
                               / scale).max())
        plain, plain_bad = qpp._chol_inv_plain(K)
        e_k, e_lib, e_plain = err(X), err(library()), err(plain)
        assert int(nonpd.sum()) == 0 and not bool(plain_bad.any())
        assert e_k <= KINV_ERR_RATIO * e_lib, (label, e_k, e_lib)
        j = B // 2
        Kb = K.clone()
        Kb[j, n // 2, n // 2] = -1.0      # a negative pivot
        Xb, nb = qpp._kinv_launch(Kb)
        others = torch.arange(B, device=device) != j
        assert nb.tolist() == [int(i == j) for i in range(B)], label
        assert bool(torch.isnan(Xb[j]).all()), label
        assert torch.equal(Xb[others], X[others]), label
        k_ms = time_ms(lambda: qpp._kinv_launch(K))
        p_ms = time_ms(lambda: qpp._chol_inv_plain(K))
        l_ms = time_ms(library)
        b_ms, b_by = bound(*kinv_work(B, n))
        blocks = qpp.kinv_blocks_per_sm(n)
        log(f"K^-1 kernel ({label}) B={B} n={n}: {blocks} blocks an SM; "
            f"rel. err vs float64 "
            f"{e_k:.3e} (library {e_lib:.3e}, plain {e_plain:.3e}); "
            f"non-PD problem all NaN, the others bit-equal; "
            f"{k_ms[0]:.4f} ms [{k_ms[1]:.4f}-{k_ms[2]:.4f}] (bound "
            f"{b_ms:.4f} ms, {b_by}: {100 * b_ms / k_ms[0]:.1f}%), plain "
            f"{p_ms[0]:.4f} ms, library {l_ms[0]:.4f} ms")
        out[f"B{B}_n{n}"] = {
            "path": label, "ms": k_ms[0], "plain_ms": p_ms[0],
            "library_ms": l_ms[0], "bound_ms": b_ms, "bound_by": b_by,
            "share": b_ms / k_ms[0], "rel_err": e_k,
            "library_rel_err": e_lib, "blocks_per_sm": blocks}
        del K, K64, X64, X, Xb, Kb, plain
        torch.cuda.empty_cache()
    return out


def run_rescue_path(cfg, device):
    """Phase 4: the rescue stage firing on the main path. Returns the
    K2 launches of this run."""
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.runtime.main import rescue_capacity
    from qrw_tpu_torch.sim import fleet as fl

    cap = rescue_capacity(None, FLEET_B)
    ps = ml.build_phase_data(cfg, ml.trot_phase_fsteps(cfg), device=device)
    ctl, carry = fl.make_fleet(cfg, FLEET_B, ps, tile=TILE, seed=2,
                               device=device)
    kw = dict(tile=TILE, rescue_cap=cap, stop_at_eps=True)
    n_norm, n_crip, n_rec = RESCUE_CYCLES
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    carry, l1, c1 = fl.fleet_rollout(ctl, carry, n_norm, ps, n_iters=300,
                                     **kw)
    k2_0 = launched(*K2)
    carry, l2, c2 = fl.fleet_rollout(ctl, carry, n_crip, ps, n_iters=1, **kw)
    k2_crip = launched(*K2) - k2_0
    carry, l3, c3 = fl.fleet_rollout(ctl, carry, n_rec, ps, n_iters=300, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, k2_dense = launched(K1), launched(*K2), launched(K2_DENSE)
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
        f"crippled cycle; {k2_dense} of the dense variant), K1 launches "
        f"{k1}; final height mean "
        f"{h[-1].mean():.4f} min {h[-1].min():.4f}; latched "
        f"{int(err.any(axis=0).sum())}")
    assert n_conv_crip == cap, f"{n_conv_crip} lanes rescued, not {cap}"
    assert int(c2.rescued[0]) == cap
    assert k2_crip >= 1, "K2 did not launch in the crippled cycle"
    assert k2_dense == 0, f"{k2_dense} launches of K2's dense variant"
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
    from qrw_tpu_torch.runtime.main import rescue_capacity, run_fleet

    cap = rescue_capacity(None, FLEET_B)
    kernels.reset_launches()
    carry, logs, cyc, wall, first = run_fleet(cfg, FLEET_B, TILE, 0, device,
                                              FLEET_CYCLES, cap)
    launches, k2 = launched(K1), launched(*K2)
    n_ticks = FLEET_CYCLES * cfg.k_mpc
    h = logs.base_pos[:, :, 2].cpu().numpy()
    err = logs.error.cpu().numpy()
    conv = cyc.converged.float().cpu().numpy()
    iters = cyc.iters.float().cpu().numpy()
    fired = int((cyc.rescued > 0).sum())
    ticks_s = FLEET_B * n_ticks / wall
    log(f"fleet B={FLEET_B} tile={TILE} rescue cap {cap} (real estimator, "
        f"the CLI's default): {FLEET_CYCLES} cycles = {n_ticks} ticks in "
        f"{wall:.3f} s (first run {first:.3f} s): {ticks_s:.1f} ticks/s "
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
    assert launches == 2 * FLEET_CYCLES, (
        f"{launches} kernel launches for twice {FLEET_CYCLES} cycles")
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
    compare_slices("slice", SLICE_B, lk, ck, lp, cp)


def compare_slices(label, B, lk, ck, lp, cp):
    """Kernel run (lk, ck) against plain run (lp, cp) of the same slice:
    logs close, solver flags and iteration counts equal, no latch."""
    tol = {"base_pos": 1e-4, "base_quat": 1e-4, "f_mpc": 1e-2,
           "tau_ff": 1e-2}
    parts = []
    for f, rel in tol.items():
        a, b = getattr(lk, f), getattr(lp, f)
        e = float((a - b).abs().max())
        lim = rel * max(1.0, float(b.abs().max()))
        parts.append(f"{f} {e:.2e} (limit {lim:.2e})")
        assert e <= lim, f"{label} kernel vs plain {f}: {e:.3e} > {lim:.3e}"
    n_flag = int((ck.converged != cp.converged).sum()
                 + (ck.iters != cp.iters).sum())
    log(f"{label} B={B} {SLICE_CYCLES} cycles, kernel vs plain: "
        + ", ".join(parts) + f"; solver flag mismatches {n_flag}")
    assert n_flag == 0, "converged/iters differ between kernel and plain"
    assert not bool(lk.error.any()), f"security latch in the {label} run"


# The kernels' functions whose launches kernels.LAUNCHES counts: K1 by
# (cap, tile); K2's cone and dense variants, K3's resident and general
# variants and K^-1 by n; the DDP derivatives by itemsize
K1 = "qrw_qp_phase_solve"
K2_CONE, K2_DENSE = "qrw_qp_admm_cone_solve", "qrw_qp_admm_solve"
K3_RESIDENT, K3_GENERAL = "qrw_ns_refine_tc", "qrw_ns_refine"
K2, K3 = (K2_CONE, K2_DENSE), (K3_RESIDENT, K3_GENERAL)
KINV, DERIVS = "qrw_kinv", "qrw_ddp_derivs"
LINESEARCH = "qrw_ddp_linesearch"


def launched(*fns) -> int:
    """Launches of the functions `fns` since kernels.reset_launches()."""
    return sum(v for (f, _), v in kernels.launches().items() if f in fns)


def caps(k1_launches) -> dict:
    """K1's launches {(cap, tile): n} summed by cap."""
    out = {}
    for (cap, _), v in k1_launches.items():
        out[cap] = out.get(cap, 0) + v
    return out


def run_hetero_path(cfg, device, calibration):
    """Phase 5b: the heterogeneous fleet at full width through the CLI's
    functions (run_hetero: a warm-up run, then a timed run from the same
    initial carry), with bounding calibrated from the shakedown capture
    of S1, then one crippled cycle and two recovery cycles from its
    final carry, so that the rescue fires at n = 144. Returns (K1
    launches of the CLI run, K2 launches of the crippled run, ticks/s)."""
    from qrw_tpu_torch.runtime.main import (hetero_summary,
                                            rescue_capacity, run_hetero)
    from qrw_tpu_torch.sim import fleet as fl

    cap = rescue_capacity(None, HETERO_B)
    kernels.reset_launches()
    carry, cyc, meta, wall, first = run_hetero(
        cfg, HETERO_B, TILE, 0, device, HETERO_CYCLES, cap,
        calibration=calibration)
    k1, k1_caps = launched(K1), caps(kernels.launches(K1))
    k2, k2_dense, k2_n = (launched(*K2), launched(K2_DENSE),
                          dict(kernels.launches(K2_CONE)))
    sm = hetero_summary(carry, cyc, meta, TILE)
    n_ticks = HETERO_CYCLES * cfg.k_mpc
    ticks_s = HETERO_B * n_ticks / wall
    conv_c = cyc.converged.float().mean(dim=1).cpu().numpy()
    conv_g = {g: round(v, 4) for g, v in sm["conv_per_gait"].items()}
    log(f"hetero fleet B={HETERO_B} tile={TILE} rescue cap {cap} (real "
        f"estimator, bounding calibrated from the shakedown capture): "
        f"{HETERO_CYCLES} cycles = "
        f"{n_ticks} ticks in {wall:.3f} s (first run {first:.3f} s): "
        f"{ticks_s:.1f} ticks/s aggregate; MPC conv {sm['conv']:.4f} (per "
        f"gait {conv_g}; per cycle {np.round(conv_c, 4).tolist()}), lanes "
        f"rescued "
        f"{sm['rescued']}; upright {sm['upright']:.4f} per gait "
        f"{sm['per_gait']} per terrain {sm['per_terrain']}; latched "
        f"{sm['latched']}; launches over both runs: K1 {k1} by cap "
        f"{k1_caps}, K2 {k2} (dense {k2_dense}, cone by n {k2_n})")
    assert sm["finite"] and bool(torch.isfinite(carry.sim_states.q).all()), \
        "non-finite state"
    assert sm["latched"] == 0, "security latch"
    assert sm["upright"] == 1.0, f"upright {sm['upright']}"
    assert sm["conv"] >= HETERO_CONV_BAR, f"MPC conv {sm['conv']:.4f}"
    assert k1 == 2 * HETERO_CYCLES and k1_caps == {48: k1}, (k1, k1_caps)
    assert k2_dense == 0 and set(k2_n) <= {144}, (k2_dense, k2_n)

    # the rescue fired deterministically: one crippled cycle
    ctl, _, ps, terrain, meta = fl.make_hetero_fleet(
        cfg, HETERO_B, tile=TILE, seed=0, device=device,
        calibration=calibration)
    sched = fl.hetero_v_ref_schedule(cfg, meta.velID,
                                     (HETERO_CYCLES + 3) * cfg.k_mpc,
                                     device=device)[n_ticks:]
    kw = dict(tile=TILE, rescue_cap=cap, stop_at_eps=True, terrain=terrain,
              phase_offsets=meta.phase_offsets,
              phase_periods=meta.phase_periods, perfect_estimator=False,
              with_logs=False)
    T = cfg.k_mpc
    kernels.reset_launches()
    carry, _, c2 = fl.fleet_rollout(ctl, carry, 1, ps, n_iters=1,
                                    v_ref_schedule=sched[:T], **kw)
    torch.cuda.synchronize()
    k1c, k2c, k2c_dense = launched(K1), launched(*K2), launched(K2_DENSE)
    k2c_n = dict(kernels.launches(K2_CONE))
    carry, _, c3 = fl.fleet_rollout(ctl, carry, 2, ps, n_iters=300,
                                    v_ref_schedule=sched[T:], **kw)
    sm3 = hetero_summary(carry, c3, meta, TILE)
    log(f"hetero rescue firing: 1 crippled cycle (1 phase iteration): "
        f"{int(c2.rescued[0])} lanes rescued, {int(c2.converged.sum())} "
        f"converged; K1 {k1c}, K2 {k2c} launches (dense {k2c_dense}, cone "
        f"by n {k2c_n}); 2 recovery cycles: conv {sm3['conv']:.4f}, upright "
        f"{sm3['upright']:.4f}, latched {sm3['latched']}")
    assert int(c2.rescued[0]) == cap, f"{int(c2.rescued[0])} lanes rescued"
    assert k2c >= 1 and k2c_dense == 0 and k2c_n == {144: k2c}, k2c_n
    assert sm3["finite"] and sm3["latched"] == 0, "recovery failed"
    return k1, k2c, ticks_s


def check_hetero_slice(cfg, device, calibration):
    """Phase 6b: the heterogeneous slice with the kernel against it with
    the plain solver: B = 384 (3 tiles, one a gait), 2 cycles, from one
    carry, on the fleet's terrain with the real estimator and the phase
    set calibrated from S1's capture."""
    from qrw_tpu_torch.ops import qp_phase
    from qrw_tpu_torch.sim import fleet as fl

    ctl, carry, ps, terrain, meta = fl.make_hetero_fleet(
        cfg, HETERO_SLICE_B, tile=TILE, seed=1, device=device,
        calibration=calibration)
    sched = fl.hetero_v_ref_schedule(cfg, meta.velID,
                                     SLICE_CYCLES * cfg.k_mpc, device=device)
    kw = dict(tile=TILE, n_iters=300, stop_at_eps=True, terrain=terrain,
              phase_offsets=meta.phase_offsets,
              phase_periods=meta.phase_periods, perfect_estimator=False,
              v_ref_schedule=sched)
    _, lk, ck = fl.fleet_rollout(ctl, carry, SLICE_CYCLES, ps, **kw)
    kernel_solve = qp_phase.solve
    qp_phase.solve = qp_phase.solve_plain       # the plain path, on purpose
    try:
        _, lp, cp = fl.fleet_rollout(ctl, carry, SLICE_CYCLES, ps, **kw)
    finally:
        qp_phase.solve = kernel_solve
    compare_slices("hetero slice", HETERO_SLICE_B, lk, ck, lp, cp)


# ----------------------------------------------------------------------
# The single-robot closed loop (no kernel: the per-problem ADMM)
# ----------------------------------------------------------------------

class SolveLog:
    """Records, while active, the iteration counts and converged flags
    of every per-robot MPC solve and WBC box-QP solve, and the logs of
    every rollout, without reading the device."""

    def __enter__(self):
        from qrw_tpu_torch.core import mpc, wbc
        from qrw_tpu_torch.sim import rollout
        self.mpc, self.wbc, self.runs = [], [], []
        self._orig = (mpc.solve_mpc, wbc.compute_wbc, rollout.rollout)

        def solve_mpc(*a, **k):
            r = self._orig[0](*a, **k)
            self.mpc.append((r.iters, r.converged))
            return r

        def compute_wbc(*a, **k):
            r = self._orig[1](*a, **k)
            self.wbc.append(r.qp_iters)
            return r

        def run(*a, **k):
            out = self._orig[2](*a, **k)
            self.runs.append(out)
            return out

        mpc.solve_mpc, wbc.compute_wbc, rollout.rollout = (
            solve_mpc, compute_wbc, run)
        return self

    def __exit__(self, *exc):
        from qrw_tpu_torch.core import mpc, wbc
        from qrw_tpu_torch.sim import rollout
        mpc.solve_mpc, wbc.compute_wbc, rollout.rollout = self._orig

    def summary(self):
        """(MPC iterations (solves, B), converged (solves, B), WBC QP
        iterations (ticks, B)) in numpy."""
        it = torch.stack([i for i, _ in self.mpc]).cpu().numpy()
        cv = torch.stack([c for _, c in self.mpc]).cpu().numpy()
        return it, cv, torch.stack(self.wbc).cpu().numpy()


def assert_no_kernel(label):
    """The single-robot path launches none of K1-K3."""
    n = (launched(K1), launched(*K2), launched(*K3))
    log(f"{label}: kernel launches K1 {n[0]}, K2 {n[1]}, K3 {n[2]}")
    assert n == (0, 0, 0), n


def run_shakedown(cfg, device):
    """S1: hetero_shakedown_capture(cfg, "bounding") on the card at its
    full 1200 ticks: the single-robot closed loop, B = 1, at full width
    (n = 192, m = 512 per MPC solve). Returns the capture, which
    calibrates the heterogeneous fleet's bounding classes (phase 5b)."""
    from qrw_tpu_torch.sim import fleet as fl

    kernels.reset_launches()
    with SolveLog() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        capture = fl.hetero_shakedown_capture(cfg, "bounding", device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert_no_kernel("S1 shakedown capture")
    (_, logs), = rec.runs
    it, cv, wit = rec.summary()
    n_ticks = logs.base_pos.shape[0]
    h = logs.base_pos[:, 2].cpu().numpy()
    latched = bool(logs.error.any())
    log(f"S1 shakedown capture (bounding to 0.4 m/s, B = 1): {n_ticks} "
        f"ticks in {wall:.3f} s: {n_ticks / wall:.1f} ticks/s, "
        f"{1e3 * wall / n_ticks:.2f} ms a tick; {it.shape[0]} MPC solves: "
        f"iterations mean {it.mean():.1f} min {int(it.min())} max "
        f"{int(it.max())}, converged share {cv.mean():.4f}; WBC QP "
        f"iterations mean {wit.mean():.1f} max {int(wit.max())}; height "
        f"min {h.min():.4f} final {h[-1]:.4f}; latched {latched}; capture "
        f"{tuple(capture.shape)}")
    assert capture.shape == (n_ticks // cfg.k_mpc, cfg.N_gait, 12)
    assert np.isfinite(capture).all() and np.isfinite(h).all()
    assert not latched, "security latch in the shakedown run"
    assert (np.abs(h - cfg.h_ref) < 0.1).all(), "not upright"
    assert cv.mean() >= CONV_BAR, f"MPC converged share {cv.mean():.4f}"
    return capture, n_ticks / wall


def run_batch_path(cfg, device):
    """S2: the CLI's default mode at --batch 256 for 300 ticks, with the
    default perturbations, through runtime.main's functions."""
    from qrw_tpu_torch.runtime import main as cli

    args = cli.build_argparser().parse_args(
        ["--batch", str(BATCH_B), "--ticks", str(BATCH_TICKS)])
    bcfg = cfg.replace(N_SIMULATION=BATCH_TICKS)
    kernels.reset_launches()
    with SolveLog() as rec:
        _, logs, wall = cli.run_single(bcfg, args, device, torch.float32)
        code = cli.single_summary(bcfg, args, logs, wall)
    assert_no_kernel("S2 --batch")
    it, cv, wit = rec.summary()
    h = logs.base_pos[:, -1, 2].cpu().numpy()
    n_lat = int(logs.error[:, -1].sum())
    ticks_s = BATCH_B * BATCH_TICKS / wall
    log(f"S2 --batch {BATCH_B} x {BATCH_TICKS} ticks in {wall:.3f} s: "
        f"{ticks_s:.1f} robot-ticks/s ({BATCH_TICKS / wall:.1f} ticks/s); "
        f"final height mean {h.mean():.4f} min {h.min():.4f}; latched "
        f"{n_lat}; MPC iterations mean {it.mean():.1f}, converged share "
        f"{cv.mean():.4f}; WBC QP iterations mean {wit.mean():.1f}")
    assert code == 0 and n_lat == 0, "security latch"
    assert np.isfinite(h).all() and (np.abs(h - cfg.h_ref) < 0.05).all()
    assert cv.mean() >= CONV_BAR, f"MPC converged share {cv.mean():.4f}"
    return ticks_s


# tolerances of the CPU parity tests (tests/test_torch_rollout.py), as
# fractions of each leaf's scale; float32 leaves not listed: 1e-3, the
# plan's far horizon (x_f_mpc) is held in float64 only
CARD_CPU_TOL32 = {"base_pos": 1e-5, "base_quat": 1e-5}
CARD_CPU_TOL64 = 1e-9


def check_card_vs_cpu(cfg, device, label="S3", tol64=None, n_ticks=None):
    """S3: one 20-tick rollout of B = 2 robots from one carry, on the
    card and on the CPU through the port, in float32 and float64;
    compared per log leaf with the CPU parity tests' tolerances (tol64:
    float64 bars by leaf, the key "default" for every other leaf,
    CARD_CPU_TOL64 without it). E4 runs it
    with cfg.kf_enabled (the Kalman estimator), D5 with the DDP backends
    for n_ticks. Returns the card's ms a tick per dtype."""
    from qrw_tpu_torch.convert import tree_map
    from qrw_tpu_torch.sim.rollout import make_rollout, rollout

    n_ticks = S3_TICKS if n_ticks is None else n_ticks
    tol64 = tol64 or {}
    worst = {}
    tick_ms = {}
    for dtype in (torch.float32, torch.float64):
        ctl, carry = make_rollout(cfg, dtype=dtype, device="cpu")
        carry = tree_map(lambda a: a.expand((2,) + tuple(a.shape)).clone(),
                         carry)
        dq = torch.as_tensor(np.random.default_rng(0).normal(
            scale=0.01, size=(2, 12)), dtype=dtype)
        q = carry.sim_state.q.clone()
        q[:, 7:] += dq
        carry = carry._replace(sim_state=carry.sim_state._replace(q=q))
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, card = rollout(ctl, tree_map(lambda a: a.to(device), carry),
                          n_ticks)
        torch.cuda.synchronize()
        tick_ms[str(dtype)[6:]] = 1e3 * (time.perf_counter() - t0) / n_ticks
        assert_no_kernel(f"{label} {dtype}")
        _, cpu = rollout(ctl, carry, n_ticks)
        f32 = dtype == torch.float32
        for name, g, w in zip(cpu._fields, card, cpu):
            g, w = g.cpu().numpy(), w.numpy()
            assert g.shape == w.shape, name
            if not np.issubdtype(w.dtype, np.floating):
                assert (g == w).all(), f"{name} differs card vs CPU"
                continue
            if f32 and name == "x_f_mpc":
                continue
            scale = max(1.0, float(np.abs(w).max()))
            err = float(np.abs(g - w).max()) / scale
            tol = (CARD_CPU_TOL32.get(name, 1e-3) if f32 else
                   tol64.get(name, tol64.get("default", CARD_CPU_TOL64)))
            worst[(str(dtype)[6:], name)] = (err, tol)
            assert err <= tol, f"{name} ({dtype}): {err:.3g} of scale > {tol}"
    top = sorted(worst.items(), key=lambda kv: -kv[1][0] / kv[1][1])[:4]
    what = (" (Kalman estimator)" if cfg.kf_enabled else
            " (planner)" if cfg.mpc_planner else
            " (DDP MPC)" if not cfg.type_MPC else "")
    log(f"{label} card vs CPU{what}"
        f", B = 2, {n_ticks} ticks, every log leaf: worst "
        "(error / tolerance, of scale) " + "; ".join(
            f"{d} {n} {e:.3g}/{t:g}" for (d, n), (e, t) in top)
        + "; card ms a tick (the first run of the process included) "
        + ", ".join(f"{d} {v:.2f}" for d, v in tick_ms.items()))
    return tick_ms


# ----------------------------------------------------------------------
# The evaluation tools (parity_320, --fleet-mpc, --sweep, the Kalman
# estimator, --estimator-demo)
# ----------------------------------------------------------------------

class Recorder:
    """Wraps `module.name` while active and keeps what each call
    returned, so that a phase can drive the CLI's own entry point and
    still read its results."""

    def __init__(self, module, name):
        self.module, self.name, self.out = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*a, **k):
            r = self.orig(*a, **k)
            self.out.append(r)
            return r

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def run_parity(cfg, device):
    """E1: python -m qrw_tpu_torch.eval.parity_320 in-process, on the
    card, at PARITY_CYCLES cycles: the trot, then the trot switching to
    the static gait at mid-capture (the union phase set at cap 64).
    Each run's JSON is printed (by the tool) and held to its bars; the
    relaxed chain launches K2 and K3 in every warm cycle, the phase
    solves K1 (cap 32 for the trot, cap 64 for the switch). Returns
    ({label: JSON}, {label: K1 launches by cap}, {label: wall
    seconds})."""
    from qrw_tpu_torch.eval import parity_320

    outs, counts, walls = {}, {}, {}
    for argv in PARITY_ARGV:
        label = "switch" if "--switch" in argv else "trot"
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = parity_320.main(argv + ([] if device == "cuda" else ["--cpu"]))
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        k1, k1_caps = launched(K1), caps(kernels.launches(K1))
        k2_cone = dict(kernels.launches(K2_CONE))
        k2_dense, k3, k3_general = (launched(K2_DENSE), launched(*K3),
                                    launched(K3_GENERAL))
        outs[label], counts[label] = out, k1_caps
        warm = PARITY_CYCLES - 1
        log(f"E1 parity_320 {' '.join(argv)} on the card in "
            f"{walls[label]:.1f} s: relaxed conv "
            f"{out['relaxed_conv_rate']:.4f}, torque err max "
            f"{out['torque_err_max_Nm_relaxed']:.4g} N m (budget "
            f"{out['torque_budget_Nm']}), phase match "
            f"{out['phase_match_rate']:.4f}, phase conv cold "
            f"{out['phase_conv_rate']:.4f} warm "
            f"{out['phase_warm_conv_rate']:.4f}, {out['n_phase_classes']} "
            f"classes; launches K1 {k1} by cap {k1_caps}, K2 "
            f"{launched(*K2)} (cone by n {k2_cone}, dense {k2_dense}), K3 "
            f"{k3} (general {k3_general}) for {warm} warm cycles")
        assert out["relaxed_conv_rate"] >= PARITY_CONV_BAR, out
        assert out["torque_err_max_Nm_relaxed"] < out["torque_budget_Nm"]
        assert out["phase_match_rate"] == 1.0, out["phase_match_rate"]
        assert k2_cone.get(192, 0) >= warm and k2_dense == 0, k2_cone
        assert k3 >= warm and k3_general == 0, (k3, k3_general)
        want_cap = 64 if label == "switch" else 32
        assert k1 >= 1 and set(k1_caps) == {want_cap}, k1_caps
    return outs, counts, walls


def run_fleet_mpc_path(cfg, device):
    """E2: the CLI's --fleet-mpc at each of FLEET_MPC_BS (10 warm cycles)
    in the JAX entry point's layout at tile 512 (--fleet-mpc 4096: 1024
    problems over phases 0 and 8; 8192: all 16 phases at 512 each):
    solves/s and conv, one K1 launch a cycle plus the cold solve, all at
    tile 512. Returns ({batch: result}, K1 launches at tile 512)."""
    from qrw_tpu_torch.runtime import main as cli

    want = {4096: (1024, [0, 8]), 8192: (8192, list(range(16)))}
    out, k1_512 = {}, 0
    for batch in FLEET_MPC_BS:
        kernels.reset_launches()
        with Recorder(cli, "run_fleet_mpc") as rec:
            code = cli.main(["--fleet-mpc", str(batch), "--fleet-cycles",
                             str(FLEET_MPC_CYCLES), "--device", device])
        k1, k1_tiles = launched(K1), dict(kernels.launches(K1))
        r, = rec.out
        log(f"E2 --fleet-mpc {batch}: B solved {r['B']} at tile "
            f"{r['tile']} over phases {r['phases']}, {r['solves_s']:.1f} "
            f"solves/s ({1e3 * r['s_per_cycle']:.3f} ms a warm cycle), "
            f"conv {r['conv']:.4f} (cold {r['cold_conv']:.4f}); K1 "
            f"launches {k1} by (cap, tile) {k1_tiles}")
        assert code == 0 and (r["B"], r["phases"]) == want[batch], r
        assert r["tile"] == cli.FLEET_MPC_TILE == TILE512, r
        assert r["conv"] >= CONV_BAR, r
        assert k1 == FLEET_MPC_CYCLES + 1, k1_tiles
        assert k1_tiles == {(32, TILE512): k1}, k1_tiles
        assert launched(*K2, *K3) == 0, kernels.launches()
        out[batch] = r
        k1_512 += k1_tiles[32, TILE512]
    return out, k1_512


def run_sweep_path(cfg, device):
    """E3: the CLI's --sweep on its full 9 x 5 grid, SWEEP_TICKS ticks:
    cells that succeeded and the largest vx error; no kernel launch (the
    per-robot solvers of the single-robot loop, as in qrw_tpu)."""
    from qrw_tpu_torch.eval import speed_sweep
    from qrw_tpu_torch.runtime import main as cli

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Recorder(speed_sweep, "run_sweep") as rec:
        code = cli.main(["--sweep", "--ticks", str(SWEEP_TICKS),
                         "--device", device])
    wall = time.perf_counter() - t0
    res, = rec.out
    assert_no_kernel("E3 --sweep")
    n_ok = int(res.success.sum())
    log(f"E3 --sweep {res.success.shape[0]} x {res.success.shape[1]} cells "
        f"x {SWEEP_TICKS} ticks in {wall:.1f} s "
        f"({res.success.size * SWEEP_TICKS / wall:.1f} robot-ticks/s): "
        f"{n_ok}/{res.success.size} succeeded; max vx err "
        f"{res.vx_err.max():.4f} m/s; success by vx "
        f"{res.success.all(axis=1).astype(int).tolist()}")
    assert code == 0 and res.success.shape == (9, 5)
    assert np.isfinite(res.vx_err).all() and np.isfinite(res.h_err).all()
    assert res.success[0, res.success.shape[1] // 2], "standing cell fell"
    return wall, n_ok, float(res.vx_err.max())


def run_estimator_demo(cfg, device):
    """E5: the CLI's --estimator-demo --kf on the card (DEMO_TICKS ticks
    standing still, float32 as the CLI runs it): the metrics."""
    from qrw_tpu_torch.eval import estimator_eval
    from qrw_tpu_torch.runtime import main as cli

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Recorder(estimator_eval, "run_demo") as rec:
        code = cli.main(["--estimator-demo", "--kf", "--ticks",
                         str(DEMO_TICKS), "--device", device])
    wall = time.perf_counter() - t0
    m, = rec.out
    assert_no_kernel("E5 --estimator-demo --kf")
    log(f"E5 --estimator-demo --kf, {DEMO_TICKS} ticks in {wall:.1f} s "
        f"({1e3 * wall / DEMO_TICKS:.1f} ms a tick): metrics {m}")
    assert code == 0 and all(np.isfinite(v) for v in m.values()), m
    assert m["z_rmse"] < 0.05 and m["xy_drift"] < 0.05, m
    return m, wall


# ----------------------------------------------------------------------
# The DDP MPC backends (ops/ilqr, core/mpc_ddp, core/mpc_ddp_planner,
# eval/compare): plain PyTorch, no kernel
# ----------------------------------------------------------------------

def device_busy(fn):
    """(wall ms, device ms) of one `fn()` under torch.profiler: the wall
    between synchronizations and the union of its kernels' device
    intervals, as qrwbench's device_idle_frac reads them (None where the
    profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from qrwbench.trace import union_seconds

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    dev = union_seconds([(e.start_ns(), e.end_ns())
                         for e in prof.profiler.kineto_results.events()
                         if e.device_type() == cuda
                         and not e.is_user_annotation()])
    return 1e3 * wall, (1e3 * dev if dev > 0 else None)


def _leaf_err(got, want):
    w = want.detach().cpu().double()
    return float((got.detach().cpu().double() - w).abs().max()) / max(
        1.0, float(w.abs().max()))


def check_ddp_slice(cfg, xr_np, fs_np, device):
    """D1's B = 8 slice: a cold and a warm DDP solve on the card and on
    the CPU from the same inputs, float64 and float32; every leaf of the
    result held to DDP_TOL. Returns {dtype: worst (error, bar, leaf)}
    and the list of the leaves over their bar."""
    from qrw_tpu_torch.core import mpc_ddp

    worst, over = {}, []
    for dtype in (torch.float64, torch.float32):
        runs = {}
        for dev in (device, "cpu"):
            x = torch.as_tensor(xr_np[:DDP_SLICE_B], dtype=dtype, device=dev)
            f = torch.as_tensor(fs_np[:DDP_SLICE_B], dtype=dtype, device=dev)
            st, runs[dev] = None, []
            for _ in range(2):
                r = mpc_ddp.solve_mpc_ddp(cfg, x, f, st)
                st = r.state
                runs[dev].append(r)
        plan_tol, cost_tol = DDP_TOL[dtype]
        errs = []
        for g, w in zip(runs[device], runs["cpu"]):
            for name, a, b, tol in (
                    ("x_f_applied", g.x_f_applied, w.x_f_applied, plan_tol),
                    ("xs", g.state.xs, w.state.xs, plan_tol),
                    ("us", g.state.us, w.state.us, plan_tol),
                    ("cost", g.cost, w.cost, cost_tol),
                    ("cost_trace", g.cost_trace, w.cost_trace, cost_tol)):
                err = _leaf_err(a, b)
                if not (err <= tol and bool(torch.isfinite(a).all())):
                    over.append(f"{name} ({dtype}): {err:.3g} > {tol}")
                errs.append((err, tol, name))
        worst[str(dtype)[6:]] = max(errs, key=lambda e: e[0] / e[1])
    return worst, over


def derivs_work(B, N, itemsize=4):
    """Operations and bytes of one launch of the DDP derivatives kernel on
    B problems of N nodes: ~900 flop a node row (the inertia and its
    inverse, the four feet's 3 x 3 blocks, the shoulder penalty's 4 x 4
    Hessian, the cone); a node row reads 53 values and writes 600, a
    terminal row reads 40 and writes 156."""
    R = B * N
    return 900 * R, itemsize * (R * (53 + 600) + B * (40 + 156))


def check_ddp_derivs_kernel(cfg, device):
    """D0: the DDP derivatives kernel (csrc/ddp_derivs.cu) at the DDP
    cell's shape (B = DERIVS_B trot problems of build_batch, N = 16): the
    rows of the first iteration of a warm solve (a cold solve first, its
    solution carried). Its float32 outputs against the plain version's,
    held to DERIVS_TOL32 of scale off the shoulder penalty's kink, and
    both against the float64 plain version; one launch. Times the
    kernel, the plain version and the torch.func route it replaced.
    Returns the kernels JSON entry's numbers."""
    from torch.func import jacfwd, vmap

    from qrw_tpu_torch.core import mpc_ddp
    from qrw_tpu_torch.eval.kernel_profile import build_batch
    from qrw_tpu_torch.ops import ilqr

    B, N = DERIVS_B, cfg.n_steps
    xr_np, fs_np = build_batch(cfg, B, np.random.default_rng(13))
    xr = torch.as_tensor(xr_np, device=device)
    fs = torch.as_tensor(fs_np, device=device)
    settings = mpc_ddp.DDPSettings()
    state = mpc_ddp.solve_mpc_ddp(cfg, xr, fs, None, settings).state
    args = mpc_ddp._setup(cfg, xr, fs, state, settings, None, None)
    X = state.xs[:, :-1].reshape(B * N, 12)
    U = args["us0"].reshape(B * N, 12)
    xT = state.xs[:, -1]
    flat = [a.reshape((B * N,) + a.shape[2:]) for a in args["node_args"]]
    term = args["term_args"]
    launches = launched(DERIVS)
    got = args["derivs"](X, U, flat, xT, term)
    torch.cuda.synchronize()
    assert launched(DERIVS) == launches + 1
    c32 = mpc_ddp.make_consts(cfg, torch.float32, device)
    c64 = mpc_ddp.make_consts(cfg, torch.float64, device)
    plain = lambda: mpc_ddp._srb_derivs_plain(  # noqa: E731
        cfg, settings, c32, X, U, flat, xT, term)
    p32 = plain()
    p64 = mpc_ddp._srb_derivs_plain(
        cfg, settings, c64, X.double(), U.double(),
        [a.double() for a in flat], xT.double(), [a.double() for a in term])
    far = (mpc_ddp.shoulder_kink_margin(X, flat[0], flat[1]) > DERIVS_KINK_M,
           mpc_ddp.shoulder_kink_margin(xT, term[1], term[2])
           > DERIVS_KINK_M)
    names = ("fx", "fu", "lx", "lu", "lxx", "lux", "luu", "Vx", "Vxx")
    errs = {}
    for name, g, p, w in zip(names, got, p32, p64):
        scale = max(1.0, float(w.abs().max()))
        rows = far[1] if name.startswith("V") else far[0]
        e = (g.double() - p.double()).abs().flatten(1).amax(1) / scale
        errs[name] = (float(e[rows].max()), float(e.max()),
                      float((g.double() - w).abs().max()) / scale,
                      float((p.double() - w).abs().max()) / scale)
        assert errs[name][0] <= DERIVS_TOL32, (name, errs[name])
    near = (int((~far[0]).sum()), int((~far[1]).sum()))
    del p32, p64, got
    fxu_fn = vmap(jacfwd(args["step"], argnums=(0, 1)))
    l_fn = vmap(ilqr._second_order(args["cost"]))
    lT_fn = vmap(ilqr._terminal_second_order(args["cost_T"]))

    def torch_func():
        return (fxu_fn(X, U, *flat), l_fn(X, U, *flat), lT_fn(xT, *term))

    k_ms = time_ms(lambda: args["derivs"](X, U, flat, xT, term))
    p_ms = time_ms(plain)
    f_ms = time_ms(torch_func, windows=3)
    b_ms, b_by = bound(*derivs_work(B, N))
    blocks = mpc_ddp.derivs_blocks_per_sm(4)
    log(f"D0 DDP derivatives kernel, B = {B} x N = {N} rows (+ {B} "
        f"terminal), float32: {blocks} blocks an SM; error of scale, kernel "
        f"vs plain off the shoulder kink / on all rows ({near[0]} node and "
        f"{near[1]} terminal rows within {DERIVS_KINK_M} m of it), kernel "
        "and plain vs float64: " + ", ".join(
            f"{n} {a:.2e}/{b:.2e}, {c:.2e}/{d:.2e}"
            for n, (a, b, c, d) in errs.items())
        + f"; {k_ms[0]:.4f} ms [{k_ms[1]:.4f}-{k_ms[2]:.4f}] (bound "
        f"{b_ms:.4f} ms, {b_by}: {100 * b_ms / k_ms[0]:.1f}%), plain "
        f"{p_ms[0]:.3f} ms, torch.func {f_ms[0]:.3f} ms")
    return {"B": B, "N": N, "ms": k_ms[0], "ms_min": k_ms[1],
            "ms_max": k_ms[2], "plain_ms": p_ms[0], "library_ms": f_ms[0],
            "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / k_ms[0],
            "blocks_per_sm": blocks, "near_kink_rows": near,
            "rel_err": {n: e[0] for n, e in errs.items()}}


def linesearch_work(B, N, A, itemsize=4):
    """Operations and bytes of one launch of the DDP line-search kernel on
    B problems of N nodes and A step sizes: ~600 flop a (problem, step
    size, node) (the gains' product, the SRB step, the costs); a problem
    reads its gains N (144 + 12) values, its trajectory (2N + 1) 12, its
    node arguments N (12 + 4 + 12 + 1), its terminal arguments 28, x0 12,
    its cost and regularization, and writes its new trajectory, cost,
    regularization and trace entry."""
    reads = N * (144 + 12) + (2 * N + 1) * 12 + N * 29 + 28 + 12 + 2
    writes = (2 * N + 1) * 12 + 3
    return 600 * B * A * N, itemsize * B * (reads + writes)


def check_ddp_linesearch_kernel(cfg, device):
    """D0b: the DDP line-search kernel (csrc/ddp_linesearch.cu) at the DDP
    cell's shape (B = DERIVS_B trot problems of build_batch, N = 16, the
    9 step sizes): the first iteration of a warm solve (a cold solve
    first, its solution carried; the iterate's rollout, derivatives and
    backward pass through the solver's own code). One launch.
    Every third problem's current cost is set to 0, so that it is
    rejected. Checked, the float32 plain version beside it under the
    same measures:
    - the accepted cost's relative error against the float64 plain
      version's, at most twice the plain version's plus 1e-6;
    - the same accept as the plain version on 99% of problems, and on
      every problem whose choice rounding cannot decide (each step
      size's float64 cost, the best two and the best and the current
      cost apart by more than LS_TIE of the cost scale, as the card test
      `test_linesearch_kernel_against_plain` splits them);
    - the new iterate xs, us: on a rejected problem the old one, bit for
      bit; on every problem rounding cannot decide within 1e-4 of scale
      of the plain version's; the share of problems within 1e-4 of scale
      of the float64 plain version's at least the plain version's;
    - the iterate against itself: the float64 rollout of its controls
      us from x0 within 1e-4 of scale of its states xs, and that
      rollout's cost against the reported cost of an accepted problem
      (relative error at most twice the plain version's plus 1e-6), so
      the states, controls and cost written belong to one step size.
    Times the kernel and the plain version. Returns the kernels JSON
    entry's numbers."""
    from qrw_tpu_torch.core import mpc_ddp
    from qrw_tpu_torch.eval.kernel_profile import build_batch
    from qrw_tpu_torch.ops import ilqr

    B, N = DERIVS_B, cfg.n_steps
    xr_np, fs_np = build_batch(cfg, B, np.random.default_rng(13))
    settings = mpc_ddp.DDPSettings()
    runs = {}
    for dtype in (torch.float32, torch.float64):
        xr = torch.as_tensor(xr_np, device=device, dtype=dtype)
        fs = torch.as_tensor(fs_np, device=device, dtype=dtype)
        if dtype == torch.float32:
            state = mpc_ddp.solve_mpc_ddp(cfg, xr, fs, None, settings).state
        st = mpc_ddp.DDPState(*(t.to(dtype) for t in state))
        args = mpc_ddp._setup(cfg, xr, fs, st, settings, None, None)

        def plain_of(alphas, a=args):
            return ilqr.plain_linesearch(
                a["step"], a["cost"], a["cost_T"], a["node_args"],
                a["term_args"], settings.to_ilqr()._replace(alphas=alphas),
                a["project_u"])
        runs[dtype] = (args, plain_of(settings.alphas), plain_of)
    args, plain, _ = runs[torch.float32]
    args64, plain64, plain64_of = runs[torch.float64]
    reg = torch.full((B,), settings.reg_init, device=device)
    trace = torch.empty((B, settings.max_iters), device=device)
    xs, us, cost, _, _ = plain(args["x0"], None, args["us0"], None, None,
                               None, reg, trace, 0)
    flat = [a.reshape((B * N,) + a.shape[2:]) for a in args["node_args"]]
    d = args["derivs"](xs[:, :-1].reshape(B * N, 12), us.reshape(B * N, 12),
                       flat, xs[:, -1], args["term_args"])
    d = [t.reshape((B, N) + t.shape[1:]) for t in d[:7]] + list(d[7:])
    kffs, Ks = ilqr._backward(*d, reg[:, None, None] * torch.eye(
        12, device=device))
    # every third problem's current cost 0: no step size beats it, so the
    # kernel keeps its iterate (the reject's copy)
    third = torch.arange(B, device=device) % 3 == 0
    cost = torch.where(third, 0.0, cost)
    inputs = (args["x0"], xs, us, kffs, Ks, cost, reg)
    inputs64 = tuple([t.double() for t in a] if isinstance(a, list)
                     else a.double() for a in inputs)
    trace64 = trace.double()

    def kernel():
        return args["linesearch"](*inputs, trace, 0)

    def plain32():
        return plain(*inputs, trace, 0)

    launches = launched(LINESEARCH)
    got = kernel()
    torch.cuda.synchronize()
    assert launched(LINESEARCH) == launches + 1
    p32 = plain32()
    p64 = plain64(*inputs64, trace64, 0)
    # each step size's float64 cost (+inf for NaN): where the best two,
    # or the best and the current cost, lie within LS_TIE of the cost
    # scale, rounding may decide the choice
    inf64 = torch.full((B,), torch.inf, dtype=torch.float64, device=device)
    each = torch.stack([plain64_of((a,))(*inputs64[:5], inf64, inputs64[6],
                                         trace64, 0)[2]
                        for a in settings.alphas])
    cost_scale = max(1.0, float(p64[2].abs().max()))
    top2 = each.sort(0).values[:2]
    sure = ~(((top2[1] - top2[0]).abs() <= LS_TIE * cost_scale)
             | ((top2[0] - inputs64[5]).abs() <= LS_TIE * cost_scale))
    del each, top2
    scales = [max(1.0, float(p64[i].abs().max())) for i in (0, 1)]

    def gap(a, b):
        """The largest gap of xs and of us, each a share of its scale, a
        problem."""
        return torch.maximum(*[(a[i].double() - b[i].double()).abs()
                               .flatten(1).amax(1) / scales[i]
                               for i in (0, 1)])

    errs = {}
    for name, r in (("kernel", got), ("plain", p32)):
        cost_err = ((r[2].double() - p64[2]) / p64[2].abs()).abs()[p64[4]]
        kept = ~r[4]
        assert torch.equal(r[0][kept], xs[kept]), name
        assert torch.equal(r[1][kept], us[kept]), name
        # the float64 rollout of the iterate's controls
        own = plain64(inputs64[0], None, r[1].double(), None, None, None,
                      inputs64[6], trace64, 0)
        own_err = ((r[2].double() - own[2]) / own[2].abs()).abs()[r[4]]
        errs[name] = dict(
            cost_err=float(cost_err.max()),
            near=float((gap(r, p64) <= 1e-4).double().mean()),
            accepted=float(r[4].double().mean()),
            own_x=float((r[0].double() - own[0]).abs().max()) / scales[0],
            own_cost=float(own_err.max()))
        del own
    same = float((got[4] == p32[4]).double().mean())
    sure_gap = float(gap(got, p32)[sure].max())
    k, p = errs["kernel"], errs["plain"]
    assert k["cost_err"] <= 2 * p["cost_err"] + 1e-6, errs
    assert same >= 0.99, same
    assert not bool(got[4][third].any()) and bool(got[4].any())
    assert torch.equal(got[4][sure], p32[4][sure])
    assert sure_gap <= 1e-4, sure_gap
    assert k["near"] >= p["near"], errs
    assert k["own_x"] <= 1e-4, errs
    assert k["own_cost"] <= 2 * p["own_cost"] + 1e-6, errs
    n_sure = int(sure.sum())
    del p32, p64, got, sure
    k_ms = time_ms(kernel)
    p_ms = time_ms(plain32, windows=3)
    b_ms, b_by = bound(*linesearch_work(B, N, len(settings.alphas)))
    log(f"D0b DDP line-search kernel, B = {B}, N = {N}, "
        f"{len(settings.alphas)} step sizes, float32, kernel / plain: "
        "largest relative cost error against the float64 plain version "
        f"{k['cost_err']:.2e} / {p['cost_err']:.2e}; share of problems "
        f"within 1e-4 of scale of its xs and us {k['near']:.5f} / "
        f"{p['near']:.5f}; accepted share {k['accepted']:.5f} / "
        f"{p['accepted']:.5f}; the iterate's states against the float64 "
        f"rollout of its controls {k['own_x']:.2e} / {p['own_x']:.2e} of "
        f"scale, its cost against that rollout's {k['own_cost']:.2e} / "
        f"{p['own_cost']:.2e}; the same accept as the plain version on "
        f"{same:.5f}; {n_sure} problems whose choice rounding cannot "
        f"decide, where the kernel's iterate lies within {sure_gap:.2e} of "
        f"scale of the plain version's; {k_ms[0]:.4f} ms "
        f"[{k_ms[1]:.4f}-{k_ms[2]:.4f}] "
        f"(bound {b_ms:.4f} ms, {b_by}: {100 * b_ms / k_ms[0]:.1f}%), "
        f"plain {p_ms[0]:.3f} ms")
    return {"B": B, "N": N, "ms": k_ms[0], "ms_min": k_ms[1],
            "ms_max": k_ms[2], "plain_ms": p_ms[0], "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / k_ms[0],
            "checks": errs, "same_accept": same, "sure": n_sure,
            "sure_gap": sure_gap}


def run_ddp_batch(cfg, device):
    """D1: bench.py::run_ddp_bench through the port: B = 1024 trot
    problems of build_batch(cfg, B, default_rng(11)) (the port's copy in
    eval/kernel_profile), one warm-started batched DDP solve
    (core/mpc_ddp.solve_mpc_ddp, 10 iLQR iterations) a 50 Hz cycle: one
    warm-up cycle, then DDP_CYCLES timed cycles; the torch operations one
    solve dispatches; the mean total fz of the last cycle's first node
    (bar: within 2 N of qrw_tpu's DDP_FZ_REF, all finite). Then the
    B = 8 slice, card against CPU."""
    from qrw_tpu_torch.core import mpc_ddp
    from qrw_tpu_torch.eval.kernel_profile import build_batch
    from qrw_tpu_torch.utils.op_count import count_ops, launches

    xr_np, fs_np = build_batch(cfg, DDP_B, np.random.default_rng(11))
    xr = torch.as_tensor(xr_np, device=device)
    fs = torch.as_tensor(fs_np, device=device)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = mpc_ddp.solve_mpc_ddp(cfg, xr, fs).state          # warm-up cycle
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    derivs0, ls0 = launched(DERIVS), launched(LINESEARCH)
    for _ in range(DDP_CYCLES):
        res = mpc_ddp.solve_mpc_ddp(cfg, xr, fs, st)
        st = res.state
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert_no_kernel("D1 batched DDP")
    derivs = launched(DERIVS) - derivs0
    assert derivs == DDP_CYCLES * mpc_ddp.DDPSettings().max_iters, derivs
    searches = launched(LINESEARCH) - ls0
    assert searches == DDP_CYCLES * (1 + mpc_ddp.DDPSettings().max_iters), \
        searches
    ops = count_ops(lambda: mpc_ddp.solve_mpc_ddp(cfg, xr, fs, st))
    ops = (sum(ops.values()), launches(ops))
    prof_wall, prof_dev = device_busy(
        lambda: mpc_ddp.solve_mpc_ddp(cfg, xr, fs, st))
    busy = ("not measured" if prof_dev is None else
            f"{prof_dev:.3f} ms of {prof_wall:.3f} ms, busy share "
            f"{prof_dev / prof_wall:.4f}")
    fz = res.x_f_applied[:, 12:, 0].reshape(DDP_B, 4, 3)[:, :, 2].sum(1)
    fz_mean = float(fz.mean())
    finite = bool(torch.isfinite(res.x_f_applied).all())
    ms = 1e3 * wall / DDP_CYCLES
    worst, over = check_ddp_slice(cfg, xr_np, fs_np, device)
    log(f"D1 batched DDP (bench.py::run_ddp_bench), B = {DDP_B}, "
        f"{DDP_CYCLES} warm cycles in {wall:.3f} s: "
        f"{DDP_B * DDP_CYCLES / wall:.1f} solves/s, {ms:.3f} ms a batched "
        f"solve ({1e3 * ms / DDP_B:.3f} us a problem; warm-up cycle "
        f"{first:.3f} s); {derivs} derivatives and {searches} line-search "
        "kernel launches; "
        f"{ops[0]} torch ops a solve, {ops[1]} not views "
        f"(launches); device time of one solve (torch.profiler) {busy}; "
        f"mean total fz of the first node {fz_mean:.4f} N "
        f"(qrw_tpu {DDP_FZ_REF}; mg {cfg.mass * cfg.gravity:.4f}); finite "
        f"{finite}; B = {DDP_SLICE_B} card vs CPU, "
        "worst (error / bar, of scale): " + "; ".join(
            f"{d} {n} {e:.3g}/{t:g}" for d, (e, t, n) in worst.items()))
    assert not over, f"D1 slice card vs CPU: {over}"
    assert finite, "non-finite DDP plan"
    assert abs(fz_mean - DDP_FZ_REF) < 2.0, f"mean total fz {fz_mean:.3f}"
    return dict(solves_s=DDP_B * DDP_CYCLES / wall, ms=ms, ops=ops,
                fz=fz_mean, device_ms=prof_dev)


def _single_run_summary(label, cfg, logs, wall, n_ticks, solves):
    """Bars of the JAX package's DDP rollout tests (tests/
    test_mpc_ddp.py:144-158, 175-187; tests/test_mpc_planner.py:97-109):
    |h - h_ref| < 0.05 at the end, no security latch; finite."""
    h = logs.base_pos[..., 2].cpu().numpy()
    latched = bool(logs.error.any())
    log(f"{label}: {n_ticks} ticks in {wall:.3f} s, "
        f"{1e3 * wall / n_ticks:.2f} ms a tick ({n_ticks / wall:.2f} "
        f"ticks/s); {solves} MPC solves; height final {h[-1]:.4f} min "
        f"{h.min():.4f} (h_ref {cfg.h_ref}); latched {latched}")
    assert np.isfinite(h).all(), "non-finite height"
    assert abs(h[-1] - cfg.h_ref) < 0.05, f"final height {h[-1]:.4f}"
    assert not latched, "security latch"
    return 1e3 * wall / n_ticks


def run_ddp_cli(cfg, device):
    """D2: the CLI's single-robot mode with --ddp (type_MPC = False) for
    DDP_TICKS ticks, through runtime.main: its defaults (velID 2, the
    default perturbations, float32)."""
    from qrw_tpu_torch.core import mpc_ddp
    from qrw_tpu_torch.runtime import main as cli

    kernels.reset_launches()
    with Recorder(mpc_ddp, "solve_mpc_ddp") as solves, \
            Recorder(cli, "run_single") as rec:
        code = cli.main(["--ddp", "--ticks", str(DDP_TICKS), "--device",
                         device])
    assert_no_kernel("D2 --ddp")
    (_, logs, wall), = rec.out
    assert code == 0
    assert len(solves.out) == DDP_TICKS // cfg.k_mpc
    return _single_run_summary("D2 --ddp (runtime.main)", cfg, logs, wall,
                               DDP_TICKS, len(solves.out))


def run_single_config(label, cfg, device, n_ticks, module, name):
    """D3, D4: the CLI's single-robot mode (runtime.main.run_single, as
    `--config` with the backend's flag selects it) for n_ticks, its
    solves counted through `module.name`."""
    from qrw_tpu_torch.runtime import main as cli

    args = cli.build_argparser().parse_args(["--ticks", str(n_ticks)])
    rcfg = cfg.replace(N_SIMULATION=n_ticks)
    kernels.reset_launches()
    with Recorder(module, name) as solves:
        _, logs, wall = cli.run_single(rcfg, args, device, torch.float32)
        code = cli.single_summary(rcfg, args, logs, wall)
    assert_no_kernel(label)
    assert code == 0
    return _single_run_summary(label, rcfg, logs, wall, n_ticks,
                               len(solves.out)), len(solves.out)


def run_compare(cfg, device):
    """D6: eval/compare on the card as qrw_tpu's test of it runs
    (tests/test_aux.py:62-85): a float64 capture of COMPARE_TICKS ticks
    of the closed loop (compare.capture_cycles, the QP backend), then
    every cycle from COMPARE_SKIP on re-solved by both backends, cold
    (compare_solvers: DDP at 40 iterations) and warm in the loop
    (compare_solvers_warm); bars: both fz means within 2 N of mg/4 and
    force_rmse_mean < 3 N, both ways."""
    from qrw_tpu_torch.eval import compare

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xr, fs = compare.capture_cycles(cfg, COMPARE_TICKS, device=device)
    torch.cuda.synchronize()
    t_cap = time.perf_counter() - t0
    mg4 = cfg.mass * cfg.gravity / 4
    out = {}
    for mode, fn in (("cold", compare.compare_solvers),
                     ("warm-in-loop", compare.compare_solvers_warm)):
        t0 = time.perf_counter()
        s = compare.summarize(fn(cfg, xr[COMPARE_SKIP:], fs[COMPARE_SKIP:]))
        s["seconds"] = time.perf_counter() - t0
        out[mode] = s
        log(f"D6 eval.compare ({mode}) on the card: {json.dumps(s)}")
    assert_no_kernel("D6 eval.compare")
    log(f"D6 capture {COMPARE_TICKS} ticks (float64) in {t_cap:.1f} s "
        f"({1e3 * t_cap / COMPARE_TICKS:.2f} ms a tick)")
    for mode, s in out.items():
        assert s["cycles"] == COMPARE_TICKS // cfg.k_mpc - COMPARE_SKIP
        assert abs(s["fz_qp_mean"] - mg4) < 2.0, (mode, s)
        assert abs(s["fz_ddp_mean"] - mg4) < 2.0, (mode, s)
        assert s["force_rmse_mean"] < 3.0, (mode, s)
    return out


def run_ddp_phases(cfg, device, clock):
    """D0, D0b, D1-D6 in order; each asserts that it launched none of
    K1-K3."""
    from qrw_tpu_torch.core import mpc_ddp, mpc_ddp_planner

    d0 = check_ddp_derivs_kernel(cfg, device)
    clock.lap("D0")
    d0b = check_ddp_linesearch_kernel(cfg, device)
    clock.lap("D0b")
    d1 = run_ddp_batch(cfg, device)
    clock.lap("D1")
    d2 = run_ddp_cli(cfg, device)
    clock.lap("D2")
    d3, _ = run_single_config(
        "D3 planner (mpc_planner)", cfg.replace(mpc_planner=True), device,
        DDP_TICKS, mpc_ddp_planner, "solve_mpc_planner")
    clock.lap("D3")
    d4, n4 = run_single_config(
        "D4 every-tick DDP (mpc_every_tick)",
        cfg.replace(type_MPC=False, mpc_every_tick=True), device,
        EVERY_TICK_TICKS, mpc_ddp, "solve_mpc_ddp")
    assert n4 == EVERY_TICK_TICKS, n4
    clock.lap("D4")
    check_card_vs_cpu(cfg.replace(type_MPC=False), device, label="D5",
                      tol64=DDP_PLAN_TOL64, n_ticks=D5_TICKS)
    check_card_vs_cpu(cfg.replace(mpc_planner=True), device, label="D5",
                      tol64=PLANNER_TOL64, n_ticks=D5_TICKS)
    clock.lap("D5")
    d6 = run_compare(cfg, device)
    clock.lap("D6")
    return (d0, d0b), d1, d2, d3, d4, d6


# ----------------------------------------------------------------------
# The host runtime (H1-H7) and the utilities (U1-U4): no kernel on these
# paths, in either package; each phase asserts that it launched none
# ----------------------------------------------------------------------

HOST_TICKS = 120                # H3, H4, H7: the JAX tests' 120 ticks
GAMEPAD_TICKS = 20              # H3's gamepad + clone run (JAX test: 60)
REALTIME_TICKS = 50             # H5
PACER_PERIODS = 200             # H1
PACER_SPINS = (100e-6, 500e-6, 1e-3)    # H1: the pacer's spin tails [s]
ECHOES = 200                    # H1: mailbox round trips
FLOOR_S = 0.2                   # H2: put_on_the_floor (JAX test: 1 s)
# H7: base_pos, m (float32). The first run on the card measured 0 (the
# same kernels on the same commands); the bar allows ~60 float32 ulps
# of the 0.24 m height
REPLAY_TOL32 = 1e-6
MESH_B = 8                      # U4: --batch 8 --mesh
MESH_TICKS = 50                 # U4


def sync_if(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _echo_child(in_name, out_name):
    """H1's child: echo every message of one mailbox into the other
    until a message whose first entry is negative."""
    from qrw_tpu_torch.runtime.ipc import Mailbox
    box_in = Mailbox(in_name, (8,), create=False)
    box_out = Mailbox(out_name, (8,), create=False)
    try:
        while True:
            msg = box_in.read()
            if msg is None:
                continue
            box_out.write(msg)
            if msg[0] < 0:
                break
    finally:
        box_in.close()
        box_out.close()


def run_ipc_phase():
    """H1: build the IPC library from qrw_tpu_torch/csrc/qrw_ipc.cpp, a
    mailbox round trip across a spawned process, the pacer's lateness."""
    import multiprocessing as mp
    import os

    from qrw_tpu_torch.runtime import ipc

    kernels.reset_launches()
    so = ipc._build_lib()
    ipc.load_library()
    built = ("loaded cached" if ipc.BUILD_SECONDS is None else
             f"built in {ipc.BUILD_SECONDS:.2f} s")
    tag = f"/qrw_smoke_{os.getpid()}"
    box_in = ipc.Mailbox(tag + "_in", (8,))
    box_out = ipc.Mailbox(tag + "_out", (8,))
    proc = mp.get_context("spawn").Process(
        target=_echo_child, args=(tag + "_in", tag + "_out"))
    proc.start()
    try:
        rtt = []
        for i in range(ECHOES + 1):
            msg = np.full(8, float(i))
            t0 = time.perf_counter()
            box_in.write(msg)
            deadline = t0 + (120.0 if i == 0 else 10.0)   # child start-up
            while True:
                got = box_out.read()
                if got is not None:
                    break
                assert time.perf_counter() < deadline, "no echo"
                assert proc.is_alive(), f"echo child died {proc.exitcode}"
            rtt.append(time.perf_counter() - t0)
            assert (got == msg).all(), (got, msg)
        box_in.write(np.full(8, -1.0))
        proc.join(timeout=30)
        assert proc.exitcode == 0, proc.exitcode
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join()
        box_in.close()
        box_out.close()
    rtt = np.asarray(rtt[1:]) * 1e6
    pacer = ipc.Pacer(0.002)
    try:
        late = np.asarray([pacer.wait() for _ in range(PACER_PERIODS)]) * 1e6
        overruns = pacer.overruns
    finally:
        pacer.close()
    sweep = {}
    for spin in PACER_SPINS:
        pacer = ipc.Pacer(0.002, spin)
        try:
            late_s = np.asarray([pacer.wait()
                                 for _ in range(PACER_PERIODS)]) * 1e6
            sweep[spin] = (float(np.median(late_s)), float(late_s.max()),
                           pacer.overruns)
        finally:
            pacer.close()
    assert_no_kernel("H1 IPC")
    log("H1 pacer, 2 ms period, no work in the loop, by spin tail: "
        + "; ".join(f"{1e6 * spin:.0f} us: lateness median {m:.1f} us, "
                    f"max {mx:.1f} us, overruns {o}"
                    for spin, (m, mx, o) in sweep.items()))
    log(f"H1 IPC library {os.path.basename(so)} {built} (g++, from "
        f"qrw_tpu_torch/csrc/qrw_ipc.cpp); mailbox round trip "
        f"across a spawned process, {ECHOES} echoes: median "
        f"{np.median(rtt):.1f} us, max {rtt.max():.1f} us; pacer over "
        f"{PACER_PERIODS} periods of 2 ms: lateness median "
        f"{np.median(late):.1f} us, max {late.max():.1f} us, overruns "
        f"{overruns}")
    return dict(rtt_us=float(np.median(rtt)),
                pacer_late_us=float(np.median(late)), pacer_sweep=sweep)


def _hold(cfg, dev, n):
    """n ticks of the reference PD hold of q_init: (q_mes, dummyPos) per
    tick."""
    dev.SetDesiredJointPDgains(np.full(12, 6.0), np.full(12, 0.3))
    dev.SetDesiredJointPosition(np.asarray(cfg.q_init))
    dev.SetDesiredJointVelocity(np.zeros(12))
    dev.SetDesiredJointTorque(np.zeros(12))
    q, pos = [], []
    for _ in range(n):
        dev.UpdateMeasurment()
        dev.SendCommand(WaitEndOfCycle=False)
        dev.UpdateMeasurment()
        q.append(dev.q_mes.copy())
        pos.append(dev.dummyPos.copy())
    return np.stack(q), np.stack(pos)


def run_device_phase(cfg, device):
    """H2: SimDevice on the card, float32 and float64: a 50-tick PD hold
    (height within 0.05 of 0.24 m), put_on_the_floor (gap < 0.15 rad);
    the float64 hold against the same run on the CPU (S3's bar)."""
    from qrw_tpu_torch.sim.device import SimDevice, put_on_the_floor

    kernels.reset_launches()
    parts = []
    for dtype in (torch.float32, torch.float64):
        dev = SimDevice(cfg, dtype=dtype, device=device)
        dev.Init(q_init=cfg.q_init)
        sync_if(device)
        t0 = time.perf_counter()
        q, pos = _hold(cfg, dev, 50)
        ms = 1e3 * (time.perf_counter() - t0) / 50
        floor_dev = SimDevice(cfg, dtype=dtype, device=device)
        floor_dev.Init(q_init=cfg.q_init)
        gap = put_on_the_floor(floor_dev, cfg.q_init, duration_s=FLOOR_S)
        assert abs(pos[-1, 2] - 0.24) < 0.05, pos[-1]
        assert gap < 0.15, gap
        part = (f"{str(dtype)[6:]} {ms:.2f} ms a tick, height "
                f"{pos[-1, 2]:.4f}, floor gap {gap:.4f} rad")
        if dtype == torch.float64:
            cpu = SimDevice(cfg, dtype=dtype, device="cpu")
            cpu.Init(q_init=cfg.q_init)
            cq, cpos = _hold(cfg, cpu, 50)
            err = max(np.abs(q - cq).max() / max(1.0, np.abs(cq).max()),
                      np.abs(pos - cpos).max() / max(1.0,
                                                     np.abs(cpos).max()))
            assert err <= CARD_CPU_TOL64, err
            part += f"; card vs CPU {err:.3g} of scale"
        parts.append(part)
    assert_no_kernel("H2 SimDevice")
    log("H2 SimDevice PD hold (50 ticks), put_on_the_floor "
        f"({FLOOR_S} s): " + "; ".join(parts))


def run_host_loop_phase(cfg, device):
    """H3: run_host_loop on the card, 120 ticks (trot, default Config):
    no abort, latch or timeout, |z - h_ref| < 0.06 m every tick, |tau_ff|
    < tau_security; ms a tick. Then the startup abort and the
    SyntheticGamepad + clone run. Returns H3's ms a tick."""
    from qrw_tpu_torch.runtime.gamepad import (FRAME_SIZE, GamepadReader,
                                               SyntheticGamepad)
    from qrw_tpu_torch.runtime.host_loop import run_host_loop
    from qrw_tpu_torch.sim.device import SimDevice

    kernels.reset_launches()
    frames = np.zeros((1, FRAME_SIZE))
    frames[0, 0] = 0.5                       # the stick pushed forward
    # the reader starts now: its spawn overlaps the 120-tick run
    t_gp = time.perf_counter()
    gp = GamepadReader(source=SyntheticGamepad(frames), period_s=0.001)
    try:
        sync_if(device)
        t0 = time.perf_counter()
        res = run_host_loop(cfg, n_ticks=HOST_TICKS, torch_device=device)
        ms = 1e3 * (time.perf_counter() - t0) / HOST_TICKS
        assert res.n_ticks == HOST_TICKS, res.n_ticks
        assert not (res.startup_abort or res.error or res.timeout)
        dz = np.abs(res.q_log[:, 2] - cfg.h_ref).max()
        tau = np.abs(res.tau_log).max()
        assert dz < 0.06 and tau < cfg.tau_security, (dz, tau)

        far = SimDevice(cfg, device=device)
        far.Init(q_init=np.asarray(cfg.q_init) + 0.8)
        abort = run_host_loop(cfg, n_ticks=10, device=far)
        assert abort.startup_abort and abort.n_ticks == 1, abort[:4]

        clone = SimDevice(cfg, device=device)
        clone.Init(q_init=cfg.q_init)
        while gp.read()[0] == 0:
            assert time.perf_counter() - t_gp < 120, "no gamepad frame"
            time.sleep(0.005)
        wait_s = time.perf_counter() - t_gp
        gpr = run_host_loop(cfg, n_ticks=GAMEPAD_TICKS, gamepad=gp,
                            clone=clone, torch_device=device)
    finally:
        gp.stop()
    assert not (gpr.startup_abort or gpr.error), gpr[:4]
    clone.UpdateMeasurment()
    clone_err = float(np.abs(clone.q_mes - gpr.q_log[-1, 7:]).max())
    assert clone_err <= 1e-6, clone_err
    assert_no_kernel("H3 host loop")
    log(f"H3 run_host_loop, {HOST_TICKS} ticks on the card: {ms:.2f} ms a "
        f"tick ({1e3 / ms:.2f} ticks/s), max "
        f"|z - h_ref| {dz:.4f} m, max |tau_ff| {tau:.3f} N m; startup abort "
        f"after {abort.n_ticks} tick; SyntheticGamepad (first frame "
        f"{wait_s:.2f} s after its spawn) + clone, {GAMEPAD_TICKS} ticks: x "
        f"{gpr.q_log[-1, 0]:.4f} m, clone - primary {clone_err:.3g} rad")
    return ms


def run_pipelined_phase(cfg, device, host_ms):
    """H4: run_host_loop_pipelined(depth=2), 120 ticks: upright, no
    latch; the periods' p50 and p99 beside H3's ms a tick."""
    from qrw_tpu_torch.runtime.host_loop import run_host_loop_pipelined

    kernels.reset_launches()
    r = run_host_loop_pipelined(cfg, n_ticks=HOST_TICKS, depth=2,
                                torch_device=device)
    assert r.n_ticks == HOST_TICKS and not r.error
    assert abs(r.q_log[-1, 2] - 0.2447) < 0.05, r.q_log[-1, 2]
    assert r.periods_ms.shape == (HOST_TICKS - 1,)
    p50, p99 = np.percentile(r.periods_ms, [50, 99])
    assert_no_kernel("H4 pipelined host loop")
    log(f"H4 run_host_loop_pipelined depth 2, {HOST_TICKS} ticks: period "
        f"p50 {p50:.2f} ms, p99 {p99:.2f} ms (H3 {host_ms:.2f} ms a tick); "
        f"final height {r.q_log[-1, 2]:.4f}")
    return float(p50), float(p99)


def run_realtime_phase(cfg, device):
    """H5: python -m qrw_tpu_torch.runtime.main --host-loop --realtime
    --ticks 50 in-process: the pacer's overruns and mean lateness. No bar
    on real time: the tick is host-bound at ~100 ms, 50x the 2 ms
    period, so every tick overruns."""
    from qrw_tpu_torch.runtime import ipc
    from qrw_tpu_torch.runtime import main as cli

    seen = []
    orig = ipc.Pacer.wait

    def wait(self):
        late = orig(self)
        seen.append((late, self.overruns))
        return late

    kernels.reset_launches()
    ipc.Pacer.wait = wait
    try:
        t0 = time.perf_counter()
        code = cli.main(["--host-loop", "--realtime", "--ticks",
                         str(REALTIME_TICKS), "--device", device])
        wall = time.perf_counter() - t0
    finally:
        ipc.Pacer.wait = orig
    assert code == 0, code
    assert len(seen) == REALTIME_TICKS, len(seen)
    late = np.asarray([s[0] for s in seen]) * 1e3
    overruns = seen[-1][1]
    assert_no_kernel("H5 --realtime")
    log(f"H5 --host-loop --realtime --ticks {REALTIME_TICKS} (and its 2.5 "
        f"s damping shutdown) in {wall:.1f} s: pacer overruns {overruns} of "
        f"{REALTIME_TICKS}, lateness mean {late.mean():.2f} ms, max "
        f"{late.max():.2f} ms (no real-time bar: the tick is host-bound, "
        "PERF.md section 5)")
    return overruns, float(late.mean())


def mpc_problem(cfg):
    """A seeded four-stance MPC problem (xref (12, N+1), fsteps)."""
    rng = np.random.default_rng(5)
    xref = np.zeros((12, cfg.n_steps + 1))
    xref[2, :] = 0.2447
    xref[:, 0] += rng.normal(scale=0.01, size=12)
    xref[6, 1:] = 0.3
    feet = np.array([0.195, 0.147, 0.0, 0.195, -0.147, 0.0,
                     -0.195, 0.147, 0.0, -0.195, -0.147, 0.0])
    fsteps = np.zeros((cfg.N_gait, 12))
    fsteps[:cfg.n_steps] = feet
    return xref, fsteps


def run_mpc_service_phase(cfg, device):
    """H6: MPCService on the card: the worker's start-up seconds, one
    problem's round trip, the plan against a direct float64 solve_mpc on
    the card (1e-9 of scale), the stale read, stop."""
    from qrw_tpu_torch.core import mpc as mpc_mod
    from qrw_tpu_torch.runtime.mpc_service import MPCService

    kernels.reset_launches()
    xref, fsteps = mpc_problem(cfg)
    svc = MPCService(cfg, device=device)
    try:
        startup = svc.wait_ready()
        rtts = []
        for k in range(3):
            t0 = time.perf_counter()
            svc.solve(k, xref, fsteps)
            got = svc.wait_result(timeout=60.0)
            rtts.append(1e3 * (time.perf_counter() - t0))
            if k == 0:
                first = got
        stale = svc.get_latest_result()
        assert (stale == got).all(), "stale read changed"
    finally:
        svc.stop()
    assert not svc._proc.is_alive() and svc._proc.exitcode == 0
    f64 = dict(dtype=torch.float64, device=device)
    direct = mpc_mod.solve_mpc(cfg, torch.as_tensor(xref, **f64),
                               torch.as_tensor(fsteps, **f64),
                               mpc_mod.init_mpc_state(cfg, **f64))
    want = direct.x_f_applied.cpu().numpy()
    err = float(np.abs(first - want).max()) / max(1.0, np.abs(want).max())
    assert err <= 1e-9, err
    assert_no_kernel("H6 MPC service")
    log(f"H6 MPCService(device={device!r}): worker start-up {startup:.2f} s "
        f"(spawn, torch import, CUDA context); round trips "
        + ", ".join(f"{r:.1f}" for r in rtts) + " ms (first cold); plan vs "
        f"a direct float64 solve_mpc on the card {err:.3g} of scale; stale "
        "read unchanged; stopped")
    return startup, rtts


def run_replay_phase(cfg, device):
    """H7: a 120-tick rollout on the card (float32), its logged commands
    replayed through the simulator: base_pos against the rollout's.
    Returns the logs (U3 re-solves their MPC cycles)."""
    from qrw_tpu_torch.models.solo12 import make_solo12
    from qrw_tpu_torch.ops import rbd
    from qrw_tpu_torch.runtime.replay import replay
    from qrw_tpu_torch.sim.physics import init_sim_state
    from qrw_tpu_torch.sim.rollout import make_rollout, rollout

    kernels.reset_launches()
    ctl, carry = make_rollout(cfg, device=device)
    _, logs = rollout(ctl, carry, HOST_TICKS)
    sync_if(device)
    t0 = time.perf_counter()
    _, rlog = replay(cfg, rbd.to_torch(make_solo12()),
                     init_sim_state(cfg, device=device), logs.q_des,
                     logs.v_des, logs.tau_ff)
    sync_if(device)
    ms = 1e3 * (time.perf_counter() - t0) / HOST_TICKS
    err = float((rlog.base_pos - logs.base_pos).abs().max())
    assert err <= REPLAY_TOL32, err
    assert_no_kernel("H7 replay")
    log(f"H7 replay of a {HOST_TICKS}-tick rollout on the card (float32): "
        f"{ms:.2f} ms a tick; base_pos against the rollout's {err:.3g} m "
        f"(bar {REPLAY_TOL32:g})")
    return logs


def run_host_phases(cfg, device, clock):
    """H1-H7 in order; returns (H7's logs, the numbers PERF.md quotes)."""
    h = {"ipc": run_ipc_phase()}
    run_device_phase(cfg, device)
    h["tick_ms"] = run_host_loop_phase(cfg, device)
    h["pipelined"] = run_pipelined_phase(cfg, device, h["tick_ms"])
    h["realtime"] = run_realtime_phase(cfg, device)
    h["service"] = run_mpc_service_phase(cfg, device)
    logs = run_replay_phase(cfg, device)
    clock.lap("H1-H7")
    return logs, h


def run_stage_timings(cfg, device):
    """U1: utils/profiling.stage_timings on the card."""
    from qrw_tpu_torch.utils.profiling import stage_timings

    kernels.reset_launches()
    t = stage_timings(cfg, reps=20, device=device)
    assert all(v > 0 for v in t.values()), t
    assert_no_kernel("U1 stage_timings")
    log("U1 stage_timings (float32, 20 reps, synchronized), ms: "
        + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in t.items()))
    return t


def run_checkpoint_phase(cfg, device):
    """U2: 20 ticks, a checkpoint round trip, 20 more: bit-equal to the
    same ticks without the round trip, on the card."""
    import os
    import tempfile

    from qrw_tpu_torch.sim.rollout import make_rollout, rollout
    from qrw_tpu_torch.utils.checkpoint import (_leaves_with_path,
                                                load_state, save_state)

    kernels.reset_launches()
    ctl, carry = make_rollout(cfg, device=device)
    mid, _ = rollout(ctl, carry, 20)
    full, _ = rollout(ctl, mid, 20, k0=20)
    with tempfile.TemporaryDirectory() as d:
        path = save_state(os.path.join(d, "ck.npz"), mid)
        loaded = load_state(path, mid)
    resumed, _ = rollout(ctl, loaded, 20, k0=20)
    pairs = zip(_leaves_with_path(full), _leaves_with_path(resumed))
    n = 0
    for (p, a), (_, b) in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b), "/".join(p)
        n += 1
    assert_no_kernel("U2 checkpoint")
    log(f"U2 checkpoint at tick 20 on the card, resumed 20 ticks: {n} "
        "leaves bit-equal to the run without the round trip")


def run_viz_phase(cfg, device, logs):
    """U3: viz.mpc_predictions of H7's logs on the card against the CPU,
    float64 (1e-9 of scale)."""
    from qrw_tpu_torch.utils import viz

    kernels.reset_launches()
    sync_if(device)
    t0 = time.perf_counter()
    ticks, card = viz.mpc_predictions(logs, cfg, device=device)
    wall = time.perf_counter() - t0
    _, cpu = viz.mpc_predictions(logs, cfg, device="cpu")
    err = float(np.abs(card - cpu).max()) / max(1.0, np.abs(cpu).max())
    assert err <= 1e-9, err
    assert_no_kernel("U3 mpc_predictions")
    log(f"U3 viz.mpc_predictions: {len(ticks)} cycles re-solved in one "
        f"batched float64 call on the card in {wall:.2f} s; card vs CPU "
        f"{err:.3g} of scale")


def run_mesh_phase(cfg, device):
    """U4: the CLI's --batch 8 --mesh at world size 1 (NCCL) against the
    unsharded --batch 8, leaf by leaf; scenario_metrics through the NCCL
    all-reduce against the plain reductions."""
    from qrw_tpu_torch.parallel.mesh import make_mesh, scenario_metrics
    from qrw_tpu_torch.runtime import main as cli

    kernels.reset_launches()
    argv = ["--batch", str(MESH_B), "--ticks", str(MESH_TICKS)]
    with Recorder(cli, "run_single") as rec:
        code = cli.main(argv + ["--mesh", "--device", device])
    assert code == 0, code
    (_, sharded, wall), = rec.out
    bcfg = cfg.replace(N_SIMULATION=MESH_TICKS)
    _, plain, _ = cli.run_single(bcfg, cli.build_argparser().parse_args(
        argv), device, torch.float32)
    for f, a, b in zip(plain._fields, sharded, plain):
        assert torch.equal(a.cpu(), b.cpu()), f"{f} differs sharded"
    mesh = make_mesh(device=device)
    try:
        rng = np.random.default_rng(4)
        errors = torch.as_tensor(rng.random(64) < 0.2, device=mesh.device)
        iters = torch.as_tensor(rng.integers(25, 500, size=64),
                                dtype=torch.int32, device=mesh.device)
        m = {k: float(v) for k, v in
             scenario_metrics(errors, iters, mesh).items()}
        backend = torch.distributed.get_backend()
    finally:
        mesh.close()
    e, i = errors.cpu().numpy(), iters.cpu().numpy()
    assert m["max_iters"] == i.max()
    assert abs(m["error_rate"] - e.astype(np.float32).mean()) < 1e-6
    assert abs(m["mean_iters"] - i.astype(np.float32).mean()) < 1e-3
    assert_no_kernel("U4 mesh")
    log(f"U4 --batch {MESH_B} --mesh ({backend}, world size 1), "
        f"{MESH_TICKS} ticks in {wall:.2f} s: {len(plain._fields)} log "
        f"leaves equal to the unsharded run; scenario_metrics all-reduced "
        f"{m} = the plain reductions")


def run_util_phases(cfg, device, clock, logs):
    """U1-U4 in order; returns U1's stage timings."""
    t = run_stage_timings(cfg, device)
    run_checkpoint_phase(cfg, device)
    run_viz_phase(cfg, device, logs)
    run_mesh_phase(cfg, device)
    clock.lap("U1-U4")
    return t


# ----------------------------------------------------------------------
# The full-size batched MPC path (kernels K2 at n = 192, m = 512 and K3)
# ----------------------------------------------------------------------

def full_settings():
    """The entry point's QP settings (kernel_profile.py)."""
    from qrw_tpu_torch.ops import qp
    return qp.QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=450,
                         adaptive_rho_interval=200)


def full_problems(cfg, B, device, shift=0.0, seed=0):
    """B full-size condensed QPs of the entry point's build_batch (the
    current state shifted by `shift`): (H, q, A, l, u, cone)."""
    from qrw_tpu_torch.core import mpc as tm
    from qrw_tpu_torch.eval.kernel_profile import build_batch
    from qrw_tpu_torch.ops import qp
    xr, fs = build_batch(cfg, B, np.random.default_rng(seed))
    xr[:, :, 0] += shift
    t = lambda a: torch.as_tensor(a, device=device)
    H, q, l, u, _, _ = tm.build_qp_compact(cfg, t(xr), t(fs))
    A = torch.as_tensor(tm.cone_matrix(cfg.n_steps, cfg.mu),
                        dtype=torch.float32, device=device)
    return H, q, A, l, u, qp.ConeStructure(cfg.n_steps, cfg.mu)


def full_kkt(H, q, A, l, u, cone, rho=0.1):
    """K, rho', sigma' at a uniform rho, with the solver's Ruiz scaling."""
    from qrw_tpu_torch.ops import qp_pallas as qpp
    _, sig, rho_to_vec = qpp.precondition(H, q, A, l, u, full_settings())
    rho_vec = rho_to_vec(torch.full((q.shape[0], 1), rho,
                                    device=q.device))
    return (qpp._build_K(H, A, rho_vec, sig, cone).contiguous(), rho_vec,
            sig)


def good_seed(cfg, B, device):
    """(K, seed): K of B problems at rho 0.1 and the inverse of the same
    problems 0.1 mm of state earlier (a good Newton-Schulz seed)."""
    from qrw_tpu_torch.ops import qp_pallas as qpp
    K, _, _ = full_kkt(*full_problems(cfg, B, device))
    K_prev, _, _ = full_kkt(*full_problems(cfg, B, device, shift=-1e-4))
    return K, qpp._chol_inv(K_prev).contiguous()


def bad_flags(resid):
    """_factor's guard: not finite, or above 1e-2."""
    return ~torch.isfinite(resid) | (resid > 1e-2)


def plain_ns_refine(K, X0, ns_iters):
    """ops/qp_pallas._ns_refine with K3's plain version on any device."""
    from qrw_tpu_torch.ops import qp_pallas as qpp
    X, resid = qpp._ns_refine_plain(K, X0, ns_iters)
    return 0.5 * (X + X.transpose(1, 2)), resid


class solver_path:
    """Run ops/qp_pallas with the kernels ("kernel") or with their plain
    versions ("plain", on purpose), recording the residual of every
    Newton-Schulz refinement in `resids`."""

    def __init__(self, which):
        self.which, self.resids = which, []

    def __enter__(self):
        from qrw_tpu_torch.ops import qp_pallas as qpp
        self.saved = (qpp._run_kernel, qpp._ns_refine)
        ns = plain_ns_refine if self.which == "plain" else qpp._ns_refine

        def record(K, X0, ns_iters):
            X, resid = ns(K, X0, ns_iters)
            self.resids.append(resid)
            return X, resid
        qpp._ns_refine = record
        if self.which == "plain":
            qpp._run_kernel = lambda *a, tile=16, K=None, cone=None: \
                qpp._run_kernel_plain(*a, K=K)
        return self

    def __exit__(self, *exc):
        from qrw_tpu_torch.ops import qp_pallas as qpp
        qpp._run_kernel, qpp._ns_refine = self.saved


def rho_differs(got, want):
    """Problems whose adapted rho differs between the two paths."""
    return ((got.rho / want.rho).flatten() - 1.0).abs() > 1e-3


def near_threshold(sol, P, A, q, s):
    """Problems whose termination test reads a residual within a factor 2
    of its threshold: max(pri / eps_pri, dua / eps_dua) in (0.5, 2), with
    OSQP's thresholds from the returned iterate."""
    amax = lambda v: v.abs().amax(dim=1)
    Ax = sol.x @ A.T
    Px = torch.einsum("bij,bi->bj", P, sol.x)
    n1 = torch.maximum(amax(Ax), amax(sol.z))
    n2 = torch.maximum(torch.maximum(amax(Px), amax(sol.y @ A)), amax(q))
    ratio = torch.maximum(sol.pri_res / (s.eps_abs + s.eps_rel * n1),
                          sol.dua_res / (s.eps_abs + s.eps_rel * n2))
    return (ratio > 0.5) & (ratio < 2.0)


def compare_solves(name, got, want, kpath, ppath, tol, excuse=None,
                   why=""):
    """Kernel path vs plain path of one solve: x, y, z within `tol` of
    their scale; converged flags and iteration counts equal except on
    problems whose K3 bad flag differed between the paths and on those
    in `excuse` (counted and printed with `why`): for a cold solve the
    problems whose adapted rho differs between the paths (the rho rule
    reads residuals at the float32 round-off floor, ROADMAP queue 3), for
    the "stale" policy those reading a residual near its threshold (its
    refinement stalls at its noise floor next to the 1e-4 tolerances,
    qrw_tpu/ops/qp_pallas.py:410-415), and for the "ns" policy the same
    (K3's resident variant rounds its products as 3xTF32, so the refined
    K^-1 differs from the plain one by ~1e-6 of its scale, and a residual
    within 2x of its threshold may land on the other side). Returns the
    worst absolute error."""
    excused = torch.zeros_like(want.converged)
    for rk, rp in zip(kpath.resids, ppath.resids):
        excused |= bad_flags(rk) != bad_flags(rp)
    n_exc = int(excused.sum())
    n_more = 0
    if excuse is not None:
        n_more = int((excuse & ~excused).sum())
        excused = excused | excuse
    flag_diff = (got.converged != want.converged) | (got.iters != want.iters)
    n_conv = int((got.converged != want.converged).sum())
    n_it = int((got.iters != want.iters).sum())
    n_unexcused = int((flag_diff & ~excused).sum())
    worst, errs, fails = 0.0, [], []
    for f in ("x", "y", "z"):
        g, w = getattr(got, f), getattr(want, f)
        keep = ~excused[:, None].expand_as(w)
        e = float((g - w)[keep].abs().max()) if bool(keep.any()) else 0.0
        lim = tol * max(1.0, float(w.abs().max()))
        errs.append(e)
        worst = max(worst, e)
        if not bool(torch.isfinite(g).all()):
            fails.append(f"{f} not finite")
        if not e <= lim:
            fails.append(f"{f}: {e:.3e} > {lim:.3e}")
    rr = (got.rho / want.rho).flatten()
    log(f"{name}: conv kernel {float(got.converged.float().mean()):.4f} "
        f"plain {float(want.converged.float().mean()):.4f}, mean iters "
        f"{float(got.iters.float().mean()):.1f}; K3 bad flags differing "
        f"{n_exc}; {why or 'other excused'} {n_more}; flag mismatches "
        f"conv {n_conv} iters {n_it} "
        f"(unexcused {n_unexcused}); max|dx| {errs[0]:.2e} max|dy| "
        f"{errs[1]:.2e} max|dz| {errs[2]:.2e} (limit {tol:g} of scale); "
        f"rho ratio [{float(rr.min()):.4f}, {float(rr.max()):.4f}]")
    assert not fails, f"{name}: {fails}"
    assert n_unexcused == 0, f"{n_unexcused} flags differ outside K3's"
    return worst


def bmm_chain(K, X, ns_iters, T, P):
    """The library yardstick of K3: its 2 ns_iters + 1 products as
    torch.bmm calls (cuBLAS, TF32 off) into preallocated outputs. The
    port never calls it."""
    for _ in range(ns_iters):
        torch.bmm(K, X, out=T)
        torch.bmm(X, T, out=P)
    torch.bmm(K, X, out=T)


def check_ns_kernel(cfg, device):
    """Phase 7: K3's two variants against its plain version at B =
    FULL_B, then timed at FULL_TIME_B. Returns (max_abs_err of the
    resident variant, and for ns_iters 3 and 0 dicts of its time, the
    general variant's, the plain version's, the bmm chain's and both
    bounds)."""
    from qrw_tpu_torch.ops import qp_pallas as qpp
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls on"
    K, good = good_seed(cfg, FULL_B, device)
    rolled = torch.roll(good, 1, dims=0).contiguous()
    assert qpp.ns_variant(K.shape[-1]) == "resident"
    n_cl = qpp.ns_max_active_clusters()
    log(f"K3 resident variant: a cluster of 2 blocks a problem, "
        f"{n_cl} clusters on the card at once")
    worst = 0.0
    for variant in ("resident", "general"):
        for name, X0, ns in [("3 steps, good seed", good, 3),
                             ("3 steps, rolled-stance seed", rolled, 3),
                             ("no step, good seed", good, 0)]:
            Xk, rk = qpp._ns_launch(K, X0, ns, variant=variant)
            Xp, rp = plain_ns_refine(K, X0, ns)
            torch.cuda.synchronize()
            fin = torch.isfinite(Xp)
            n_fin = int((torch.isfinite(Xk) != fin).sum())
            e = float((Xk - Xp)[fin].abs().max()) if bool(fin.any()) else 0.0
            scale = float(Xp[fin].abs().max()) if bool(fin.any()) else 1.0
            if variant == "resident":
                worst = max(worst, e)
            rk_, rp_ = (torch.where(torch.isfinite(r), r, torch.full_like(
                r, float("inf"))) for r in (rk, rp))
            both = torch.isfinite(rk_) & torch.isfinite(rp_)
            d_r = (rk_ - rp_).abs()
            lim_r = torch.clamp(NS_RESID_REL * rp_.abs(), min=NS_RESID_ABS)
            r_abs = float(d_r[both].max()) if bool(both.any()) else 0.0
            r_rel = float((d_r / rp_.abs().clamp(min=1e-30))[both].max()) \
                if bool(both.any()) else 0.0
            n_rout = int((d_r > lim_r)[both].sum())
            n_rinf = int((torch.isfinite(rk_) != torch.isfinite(rp_)).sum())
            n_bad = int((bad_flags(rk) != bad_flags(rp)).sum())
            n_near = int(((rp > 0.5e-2) & (rp < 2e-2)).sum())
            log(f"K3 qp_ns_refine {variant} B={FULL_B} n=192 {name}: bad "
                f"kernel {int(bad_flags(rk).sum())} plain "
                f"{int(bad_flags(rp).sum())} (differing {n_bad}, resid "
                f"within 2x of 1e-2: {n_near}); resid median "
                f"{float(rp.median()):.3e}; max|dX| {e:.2e} of max|X| "
                f"{scale:.3g} ({e / scale:.2e}); finite pattern mismatches "
                f"{n_fin}; resid max|diff| {r_abs:.2e}, rel {r_rel:.2e}, "
                f"outside max({NS_RESID_REL:g} rel, {NS_RESID_ABS:g}) "
                f"{n_rout}, inf mismatches {n_rinf}")
            assert n_fin == 0, "K3 finite pattern differs"
            assert e <= NS_TOL * scale, (
                f"K3 {variant} X: {e:.3e} > {NS_TOL} * {scale:.3g}")
            assert n_rinf == 0 and n_rout == 0, f"K3 {variant} resid"
            assert n_bad <= n_near, f"{n_bad} K3 bad flags differ"
    K, good = good_seed(cfg, FULL_TIME_B, device)
    n = K.shape[-1]
    T, P = torch.empty_like(K), torch.empty_like(K)
    X1 = torch.empty_like(K)
    out = []
    for ns in (3, 0):
        k_ms = time_ms(lambda: qpp._ns_launch(K, good, ns))
        g_ms = time_ms(lambda: qpp._ns_launch(K, good, ns,
                                              variant="general"))
        p_ms = time_ms(lambda: qpp._ns_refine_plain(K, good, ns))
        l_ms = time_ms(lambda: bmm_chain(K, good, ns, T, P))
        c_ms = time_ms(lambda: torch.mul(good + good.transpose(1, 2), 0.5,
                                         out=X1))
        work = k3_work(FULL_TIME_B, n, ns)
        b, b32 = bound_3xtf32(*work), bound(*work)
        log(f"K3 qp_ns_refine B={FULL_TIME_B} ns_iters={ns}: resident "
            f"{k_ms[0]:.3f} ms [{k_ms[1]:.3f}, {k_ms[2]:.3f}], general "
            f"{g_ms[0]:.3f} ms [{g_ms[1]:.3f}, {g_ms[2]:.3f}] (of which the "
            f"wrapper's re-centring pass {c_ms[0]:.3f} ms), plain "
            f"{p_ms[0]:.3f} ms [{p_ms[1]:.3f}, {p_ms[2]:.3f}], "
            f"{2 * ns + 1} torch.bmm {l_ms[0]:.3f} ms [{l_ms[1]:.3f}, "
            f"{l_ms[2]:.3f}] (median [min, max] of 7 windows); 3xTF32 "
            f"bound {b[0]:.4f} ms ({b[1]}): resident {100 * b[0] / k_ms[0]:.1f}"
            f"%, general {100 * b[0] / g_ms[0]:.1f}%; float32 bound "
            f"{b32[0]:.4f} ms ({b32[1]}): resident "
            f"{100 * b32[0] / k_ms[0]:.1f}%, general "
            f"{100 * b32[0] / g_ms[0]:.1f}%; resident "
            f"{g_ms[0] / k_ms[0]:.2f}x faster than general, "
            f"{l_ms[0] / k_ms[0]:.2f}x than the bmm chain")
        out.append({"ms": k_ms[0], "general_ms": g_ms[0],
                    "recentre_ms": c_ms[0], "plain_ms": p_ms[0],
                    "library_ms": l_ms[0], "bound": b, "bound_f32": b32})
    return worst, out[0], out[1]


def check_full_kernel(cfg, device):
    """Phase 8: K2 at n = 192, m = 512 against its plain version. Returns
    (max_abs_err of the single rounds, on the same inputs, (ms, lo, hi),
    (plain_ms, lo, hi), (bound_ms, bound_by)) of one 50-iteration round
    at B = FULL_TIME_B, and the same for the K_ref variant."""
    from qrw_tpu_torch.ops import qp_pallas as qpp
    s = full_settings()
    H, q, A, l, u, cone = full_problems(cfg, FULL_B, device)
    H2, q2, _, l2, u2, _ = full_problems(cfg, FULL_B, device, shift=0.001)
    worst = 0.0
    with solver_path("kernel") as kp:
        cold = qpp.solve(H, q, A, l, u, s, cone=cone)
    with solver_path("plain") as pp:
        cold_p = qpp.solve(H, q, A, l, u, s, cone=cone)
    torch.cuda.synchronize()
    compare_solves(f"K2 qp_admm B={FULL_B} n=192 m=512 whole cold solve",
                   cold, cold_p, kp, pp, COLD_SOLVE_TOL,
                   rho_differs(cold, cold_p), "adapted rho differing")
    carry = dict(x0=cold.x, y0=cold.y, rho_init=cold.rho,
                 precond=cold.precond, kinv_init=cold.kinv,
                 kinv_rho=cold.kinv_rho, cone=cone, schedule=[50])
    for policy in ("ns", "chol", "stale"):
        with solver_path("kernel") as kp:
            got = qpp.solve(H2, q2, A, l2, u2, s, refactor=policy, **carry)
        with solver_path("plain") as pp:
            want = qpp.solve(H2, q2, A, l2, u2, s, refactor=policy, **carry)
        torch.cuda.synchronize()
        floor = None if policy == "chol" else (
            near_threshold(got, H2, A, q2, s) | near_threshold(want, H2, A,
                                                             q2, s))
        compare_solves(f"K2 qp_admm B={FULL_B} whole warm solve "
                       f"\"{policy}\" (1 mm shift, schedule [50])", got, want,
                       kp, pp, NS_SOLVE_TOL if policy == "ns" else SOLVE_TOL,
                       floor, "near the tolerance")
    # single rounds on fixed inputs
    K, rho_vec, sig = full_kkt(H, q, A, l, u, cone)
    K2, rho_vec2, sig2 = full_kkt(H2, q2, A, l2, u2, cone)
    zeros = (torch.zeros_like(q), torch.zeros_like(l))
    rounds = [("cold", (qpp._chol_inv(K), H, A, q, l, u, rho_vec, sig,
                        *zeros), None),
              ("warm", (qpp._chol_inv(K2), H2, A, q2, l2, u2, rho_vec2, sig2,
                        cold.x, cold.y), None),
              ("K_ref, previous inverse", (qpp._chol_inv(K), H2, A, q2, l2,
                                           u2, rho_vec2, sig2, cold.x,
                                           cold.y), K2)]
    for name, args, Kr in rounds:
        args = args + (s.alpha, 50)
        got = qpp._run_kernel(*args, K=Kr, cone=cone)
        want = qpp._run_kernel_plain(*args, K=Kr)
        dense = qpp._run_kernel(*args, K=Kr)
        torch.cuda.synchronize()
        errs = []
        for f, g, w, d in zip(("x", "y", "z"), got[:3], want[:3], dense[:3]):
            assert torch.isfinite(g).all(), f"K2 full round {f} not finite"
            e = float((g - w).abs().max())
            e_d = float((d - w).abs().max())
            errs.append(e)
            worst = max(worst, e)
            lim = REL_TOL * max(1.0, float(w.abs().max()))
            assert e <= lim, f"K2 full round {name} {f}: {e:.3e} > {lim:.3e}"
            assert e_d <= lim, f"K2 dense {name} {f}: {e_d:.3e} > {lim:.3e}"
        flag = lambda r: ((r[3] <= s.eps_abs + s.eps_rel * r[5])
                          & (r[4] <= s.eps_abs + s.eps_rel * torch.maximum(
                              r[6], args[3].abs().amax(dim=1))))
        n_flag = int((flag(got) != flag(want)).sum())
        n_flag_d = int((flag(dense) != flag(want)).sum())
        log(f"K2 qp_admm B={FULL_B} n=192 m=512 one 50-iteration round "
            f"{name}: converged cone kernel {int(flag(got).sum())} plain "
            f"{int(flag(want).sum())} (mismatches {n_flag}, dense kernel "
            f"{n_flag_d}); max|dx| {errs[0]:.2e} max|dy| {errs[1]:.2e} "
            f"max|dz| {errs[2]:.2e}")
        assert n_flag == 0, f"{n_flag} round flags differ"
        assert n_flag_d == 0, f"{n_flag_d} dense round flags differ"
    # timings at the entry point's batch: a round from zero, and K_ref
    H, q, A, l, u, cone = full_problems(cfg, FULL_TIME_B, device)
    K, rho_vec, sig = full_kkt(H, q, A, l, u, cone)
    Kinv = qpp._chol_inv(K).contiguous()
    args = (Kinv, H, A, q, l, u, rho_vec, sig, torch.zeros_like(q),
            torch.zeros_like(l), s.alpha, 50)
    n, m = q.shape[1], A.shape[0]
    out, variants = [], {}
    for name, Kr in (("plain", None), ("K_ref", K)):
        kr = Kr is not None
        k_ms = time_ms(lambda: qpp._run_kernel(*args, K=Kr, cone=cone))
        d_ms = time_ms(lambda: qpp._run_kernel(*args, K=Kr))
        p_ms = time_ms(lambda: qpp._run_kernel_plain(*args, K=Kr))
        b = bound(*k2_cone_work(FULL_TIME_B, n, m, 50, cone, k_ref=kr))
        b_d = bound(*k2_work(FULL_TIME_B, n, m, 50, k_ref=kr))
        log(f"K2 qp_admm B={FULL_TIME_B} n=192 m=512 one 50-iteration round "
            f"({name}): cone kernel {k_ms[0]:.3f} ms [{k_ms[1]:.3f}, "
            f"{k_ms[2]:.3f}] (cone bound {b[0]:.4f} ms, {b[1]}: "
            f"{100 * b[0] / k_ms[0]:.1f}%; dense bound {b_d[0]:.4f} ms: "
            f"{100 * b_d[0] / k_ms[0]:.1f}%), dense kernel {d_ms[0]:.3f} ms "
            f"[{d_ms[1]:.3f}, {d_ms[2]:.3f}] ({100 * b_d[0] / d_ms[0]:.2f}% "
            f"of the dense bound), plain {p_ms[0]:.3f} ms [{p_ms[1]:.3f}, "
            f"{p_ms[2]:.3f}] (median [min, max] of 7 windows); cone "
            f"{d_ms[0] / k_ms[0]:.1f}x faster than dense")
        out.append((k_ms, p_ms, b))
        key = "_k_ref" if kr else ""
        variants["cone" + key] = variant(k_ms, b)
        variants["dense" + key] = variant(d_ms, b_d)
        # the cone round's cost split: one iteration against fifty
        one = time_ms(lambda: qpp._run_kernel(*args[:-1], 1, K=Kr,
                                              cone=cone))
        per_it = (k_ms[0] - one[0]) / 49
        log(f"K2 cone B={FULL_TIME_B} ({name}): a 1-iteration round "
            f"{one[0]:.3f} ms [{one[1]:.3f}, {one[2]:.3f}], so "
            f"{1e3 * per_it:.2f} us an iteration and "
            f"{one[0] - per_it:.3f} ms a launch outside the iterations")
        variants["cone" + key]["one_iteration_ms"] = one[0]
    return (worst,) + out[0] + (out[1], variants)


def check_full_path(cfg, device):
    """Phase 9: solve_mpc_batch_pallas with the kernels against it with
    the plain versions, B = PATH_B: cold, then warm "ns" and "stale" from
    the kernel path's cold carry on a 1 mm shifted state."""
    from qrw_tpu_torch.core import mpc as tm
    from qrw_tpu_torch.eval.kernel_profile import build_batch
    s = full_settings()
    xr, fs = build_batch(cfg, PATH_B, np.random.default_rng(1))
    t = lambda a: torch.as_tensor(a, device=device)
    xr2 = xr.copy()
    xr2[:, :, 0] += 0.001
    with solver_path("kernel") as kp:
        cold = tm.solve_mpc_batch_pallas(cfg, t(xr), t(fs), settings=s)
    with solver_path("plain") as pp:
        cold_p = tm.solve_mpc_batch_pallas(cfg, t(xr), t(fs), settings=s)
    H2, q2, _, _, _, _ = tm.build_qp_compact(cfg, t(xr2), t(fs))
    A = torch.as_tensor(tm.cone_matrix(cfg.n_steps, cfg.mu),
                        dtype=torch.float32, device=device)
    runs = [("cold", cold, cold_p, kp, pp)]
    for policy in ("ns", "stale"):
        with solver_path("kernel") as kp:
            got = tm.solve_mpc_batch_pallas(cfg, t(xr2), t(fs), state=cold[1],
                                            settings=s, refactor=policy)
        with solver_path("plain") as pp:
            want = tm.solve_mpc_batch_pallas(cfg, t(xr2), t(fs),
                                             state=cold[1], settings=s,
                                             refactor=policy)
        runs.append((f"warm \"{policy}\"", got, want, kp, pp))
    torch.cuda.synchronize()
    for name, got, want, kp, pp in runs:
        tol, why, excuse = SOLVE_TOL, "", None
        if name == "cold":
            tol, why = COLD_SOLVE_TOL, "adapted rho differing"
            excuse = rho_differs(got[2], want[2])
        else:
            why = "near the tolerance"
            if "ns" in name:
                tol = NS_SOLVE_TOL
            excuse = (near_threshold(got[2], H2, A, q2, s)
                      | near_threshold(want[2], H2, A, q2, s))
        compare_solves(f"full path B={PATH_B} {name} (solver)", got[2],
                       want[2], kp, pp, tol, excuse, why)
        excused = torch.zeros_like(want[2].converged)
        for rk, rp in zip(kp.resids, pp.resids):
            excused |= bad_flags(rk) != bad_flags(rp)
        if excuse is not None:
            excused |= excuse
        a, b = got[0][~excused], want[0][~excused]
        assert torch.isfinite(got[0]).all(), f"full path {name} x_f"
        e = float((a - b).abs().max())
        lim = tol * max(1.0, float(b.abs().max()))
        log(f"full path B={PATH_B} {name}: x_f (24 x N a problem) max "
            f"|diff| {e:.2e} (limit {lim:.2e})")
        assert e <= lim, f"full path {name} x_f: {e:.3e} > {lim:.3e}"


def run_entry_point(cfg, device, argv=PROFILE_ARGV):
    """Phase 10: the entry point at full width. Returns (K2 launches, K3
    launches, its JSON dict)."""
    from qrw_tpu_torch.core import mpc as tm
    from qrw_tpu_torch.eval import kernel_profile
    tiles = argv[argv.index("--tiles") + 1:]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = kernel_profile.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k3 = launched(*K2), launched(*K3)
    k2_dense, k3_general = launched(K2_DENSE), launched(K3_GENERAL)
    log(f"entry point python -m qrw_tpu_torch.eval.kernel_profile "
        f"{' '.join(argv)}: {wall:.2f} s; K2 launches {k2} ({k2_dense} of "
        f"the dense variant), K3 launches {k3} ({k3_general} of the "
        f"general variant)")
    log(json.dumps(res))
    assert k2_dense == 0, f"{k2_dense} launches of K2's dense variant"
    assert k3_general == 0, f"{k3_general} launches of K3's general variant"
    assert k2 == PROFILE_K2_LAUNCHES * len(tiles), f"{k2} K2 launches"
    assert k3 == PROFILE_K3_LAUNCHES * len(tiles), f"{k3} K3 launches"
    for tile in tiles:
        cold = res[f"tile{tile}_cold_conv"]
        warm = res[f"tile{tile}_ns_50it"]["conv"]
        assert cold >= FULL_CONV_BAR, f"cold conv {cold}"
        assert warm >= FULL_CONV_BAR, f"warm ns conv {warm}"
    # every policy's outputs finite, on the entry point's inputs
    B = int(argv[argv.index("--batch") + 1])
    xr, fs = kernel_profile.build_batch(cfg, B, np.random.default_rng(0))
    xs, fs = torch.as_tensor(xr, device=device), torch.as_tensor(
        fs, device=device)
    s = full_settings()
    _, st, _ = tm.solve_mpc_batch_pallas(cfg, xs, fs, settings=s)
    for policy, iters in (("ns", 50), ("ns", 1), ("chol", 50),
                          ("stale", 50)):
        x_f, st2, sol = tm.solve_mpc_batch_pallas(
            cfg, xs, fs, state=st, settings=s, refactor=policy,
            schedule=[iters])
        bad = [name for name, v in [("x_f", x_f)] + list(zip(st2._fields,
                                                              st2))
               if not bool(torch.isfinite(v).all())]
        log(f"entry point inputs, warm \"{policy}\" {iters} it: conv "
            f"{float(sol.converged.float().mean()):.4f}, non-finite "
            f"outputs {bad}")
        assert not bad, f"{policy}: non-finite {bad}"
        if (policy, iters) == ("ns", 1):
            # one iteration from the carried solution leaves most
            # problems at their threshold: the plain path's conv beside
            # the kernels', a measurement, not a check
            with solver_path("plain"):
                _, _, sol_p = tm.solve_mpc_batch_pallas(
                    cfg, xs, fs, state=st, settings=s, refactor=policy,
                    schedule=[iters])
            log(f"entry point inputs, warm \"ns\" 1 it with the plain "
                f"versions: conv {float(sol_p.converged.float().mean()):.4f}"
                f", converged flags differing from the kernels' "
                f"{int((sol.converged != sol_p.converged).sum())}")
    return k2, k3, res


class stage_timer:
    """Wrap module functions so that every call is timed with CUDA events
    between two synchronizations; `ms[label]` sums its milliseconds and
    `calls[label]` counts its calls. An outer stage's time includes the
    stages it calls."""

    def __init__(self, targets):
        self.targets = targets          # [(label, module, attribute)]
        self.ms = {label: 0.0 for label, _, _ in targets}
        self.calls = {label: 0 for label, _, _ in targets}

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr))
                      for _, mod, attr in self.targets]
        for (label, mod, attr), (_, _, fn) in zip(self.targets, self.saved):
            setattr(mod, attr, self._timed(label, fn))
        return self

    def _timed(self, label, fn):
        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            out = fn(*args, **kw)
            b.record()
            torch.cuda.synchronize()
            self.ms[label] += a.elapsed_time(b)
            self.calls[label] += 1
            return out
        return timed

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def split_ns_cycle(cfg, device, B=FULL_TIME_B, reps=5):
    """Phase 10b: one warm "ns" 50-iteration call of
    solve_mpc_batch_pallas at B, split into its stages (CUDA events
    between synchronizations, mean of `reps` calls after one warm-up).
    Returns {stage: ms} with the whole call's time with and without
    the synchronizations."""
    from qrw_tpu_torch.core import mpc as tm
    from qrw_tpu_torch.eval.kernel_profile import build_batch
    from qrw_tpu_torch.ops import qp_pallas as qpp
    s = full_settings()
    xr, fs = build_batch(cfg, B, np.random.default_rng(0))
    xs, fs = torch.as_tensor(xr, device=device), torch.as_tensor(
        fs, device=device)
    _, st, _ = tm.solve_mpc_batch_pallas(cfg, xs, fs, settings=s)
    call = lambda: tm.solve_mpc_batch_pallas(
        cfg, xs, fs, state=st, settings=s, refactor="ns", schedule=[50])
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / reps * 1e3
    targets = [("build_qp_compact", tm, "build_qp_compact"),
               ("precondition", qpp, "precondition"),
               ("cone check (host read)", qpp, "check_cone"),
               ("_build_K", qpp, "_build_K"),
               ("_factor", qpp, "_factor"),
               ("K3", qpp, "_ns_refine"),
               ("Cholesky of the cap worst", qpp, "_chol_inv"),
               ("K2 round", qpp, "_run_kernel"),
               ("recover_dx", tm, "recover_dx"),
               ("whole call", tm, "solve_mpc_batch_pallas")]
    with stage_timer(targets) as tmr:
        for _ in range(reps):
            call()
    ms = {k: v / reps for k, v in tmr.ms.items()}
    assert tmr.calls["K3"] == reps and tmr.calls["K2 round"] == reps
    top = ("build_qp_compact", "precondition", "cone check (host read)",
           "_build_K", "_factor", "K2 round", "recover_dx")
    split = {
        "build_qp_compact": ms["build_qp_compact"],
        "cone check (host read)": ms["cone check (host read)"],
        "_build_K": ms["_build_K"],
        "K3": ms["K3"],
        "top-k and Cholesky (_factor less K3)": ms["_factor"] - ms["K3"],
        "of which the Cholesky of the cap worst":
            ms["Cholesky of the cap worst"],
        "K2 round": ms["K2 round"],
        "recover_dx": ms["recover_dx"],
        "precondition": ms["precondition"],
        "glue (the rest)": ms["whole call"] - sum(ms[k] for k in top),
        "whole call, split": ms["whole call"],
        "whole call, unsplit (host clock)": plain_ms}
    log(f"warm \"ns\" 50 cycle at B={B}, split (ms, mean of {reps} calls "
        f"with a synchronization around each stage): " + "; ".join(
            f"{k} {v:.3f}" for k, v in split.items()))
    return split


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from qrw_tpu_torch.config import Config
    from qrw_tpu_torch.core import mpc_lane as ml

    device = "cuda"
    card = card_line()
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    clock = Clock()
    t0 = time.perf_counter()
    kernels.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.BUILD_SECONDS if kernels.BUILD_SECONDS is None else round(kernels.BUILD_SECONDS, 2)} s)")
    for line in kernels.BUILD_LOG.splitlines():
        if any(w in line for w in ("registers", "spill", "smem",
                                   "entry function")):
            log(f"  ptxas: {line.strip()}")

    cfg = Config()
    ps = ml.build_phase_data(cfg, ml.trot_phase_fsteps(cfg), device=device)

    err, k_ms, p_ms, k_bound, k1_geo = check_kernel(cfg, ps, device,
                                                    B_KERNEL, TILE)
    # 2d: the JAX package's accelerator tile over a cluster of 16
    err512, k512_ms, p512_ms, k512_bound, k512_geo = check_kernel(
        cfg, ps, device, TILE512_B, TILE512, phase_ids=TILE512_PHASES)
    k512_geo.update(check_tile_answer(cfg, ps, device))
    # the heterogeneous fleet's union phase set (make_hetero_fleet's)
    ups = ml.union_phase_fsteps(cfg, [ml.gait_phase_fsteps(cfg, g)
                                      for g in HETERO_GAITS])
    ps48 = ml.build_phase_data(cfg, ups, device=device)
    err48s, k48s_ms, p48s_ms, k48s_bound, k48s_geo = check_kernel(
        cfg, ps48, device, B_KERNEL, TILE, phase_fs=ups)
    # ... and at the heterogeneous fleet's own B: 32 tiles, 15 resident
    err48, k48_ms, p48_ms, k48_bound, k48_geo = check_kernel(
        cfg, ps48, device, HETERO_B, TILE, phase_fs=ups)
    # 2e: cap 48 at tile 256 over a cluster of 16
    err48t, k48t_ms, p48t_ms, k48t_bound, k48t_geo = check_kernel(
        cfg, ps48, device, B_KERNEL, CAP48_TILE16, phase_fs=ups)
    # the trot -> static union set (parity_320 --switch static): cap 64
    ups64 = ml.union_phase_fsteps(cfg, [
        ml.gait_phase_fsteps(cfg, "trot"), ml.gait_phase_fsteps(cfg, "static"),
        ml.transition_phase_fsteps(cfg, "trot", "static")])
    ps64 = ml.build_phase_data(cfg, ups64, device=device)
    assert ps64.cap == 64 and ups64.shape[0] == 201, (ps64.cap, ups64.shape)
    err64, k64_ms, p64_ms, k64_bound, k64_geo = check_kernel(
        cfg, ps64, device, B_KERNEL, CAP64_TILE, phase_fs=ups64)
    # 2e: cap 64 at tile 64 over a cluster of 16
    err64t, k64t_ms, p64t_ms, k64t_bound, k64t_geo = check_kernel(
        cfg, ps64, device, B_KERNEL, CAP64_TILE16, phase_fs=ups64)
    del ps64
    err2, k2_ms, p2_ms, k2_bound, k2_variants = check_rescue_kernel(cfg,
                                                                    device)
    err144, k144_ms, p144_ms, k144_bound, k144_variants = \
        check_rescue_kernel(cfg, device, gait="walk")
    check_cone_bits(cfg, device)
    check_cone_nonfinite(cfg, device)
    kinv = check_kinv_kernel(cfg, device)
    clock.lap("kernel build, K1, K2 and K^-1 checks")
    k2_launches = run_rescue_path(cfg, device)
    kinv_launches = launched(KINV)      # since run_rescue_path's reset
    assert kinv_launches > 0
    launches, _ = run_main_path(cfg, device)
    check_slice(cfg, ps, device)
    capture, _ = run_shakedown(cfg, device)
    calibration = {"bounding": capture}
    k1_hetero, k2_hetero, _ = run_hetero_path(cfg, device, calibration)
    check_hetero_slice(cfg, device, calibration)
    clock.lap("the fleets and S1")
    run_batch_path(cfg, device)
    clock.lap("S2")
    check_card_vs_cpu(cfg, device)
    clock.lap("S3")
    _, parity_counts, _ = run_parity(cfg, device)
    clock.lap("E1")
    _, k1_tile512 = run_fleet_mpc_path(cfg, device)
    run_sweep_path(cfg, device)
    clock.lap("E2, E3")
    check_card_vs_cpu(cfg.replace(kf_enabled=True), device, label="E4")
    run_estimator_demo(cfg, device)
    clock.lap("E4, E5")
    d0, d0b = run_ddp_phases(cfg, device, clock)[0]
    h7_logs, _ = run_host_phases(cfg, device, clock)
    run_util_phases(cfg, device, clock, h7_logs)
    del h7_logs
    err3, k3, k3_ns0 = check_ns_kernel(cfg, device)
    err4, k4_ms, p4_ms, k4_bound, k4_ref, k4_variants = check_full_kernel(
        cfg, device)
    check_full_path(cfg, device)
    k2_full, k3_launches, _ = run_entry_point(cfg, device)
    split_ns_cycle(cfg, device)
    clock.lap("K3, K2 at n = 192, the full path and kernel_profile")

    log(json.dumps({"kernels": [{
        "name": "qp_phase", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_phase.cu",
        "replaces": "qrw_tpu/ops/qp_phase.py:233",
        "launches": launches, "max_abs_err": err,
        "ms": k_ms[0], "plain_ms": p_ms[0], "bound_ms": k_bound[0],
        "bound_by": k_bound[1], "library_ms": None, **k1_geo}, {
        "name": "qp_phase_tile512", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_phase.cu",
        "replaces": "qrw_tpu/ops/qp_phase.py:233",
        "launches": k1_tile512, "path": "--fleet-mpc (E2)",
        "max_abs_err": err512, "B": TILE512_B, "tile": TILE512,
        "ms": k512_ms[0], "plain_ms": p512_ms[0], "bound_ms": k512_bound[0],
        "bound_by": k512_bound[1], "library_ms": None,
        "share": k512_bound[0] / k512_ms[0], **k512_geo}, {
        "name": "qp_phase_cap48", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_phase.cu",
        "replaces": "qrw_tpu/ops/qp_phase.py:233",
        "launches": k1_hetero, "max_abs_err": max(err48, err48s),
        "B": HETERO_B, "ms": k48_ms[0], "plain_ms": p48_ms[0],
        "bound_ms": k48_bound[0], "bound_by": k48_bound[1],
        "library_ms": None, "share": k48_bound[0] / k48_ms[0], **k48_geo,
        f"B{B_KERNEL}": {"ms": k48s_ms[0], "plain_ms": p48s_ms[0],
                         "bound_ms": k48s_bound[0],
                         "share": k48s_bound[0] / k48s_ms[0],
                         "clusters_resident":
                             k48s_geo["clusters_resident"],
                         "sms": k48s_geo["sms"],
                         "excused": k48s_geo["excused"]},
        # no path of either package gives cap 48 at tile 256: 0 launches
        f"tile{CAP48_TILE16}": {
            "launches": 0, "max_abs_err": err48t, "B": B_KERNEL,
            "ms": k48t_ms[0], "plain_ms": p48t_ms[0],
            "bound_ms": k48t_bound[0], "bound_by": k48t_bound[1],
            "library_ms": None, "share": k48t_bound[0] / k48t_ms[0],
            **k48t_geo}}, {
        "name": "qp_phase_cap64", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_phase.cu",
        "replaces": "qrw_tpu/ops/qp_phase.py:233",
        "launches": parity_counts["switch"].get(64, 0),
        "max_abs_err": err64, "B": B_KERNEL, "tile": CAP64_TILE,
        "ms": k64_ms[0], "plain_ms": p64_ms[0], "bound_ms": k64_bound[0],
        "bound_by": k64_bound[1], "library_ms": None,
        "share": k64_bound[0] / k64_ms[0], **k64_geo,
        # no path of either package gives cap 64 at tile 64: 0 launches
        f"tile{CAP64_TILE16}": {
            "launches": 0, "max_abs_err": err64t, "B": B_KERNEL,
            "ms": k64t_ms[0], "plain_ms": p64t_ms[0],
            "bound_ms": k64t_bound[0], "bound_by": k64t_bound[1],
            "library_ms": None, "share": k64t_bound[0] / k64t_ms[0],
            **k64t_geo}}, {
        "name": "qp_admm", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_admm.cu",
        "replaces": "qrw_tpu/ops/qp_pallas.py:55",
        "launches": k2_launches, "max_abs_err": err2,
        "ms": k2_ms[0], "plain_ms": p2_ms[0], "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": None,
        "variants": {f"R{R}": v for R, v in k2_variants.items()}}, {
        "name": "qp_admm_n144", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_admm.cu",
        "replaces": "qrw_tpu/ops/qp_pallas.py:55",
        "launches": k2_hetero, "max_abs_err": err144,
        "ms": k144_ms[0], "plain_ms": p144_ms[0],
        "bound_ms": k144_bound[0], "bound_by": k144_bound[1],
        "library_ms": None, "share": k144_bound[0] / k144_ms[0],
        "variants": {f"R{R}": v for R, v in k144_variants.items()}}, {
        "name": "qp_admm_full", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_admm.cu",
        "replaces": "qrw_tpu/ops/qp_pallas.py:55",
        "launches": k2_full, "max_abs_err": err4,
        "ms": k4_ms[0], "plain_ms": p4_ms[0], "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1], "library_ms": None,
        "k_ref_ms": k4_ref[0][0], "k_ref_plain_ms": k4_ref[1][0],
        "k_ref_bound_ms": k4_ref[2][0], "variants": k4_variants}, {
        "name": "qp_ns_refine", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_ns_refine_tc.cu",
        "replaces": "qrw_tpu/ops/qp_pallas.py:194",
        "launches": k3_launches, "max_abs_err": err3,
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound"][0], "bound_by": k3["bound"][1],
        "library_ms": k3["library_ms"],
        "bound_f32_ms": k3["bound_f32"][0],
        "general_source": "qrw_tpu_torch/csrc/qp_ns_refine.cu",
        "general_ms": k3["general_ms"], "recentre_ms": k3["recentre_ms"],
        "ns0_ms": k3_ns0["ms"], "ns0_general_ms": k3_ns0["general_ms"],
        "ns0_plain_ms": k3_ns0["plain_ms"],
        "ns0_library_ms": k3_ns0["library_ms"],
        "ns0_bound_ms": k3_ns0["bound"][0],
        "ns0_bound_f32_ms": k3_ns0["bound_f32"][0]}, {
        "name": "qp_kinv", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/qp_kinv.cu",
        "replaces": None, "stands_for": "qrw_tpu/ops/qp_pallas.py:254",
        "launches": kinv_launches, "path": "rescue (phase 4)",
        "shapes": kinv}, {
        "name": "ddp_derivs", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/ddp_derivs.cu",
        "replaces": None, "stands_for": "qrw_tpu/ops/ilqr.py (jacfwd, "
        "jax.hessian)", "path": "core/mpc_ddp.solve_mpc_ddp (D0, D1)",
        **d0}, {
        "name": "ddp_linesearch", "route": "cuda",
        "source": "qrw_tpu_torch/csrc/ddp_linesearch.cu",
        "replaces": None, "stands_for": "qrw_tpu/ops/ilqr.py:118-132 "
        "(jax.vmap(forward))", "path": "core/mpc_ddp.solve_mpc_ddp (D0b, "
        "D1)", **d0b}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
