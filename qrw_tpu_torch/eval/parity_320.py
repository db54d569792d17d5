"""Solver parity over a 320-cycle closed-loop trot (BASELINE.md target:
"match OSQP-MPC ground-reaction forces / joint torques within tolerance
over a 320-step horizon").

Port of qrw_tpu/eval/parity_320.py, with its arguments and JSON keys.
Procedure:
  1. capture 320 MPC cycles (3200 control ticks) of the closed-loop trot
     at the reference's velID=2 ramp, in float64 (sim/rollout, the real
     complementary-filter estimator unless --perfect-estimator);
  2. re-solve every cycle's QP with
       a. the float64 interior-point ORACLE (eval/qp_oracle, a copy of
          tests/qp_oracle.py: the role OSQP plays for the reference),
       b. the production float32 path at its relaxed tolerance (eps
          1e-4): core/mpc.solve_mpc_batch_pallas at B = 1, cold on the
          first cycle, then warm cycle to cycle with one 100-iteration
          round and the Newton-Schulz refactorization ("ns"): kernels
          K2 (cone variant, n = 192, m = 512) and K3 on the card,
       c. the float64 per-problem path at reference tolerances (eps
          1e-6, core/mpc.solve_mpc), warm-started,
       d. the lane-major phase solver (core/mpc_lane, kernel K1 on the
          card), cold and as 16 warm phase streams;
  3. report the force errors against the oracle (first-step forces, the
     ones the WBC consumes, and the whole horizon), the relaxed path's
     convergence rate, and the joint-torque error that its first-step
     force error induces through tau = -Jc' f at the logged
     configuration.

    python -m qrw_tpu_torch.eval.parity_320 [--cycles 320]     # the card
    python -m qrw_tpu_torch.eval.parity_320 --cpu --cycles 16

Everything runs on the card unless --cpu is given (the oracle and the
torque map run in float64 numpy / torch on the host either way). On the
CPU the kernels' plain versions run in their place. Prints one JSON
dict.
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple

import numpy as np
import torch

SWITCH_CODES = {"pacing": 1, "bounding": 2, "trot": 3, "static": 4}

# K1's smallest tile: the phase solves group their problems into tiles
# of this many lanes, one phase a tile
PHASE_TILE = 32


def capture(cfg, n_cycles: int, perfect: bool = False, gait: str = "trot",
            switch_to: str = None, device="cuda"):
    """(C, 12, N+1) xrefs, (C, N_gait, 12) fsteps and (C, 12) joint
    angles from a closed-loop run driven by the velID profile, in
    float64 on `device`. perfect=False (the default) runs the real
    complementary-filter estimator. switch_to injects a one-tick
    joystick gait-switch pulse at the capture's midpoint."""
    from qrw_tpu_torch.sim.rollout import make_rollout, rollout

    n_ticks = n_cycles * cfg.k_mpc
    ctl, carry = make_rollout(cfg, dtype=torch.float64, gait=gait,
                              device=device)
    js = None
    if switch_to is not None:
        js = np.zeros(n_ticks, np.int32)
        js[(n_cycles // 2) * cfg.k_mpc] = SWITCH_CODES[switch_to]
    _, logs = rollout(ctl, carry, n_ticks, perfect_estimator=perfect,
                      joystick_schedule=js)
    assert not bool(logs.error.any()), "capture run latched"
    ticks = torch.arange(0, n_ticks, cfg.k_mpc, device=logs.error.device)
    host = lambda t: t[ticks].cpu().numpy()
    return host(logs.mpc_xref), host(logs.mpc_fsteps), host(logs.q_mes)


def build_phase_set(cfg, gait: str, switch_to: str = None):
    """(P, N_gait, 12) phase classes covering the capture: the cyclic
    set of `gait`, plus, for a switching capture, the target gait's set
    and the mixed transition windows."""
    from qrw_tpu_torch.core import mpc_lane as ml
    if switch_to is None:
        return ml.gait_phase_fsteps(cfg, gait)
    return ml.union_phase_fsteps(cfg, [
        ml.gait_phase_fsteps(cfg, gait),
        ml.gait_phase_fsteps(cfg, switch_to),
        ml.transition_phase_fsteps(cfg, gait, switch_to)])


def solve_oracle(cfg, xrefs, fsteps):
    """Ground-truth forces per cycle: the float64 interior-point method
    on the exact condensed QP (built on the host)."""
    from qrw_tpu_torch.core import mpc as mpc_mod
    from qrw_tpu_torch.eval.qp_oracle import solve_qp_oracle

    C = xrefs.shape[0]
    A = mpc_mod.cone_matrix(cfg.n_steps, cfg.mu)
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    H, qlin, l, u, _, _ = mpc_mod.build_qp(cfg, f64(xrefs), f64(fsteps))
    out = np.zeros((C, 12 * cfg.n_steps))
    for i in range(C):
        out[i] = solve_qp_oracle(H[i].numpy(), qlin[i].numpy(), A,
                                 l[i].numpy(), u[i].numpy(), tol=1e-10)
    return out


def relaxed_settings():
    """The relaxed production tolerances of solve_pallas_seq."""
    from qrw_tpu_torch.ops import qp
    return qp.QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=450,
                         adaptive_rho_interval=200)


def solve_pallas_seq(cfg, xrefs, fsteps, device="cuda"):
    """The production relaxed-tolerance path, warm-started cycle to cycle
    (the controller's 50 Hz pattern), one problem a call: a cold first
    call, then warm calls with one 100-iteration round and the
    Newton-Schulz refactorization, the production warm policy. On the
    card every warm call launches K3 and K2. Returns (forces (C, 12N)
    float64, converged (C,))."""
    from qrw_tpu_torch.core import mpc as mpc_mod

    settings = relaxed_settings()
    C = xrefs.shape[0]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    xs, fs = t(xrefs), t(fsteps)
    _, st, sol = mpc_mod.solve_mpc_batch_pallas(cfg, xs[0:1], fs[0:1],
                                                settings=settings)
    xs_out, conv = [sol.x[0]], [sol.converged[0]]
    for i in range(1, C):
        _, st, sol = mpc_mod.solve_mpc_batch_pallas(
            cfg, xs[i:i + 1], fs[i:i + 1], state=st, settings=settings,
            schedule=[100], refactor="ns")
        xs_out.append(sol.x[0])
        conv.append(sol.converged[0])
    return (torch.stack(xs_out).double().cpu().numpy(),
            torch.stack(conv).cpu().numpy().astype(bool).reshape(C))


def match_phases(cfg, ps, fsteps) -> np.ndarray:
    """(C,) index of the phase class whose stance support each cycle's
    fsteps has, -1 where none has it."""
    N = cfg.n_steps
    C = fsteps.shape[0]
    sup = (np.asarray(fsteps)[:, :N, 0::3] != 0).reshape(C, -1)
    supports = ps.supports.cpu().numpy()
    phases = np.full(C, -1, np.int32)
    for i in range(C):
        m = np.where((supports == sup[i]).all(axis=1))[0]
        if m.size:
            phases[i] = m[0]
    return phases


class Grouping(NamedTuple):
    src: np.ndarray        # (L,) problem each lane holds
    phases_of: np.ndarray  # (L // tile,) phase of each tile
    first: np.ndarray      # (n,) the lane that returns each problem


def group_by_phase(phases, tile: int) -> Grouping:
    """A lane layout that puts the problems of one phase into whole
    tiles of `tile` lanes (K1 takes one phase a tile): each phase's
    problems in order, the last tile filled with copies of the same
    phase's problems (np.resize repeats them)."""
    phases = np.asarray(phases)
    src, tiles = [], []
    for p in np.unique(phases):
        idx = np.where(phases == p)[0]
        n_t = -(-idx.size // tile)
        src.append(np.resize(idx, n_t * tile))
        tiles += [int(p)] * n_t
    src = np.concatenate(src)
    _, first = np.unique(src, return_index=True)
    return Grouping(src=src, phases_of=np.asarray(tiles, np.int32),
                    first=first)


def solve_phase_grouped(cfg, ps, xrefs, fsteps, phases, state=None,
                        tile: int = PHASE_TILE, device="cuda"):
    """The lane-major phase solver (core/mpc_lane.solve_mpc_batch_phase,
    kernel K1 on the card, its plain version on the CPU) on n problems
    with per-problem phases, at the production 300-iteration budget.

    xrefs (n, 12, N+1), fsteps (n, N_gait, 12), phases (n,); state an
    MPCLaneState of the n problems in their own order (f (4N, 3, n),
    y (4N, 5, n)) or None. The problems are regrouped into tiles of one
    phase (group_by_phase), solved, and the copies dropped; the warm
    carry follows each problem through the regrouping. stop_at_eps is
    off, so every lane runs the whole budget on its own problem: a
    lane's result does not depend on its tile-mates, and a copy returns
    what the original does. Returns (new state (n problems), converged
    (n,) bool tensor)."""
    from qrw_tpu_torch.core import mpc_lane as ml

    g = group_by_phase(phases, tile)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    src = torch.as_tensor(g.src, device=device)
    xr = t(np.moveaxis(np.asarray(xrefs), 0, -1)[..., g.src])
    fs = t(np.moveaxis(np.asarray(fsteps), 0, -1)[..., g.src])
    st = (None if state is None else
          ml.MPCLaneState(f=state.f[..., src], y=state.y[..., src]))
    _, st2, sol = ml.solve_mpc_batch_phase(
        cfg, xr, fs, ps, g.phases_of, state=st, n_iters=300, tile=tile,
        stop_at_eps=False)
    keep = torch.as_tensor(g.first, device=device)
    return (ml.MPCLaneState(f=st2.f[..., keep], y=st2.y[..., keep]),
            sol.converged[keep])


def _phase_structure(cfg, phase_fs, ps, device):
    """`ps`, or the phase data of phase_fs (default: the trot's)."""
    from qrw_tpu_torch.core import mpc_lane as ml
    if ps is not None:
        return ps
    if phase_fs is None:
        phase_fs = ml.trot_phase_fsteps(cfg)
    return ml.build_phase_data(cfg, phase_fs, device=device)


def solve_phase_cold(cfg, xrefs, fsteps, phase_fs=None,
                     tile: int = PHASE_TILE, device="cuda", ps=None):
    """The lane-major phase solver on every captured cycle, cold at the
    production 300-iteration budget. Cycles whose stance support is not
    in the phase-class set are excluded (phase_match_rate). `ps`: the
    phase data of phase_fs when the caller has built it. Returns
    (forces (C, 12N), conv (C,), matched (C,))."""
    C = xrefs.shape[0]
    N = cfg.n_steps
    ps = _phase_structure(cfg, phase_fs, ps, device)
    phases = match_phases(cfg, ps, fsteps)
    matched = phases >= 0
    idx = np.where(matched)[0]
    out = np.zeros((C, 12 * N))
    conv = np.zeros(C, bool)
    if idx.size:
        st, cv = solve_phase_grouped(cfg, ps, xrefs[idx], fsteps[idx],
                                     phases[idx], tile=tile, device=device)
        out[idx] = st.f.reshape(12 * N, -1).T.double().cpu().numpy()
        conv[idx] = cv.cpu().numpy()
    return out, conv, matched


def solve_phase_warm_streams(cfg, xrefs, fsteps, phase_fs=None,
                             tile: int = PHASE_TILE, device="cuda",
                             ps=None):
    """The phase solver in its fleet pattern: the captured cycles are
    grouped into 16 phase streams (consecutive cycles rotate through the
    gait offsets), each warm-starting from its own previous solve (one
    gait period earlier). The 16 streams of a round solve together at
    the production 300-iteration budget. A round holding an unmatched
    cycle (e.g. a gait-switch window) resets the warm carry and is
    skipped. `ps` as in solve_phase_cold. Returns (forces (C, 12N),
    conv (C,), matched (C,))."""
    C = xrefs.shape[0]
    N = cfg.n_steps
    ps = _phase_structure(cfg, phase_fs, ps, device)
    phases = match_phases(cfg, ps, fsteps)
    matched = phases >= 0
    out = np.zeros((C, 12 * N))
    conv = np.zeros(C, bool)
    P = N       # rounds of 16 consecutive cycles, one per phase stream
    st = None
    for r in range(C // P):
        idx = np.arange(r * P, (r + 1) * P)
        if not matched[idx].all():
            st = None
            continue
        st, cv = solve_phase_grouped(cfg, ps, xrefs[idx], fsteps[idx],
                                     phases[idx], state=st, tile=tile,
                                     device=device)
        out[idx] = st.f.reshape(12 * N, P).T.double().cpu().numpy()
        conv[idx] = cv.cpu().numpy()
    return out, conv, matched


def solve_xla64_seq(cfg, xrefs, fsteps, device="cuda"):
    """The float64 per-problem path at reference tolerances
    (core/mpc.solve_mpc), warm-started cycle to cycle."""
    from qrw_tpu_torch.core import mpc as mpc_mod

    C = xrefs.shape[0]
    out = np.zeros((C, 12 * cfg.n_steps))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device=device)
    st = None
    for i in range(C):
        res = mpc_mod.solve_mpc(cfg, t(xrefs[i]), t(fsteps[i]), st)
        st = res.state
        out[i] = res.state.f.cpu().numpy()
    return out


def torque_error(cfg, q_mes, df_first):
    """|tau| error induced by a first-step force error df via the
    stance-feet contact-Jacobian map tau = -Jc[:, 6:]' f at the logged
    joint configuration, float64 on the host."""
    from qrw_tpu_torch.models.solo12 import make_solo12
    from qrw_tpu_torch.ops import rbd

    model = rbd.to_torch(make_solo12())
    q = torch.as_tensor(np.asarray(q_mes), dtype=torch.float64)
    C = q.shape[0]
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    base = torch.tensor([0.0, 0.0, cfg.h_ref], dtype=torch.float64)
    J = rbd.foot_jacobians(model, base.expand(C, 3), ident.expand(C, 4), q)
    Jc = J.reshape(C, 12, 18)[:, :, 6:].numpy()
    tau = np.einsum("cij,ci->cj", Jc, np.asarray(df_first))
    return np.abs(tau).max(axis=1)


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=320)
    ap.add_argument("--perfect-estimator", action="store_true",
                    help="capture with ground-truth state injection "
                         "(default: the real complementary filter)")
    ap.add_argument("--gait", default="trot",
                    choices=["trot", "walk", "pacing", "bounding"],
                    help="gait of the capture (phase set matches)")
    ap.add_argument("--switch", default=None, metavar="TO",
                    choices=["trot", "pacing", "bounding", "static"],
                    help="inject a joystick gait switch at the capture "
                         "midpoint; the phase set becomes the union of "
                         "both gaits' classes + transition windows")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="keep shoulder-nominal metric footholds "
                         "instead of calibrating to the capture")
    ap.add_argument("--backend", choices=["auto", "pallas", "interpret"],
                    default="auto",
                    help="the relaxed path's solver: the kernels on the "
                         "card (pallas; auto without --cpu) or their "
                         "plain versions on the CPU (interpret)")
    ap.add_argument("--cpu", action="store_true",
                    help="run everything on the CPU")
    ap.add_argument("--phase", choices=["all", "pallas"], default="all",
                    help="pallas: only the relaxed chain, on the cycles "
                         "of --data (an npz of xrefs, fsteps), saved to "
                         "--out")
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from qrw_tpu_torch.config import Config
    cfg = Config(velID=2)
    device = "cpu" if args.cpu else "cuda"
    interpret = args.cpu or args.backend == "interpret"
    relaxed_device = "cpu" if interpret else "cuda"

    if args.phase == "pallas":
        with np.load(args.data) as f:
            xrefs, fsteps = f["xrefs"], f["fsteps"]
        f_relaxed, conv = solve_pallas_seq(cfg, xrefs, fsteps,
                                           relaxed_device)
        np.savez(args.out, f_relaxed=f_relaxed, conv=conv)
        return None

    xrefs, fsteps, q_mes = capture(cfg, args.cycles,
                                   perfect=args.perfect_estimator,
                                   gait=args.gait, switch_to=args.switch,
                                   device=device)
    phase_fs = build_phase_set(cfg, args.gait, args.switch)
    from qrw_tpu_torch.core import mpc_lane as ml
    if not args.no_calibrate:
        # re-center the shared metrics on the captured foothold
        # distribution (core/mpc_lane.calibrate_phase_fsteps)
        phase_fs = ml.calibrate_phase_fsteps(cfg, phase_fs, fsteps)
    f_star = solve_oracle(cfg, xrefs, fsteps)
    f_ref64 = solve_xla64_seq(cfg, xrefs, fsteps, device)
    ps = ml.build_phase_data(cfg, phase_fs, device=device)
    f_phase, conv_phase, matched = solve_phase_cold(
        cfg, xrefs, fsteps, device=device, ps=ps)
    f_ph_w, conv_ph_w, matched_w = solve_phase_warm_streams(
        cfg, xrefs, fsteps, device=device, ps=ps)
    f_relaxed, conv = solve_pallas_seq(cfg, xrefs, fsteps, relaxed_device)

    N = cfg.n_steps

    def stats(f):
        d = f - f_star
        d1 = d.reshape(-1, N, 12)[:, 0, :]          # first-step forces
        return {
            "force_err_max_first_step_N": float(np.abs(d1).max()),
            "force_err_mean_first_step_N": float(np.abs(d1).mean()),
            "force_err_max_horizon_N": float(np.abs(d).max()),
            "force_err_rms_horizon_N": float(np.sqrt((d ** 2).mean())),
        }

    df1 = (f_relaxed - f_star).reshape(-1, N, 12)[:, 0, :]
    tau_err = torque_error(cfg, q_mes, df1)
    fz_scale = cfg.mass * cfg.gravity / 2.0   # per-foot stance force scale

    def stats_sel(f, sel):
        if not np.any(sel):
            # a short capture may select nothing
            return {"n_selected": 0}
        d = (f - f_star)[sel]
        d1 = d.reshape(-1, N, 12)[:, 0, :]
        return {
            "force_err_max_first_step_N": float(np.abs(d1).max()),
            "force_err_mean_first_step_N": float(np.abs(d1).mean()),
            "force_err_max_horizon_N": float(np.abs(d).max()),
        }

    out = {
        "cycles": int(args.cycles),
        "gait": args.gait + (f"->{args.switch}" if args.switch else ""),
        "n_phase_classes": int(phase_fs.shape[0]),
        "metric_calibration": ("none (shoulder nominals)"
                               if args.no_calibrate
                               else "captured-foothold means"),
        "estimator": ("perfect" if args.perfect_estimator
                      else "complementary (reference default)"),
        "backend_relaxed": ("plain (cpu)" if interpret
                            else "cuda (K2 cone variant + K3)"),
        "relaxed_conv_rate": float(conv.mean()),
        "relaxed_eps": 1e-4,
        "relaxed": stats(f_relaxed),
        "f64_eps1e-6": stats(f_ref64),
        "phase_solver_cold": stats_sel(f_phase, matched & conv_phase),
        "phase_conv_rate": float(conv_phase[matched].mean()),
        "phase_match_rate": float(matched.mean()),
        "phase_solver_warm_streams": stats_sel(f_ph_w,
                                               matched_w & conv_ph_w),
        "phase_solver_warm_steady": stats_sel(
            f_ph_w, matched_w & conv_ph_w
            & (np.arange(int(args.cycles)) >= cfg.n_steps)),
        "phase_warm_conv_rate": float(conv_ph_w[matched_w].mean()),
        "torque_err_max_Nm_relaxed": float(tau_err.max()),
        "torque_budget_Nm": 8.0,
        "stance_fz_scale_N": float(fz_scale),
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":  # pragma: no cover
    main()
