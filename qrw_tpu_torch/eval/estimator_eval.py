"""Offline estimator evaluation: estimate against ground truth.

Port of qrw_tpu/eval/estimator_eval.py. In simulation the simulator
state is the ground truth (the reference's perfect-estimator source), so
the reference's mocap studies become: run a closed-loop rollout, then
score the logged estimate (q_est / v_est) against the logged simulator
state (base_pos / base_quat / base_vel): drift, RMSE and velocity error
per axis, with the same figure set. Works on a live RolloutLog of
tensors (any leading shape (T, ...) of one robot) or on a dict from
utils.logger; the metrics are computed in float64 numpy / torch on the
host.

    from qrw_tpu_torch.eval.estimator_eval import run_demo
    metrics = run_demo(n_ticks=1000, kf=True)   # on the card
    metrics = run_demo(n_ticks=100, kf=True, device="cpu")
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.ops.rotations import quat_to_rpy


def _as_dict(logs) -> dict:
    if isinstance(logs, dict):
        return logs
    from qrw_tpu_torch.utils.logger import log_to_dict
    return log_to_dict(logs)


def _rpy(quats) -> np.ndarray:
    """(T, 4) quaternions -> (T, 3) roll / pitch / yaw in float64."""
    return quat_to_rpy(torch.as_tensor(np.array(quats, np.float64))).numpy()


def score(logs, cfg: Optional[Config] = None, skip: int = 50
          ) -> Dict[str, float]:
    """Estimator-vs-ground-truth metrics over a rollout log.

    skip: initial ticks excluded (filter settling). Returns RMSEs for
    base height, roll/pitch, linear velocity, plus final horizontal
    drift of the estimate relative to ground truth [m]."""
    cfg = cfg if cfg is not None else Config()
    d = _as_dict(logs)
    skip = min(skip, d["base_pos"].shape[0] // 2)  # short logs: keep data
    sl = slice(skip, None)

    z_sim = d["base_pos"][sl, 2]
    z_est = d["q_est"][sl, 2]
    rpy_sim = _rpy(d["base_quat"][sl])
    rpy_est = _rpy(d["q_est"][sl, 3:7])
    v_sim = d["base_vel"][sl]
    v_est = d["v_est"][sl, 0:3]

    def rmse(a, b):
        return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b))
                                     ** 2)))

    # horizontal drift: the estimator integrates velocity for x/y, so it
    # drifts; the reference quantifies exactly this against mocap.
    drift = float(np.linalg.norm(d["q_est"][-1, 0:2]
                                 - d["base_pos"][-1, 0:2]))
    return {
        "z_rmse": rmse(z_sim, z_est),
        "roll_rmse": rmse(rpy_sim[:, 0], rpy_est[:, 0]),
        "pitch_rmse": rmse(rpy_sim[:, 1], rpy_est[:, 1]),
        "vx_rmse": rmse(v_sim[:, 0], v_est[:, 0]),
        "vy_rmse": rmse(v_sim[:, 1], v_est[:, 1]),
        "vz_rmse": rmse(v_sim[:, 2], v_est[:, 2]),
        "xy_drift": drift,
        "n_ticks": int(z_sim.shape[0]),
    }


def plot(logs, cfg: Optional[Config] = None, show: bool = True,
         save_prefix: Optional[str] = None):
    """Estimate-vs-truth figures (plot_IMU_mocap_result.py figure set:
    position, orientation, linear velocity per axis)."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = cfg if cfg is not None else Config()
    d = _as_dict(logs)
    t = np.arange(d["base_pos"].shape[0]) * cfg.dt_wbc
    rpy_sim = _rpy(d["base_quat"])
    rpy_est = _rpy(d["q_est"][:, 3:7])

    fig, axs = plt.subplots(3, 3, figsize=(14, 9), sharex=True)
    rows = [
        ("pos", d["base_pos"], d["q_est"][:, 0:3], "m"),
        ("rpy", rpy_sim, rpy_est, "rad"),
        ("lin vel", d["base_vel"], d["v_est"][:, 0:3], "m/s"),
    ]
    for r, (name, sim, est, unit) in enumerate(rows):
        for c in range(3):
            axs[r, c].plot(t, sim[:, c], "b", label="ground truth")
            axs[r, c].plot(t, est[:, c], "r--", label="estimate")
            axs[r, c].set_ylabel(f"{name} {'xyz'[c]} [{unit}]")
    axs[0, 0].legend()
    for c in range(3):
        axs[2, c].set_xlabel("t [s]")
    fig.suptitle("Estimator vs ground truth")
    if save_prefix:
        fig.savefig(save_prefix + "_estimator.png", dpi=110)
    if show:  # pragma: no cover
        plt.show()
    return fig


def fk_per_foot_velocity(logs, cfg: Optional[Config] = None):
    """Offline per-foot kinematic base-velocity estimates.

    The reference's estimator studies recompute, per contact foot, the
    base velocity implied by leg odometry (BaseVelocityFromKinAndIMU,
    scripts/plot_IMU_mocap_result.py:96-135: v = omega x r - R v_foot at
    the IMU location) from the logged encoder/IMU signals with Pinocchio.
    Here the same quantity is recomputed from the logged q_mes/v_mes and
    angular velocity with ops/rbd, batched over all ticks in float64.
    Returns (T, 4, 3) per-foot velocities in the base frame."""
    from qrw_tpu_torch.models.solo12 import make_solo12
    from qrw_tpu_torch.ops import rbd

    cfg = cfg if cfg is not None else Config()
    d = _as_dict(logs)
    model = rbd.to_torch(make_solo12())
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    q_mes, v_mes, omega = f64(d["q_mes"]), f64(d["v_mes"]), f64(d["rpy_vel"])
    T = q_mes.shape[0]
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    kin = rbd.frame_kinematics(model, torch.zeros(T, 3, dtype=torch.float64),
                               ident.expand(T, 4), q_mes,
                               torch.zeros(T, 6, dtype=torch.float64), v_mes)
    # v_base = omega x (-r_foot) - v_foot for each foot
    w = omega[:, None, :].expand_as(kin.pos)
    return (torch.linalg.cross(w, -kin.pos) - kin.vel).numpy()


def plot_fk_feet(logs, cfg: Optional[Config] = None, show: bool = True,
                 save_prefix: Optional[str] = None):
    """Per-foot leg-odometry velocity vs ground truth vs the fused
    estimate (the per-foot study figures of plot_IMU_mocap_result.py)."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = cfg if cfg is not None else Config()
    d = _as_dict(logs)
    v_feet = fk_per_foot_velocity(d, cfg)
    t = np.arange(d["base_pos"].shape[0]) * cfg.dt_wbc
    names = ["FL", "FR", "HL", "HR"]
    fig, axs = plt.subplots(3, 1, figsize=(12, 9), sharex=True)
    for a, lbl in enumerate("xyz"):
        for f in range(4):
            axs[a].plot(t, v_feet[:, f, a], lw=0.6, alpha=0.7,
                        label=f"{names[f]} odometry" if a == 0 else None)
        axs[a].plot(t, d["base_vel"][:, a], "k", lw=1.0,
                    label="ground truth" if a == 0 else None)
        if "v_est" in d:
            axs[a].plot(t, d["v_est"][:, a], "r--", lw=1.0,
                        label="fused estimate" if a == 0 else None)
        axs[a].set_ylabel(f"base v{lbl} [m/s]")
    axs[0].legend(fontsize=7, ncol=3)
    axs[2].set_xlabel("t [s]")
    fig.suptitle("Per-foot leg-odometry base velocity")
    if save_prefix:
        fig.savefig(save_prefix + "_fk_feet.png", dpi=110)
    if show:  # pragma: no cover
        plt.show()
    return fig


def plot_tracking(logs_list, labels=None, cfg: Optional[Config] = None,
                  show: bool = True, save_prefix: Optional[str] = None):
    """Velocity-command tracking, optionally across several runs (the
    'Tracking of the velocity command sent to the robot' figure of
    plot_IMU_mocap_result.py:533 and the multi-log overlays of
    plot_comparison_fb.py)."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = cfg if cfg is not None else Config()
    if not isinstance(logs_list, (list, tuple)):
        logs_list = [logs_list]
    labels = labels or [f"run {i}" for i in range(len(logs_list))]
    fig, axs = plt.subplots(3, 1, figsize=(12, 8), sharex=True)
    comps = [(0, "vx [m/s]", 0), (1, "vy [m/s]", 1), (5, "wyaw [rad/s]", 2)]
    for li, logs in enumerate(logs_list):
        d = _as_dict(logs)
        t = np.arange(d["base_pos"].shape[0]) * cfg.dt_wbc
        for ci, (idx, lbl, row) in enumerate(comps):
            mes = (d["base_vel"][:, idx] if idx < 3
                   else d["rpy_vel"][:, idx - 3])
            axs[row].plot(t, mes, lw=0.8, label=labels[li])
            if li == 0 and "v_ref" in d:
                axs[row].plot(t, d["v_ref"][:, idx], "k--", lw=1.0,
                              label="command")
            axs[row].set_ylabel(lbl)
    axs[0].legend(fontsize=8)
    axs[2].set_xlabel("t [s]")
    fig.suptitle("Tracking of the velocity command")
    if save_prefix:
        fig.savefig(save_prefix + "_tracking.png", dpi=110)
    if show:  # pragma: no cover
        plt.show()
    return fig


def windowed_drift(logs, cfg: Optional[Config] = None,
                   window_s: float = 0.5):
    """Per-window horizontal drift of the estimated base position
    relative to ground truth (the windowed integrated-drift study of
    plot_IMU_mocap_result_bis.py: how much the odometry walks away per
    fixed time window, rather than a single end-of-run number).
    Returns (t_windows (W,), drift (W, 2)) in meters per window."""
    cfg = cfg if cfg is not None else Config()
    d = _as_dict(logs)
    T_total = d["base_pos"].shape[0]
    w = max(2, min(int(round(window_s / cfg.dt_wbc)), T_total // 2))
    err = d["q_est"][:, 0:2] - d["base_pos"][:, 0:2]   # (T, 2)
    T = (err.shape[0] // w) * w
    seg = err[:T].reshape(-1, w, 2)
    drift = seg[:, -1, :] - seg[:, 0, :]
    t_w = (np.arange(drift.shape[0]) + 0.5) * w * cfg.dt_wbc
    return t_w, drift


def velocity_error_fft(logs, cfg: Optional[Config] = None,
                       skip: int = 100):
    """Amplitude spectrum of the linear-velocity estimation error per
    axis (the FFT panels of plot_IMU_mocap_result_bis.py — the gait
    frequency and its harmonics dominate the leg-odometry error).
    Returns (freqs (F,), amp (F, 3))."""
    cfg = cfg if cfg is not None else Config()
    d = _as_dict(logs)
    skip = min(skip, d["base_vel"].shape[0] // 2)  # short logs
    err = (d["v_est"][skip:, 0:3] - d["base_vel"][skip:]).astype(
        np.float64)
    T = err.shape[0]
    amp = np.abs(np.fft.rfft(err - err.mean(axis=0), axis=0)) / T
    freqs = np.fft.rfftfreq(T, d=cfg.dt_wbc)
    return freqs, amp


def plot_bis(logs, cfg: Optional[Config] = None, show: bool = True,
             save_prefix: Optional[str] = None):
    """The deep-study panel set of plot_IMU_mocap_result_bis.py:
    (1) windowed horizontal drift, (2) FFT of the velocity estimation
    error with the gait frequency marked, (3) complementary-filter
    internals (HP/LP contributions, already logged per tick)."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = cfg if cfg is not None else Config()
    d = _as_dict(logs)
    fig, axs = plt.subplots(3, 1, figsize=(12, 10))

    t_w, drift = windowed_drift(d, cfg)
    axs[0].bar(t_w - 0.1, drift[:, 0], width=0.2, label="x")
    axs[0].bar(t_w + 0.1, drift[:, 1], width=0.2, label="y")
    axs[0].set_ylabel("drift per 0.5 s window [m]")
    axs[0].set_xlabel("t [s]")
    axs[0].legend()

    freqs, amp = velocity_error_fft(d, cfg)
    for a, lbl in enumerate("xyz"):
        axs[1].semilogy(freqs[1:], amp[1:, a] + 1e-12, lw=0.8,
                        label=f"v{lbl} err")
    f_gait = 2.0 / cfg.T_gait            # two stance switches per period
    axs[1].axvline(f_gait, color="k", ls=":", lw=1.0,
                   label=f"gait {f_gait:.1f} Hz")
    axs[1].set_xlim(0, 60)
    axs[1].set_ylabel("velocity error amplitude")
    axs[1].set_xlabel("f [Hz]")
    axs[1].legend(fontsize=7)

    t = np.arange(d["base_pos"].shape[0]) * cfg.dt_wbc
    if "est_hp_vel" in d and "est_lp_vel" in d:
        axs[2].plot(t, d["est_hp_vel"][:, 0], lw=0.7,
                    label="HP (IMU integration) vx")
        axs[2].plot(t, d["est_lp_vel"][:, 0], lw=0.7,
                    label="LP (leg odometry) vx")
        axs[2].plot(t, d["v_est"][:, 0], "r--", lw=1.0, label="fused vx")
        axs[2].plot(t, d["base_vel"][:, 0], "k", lw=0.8, label="truth vx")
    axs[2].set_ylabel("vx [m/s]")
    axs[2].set_xlabel("t [s]")
    axs[2].legend(fontsize=7)
    fig.suptitle("Estimator deep study (windowed drift / error FFT / "
                 "filter internals)")
    if save_prefix:
        fig.savefig(save_prefix + "_estimator_bis.png", dpi=110)
    if show:  # pragma: no cover
        plt.show()
    return fig


def compare_filters(cfg: Optional[Config] = None, n_ticks: int = 1000,
                    vx: float = 0.5, dtype=torch.float32, show: bool = True,
                    save_prefix: Optional[str] = None, device="cuda"):
    """Filter-variant overlay (the complementary-vs-Kalman comparison
    panels of the reference's estimator studies): run the SAME scenario
    once per estimator variant and overlay estimates against the shared
    ground truth. Returns (figure, {label: metrics})."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from qrw_tpu_torch.sim.rollout import make_rollout, rollout

    cfg = cfg if cfg is not None else Config()
    sched = np.zeros((n_ticks, 6))
    sched[:, 0] = np.minimum(vx, np.arange(n_ticks)
                             * (vx / max(1, n_ticks // 3)))
    sched = torch.as_tensor(sched).to(dtype)
    runs = {}
    for label, kf in (("complementary", False), ("kalman18", True)):
        c = cfg.replace(kf_enabled=kf)
        ctl, carry = make_rollout(c, dtype=dtype, device=device)
        _, logs = rollout(ctl, carry, n_ticks, v_ref_schedule=sched)
        runs[label] = _as_dict(logs)

    fig, axs = plt.subplots(2, 3, figsize=(14, 7), sharex=True)
    t = np.arange(n_ticks) * cfg.dt_wbc
    colors = {"complementary": "r", "kalman18": "g"}
    for c_i in range(3):
        axs[0, c_i].plot(t, runs["complementary"]["base_vel"][:, c_i],
                         "k", lw=0.8, label="truth")
        axs[1, c_i].set_xlabel("t [s]")
        for label, d in runs.items():
            axs[0, c_i].plot(t, d["v_est"][:, c_i],
                             colors[label] + "--", lw=0.8, label=label)
            axs[1, c_i].plot(t, d["v_est"][:, c_i] - d["base_vel"][:, c_i],
                             colors[label], lw=0.7, label=label)
        axs[0, c_i].set_ylabel(f"v{'xyz'[c_i]} [m/s]")
        axs[1, c_i].set_ylabel(f"v{'xyz'[c_i]} error [m/s]")
    axs[0, 0].legend(fontsize=7)
    fig.suptitle("Estimator variants vs ground truth")
    metrics = {label: score(d, cfg) for label, d in runs.items()}
    if save_prefix:
        fig.savefig(save_prefix + "_filter_variants.png", dpi=110)
    if show:  # pragma: no cover
        plt.show()
    return fig, metrics


def run_demo(cfg: Optional[Config] = None, n_ticks: int = 500,
             kf: bool = False, dtype=torch.float64,
             device="cuda") -> Dict[str, float]:
    """Estimator demo run (main_solo12_demo_estimator.py analog): run the
    closed loop standing still (zero velocity command) with the chosen
    estimator and score it. Runs on `device` (the card unless the
    caller asks for the CPU), in float64 unless `dtype` says otherwise."""
    from qrw_tpu_torch.sim.rollout import make_rollout, rollout
    cfg = cfg if cfg is not None else Config()
    if kf:
        cfg = cfg.replace(kf_enabled=True)
    ctl, carry = make_rollout(cfg, dtype=dtype, device=device)
    _, logs = rollout(ctl, carry, n_ticks,
                      v_ref_schedule=torch.zeros((n_ticks, 6), dtype=dtype))
    return score(logs, cfg)
