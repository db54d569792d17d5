"""Structured run logging: npz save / load and the figure set.

Port of qrw_tpu/utils/logger.py. The rollout returns a RolloutLog of
tensors (sim/rollout); this module handles the host side: timestamped
`.npz` dumps with a save / load round trip, and the 13 figures of the
reference's plotAll. The npz keys are the JAX package's (the
RolloutLog field names, plus `_dt_wbc` and `_dt_mpc`), so a file written
by one package loads in the other.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def _numpy(v):
    """A tensor (any device) or array -> numpy."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def log_to_dict(logs, cfg=None) -> dict:
    """RolloutLog (or any NamedTuple of tensors or arrays) ->
    {name: np.ndarray}."""
    d = {k: _numpy(v) for k, v in logs._asdict().items() if v is not None}
    if cfg is not None:
        d["_dt_wbc"] = np.asarray(cfg.dt_wbc)
        d["_dt_mpc"] = np.asarray(cfg.dt_mpc)
    return d


def save_npz(logs, path: Optional[str] = None, cfg=None,
             prefix: str = "data") -> str:
    """Timestamped .npz dump; returns the file path."""
    if path is None:
        path = time.strftime(prefix + "_%Y_%m_%d_%H_%M") + ".npz"
    np.savez_compressed(path, **log_to_dict(logs, cfg))
    return path


def load_npz(path: str) -> dict:
    """The symmetric load: {name: np.ndarray}."""
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


_FOOT_NAMES = ["FL", "FR", "HL", "HR"]


def plot_all(data: dict, dt: float = 0.002, show: bool = True,
             save_prefix: Optional[str] = None):
    """The plotAll figure set (scripts/LoggerControl.py:192-549),
    figure-by-figure:

      1. base position + linear velocity (est vs sim ground truth)
         — LoggerControl.py:270-297 + 299-323 (sim truth plays the
         mocap role; processMocap's base-frame rotation is already done
         in the rollout since base_vel is logged in the base frame)
      2. base orientation (RPY) + angular velocity — same reference figs
      3. measured & reference feet positions (base frame) — :219-238
      4. measured & reference feet velocities (base frame) — :242-254
      5. reference feet accelerations (base frame) — :258-266
      6. desired vs measured actuator positions — :403-415
      7. desired vs measured actuator velocities — :343-360
      8. FF torques & PD feedback & sent & measured — :361-379
      9. contact forces: MPC command & WBC QP output — :383-399
     10. MPC predicted position/orientation trajectories vs executed
         — the static analog of :426-442 (the JAX package's
         interactive slider replay, utils/viz.py, is not ported yet)
     11. MPC predicted velocity trajectories vs executed — :444-459
     12. velocity complementary filter internals — :508-524
     13. position complementary filter internals — :528-544

    `data` is a dict from log_to_dict/load_npz. Returns the figures."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    T = data["base_pos"].shape[0]
    t = np.arange(T) * dt
    figs = []

    def grid(nr, nc, title, size=(14, 9)):
        fig, axs = plt.subplots(nr, nc, figsize=size, sharex=True)
        fig.suptitle(title)
        figs.append(fig)
        return fig, axs

    def quat_to_rpy(qs):
        x, y, z, w = qs[:, 0], qs[:, 1], qs[:, 2], qs[:, 3]
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        return np.stack([roll, pitch, yaw], 1)

    # -- 1: base position + linear velocity -------------------------------
    fig, axs = grid(3, 2, "Base position & linear velocity (sim truth vs "
                          "estimate)", (12, 8))
    for i, lbl in enumerate("xyz"):
        axs[i, 0].plot(t, data["base_pos"][:, i], "b", label="sim")
        if "q_est" in data:
            axs[i, 0].plot(t, data["q_est"][:, i], "r--", label="estimate")
        axs[i, 0].set_ylabel(f"pos {lbl} [m]")
        axs[i, 1].plot(t, data["base_vel"][:, i], "b")
        if "v_est" in data:
            axs[i, 1].plot(t, data["v_est"][:, i], "r--")
        axs[i, 1].set_ylabel(f"lin vel {lbl} [m/s]")
    axs[0, 0].legend()

    # -- 2: base orientation + angular velocity ---------------------------
    if "base_quat" in data:
        fig, axs = grid(3, 2, "Base orientation (RPY) & angular velocity",
                        (12, 8))
        rpy = quat_to_rpy(data["base_quat"])
        rpy_est = (quat_to_rpy(data["q_est"][:, 3:7])
                   if "q_est" in data else None)
        for i, lbl in enumerate(["roll", "pitch", "yaw"]):
            axs[i, 0].plot(t, rpy[:, i], "b", label="sim")
            if rpy_est is not None:
                axs[i, 0].plot(t, rpy_est[:, i], "r--", label="estimate")
            axs[i, 0].set_ylabel(f"{lbl} [rad]")
            axs[i, 1].plot(t, data["rpy_vel"][:, i], "b")
            if "v_est" in data:
                axs[i, 1].plot(t, data["v_est"][:, 3 + i], "r--")
            axs[i, 1].set_ylabel(f"ang vel {lbl} [rad/s]")
        axs[0, 0].legend()

    # -- 3/4/5: feet positions / velocities / accelerations ---------------
    for key_m, key_r, title, unit in [
            ("feet_pos_mes", "feet_p_cmd",
             "Measured & reference feet positions (base frame)", "m"),
            ("feet_vel_mes", "feet_v_cmd",
             "Measured & reference feet velocities (base frame)", "m/s"),
            (None, "feet_a_cmd",
             "Reference feet accelerations (base frame)", "m/s^2")]:
        if key_r not in data:
            continue
        fig, axs = grid(3, 4, title)
        for f in range(4):
            for a, lbl in enumerate("xyz"):
                ax = axs[a, f]
                if key_m is not None and key_m in data:
                    ax.plot(t, data[key_m][:, a, f], "b", lw=0.8,
                            label="measured")
                ax.plot(t, data[key_r][:, a, f], "r--", lw=0.8,
                        label="reference")
                ax.set_title(f"{_FOOT_NAMES[f]} {lbl} [{unit}]", fontsize=8)
        axs[0, 0].legend(fontsize=7)

    # -- 6: actuator positions ---------------------------------------------
    fig, axs = grid(4, 3, "Desired & measured actuator positions")
    for j in range(12):
        ax = axs[j // 3, j % 3]
        ax.plot(t, data["q_mes"][:, j], "b", lw=0.8, label="measured")
        ax.plot(t, data["q_des"][:, j], "r--", lw=0.8, label="desired")
        ax.set_title(f"joint {j}", fontsize=8)
    axs[0, 0].legend(fontsize=7)

    # -- 7: actuator velocities ---------------------------------------------
    if "v_mes" in data and "v_des" in data:
        fig, axs = grid(4, 3, "Desired & measured actuator velocities")
        for j in range(12):
            ax = axs[j // 3, j % 3]
            ax.plot(t, data["v_mes"][:, j], "b", lw=0.8, label="measured")
            ax.plot(t, data["v_des"][:, j], "r--", lw=0.8, label="desired")
            ax.set_title(f"joint {j}", fontsize=8)
        axs[0, 0].legend(fontsize=7)

    # -- 8: torques: ff, PD feedback, sent, applied -------------------------
    fig, axs = grid(4, 3, "FF / PD-feedback / sent / applied torques [N m]")
    P, D = 3.0, 0.2   # scripts/Controller.py:306-307
    for j in range(12):
        ax = axs[j // 3, j % 3]
        ax.plot(t, data["tau_ff"][:, j], "r--", lw=0.8, label="ff")
        if all(k in data for k in ("q_des", "q_mes", "v_des", "v_mes")):
            fb = (P * (data["q_des"][:, j] - data["q_mes"][:, j])
                  + D * (data["v_des"][:, j] - data["v_mes"][:, j]))
            ax.plot(t, fb, "g", lw=0.6, label="PD fb")
            ax.plot(t, fb + data["tau_ff"][:, j], "k", lw=0.6, label="sent")
        if "tau_applied" in data:
            ax.plot(t, data["tau_applied"][:, j], "b", lw=0.6,
                    label="applied")
        ax.set_title(f"joint {j}", fontsize=8)
    axs[0, 0].legend(fontsize=7)

    # -- 9: contact forces: MPC command & WBC output ------------------------
    fig, axs = grid(4, 3, "Contact forces: MPC command & WBC QP output")
    for f in range(4):
        for a, lbl in enumerate("xyz"):
            ax = axs[f, a]
            ax.plot(t, data["f_mpc"][:, 3 * f + a], "b", lw=0.8,
                    label="MPC")
            if "f_wbc" in data:
                ax.plot(t, data["f_wbc"][:, 3 * f + a], "r--", lw=0.8,
                        label="WBC")
            ax.set_title(f"{_FOOT_NAMES[f]} f{lbl} [N]", fontsize=8)
    axs[0, 0].legend(fontsize=7)

    # -- 10/11: MPC predicted trajectories vs executed ----------------------
    if "x_f_mpc" in data and "mpc_xref" in data:
        N = data["x_f_mpc"].shape[2]
        dt_mpc = float(data.get("_dt_mpc", 0.02))
        k_mpc = max(1, int(round(dt_mpc / dt)))
        stride = max(1, (T // k_mpc) // 12) * k_mpc   # ~12 horizons shown
        names = ["x", "y", "z", "roll", "pitch", "yaw"]
        for blk, title in [
                (0, "MPC predicted position/orientation vs executed"),
                (6, "MPC predicted velocities vs executed")]:
            fig, axs = grid(3, 2, title, (12, 9))
            exec_sig = (np.concatenate([data["q_est"][:, 0:3],
                                        quat_to_rpy(data["q_est"][:, 3:7])],
                                       1)
                        if blk == 0 else data["v_est"][:, 0:6])
            for i in range(6):
                ax = axs[i % 3, i // 3]
                ax.plot(t, exec_sig[:, i], "k", lw=0.9, label="executed")
                for k0 in range(0, T, stride):
                    th = t[k0] + dt_mpc * np.arange(1, N + 1)
                    ax.plot(th, data["x_f_mpc"][k0, blk + i, :], lw=0.6,
                            alpha=0.7)
                lbl = names[i] if blk == 0 else "v" + names[i]
                ax.set_ylabel(lbl)
            axs[0, 0].legend(fontsize=7)

    # -- 12/13: complementary filter internals ------------------------------
    for hp, lp, inp, out, title in [
            ("est_hp_vel", "est_lp_vel", "est_fk_vel", None,
             "Velocity complementary filter internals"),
            ("est_hp_pos", "est_lp_pos", "est_fk_xyz", None,
             "Position complementary filter internals")]:
        if hp not in data:
            continue
        fig, axs = grid(3, 1, title, (12, 8))
        for i, lbl in enumerate("xyz"):
            axs[i].plot(t, data[hp][:, i], "g", lw=0.8, label="HP part")
            axs[i].plot(t, data[lp][:, i], "b", lw=0.8, label="LP part")
            axs[i].plot(t, data[hp][:, i] + data[lp][:, i], "k", lw=0.8,
                        label="filtered")
            if inp in data:
                axs[i].plot(t, data[inp][:, i], "r--", lw=0.6,
                            label="FK input")
            axs[i].set_ylabel(lbl)
        axs[0].legend(fontsize=7)

    if save_prefix is not None:
        for i, fig in enumerate(figs):
            fig.savefig(f"{save_prefix}_fig{i}.png", dpi=100)
    if show:
        plt.show()
    return figs
