"""Run visualization: contact-force monitor and MPC prediction replay.

Port of qrw_tpu/utils/viz.py, the offline stand-ins for the reference's
live-debug visualizers:

  * `force_monitor`: the ForceMonitor analog (scripts/ForceMonitor.py:
    29-84 draws ground-reaction-force lines in the PyBullet GUI). The
    whole run's foot positions are recomputed from the logged
    configurations in one batched forward-kinematics call
    (`foot_positions`: ops/rbd.frame_kinematics along the tick axis),
    and the forces are drawn as a 3D quiver snapshot on the host.
  * `slider_replay`: the interactive MPC-prediction scrubber
    (scripts/LoggerControl.py:716-915). The per-cycle predictions are
    re-solved offline (`mpc_predictions`) as ONE batched core/mpc.
    solve_mpc along a leading cycle axis instead of being logged per
    tick.
  * `animate_rollout`: a 3D rollout animation (base box, legs, swing
    targets, WBC forces, a camera that follows the base).

Everything accepts a RolloutLog of tensors or the dict of
utils/logger.log_to_dict / load_npz, so saved runs of either package
replay the same. The kinematics and the MPC run on `device`, the card
unless the caller asks for the CPU; the figures are drawn on the host
(matplotlib, imported only here, with its Agg backend when
show=False).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _as_dict(logs) -> dict:
    from qrw_tpu_torch.utils.logger import log_to_dict
    return logs if isinstance(logs, dict) else log_to_dict(logs)


def foot_positions(logs, dtype=torch.float64, device="cuda") -> np.ndarray:
    """(T, 4, 3) world foot positions recomputed from the logged base
    pose and joint angles in one batched kinematics call on `device`."""
    from qrw_tpu_torch.models.solo12 import make_solo12
    from qrw_tpu_torch.ops import rbd
    from qrw_tpu_torch.sim.fleet import _check_device
    d = _as_dict(logs)
    kw = dict(dtype=dtype, device=_check_device(device))
    qj = torch.as_tensor(d["q_mes"], **kw)
    T = qj.shape[0]
    kin = rbd.frame_kinematics(
        rbd.to_torch(make_solo12()), torch.as_tensor(d["base_pos"], **kw),
        torch.as_tensor(d["base_quat"], **kw), qj,
        torch.zeros((T, 6), **kw), torch.zeros((T, 12), **kw))
    return kin.pos.cpu().numpy()


def force_monitor(logs, tick: Optional[int] = None, scale: float = 0.01,
                  show: bool = True, save_path: Optional[str] = None,
                  device="cuda"):
    """3D snapshot of ground-reaction forces at the feet (ForceMonitor
    analog). tick=None shows the mid-run tick; the feet come from
    `foot_positions` on `device`. Returns the figure."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = _as_dict(logs)
    feet = foot_positions(d, device=device)
    T = feet.shape[0]
    k = T // 2 if tick is None else int(tick)
    f = d["f_mpc"][k].reshape(4, 3)

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    p = feet[k]
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], c="k", s=20)
    for i in range(4):
        ax.quiver(p[i, 0], p[i, 1], p[i, 2],
                  f[i, 0] * scale, f[i, 1] * scale, f[i, 2] * scale,
                  color="r", linewidth=2)
    bp = d["base_pos"][k]
    ax.scatter([bp[0]], [bp[1]], [bp[2]], c="b", s=60, marker="s")
    ax.plot(d["base_pos"][:k + 1, 0], d["base_pos"][:k + 1, 1],
            d["base_pos"][:k + 1, 2], "b-", alpha=0.4)
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z [m]")
    ax.set_title(f"Ground-reaction forces, tick {k} "
                 f"(arrows: {1.0 / scale:.0f} N/m)")
    if save_path:
        fig.savefig(save_path, dpi=110)
    if show:  # pragma: no cover
        plt.show()
    return fig


def mpc_predictions(logs, cfg=None, dtype=torch.float64, device="cuda"):
    """Re-solve every captured MPC cycle in one batched call on `device`.

    Returns (ticks, x_f): (C,) solve ticks and (C, 24, N) predictions,
    the data behind the reference's slider replay, regenerated offline
    the crocoddyl_eval way instead of logged per tick. Each cycle is
    solved cold, on its own, as qrw_tpu's jax.vmap of solve_mpc does."""
    from qrw_tpu_torch.config import Config
    from qrw_tpu_torch.core import mpc as mpc_mod
    from qrw_tpu_torch.sim.fleet import _check_device
    cfg = cfg if cfg is not None else Config()
    d = _as_dict(logs)
    kw = dict(dtype=dtype, device=_check_device(device))
    T = d["mpc_xref"].shape[0]
    ticks = np.arange(0, T, cfg.k_mpc)
    xrefs = torch.as_tensor(d["mpc_xref"][ticks], **kw)
    fsteps = torch.as_tensor(d["mpc_fsteps"][ticks], **kw)
    res = mpc_mod.solve_mpc(cfg, xrefs, fsteps)
    return ticks, res.x_f_applied.cpu().numpy()


def slider_replay(logs, cfg=None, show: bool = True, device="cuda"):
    """Interactive scrubber over MPC cycles (LoggerControl.py:716-915):
    executed base trajectory + the predicted horizon and footholds of
    the selected cycle; the predictions are re-solved on `device`.
    Returns (figure, slider)."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider

    from qrw_tpu_torch.config import Config
    cfg = cfg if cfg is not None else Config()
    d = _as_dict(logs)
    ticks, x_f = mpc_predictions(d, cfg, device=device)
    C = len(ticks)
    dt = cfg.dt_mpc

    fig, (ax_xy, ax_z) = plt.subplots(1, 2, figsize=(13, 6))
    ax_xy.plot(d["base_pos"][:, 0], d["base_pos"][:, 1], "b-",
               label="executed")
    pred_line, = ax_xy.plot([], [], "r.-", label="MPC prediction")
    foot_pts, = ax_xy.plot([], [], "g^", label="footholds")
    ax_xy.set_xlabel("x [m]"); ax_xy.set_ylabel("y [m]")
    ax_xy.legend(); ax_xy.set_title("horizontal plane")

    t_exec = np.arange(d["base_pos"].shape[0]) * cfg.dt_wbc
    ax_z.plot(t_exec, d["base_pos"][:, 2], "b-")
    predz_line, = ax_z.plot([], [], "r.-")
    ax_z.set_xlabel("t [s]"); ax_z.set_ylabel("z [m]")
    ax_z.set_title("height")

    ax_s = fig.add_axes([0.2, 0.015, 0.6, 0.025])
    slider = Slider(ax_s, "cycle", 0, C - 1, valinit=0, valstep=1)

    def update(val):
        c = int(slider.val)
        k = ticks[c]
        xs = x_f[c, :12, :]                           # (12, N)
        pred_line.set_data(xs[0], xs[1])
        predz_line.set_data(k * cfg.dt_wbc + dt * np.arange(1, xs.shape[1]
                                                            + 1), xs[2])
        fs = d["mpc_fsteps"][k][0].reshape(4, 3)
        foot_pts.set_data(fs[:, 0], fs[:, 1])
        fig.canvas.draw_idle()

    slider.on_changed(update)
    update(0)
    if show:  # pragma: no cover
        plt.show()
    return fig, slider


def animate_rollout(logs, cfg=None, stride: int = 10, fps: int = 25,
                    force_scale: float = 0.01, show: bool = True,
                    save_path: Optional[str] = None, device="cuda"):
    """Lightweight 3D rollout animation — the offline stand-in for the
    PyBullet GUI chase camera, debug foothold spheres and contact-force
    lines (scripts/Controller.py:332-339,
    scripts/PyBulletSimulator.py:177-210, scripts/ForceMonitor.py:29-84).

    Draws per frame: the base as an oriented box wireframe, straight
    shoulder->foot leg segments from the batched-FK foot positions, the
    commanded swing targets as floating markers ("debug spheres"), and
    WBC ground-reaction-force quivers — with the axes window chasing the
    base like the GUI camera. save_path: ".gif" (Pillow) or ".html"
    (jshtml, no external encoder needed); the feet come from
    `foot_positions` on `device`. Returns the FuncAnimation.
    """
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    from qrw_tpu_torch.config import Config
    from qrw_tpu_torch.ops.rotations import quat_to_rot

    cfg = cfg if cfg is not None else Config()
    d = _as_dict(logs)
    feet = foot_positions(d, device=device)
    T = feet.shape[0]
    frames = range(0, T, max(1, stride))
    bp = np.asarray(d["base_pos"])
    R = quat_to_rot(torch.as_tensor(d["base_quat"],
                                    dtype=torch.float64)).numpy()
    f_wbc = np.asarray(d.get("f_wbc", d.get("f_mpc")))
    targets = np.asarray(d["feet_pos_ref"]) if "feet_pos_ref" in d \
        else None

    # base box (Solo-12 trunk approx) in body frame
    hx, hy, hz = 0.195, 0.0875, 0.035
    corners = np.array([[sx * hx, sy * hy, sz * hz]
                        for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)])
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6),
             (5, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
    shoulders = np.array([[0.1946, 0.0875, 0.0], [0.1946, -0.0875, 0.0],
                          [-0.1946, 0.0875, 0.0],
                          [-0.1946, -0.0875, 0.0]])

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    box_lines = [ax.plot([], [], [], "k-", lw=1.2)[0] for _ in edges]
    leg_lines = [ax.plot([], [], [], "b-", lw=1.5)[0] for _ in range(4)]
    foot_pts, = ax.plot([], [], [], "ko", ms=4)
    tgt_pts, = ax.plot([], [], [], "go", ms=6, alpha=0.6)
    frc_lines = [ax.plot([], [], [], "r-", lw=1.0)[0] for _ in range(4)]
    trail, = ax.plot([], [], [], "c-", lw=0.8, alpha=0.7)
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z")

    def draw(k):
        Rw = R[k]
        cw = bp[k] + corners @ Rw.T
        for ln, (a, b) in zip(box_lines, edges):
            seg = np.stack([cw[a], cw[b]])
            ln.set_data(seg[:, 0], seg[:, 1])
            ln.set_3d_properties(seg[:, 2])
        sh_w = bp[k] + shoulders @ Rw.T
        for f in range(4):
            seg = np.stack([sh_w[f], feet[k, f]])
            leg_lines[f].set_data(seg[:, 0], seg[:, 1])
            leg_lines[f].set_3d_properties(seg[:, 2])
            frc = f_wbc[k].reshape(4, 3)[f] * force_scale
            seg2 = np.stack([feet[k, f], feet[k, f] + frc])
            frc_lines[f].set_data(seg2[:, 0], seg2[:, 1])
            frc_lines[f].set_3d_properties(seg2[:, 2])
        foot_pts.set_data(feet[k, :, 0], feet[k, :, 1])
        foot_pts.set_3d_properties(feet[k, :, 2])
        if targets is not None:
            tw = targets[k].T if targets[k].shape == (3, 4) \
                else targets[k]
            tgt_pts.set_data(tw[:, 0], tw[:, 1])
            tgt_pts.set_3d_properties(tw[:, 2])
        trail.set_data(bp[:k:5, 0], bp[:k:5, 1])
        trail.set_3d_properties(bp[:k:5, 2])
        # chase camera: axes window follows the base
        cx, cy = bp[k, 0], bp[k, 1]
        ax.set_xlim(cx - 0.45, cx + 0.45)
        ax.set_ylim(cy - 0.45, cy + 0.45)
        ax.set_zlim(0.0, 0.5)
        return box_lines + leg_lines + frc_lines + [foot_pts, tgt_pts,
                                                    trail]

    ani = animation.FuncAnimation(fig, draw, frames=frames,
                                  interval=1000 // fps, blit=False)
    if save_path:
        if save_path.endswith(".html"):
            with open(save_path, "w") as f:
                f.write(ani.to_jshtml(fps=fps))
        else:
            ani.save(save_path,
                     writer=animation.PillowWriter(fps=fps))
    if show:  # pragma: no cover
        plt.show()
    return ani
