"""Velocity-envelope sweep: batched closed-loop runs over a command grid.

Port of qrw_tpu/eval/speed_sweep.py (the reference's
crocoddyl_eval/test_4 harness: one simulation per desired (vx, wyaw)
pair, recording whether the robot survives). The JAX package runs the
grid as a jax.vmap over cells; here every (vx, wyaw) cell is one robot
of ONE batched rollout (sim/rollout along a leading axis) whose
(n_ticks, B, 6) velocity schedule ramps each robot to its own target.

Outputs per cell: success (no security latch, not fallen), the mean
forward-velocity tracking error and the mean height error over the
steady-state window. `mesh=` shards the cells over the processes of a
parallel/mesh.Mesh (the CLI's `--sweep --mesh`).

    python -m qrw_tpu_torch.runtime.main --sweep            # on the card
    python -m qrw_tpu_torch.runtime.main --sweep --cpu --ticks 60
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch.config import Config


class SweepResult(NamedTuple):
    vx: np.ndarray         # (nx,) grid
    wyaw: np.ndarray       # (nw,) grid
    success: np.ndarray    # (nx, nw) bool: survived, no security latch
    vx_err: np.ndarray     # (nx, nw) mean |vx_mes - vx_cmd| in steady state
    h_err: np.ndarray      # (nx, nw) mean |z - h_ref| in steady state


def run_sweep(cfg: Optional[Config] = None,
              vx_grid=np.linspace(0.0, 2.0, 9),
              wyaw_grid=np.linspace(-1.0, 1.0, 5),
              n_ticks: int = 1500, ramp_ticks: int = 500,
              dtype=torch.float32, device="cuda", mesh=None) -> SweepResult:
    """Run the whole grid as one batched rollout on `device` (the card
    unless the caller asks for the CPU).

    Commands ramp linearly to the target over ramp_ticks, then hold.
    With a mesh (parallel/mesh.make_mesh) the cells are sharded over its
    processes, each on its own device, and every process gets the whole
    grid's result."""
    from qrw_tpu_torch.convert import tree_map
    from qrw_tpu_torch.sim.rollout import make_rollout, rollout
    cfg = cfg if cfg is not None else Config()
    if mesh is not None:
        device = mesh.device
    ctl, carry1 = make_rollout(cfg, dtype=dtype, device=device)

    vx_g, wy_g = np.meshgrid(np.asarray(vx_grid), np.asarray(wyaw_grid),
                             indexing="ij")
    B = vx_g.size
    targets = np.zeros((B, 6), dtype=np.float64)
    targets[:, 0] = vx_g.ravel()
    targets[:, 5] = wy_g.ravel()
    ramp = np.minimum(np.arange(n_ticks) / max(ramp_ticks, 1), 1.0)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    # (B, n_ticks, 6): cells along the leading axis, the one a mesh splits
    v_sched = torch.as_tensor(
        (ramp[None, :, None] * targets[:, None, :]).astype(np_dtype),
        device=device)
    carry = tree_map(lambda a: a.expand((B,) + tuple(a.shape)).clone(),
                     carry1)
    # steady-state window: after the ramp, but never empty
    start = min(max(n_ticks - 500, ramp_ticks), n_ticks // 2)

    def cells(c, vs):
        _, logs = rollout(ctl, c, n_ticks,
                          v_ref_schedule=vs.transpose(0, 1))
        err = logs.error.any(dim=1)
        vx_err = (logs.base_vel[:, start:, 0] - vs[:, start:, 0]).abs() \
            .mean(dim=1)
        z = logs.base_pos[:, start:, 2]
        h_err = (z - cfg.h_ref).abs().mean(dim=1)
        fell = z.mean(dim=1) < 0.5 * cfg.h_ref
        return ~(err | fell), vx_err, h_err

    if mesh is not None:
        from qrw_tpu_torch.parallel.mesh import sharded_vmap
        cells = sharded_vmap(cells, mesh)
    ok, vx_err, h_err = cells(carry, v_sched)

    shape = vx_g.shape
    host = lambda t: t.cpu().numpy().reshape(shape)
    return SweepResult(
        vx=np.asarray(vx_grid), wyaw=np.asarray(wyaw_grid),
        success=host(ok), vx_err=host(vx_err), h_err=host(h_err))


def plot_envelope(res: SweepResult, show: bool = True,
                  save_path: Optional[str] = None):
    """Achievable-velocity envelope heatmap (analyse_simu analog)."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 2, figsize=(12, 5))
    ext = [res.wyaw[0], res.wyaw[-1], res.vx[0], res.vx[-1]]
    im0 = axs[0].imshow(res.success.astype(float), origin="lower",
                        extent=ext, aspect="auto", vmin=0, vmax=1)
    axs[0].set_title("success")
    im1 = axs[1].imshow(res.vx_err, origin="lower", extent=ext,
                        aspect="auto")
    axs[1].set_title("steady-state |vx err| [m/s]")
    for ax in axs:
        ax.set_xlabel("wyaw [rad/s]")
        ax.set_ylabel("vx [m/s]")
    fig.colorbar(im0, ax=axs[0])
    fig.colorbar(im1, ax=axs[1])
    if save_path:
        fig.savefig(save_path, dpi=110)
    if show:  # pragma: no cover
        plt.show()
    return fig
