"""Per-stage timing and device profiling harness.

Port of qrw_tpu/utils/profiling.py. The reference instruments each
controller stage with wall-clock deltas per tick (t_filter / t_planner
/ t_mpc / t_wbc / t_loop, scripts/Controller.py:81-88,367-379):

  * `stage_timings` runs each stage of one tick on its own (estimator,
    gait, MPC, WBC, simulator step, and the whole controller tick) on
    real initial inputs, `reps` times after a warm-up call, and returns
    seconds per call, each stage timed on the host clock between
    `torch.cuda.synchronize()` calls on the card;
  * `trace` is a context manager around torch.profiler that writes a
    Chrome/TensorBoard trace into `logdir`, as the JAX package's
    jax.profiler trace does.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict

import torch

from qrw_tpu_torch.sim.fleet import _check_device
from qrw_tpu_torch.sim.fleet import _device_from_sim as _device0


def _time_fn(fn, reps: int, sync) -> float:
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def stage_timings(cfg=None, dtype=torch.float32, reps: int = 20,
                  device="cuda") -> Dict[str, float]:
    """Per-stage seconds for one tick's work on `device` (the card
    unless the caller asks for the CPU); the keys mirror the
    reference's t_list_* names."""
    from qrw_tpu_torch.config import Config
    from qrw_tpu_torch.core import gait as gait_mod
    from qrw_tpu_torch.core import mpc as mpc_mod
    from qrw_tpu_torch.core import wbc as wbc_mod
    from qrw_tpu_torch.core.controller import (compute, init_state,
                                               make_controller)
    from qrw_tpu_torch.core.estimator import run_filter
    from qrw_tpu_torch.sim.physics import init_sim_state, step

    dev = _check_device(device)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    if cfg is None:
        cfg = Config()
    kw = dict(dtype=dtype, device=dev)
    ctl = make_controller(cfg)
    st = init_state(ctl, dtype, device=dev)
    ss = init_sim_state(cfg, **kw)
    d0 = _device0(ss)

    res: Dict[str, float] = {}
    res["t_filter"] = _time_fn(lambda: run_filter(
        cfg, ctl.model, st.estimator, 0, st.gait.current, d0,
        st.foot_traj.position), reps, sync)
    res["t_gait"] = _time_fn(lambda: gait_mod.update_gait(
        st.gait, 0, cfg.k_mpc, 0, ctl.patterns), reps, sync)
    xref = torch.zeros((12, cfg.n_steps + 1), **kw)
    xref[2, :] = cfg.h_ref
    fsteps = torch.zeros((cfg.N_gait, 12), **kw)
    res["t_mpc"] = _time_fn(lambda: mpc_mod.solve_mpc(
        cfg, xref, fsteps, st.mpc, ctl.mpc_settings), reps, sync)
    goals = torch.zeros((3, 4), **kw)
    res["t_wbc"] = _time_fn(lambda: wbc_mod.compute_wbc(
        cfg, ctl.model, st.wbc, st.qdes, torch.zeros(18, **kw),
        torch.zeros(12, **kw), torch.ones(4, **kw), goals, goals, goals,
        ctl.wbc_settings), reps, sync)
    ones = torch.ones(12, **kw)
    zeros = torch.zeros(12, **kw)
    res["t_sim"] = _time_fn(lambda: step(
        cfg, ctl.model, ss, cfg.joint_P * ones, cfg.joint_D * ones,
        st.qdes, zeros, zeros), reps, sync)
    res["t_loop"] = _time_fn(lambda: compute(ctl, st, d0, 1), reps, sync)
    return res


@contextlib.contextmanager
def trace(logdir: str = os.path.join(tempfile.gettempdir(), "qrw_trace")):
    """torch.profiler trace around a block, written into `logdir` as a
    `*.pt.trace.json` (chrome://tracing, Perfetto or TensorBoard). The
    card's kernels are traced when torch sees a card."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir
