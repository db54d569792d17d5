"""Spans and counters inside the port, per-stage timing, device traces.

Port of qrw_tpu/utils/profiling.py, plus the port's own measurement:

  * `span(name)` opens a `torch.profiler.record_function` range named
    "span:qrw.<name>" around a block, only while a torch profiler is
    running (one flag read otherwise, no torch operation). A span never
    synchronizes: it sits on the profiler's clock, beside the card's
    kernels, and spans nest as the code does. The layers' spans (pre,
    MPC, rescue, WBC, post, physics, the QP solver's stages) tile the
    functions they name, so the innermost span says where the host was.
  * `host_read(site)` is the span "span:qrw.sync.<site>" around a read
    that blocks the host until the card has run what was queued: an
    explicit read (`bool`, `int`, `.item()`, `torch.equal`, `.cpu()`),
    a library call that reads a status back (`torch.linalg.cholesky`'s
    info check), or a copy from pageable host memory to the card, which
    synchronizes the stream. It also counts "sync.<site>".
  * `count(name, value)` adds to a counter while a profiler is running:
    a host number, or a 0-d tensor added on its own device (no host
    read). `counters()` returns them as floats (reading the card once),
    `reset()` clears them.
  * `stage_timings` runs each stage of one tick on its own (estimator,
    gait, MPC, WBC, simulator step, and the whole controller tick) on
    real initial inputs, `reps` times after a warm-up call, and returns
    seconds per call, each stage timed on the host clock between
    `torch.cuda.synchronize()` calls on the card (the reference's
    t_filter / t_planner / t_mpc / t_wbc / t_loop, one robot);
  * `trace` is a context manager around torch.profiler that writes a
    Chrome/TensorBoard trace into `logdir`, as the JAX package's
    jax.profiler trace does; the spans above appear in it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "span:qrw."

_COUNTS: dict = {}


def active() -> bool:
    """True while a torch profiler is running."""
    return _autograd_profiler._is_profiler_enabled


class span:
    """A profiler range "span:qrw.<name>" around a block while a profiler
    runs; nothing otherwise."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


class host_read(span):
    """The span "sync.<site>" around a read that blocks the host on the
    card, counted as "sync.<site>"."""

    __slots__ = ()

    def __init__(self, site: str):
        super().__init__("sync." + site)

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            count(self.name, 1)
        return super().__enter__()


def spanned(name: str):
    """Decorator: the whole call inside `span(name)`."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return deco


def count(name: str, value) -> None:
    """Add `value` (a number, or a 0-d tensor summed on its device) to the
    counter `name` while a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    prev = _COUNTS.get(name)
    _COUNTS[name] = value if prev is None else prev + value


def counters() -> Dict[str, float]:
    """{name: total} of the counters since the last `reset`."""
    return {k: float(v) for k, v in _COUNTS.items()}


def reset() -> None:
    _COUNTS.clear()


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
    from qrw_tpu_torch.sim.fleet import _check_device
    from qrw_tpu_torch.sim.fleet import _device_from_sim as _device0
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
    `*.pt.trace.json` (chrome://tracing, Perfetto or TensorBoard), with
    the port's spans as CPU ranges. The card's kernels are traced when
    torch sees a card."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir
