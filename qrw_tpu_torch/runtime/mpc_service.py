"""Asynchronous MPC service over shared-memory mailboxes.

Port of qrw_tpu/runtime/mpc_service.py (the reference's process-parallel
MPC, scripts/MPC_Wrapper.py:150-264): the controller process publishes
(k, xref, fsteps) into a seqlock mailbox (runtime/ipc.Mailbox) and polls
for the latest plan; a worker process solves with the port's MPC
(core/mpc.solve_mpc, or core/mpc_ddp.solve_mpc_ddp when type_MPC is
False) in float64, warm-started from its previous solve, and publishes
the 24 x N plan. Sequence numbers replace the reference's boolean flags,
so stale results are observable.

The worker is started with the spawn method and runs on `device`, the
card unless the caller asks for the CPU. A spawned child imports torch
and, on the card, creates its own CUDA context, which takes seconds: the
worker signals when it is ready, `startup_s` records how long that took,
and `wait_result`'s timeout counts from then, so the start-up does not
decide a first solve. A worker that dies makes `wait_result` raise.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import Optional

import numpy as np

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.runtime.ipc import Mailbox

STARTUP_TIMEOUT_S = 300.0   # worker start: interpreter, torch, CUDA context


def _in_shape(cfg: Config):
    # row 0: [k, <pad>]; rows 1..12: xref (12, N+1); rest: fsteps
    return (1 + 12 + cfg.N_gait, max(cfg.n_steps + 1, 12))


def _worker_main(in_name: str, out_name: str, cfg_kw: dict, device: str,
                 ready):
    import torch

    from qrw_tpu_torch.core import mpc as mpc_mod
    from qrw_tpu_torch.core import mpc_ddp
    from qrw_tpu_torch.sim.fleet import _check_device

    cfg = Config(**cfg_kw)
    dev = _check_device(device)
    box_in = Mailbox(in_name, _in_shape(cfg), create=False)
    box_out = Mailbox(out_name, (24, cfg.n_steps), create=False)
    N = cfg.n_steps
    f64 = dict(dtype=torch.float64, device=dev)
    state = (mpc_mod.init_mpc_state(cfg, **f64) if cfg.type_MPC
             else mpc_ddp.init_ddp_state(cfg, **f64))
    if dev.type == "cuda":
        torch.zeros(1, device=dev)      # the CUDA context, before ready
    ready.set()
    try:
        while True:
            msg = box_in.read()
            if msg is None:
                time.sleep(0.0002)
                continue
            if msg[0, 0] < 0:       # shutdown sentinel (stop_parallel_loop,
                break               # scripts/MPC_Wrapper.py:300-306)
            xref = torch.as_tensor(msg[1:13, :N + 1], **f64)
            fsteps = torch.as_tensor(msg[13:13 + cfg.N_gait, :12], **f64)
            if cfg.type_MPC:
                res = mpc_mod.solve_mpc(cfg, xref, fsteps, state)
            else:
                res = mpc_ddp.solve_mpc_ddp(cfg, xref, fsteps, state)
            state = res.state
            box_out.write(res.x_f_applied.cpu().numpy())
    finally:
        box_in.close()
        box_out.close()


class MPCService:
    """Client handle: spawns the worker and exchanges problems and plans
    (MPC_Wrapper.solve / get_latest_result contract,
    scripts/MPC_Wrapper.py:73-126)."""

    def __init__(self, cfg: Config, name: Optional[str] = None,
                 device: str = "cuda"):
        self.cfg = cfg
        tag = name or f"qrw_{os.getpid()}_{id(self):x}"
        self._in = Mailbox(f"/{tag}_in", _in_shape(cfg), create=True)
        self._out = Mailbox(f"/{tag}_out", (24, cfg.n_steps),
                            create=True)
        self.last_available_result = np.zeros((24, cfg.n_steps))
        self.startup_s = None       # seconds to the worker's ready signal
        ctx = mp.get_context("spawn")
        self._ready = ctx.Event()
        cfg_kw = {f: getattr(cfg, f)
                  for f in cfg.__dataclass_fields__}  # type: ignore
        self._t0 = time.perf_counter()
        self._proc = ctx.Process(
            target=_worker_main,
            args=(f"/{tag}_in", f"/{tag}_out", cfg_kw, device, self._ready),
            daemon=True)
        self._proc.start()

    def _check_worker(self):
        if not self._proc.is_alive():
            raise RuntimeError(f"MPC worker exited with code "
                               f"{self._proc.exitcode}")

    def wait_ready(self, timeout: float = STARTUP_TIMEOUT_S) -> float:
        """Block until the worker has started (torch imported, state and
        CUDA context made); returns its start-up seconds."""
        t_end = time.perf_counter() + timeout
        while self.startup_s is None:
            if self._ready.wait(0.05):
                self.startup_s = time.perf_counter() - self._t0
                break
            self._check_worker()
            if time.perf_counter() > t_end:
                raise TimeoutError("MPC worker did not start")
        return self.startup_s

    def solve(self, k: int, xref: np.ndarray, fsteps: np.ndarray):
        """Publish a problem (non-blocking)."""
        msg = np.zeros(self._in.shape)
        msg[0, 0] = k
        msg[1:13, :self.cfg.n_steps + 1] = xref
        msg[13:13 + self.cfg.N_gait, :12] = fsteps
        self._in.write(msg)

    def get_latest_result(self) -> np.ndarray:
        """Newest plan if available, else the previous one (stale)."""
        fresh = self._out.read()
        if fresh is not None:
            self.last_available_result = fresh
        return self.last_available_result

    def wait_result(self, timeout: float = 10.0) -> np.ndarray:
        """Block until a new plan arrives; `timeout` seconds from the
        worker's ready signal (the start-up has its own limit)."""
        self.wait_ready()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            fresh = self._out.read()
            if fresh is not None:
                self.last_available_result = fresh
                return fresh
            self._check_worker()
            time.sleep(0.001)
        raise TimeoutError("MPC worker did not answer")

    def stop(self):
        """Shutdown (stop_parallel_loop, scripts/MPC_Wrapper.py:300)."""
        if self._proc.is_alive():
            msg = np.zeros(self._in.shape)
            msg[0, 0] = -1.0
            self._in.write(msg)
            self._proc.join(timeout=30.0)
            if self._proc.is_alive():  # pragma: no cover
                self._proc.terminate()
                self._proc.join(timeout=5.0)
        self._in.close()
        self._out.close()
