"""Host-driven 500 Hz control loop against the device facade.

Port of qrw_tpu/runtime/host_loop.py (the reference's entry loop,
scripts/main_solo12_control.py:91-290, for hardware-in-the-loop use):
the controller tick (core/controller.compute) runs on the device's
tensors while the host drives a masterboard-shaped device
(sim/device.SimDevice; a real robot's interface would expose the same
methods). It keeps the reference's safety sequence:

  * startup divergence abort: a desired-vs-measured joint gap over
    0.15 rad on the first tick ends the run
    (scripts/main_solo12_control.py:190-195);
  * masterboard timeout detection ends the loop;
  * the security latch ends the loop;
  * graceful shutdown: a 2.5 s damping descent (P = 0, D = 0.1), then
    zero torques (scripts/main_solo12_control.py:255-290).

The controller state lives where the device's simulator state lives;
a clone device on another device, or a device of another dtype than the
loop's, raises. Each tick reads back what the JAX loop reads back: the
joint command, the latch and the simulator's configuration (plus, with a
gamepad, the gait code the controller takes as an int).

`run_host_loop_pipelined` keeps `depth` ticks in flight: the command
applied at tick k is tick k - depth's, copied to pinned host buffers
with non_blocking=True as soon as it is computed; the apply waits on
that tick's CUDA event (on the CPU the copies are plain copies).
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.controller import (Result, compute, init_state,
                                           make_controller)
from qrw_tpu_torch.core.joystick import (gamepad_update, init_gamepad_state,
                                         v_ref_profile)
from qrw_tpu_torch.sim.device import SimDevice


class HostLoopResult(NamedTuple):
    n_ticks: int
    error: bool              # controller security latch tripped
    startup_abort: bool      # first-tick joint-gap abort
    timeout: bool            # masterboard timeout
    q_log: np.ndarray        # (n, 19) sim ground-truth configuration
    tau_log: np.ndarray      # (n, 12) feedforward torques


def _loop_device(cfg, device, clone, dtype, torch_device):
    """The primary device (built and initialized when None) after
    checking that it and the clone share the loop's dtype and device."""
    if device is None:
        device = SimDevice(cfg, dtype=dtype, device=torch_device)
        device.Init(q_init=cfg.q_init)
    for dev in (device,) if clone is None else (device, clone):
        if dev.dtype != dtype:
            raise ValueError(f"device of {dev.dtype} in a {dtype} loop")
        if dev.torch_device != device.torch_device:
            raise ValueError(f"clone on {dev.torch_device}, device on "
                             f"{device.torch_device}")
    return device


def _result_to_host(result: Result) -> Result:
    """The joint command in numpy, in one device-to-host copy."""
    return Result(*torch.stack(list(result)).cpu().numpy())


def run_host_loop(cfg: Optional[Config] = None, n_ticks: int = 500,
                  device: Optional[SimDevice] = None, gait: str = "trot",
                  realtime: bool = False, shutdown: bool = False,
                  clone: Optional[SimDevice] = None,
                  gamepad=None, dtype=torch.float32,
                  torch_device="cuda") -> HostLoopResult:
    """Run the controller against a host-driven device for n_ticks.

    device: the device to drive (default: a SimDevice on `torch_device`,
    the card unless the caller asks for the CPU, at cfg.q_init).
    clone: optional second device receiving identical commands (the
    reference's -c clone-robot mirroring,
    scripts/main_solo12_control.py:66-88,140-152).
    gamepad: optional runtime.gamepad.GamepadReader; its freshest frame
    drives the velocity command through core.joystick.gamepad_update.
    realtime: pace the primary device to dt_wbc with the native pacer."""
    cfg = cfg if cfg is not None else Config()
    device = _loop_device(cfg, device, clone, dtype, torch_device)
    dev = device.torch_device

    ctl = make_controller(cfg)
    state = init_state(ctl, dtype, gait=gait, device=dev)
    gp_state = (init_gamepad_state(dtype, dev) if gamepad is not None
                else None)

    q_log = np.zeros((n_ticks, 19))
    tau_log = np.zeros((n_ticks, 12))
    startup_abort = timeout = error = False
    k = 0
    for k in range(n_ticks):
        if device.hardware.IsTimeout():
            timeout = True
            break
        device.UpdateMeasurment()
        if gamepad is not None:
            frame = gamepad.read()
            # frame layout: runtime.gamepad.FRAME_SIZE — axes then
            # [start, back, L1, 4 gait buttons]
            gp_state = gamepad_update(cfg, gp_state, frame[0:4],
                                      frame[7:11])
            v_ref6 = gp_state.v_ref
            j_code = int(gp_state.gait_code)
        else:
            v_ref6 = v_ref_profile(k, cfg.velID, dtype, dev)
            j_code = 0
        state, result = compute(ctl, state, device.device_data, k,
                                v_ref6=v_ref6, joystick_code=j_code)
        result = _result_to_host(result)

        # startup security check (scripts/main_solo12_control.py:190-195)
        if k == 0 and np.max(np.abs(result.q_des - device.q_mes)) > 0.15:
            startup_abort = True
            break
        if bool(state.error):
            error = True
            break

        for d in (device,) if clone is None else (device, clone):
            d.SetDesiredJointPDgains(result.P, result.D)
            d.SetDesiredJointPosition(result.q_des)
            d.SetDesiredJointVelocity(result.v_des)
            d.SetDesiredJointTorque(result.tau_ff)
            d.SendCommand(WaitEndOfCycle=realtime and d is device)
        q_log[k] = device.sim_state.q.cpu().numpy()
        tau_log[k] = result.tau_ff

    if shutdown or error:
        _damping_shutdown(device, cfg)
    device.Stop()
    return HostLoopResult(n_ticks=k + 1, error=error,
                          startup_abort=startup_abort, timeout=timeout,
                          q_log=q_log[:k + 1], tau_log=tau_log[:k + 1])


def _damping_shutdown(device: SimDevice, cfg: Config,
                      duration_s: float = 2.5, D: float = 0.1):
    """Damping descent then zero torques
    (scripts/main_solo12_control.py:255-290)."""
    device.SetDesiredJointPDgains(np.zeros(12), np.full(12, D))
    device.SetDesiredJointPosition(np.zeros(12))
    device.SetDesiredJointVelocity(np.zeros(12))
    device.SetDesiredJointTorque(np.zeros(12))
    for _ in range(int(duration_s / cfg.dt_wbc)):
        device.UpdateMeasurment()
        device.SendCommand(WaitEndOfCycle=False)
    device.SetDesiredJointPDgains(np.zeros(12), np.zeros(12))
    device.SendCommand(WaitEndOfCycle=False)


class PipelinedLoopResult(NamedTuple):
    n_ticks: int
    error: bool
    depth: int
    periods_ms: np.ndarray   # (n - 1,) wall time between command applies
    q_log: np.ndarray        # (n, 19)


def run_host_loop_pipelined(cfg: Optional[Config] = None,
                            n_ticks: int = 500,
                            device: Optional[SimDevice] = None,
                            gait: str = "trot", depth: int = 2,
                            dtype=torch.float32,
                            torch_device="cuda") -> PipelinedLoopResult:
    """Double-buffered host dispatch: the deployment-shape loop when the
    device sits behind a link with a non-trivial round trip.

    run_host_loop serializes measure -> dispatch -> fetch -> apply. This
    loop keeps `depth` ticks in flight: tick k runs with the freshest
    measurement, its command starts copying host-ward at once (pinned
    buffers, non_blocking, a CUDA event recorded after the copy), and
    the command APPLIED at tick k is tick k - depth's, whose copy has
    had `depth` periods to complete: commands are depth ticks stale, the
    reference's async-MPC staleness contract (scripts/MPC_Wrapper.py:
    89-103) at the WBC rate. periods_ms: wall time between applies."""
    cfg = cfg if cfg is not None else Config()
    device = _loop_device(cfg, device, None, dtype, torch_device)
    dev = device.torch_device
    cuda = dev.type == "cuda"
    ctl = make_controller(cfg)
    state = init_state(ctl, dtype, gait=gait, device=dev)

    # the whole command profile in one host-to-device copy: the loop
    # then indexes it instead of building a command every tick
    sched = torch.as_tensor(np.stack([
        v_ref_profile(k, cfg.velID, dtype).numpy() for k in range(n_ticks)
    ]) if n_ticks else np.zeros((0, 6)), dtype=dtype, device=dev)
    # depth + 1 host buffers, reused in turn: buffer i is read (and its
    # command copied into the device facade) before it is written again
    bufs = [torch.empty((5, 12), dtype=dtype, pin_memory=cuda)
            for _ in range(depth + 1)]

    inflight = deque()
    periods = []
    q_log = np.zeros((n_ticks, 19))
    t_last = None
    applied = 0
    for k in range(n_ticks + depth):
        if k < n_ticks:
            device.UpdateMeasurment()
            state, result = compute(ctl, state, device.device_data, k,
                                    v_ref6=sched[k])
            buf = bufs[k % (depth + 1)]
            # start the host-ward copy NOW; it completes while later
            # ticks dispatch and compute
            buf.copy_(torch.stack(list(result)), non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            inflight.append((buf, event))
        if len(inflight) > depth or k >= n_ticks:
            if not inflight:
                break
            buf, event = inflight.popleft()
            if event is not None:
                event.synchronize()
            res = Result(*buf.numpy())
            device.SetDesiredJointPDgains(res.P, res.D)
            device.SetDesiredJointPosition(res.q_des)
            device.SetDesiredJointVelocity(res.v_des)
            device.SetDesiredJointTorque(res.tau_ff)
            device.SendCommand(WaitEndOfCycle=False)
            now = time.perf_counter()
            if t_last is not None:
                periods.append((now - t_last) * 1e3)
            t_last = now
            q_log[applied] = device.sim_state.q.cpu().numpy()
            applied += 1
    error = bool(state.error)
    device.Stop()
    return PipelinedLoopResult(
        n_ticks=applied, error=error, depth=depth,
        periods_ms=np.asarray(periods), q_log=q_log[:applied])
