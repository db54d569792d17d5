"""Masterboard-compatible device facade over the simulator.

Port of qrw_tpu/sim/device.py: the reference's device abstraction
(scripts/PyBulletSimulator.py:497-730: Init / UpdateMeasurment /
SetDesiredJointTorque / SetDesiredJointPDgains / SetDesiredJointPosition
/ SetDesiredJointVelocity / SendCommand / Stop, with a `Hardware` dummy)
for host-driven loops. `SendCommand` is one `sim/physics.step` on the
device's tensors; `UpdateMeasurment` copies the measurement
(`DeviceData`) to numpy attributes in one device-to-host copy, and
`SendCommand` takes the five command arrays to the device in one copy.
WaitEndOfCycle paces to real time with the native pacer
(runtime/ipc.Pacer).

The simulator state lives on `device` (the card unless the caller asks
for the CPU); a terrain on another device raises. For throughput this
facade is the wrong tool: use sim/rollout along a batch axis.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core.estimator import DeviceData
from qrw_tpu_torch.models.solo12 import make_solo12
from qrw_tpu_torch.ops import rbd
from qrw_tpu_torch.sim import physics
from qrw_tpu_torch.sim.fleet import _check_device, _device_from_sim


class Hardware:
    """Dummy hardware status object (scripts/PyBulletSimulator.py:497-522)."""

    def __init__(self):
        self.is_timeout = False
        self._imu_data = np.zeros(3)

    def IsTimeout(self) -> bool:
        return self.is_timeout

    def imu_data_attitude(self, i: int) -> float:
        return float(self._imu_data[i])


def _host_measurements(obj, d: DeviceData) -> None:
    """Set the reference's measurement attributes from `d`, copied to
    the host in one transfer."""
    flat = torch.cat([d.base_lin_acc, d.base_ang_vel, d.base_quat, d.q_mes,
                      d.v_mes, d.dummy_pos, d.b_base_vel]).cpu().numpy()
    parts = np.split(flat, np.cumsum([3, 3, 4, 12, 12, 3]))
    (obj.baseLinearAcceleration, obj.baseAngularVelocity,
     obj.baseOrientation, obj.q_mes, obj.v_mes, obj.dummyPos,
     obj.b_baseVel) = parts


class SimDevice:
    """Drop-in device for host-driven control loops.

    Same call protocol as the reference device
    (scripts/main_solo12_control.py:180-213):

        device.Init(calibrateEncoders=True, q_init=q, ...)
        while running:
            device.UpdateMeasurment()
            ... controller ...
            device.SetDesiredJointPDgains(P, D)
            device.SetDesiredJointPosition(q_des)
            device.SetDesiredJointVelocity(v_des)
            device.SetDesiredJointTorque(tau_ff)
            device.SendCommand(WaitEndOfCycle=True)
        device.Stop()
    """

    def __init__(self, cfg: Optional[Config] = None, dtype=torch.float32,
                 terrain=None, device="cuda"):
        self.cfg = cfg if cfg is not None else Config()
        self.dtype = dtype
        self.torch_device = _check_device(device)
        if terrain is not None and \
                terrain.heights.device.type != self.torch_device.type:
            raise ValueError(f"terrain on {terrain.heights.device}, device "
                             f"on {self.torch_device}")
        self.terrain = terrain
        self.model = rbd.to_torch(make_solo12())
        self.nb_motors = 12
        self.hardware = Hardware()
        self.is_timeout = False
        # desired-command mailboxes (SetDesired* targets)
        self.P = np.zeros(12)
        self.D = np.zeros(12)
        self.q_des = np.zeros(12)
        self.v_des = np.zeros(12)
        self.tau_ff = np.zeros(12)
        self._pacer = None
        self._state = None
        self._device_data = None

    # -- lifecycle -----------------------------------------------------------

    def Init(self, calibrateEncoders: bool = False, q_init=None,
             envID: int = 0, use_flat_plane: bool = True,
             enable_pyb_GUI: bool = False, dt: float = 0.002):
        """Build the sim world (PyBulletSimulator.Init,
        scripts/PyBulletSimulator.py:557-586). envID / use_flat_plane
        select the terrain when none was passed."""
        del calibrateEncoders, enable_pyb_GUI  # no-op in simulation
        cfg = self.cfg
        if dt != cfg.dt_wbc:
            cfg = cfg.replace(dt_wbc=dt)
            self.cfg = cfg
        if self.terrain is None and (envID == 1 or not use_flat_plane):
            from qrw_tpu_torch.sim.terrain import make_terrain
            self.terrain = make_terrain(
                cfg.replace(envID=envID, use_flat_plane=use_flat_plane),
                dtype=self.dtype, device=self.torch_device)
        self._state = physics.init_sim_state(
            cfg, q_init=None if q_init is None else torch.as_tensor(
                np.asarray(q_init, np.float64).ravel(), dtype=self.dtype,
                device=self.torch_device),
            dtype=self.dtype, device=self.torch_device)
        self._f_ext = torch.zeros(3, dtype=self.dtype,
                                  device=self.torch_device)
        self._device_data = None
        self.UpdateMeasurment()

    def Stop(self):
        """Release the pacer (the reference disconnects the client,
        scripts/PyBulletSimulator.py:724-729)."""
        if self._pacer is not None:
            self._pacer.close()
            self._pacer = None

    # -- measurements --------------------------------------------------------

    def UpdateMeasurment(self):
        """Refresh the measurement attributes from the last sim state
        (scripts/PyBulletSimulator.py:588-631) [sic: reference
        spelling]. Returns the measurement, on the device."""
        if self._device_data is None:
            # first call: synthesize a rest measurement
            self._device_data = _device_from_sim(self._state)
        _host_measurements(self, self._device_data)
        return self._device_data

    @property
    def device_data(self) -> DeviceData:
        """The measurement the controller consumes (tensors on the
        device)."""
        return self._device_data

    @property
    def sim_state(self) -> physics.SimState:
        return self._state

    # -- command mailboxes ---------------------------------------------------

    def SetDesiredJointTorque(self, tau):
        self.tau_ff = np.asarray(tau).ravel().copy()

    def SetDesiredJointPDgains(self, P, D):
        self.P = np.broadcast_to(np.asarray(P).ravel(), (12,)).copy()
        self.D = np.broadcast_to(np.asarray(D).ravel(), (12,)).copy()

    def SetDesiredJointPosition(self, q_des):
        self.q_des = np.asarray(q_des).ravel().copy()

    def SetDesiredJointVelocity(self, v_des):
        self.v_des = np.asarray(v_des).ravel().copy()

    def ApplyExternalForce(self, force):
        """World-frame force on the base for the next ticks (fault
        injection, scripts/PyBulletSimulator.py:402-431)."""
        self._f_ext = torch.as_tensor(
            np.asarray(force, np.float64).ravel(), dtype=self.dtype,
            device=self.torch_device)

    # -- actuation -----------------------------------------------------------

    def SendCommand(self, WaitEndOfCycle: bool = True):
        """Apply PD+feedforward torques and advance one dt_wbc tick
        (scripts/PyBulletSimulator.py:672-706). WaitEndOfCycle paces the
        host loop to real time with the native pacer, after the tick has
        finished on the device."""
        cmd = torch.as_tensor(
            np.stack([self.P, self.D, self.q_des, self.v_des,
                      self.tau_ff]).astype(np.float64),
            dtype=self.dtype, device=self.torch_device)
        self._state, self._device_data = physics.step(
            self.cfg, self.model, self._state, cmd[0], cmd[1], cmd[2],
            cmd[3], cmd[4], f_ext=self._f_ext, terrain=self.terrain)
        if WaitEndOfCycle:
            if self._pacer is None:
                from qrw_tpu_torch.runtime.ipc import Pacer
                self._pacer = Pacer(self.cfg.dt_wbc)
            if self.torch_device.type == "cuda":
                torch.cuda.synchronize(self.torch_device)
            self._pacer.wait()


class DummyDevice:
    """Fake device for the controller warm-up tick
    (scripts/Controller.py:30-47,189-198)."""

    def __init__(self, cfg: Optional[Config] = None, dtype=torch.float32,
                 device="cuda"):
        cfg = cfg if cfg is not None else Config()
        st = physics.init_sim_state(cfg, dtype=dtype,
                                    device=_check_device(device))
        self._data = _device_from_sim(st)
        _host_measurements(self, self._data)
        self.hardware = Hardware()

    @property
    def device_data(self) -> DeviceData:
        return self._data


def put_on_the_floor(device: SimDevice, q_init, duration_s: float = 2.0,
                     Kp: float = 6.0, Kd: float = 0.3):
    """Calibration ramp to the initial configuration
    (scripts/main_solo12_control.py:36-63): PD-track q_init for
    duration_s before handing control to the walking controller. The
    reference gates on a keyboard press (real robot); in simulation the
    ramp just runs. Returns the largest joint gap at the end."""
    q_init = np.asarray(q_init).ravel()
    n = int(duration_s / device.cfg.dt_wbc)
    device.SetDesiredJointPDgains(np.full(12, Kp), np.full(12, Kd))
    device.SetDesiredJointPosition(q_init)
    device.SetDesiredJointVelocity(np.zeros(12))
    device.SetDesiredJointTorque(np.zeros(12))
    for _ in range(n):
        device.UpdateMeasurment()
        device.SendCommand(WaitEndOfCycle=False)
    return np.max(np.abs(device.q_mes - q_init))
