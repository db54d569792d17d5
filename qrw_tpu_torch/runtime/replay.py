"""Trajectory replay: re-drive the simulator from logged joint commands.

Port of qrw_tpu/runtime/replay.py (the reference's replay entry point,
scripts/main_solo12_replay.py): a logged run's per-tick joint commands
(q_des, v_des, tau_ff of a RolloutLog .npz) are fed straight back to
the simulator (sim/physics.step with the device facade's PD law),
bypassing the controller. Used to validate logs and reproduce runs. The
JAX package runs the ticks as one lax.scan; here they are a Python loop
on tensors, the log preallocated on the state's device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.sim.physics import SimState, init_sim_state, step


class ReplayLog(NamedTuple):
    base_pos: torch.Tensor   # (T, 3)
    base_quat: torch.Tensor  # (T, 4)
    q_mes: torch.Tensor      # (T, 12)
    v_mes: torch.Tensor      # (T, 12)


def replay(cfg: Config, model, sim_state: SimState, q_des, v_des, tau_ff,
           P=None, D=None, terrain=None) -> Tuple[SimState, ReplayLog]:
    """Replay T ticks of logged commands ((T, 12) arrays or tensors)
    through the simulator with the joint PD law of the device facade
    (scripts/PyBulletSimulator.py:679-692); P / D default to the config's
    joint gains. Returns the final state and the log."""
    dtype, dev = sim_state.q.dtype, sim_state.q.device
    cast = lambda a: torch.as_tensor(a).to(dtype=dtype, device=dev)
    q_des, v_des, tau_ff = cast(q_des), cast(v_des), cast(tau_ff)
    T = q_des.shape[0]
    P = (torch.full((T, 12), cfg.joint_P, dtype=dtype, device=dev)
         if P is None else cast(P))
    D = (torch.full((T, 12), cfg.joint_D, dtype=dtype, device=dev)
         if D is None else cast(D))
    log = ReplayLog(*[torch.empty((T, n), dtype=dtype, device=dev)
                      for n in (3, 4, 12, 12)])
    ss = sim_state
    for t in range(T):
        ss, _ = step(cfg, model, ss, P[t], D[t], q_des[t], v_des[t],
                     tau_ff[t], terrain=terrain)
        log.base_pos[t] = ss.q[0:3]
        log.base_quat[t] = ss.q[3:7]
        log.q_mes[t] = ss.q[7:]
        log.v_mes[t] = ss.v[6:]
    return ss, log


def replay_from_npz(path: str, cfg: Config = None, dtype=torch.float32,
                    device="cuda") -> Tuple[SimState, ReplayLog]:
    """Replay a RolloutLog .npz (utils/logger.save_npz of either
    package) end to end on `device` (the card unless the caller asks
    for the CPU)."""
    from qrw_tpu_torch.models.solo12 import make_solo12
    from qrw_tpu_torch.ops import rbd
    from qrw_tpu_torch.sim.fleet import _check_device
    from qrw_tpu_torch.utils.logger import load_npz
    if cfg is None:
        cfg = Config()
    data = load_npz(path)
    model = rbd.to_torch(make_solo12())
    ss = init_sim_state(cfg, dtype=dtype, device=_check_device(device))
    return replay(cfg, model, ss, data["q_des"], data["v_des"],
                  data["tau_ff"])
