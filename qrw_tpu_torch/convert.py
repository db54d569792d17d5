"""Carry state between qrw_tpu and the port.

`to_torch` turns a qrw_tpu NamedTuple tree (leaves given as numpy
arrays, or anything `np.asarray` accepts) into the port's counterpart:
each NamedTuple becomes the port class of the same name, each array a
tensor on `device`. Floating arrays take `dtype` when it is given;
booleans and integers keep their type. Python scalars and None pass
through. `to_numpy` goes back: tensors become numpy arrays, and with
`like` (a tree of the same structure, e.g. the qrw_tpu original) every
NamedTuple takes the class found at the same place in `like`.

Covered: PhaseQPData, PhaseStructure, ControllerState (with the QP,
DDP or planner MPC carry: MPCState, DDPState, PlannerState), SimState
(with its Projectiles), DeviceData, MPCLaneState, MPCWarmState,
MPCBatchState, FleetCarry, RolloutCarry, RolloutLog, Telemetry and the
solver results (PhaseQPResult, PallasQPResult, QPSolution, MPCResult,
ILQRResult, DDPResult, PlannerResult), GamepadState and ReplayLog, with
everything they hold. A carry broadcast to a leading batch axis (B, ...) converts
the same way.
"""

from __future__ import annotations

import numpy as np
import torch

_REGISTRY = None


def _registry():
    global _REGISTRY
    if _REGISTRY is None:
        from qrw_tpu_torch.core import (controller, estimator,
                                        foot_trajectory, footstep, gait,
                                        joystick, kalman, mpc, mpc_ddp,
                                        mpc_ddp_planner, mpc_lane, wbc)
        from qrw_tpu_torch.runtime import replay
        from qrw_tpu_torch.ops import ilqr, qp, qp_pallas, qp_phase
        from qrw_tpu_torch.sim import fleet, physics, rollout, terrain
        classes = [
            qp_phase.PhaseQPData, qp_phase.PhaseQPResult,
            qp_pallas.PallasQPResult, qp.QPSolution, mpc.MPCWarmState,
            mpc.MPCBatchState,
            mpc_lane.PhaseStructure, mpc_lane.MPCLaneState,
            controller.ControllerState, controller.PreMPC,
            controller.Result, controller.WBCInputs,
            gait.GaitState, footstep.FootstepState,
            foot_trajectory.FootTrajState, estimator.EstimatorState,
            estimator.EstimatorOutput, estimator.DeviceData,
            kalman.KF18State, mpc.MPCState, wbc.WBCState, wbc.WBCResult,
            physics.SimState, physics.Projectiles, fleet.FleetCarry,
            fleet.FleetLog, fleet.FleetCycleLog, terrain.Terrain,
            terrain.FleetTerrain, mpc.MPCResult, controller.Telemetry,
            rollout.RolloutCarry, rollout.RolloutLog, mpc_ddp.DDPState,
            mpc_ddp.DDPResult, mpc_ddp_planner.PlannerState,
            mpc_ddp_planner.PlannerResult, ilqr.ILQRResult,
            joystick.GamepadState, replay.ReplayLog]
        _REGISTRY = {c.__name__: c for c in classes}
    return _REGISTRY


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """Apply `fn` to the tensor leaves of one or more trees of the same
    structure (NamedTuples, tuples, lists); None and Python scalars of
    the first tree pass through unchanged."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if _is_namedtuple(tree):
        return type(tree)(*[tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def to_torch(tree, device="cpu", dtype=None):
    """qrw_tpu tree -> the port's tree on `device`."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if _is_namedtuple(tree):
        cls = _registry().get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no port counterpart for {type(tree).__name__}")
        return cls(**{f: to_torch(getattr(tree, f), device, dtype)
                      for f in tree._fields})
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(x, device, dtype) for x in tree)
    if torch.is_tensor(tree):
        arr = tree
    else:
        arr = torch.as_tensor(np.array(np.asarray(tree)))
    if dtype is not None and arr.is_floating_point():
        arr = arr.to(dtype)
    return arr.to(device)


def to_numpy(tree, like=None):
    """The port's tree -> numpy leaves (NamedTuple classes from `like`
    when it is given)."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if _is_namedtuple(tree):
        cls = type(like) if like is not None else type(tree)
        return cls(**{f: to_numpy(getattr(tree, f),
                                  None if like is None else getattr(like, f))
                      for f in tree._fields})
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(x, None if like is None else y)
                          for x, y in zip(tree, like if like is not None
                                          else [None] * len(tree)))
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
