"""Lane-major closed-loop fleet rollout: B robots, ONE batched MPC a cycle.

Port of qrw_tpu/sim/fleet.py (`make_fleet`, `fleet_rollout`). Each 50 Hz
cycle (k_mpc = 10 ticks):

  tick k0:      compute_pre for the whole fleet (estimator foot
                kinematics hoisted lane-major) -> ONE batched phase-
                solver MPC (core/mpc_lane.solve_mpc_batch_phase, shift
                and warm carry, per-tile phases rotated p -> p-1 as the
                gait rolls) -> lane-major WBC -> compute_post ->
                lane-major physics
  ticks +1..+9: the same without the solve, consuming the held plan.

On CUDA tensors the solve runs the hand-written kernel of ops/qp_phase;
on CPU tensors its plain version. Failed lanes follow the layered
fallback of core/mpc_lane: the capacity-bounded rescue stage
(rescue_cap > 0; kernel K2 of ops/qp_pallas on the card) on cycles with
failures, then the stale-plan fallback with a cold-restart carry.

`make_hetero_fleet` builds the heterogeneous fleet: gaits per kernel
tile over a union phase set, velocity profiles and terrains per robot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.convert import tree_map
from qrw_tpu_torch.core import mpc_lane as ml
from qrw_tpu_torch.core.controller import (Controller, ControllerState,
                                           compute_post, compute_pre,
                                           init_state, make_controller,
                                           wbc_inputs)
from qrw_tpu_torch.core.estimator import DeviceData
from qrw_tpu_torch.core.wbc_lane import compute_wbc_lane
from qrw_tpu_torch.ops import rbd_lane as rl
from qrw_tpu_torch.sim.physics import SimState, init_sim_state
from qrw_tpu_torch.sim.physics_lane import step_lane
from qrw_tpu_torch.utils.profiling import host_read, span


class FleetCarry(NamedTuple):
    """Resumable fleet state."""
    ctl_states: ControllerState     # (B, ...)
    sim_states: SimState            # (B, ...)
    devices: DeviceData             # (B, ...)
    lane_state: ml.MPCLaneState     # lane-major warm carry (..., B)
    tile_phase: torch.Tensor        # (B // tile,) int32 phase per tile
    cycle: torch.Tensor             # () int32 cycles completed


class FleetLog(NamedTuple):
    """Per-tick fleet signals (T, B, ...)."""
    base_pos: torch.Tensor          # (T, B, 3)
    base_quat: torch.Tensor         # (T, B, 4)
    f_mpc: torch.Tensor             # (T, B, 12) first-step plan consumed
    tau_ff: torch.Tensor            # (T, B, 12)
    error: torch.Tensor             # (T, B)


class FleetCycleLog(NamedTuple):
    """Per-MPC-cycle solver health (C, ...)."""
    converged: torch.Tensor         # (C, B)
    iters: torch.Tensor             # (C, B)
    phase: torch.Tensor             # (C, B // tile)
    # (C,) failed lanes the rescue stage re-solved (0: it did not run)
    rescued: Optional[torch.Tensor] = None


def _device_from_sim(ss: SimState) -> DeviceData:
    return DeviceData(
        base_lin_acc=torch.zeros_like(ss.q[..., 0:3]),
        base_ang_vel=ss.v[..., 3:6], base_quat=ss.q[..., 3:7],
        q_mes=ss.q[..., 7:], v_mes=ss.v[..., 6:],
        dummy_pos=ss.q[..., 0:3], b_base_vel=ss.v[..., 0:3])


def _check_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but torch.cuda.is_available() "
                           "is False")
    return device


def make_fleet(cfg: Config, batch: int, ps: ml.PhaseStructure,
               tile: int = 128, seed: int = 0, dtype=torch.float32,
               perturb_q: float = 0.01, perturb_v: float = 0.02,
               gait: str = "trot", device="cuda"
               ) -> Tuple[Controller, FleetCarry]:
    """(controller, initial fleet carry): B robots from the standard
    init with per-robot joint-angle / base-velocity perturbations drawn
    from a torch.Generator seeded with `seed`. The shared initial phase
    is matched against `ps` by probing the tick-0 footstep support."""
    device = _check_device(device)
    if batch % tile:
        raise ValueError("batch must be a multiple of the tile")
    ctl = make_controller(cfg)
    cs0 = init_state(ctl, dtype, gait=gait, device=device)
    ss0 = init_sim_state(cfg, dtype=dtype, device=device)
    rep = lambda a: a.expand((batch,) + tuple(a.shape)).clone()
    cs_b = tree_map(rep, cs0)
    ss_b = tree_map(rep, ss0)

    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    dq = torch.randn((batch, 12), generator=gen, dtype=dtype)
    dv = torch.randn((batch, 3), generator=gen, dtype=dtype)
    q = ss_b.q.clone()
    v = ss_b.v.clone()
    q[:, 7:] += perturb_q * dq.to(device)
    v[:, 0:3] += perturb_v * dv.to(device)
    ss_b = ss_b._replace(q=q, v=v)
    dev_b = _device_from_sim(ss_b)

    pre0 = compute_pre(ctl, cs_b, dev_b, 0)
    sup = (pre0.fsteps[0, :cfg.n_steps, 0::3] != 0).reshape(-1)
    hit = torch.nonzero((ps.supports.to(device) == sup).all(dim=1))
    if hit.numel() == 0:
        raise ValueError("initial gait support not in the phase set")
    tile_phase = torch.full((batch // tile,), int(hit[0, 0]),
                            dtype=torch.int32, device=device)
    carry = FleetCarry(
        ctl_states=cs_b, sim_states=ss_b, devices=dev_b,
        lane_state=ml.init_lane_state(cfg, batch, device=device),
        tile_phase=tile_phase,
        cycle=torch.zeros((), dtype=torch.int32, device=device))
    return ctl, carry


def fleet_rollout(ctl: Controller, carry: FleetCarry, n_cycles: int,
                  ps: ml.PhaseStructure, tile: int = 128,
                  n_iters: int = 300, rescue_cap: int = 0,
                  v_ref_schedule=None, f_ext_schedule=None,
                  perfect_estimator: bool = True, with_logs: bool = True,
                  stop_at_eps: bool = True, terrain=None,
                  phase_offsets=None, phase_periods=None
                  ) -> Tuple[FleetCarry, Optional[FleetLog], FleetCycleLog]:
    """Run `n_cycles` MPC cycles (n_cycles * k_mpc ticks) of the fleet.
    Returns (carry, FleetLog or None, FleetCycleLog); resumable: call
    again with the returned carry.

    v_ref_schedule: optional (n_ticks, 6) shared or (n_ticks, B, 6)
    per-robot commands (default: the cfg.velID profile).
    f_ext_schedule: optional (n_ticks, B, 3) world-frame base forces.
    rescue_cap: capacity of the rescue stage (0: off).
    terrain: optional sim/terrain.Terrain (shared) or FleetTerrain (one
    per robot) under the lane physics; None is the flat plane.
    phase_offsets / phase_periods: optional (B // tile,) ints for a
    heterogeneous fleet whose union phase set concatenates several
    gaits' cyclic classes: tile t's phase rotates within
    [offset_t, offset_t + period_t) as offset + (p - offset - 1) % period
    (make_hetero_fleet builds them). Default: one cyclic set of size P."""
    cfg = ctl.cfg
    k_mpc = cfg.k_mpc
    B = carry.lane_state.f.shape[-1]
    n_ticks = n_cycles * k_mpc
    P = ps.data.Kbar_inv.shape[0]
    dtype = carry.sim_states.q.dtype
    dev_t = carry.sim_states.q.device
    lane_model = rl.solo12_lane()
    with host_read("fleet_cycle"):
        cycle0 = int(carry.cycle)
    if v_ref_schedule is not None:
        v_ref_schedule = torch.as_tensor(v_ref_schedule, dtype=dtype,
                                         device=dev_t)
        if v_ref_schedule.dim() == 2:
            v_ref_schedule = v_ref_schedule[:, None, :].expand(n_ticks, B, 6)
        if tuple(v_ref_schedule.shape) != (n_ticks, B, 6):
            raise ValueError(f"v_ref_schedule must be ({n_ticks}, 6) or "
                             f"({n_ticks}, {B}, 6)")
    if f_ext_schedule is not None:
        f_ext_schedule = torch.as_tensor(f_ext_schedule, dtype=dtype,
                                         device=dev_t)
        if tuple(f_ext_schedule.shape) != (n_ticks, B, 3):
            raise ValueError(f"f_ext_schedule must be ({n_ticks}, {B}, 3)")

    def pre_tick(cs, dev, k, v_ref6):
        """compute_pre with the estimator FK hoisted lane-major."""
        with span("fleet.fk"):
            qm = dev.q_mes.reshape(B, 4, 3).permute(1, 2, 0)
            vm = dev.v_mes.reshape(B, 4, 3).permute(1, 2, 0)
            kin = rl.frame_kinematics(lane_model, rl.ZV3, rl.EYE3, qm, None,
                                      vm)
            pos = torch.stack([p.T for p in kin.pos], dim=2)
            vel = torch.stack([p.T for p in kin.vel], dim=2)
        return compute_pre(ctl, cs, dev, k, v_ref6, 0, perfect_estimator,
                           est_fk=(pos, vel))

    def post_tick(cs, pre, x_f_b, k):
        inp = wbc_inputs(ctl, cs, pre, x_f_b)
        wbc_b = compute_wbc_lane(cfg, lane_model, cs.wbc, inp.qj, inp.b_v,
                                 inp.f_cmd, inp.contacts, inp.feet_p_cmd,
                                 inp.feet_v_cmd, inp.feet_a_cmd)
        return compute_post(ctl, cs, pre, k, x_f_b, x_f_b, cs.mpc,
                            cs.planner_target, wbc_res=wbc_b)

    def sim_tick(ss, res, f_ext):
        return step_lane(cfg, lane_model, ss, res.P, res.D, res.q_des,
                         res.v_des, res.tau_ff, f_ext=f_ext, terrain=terrain)

    if phase_offsets is not None:
        with host_read("fleet_phase_offsets"):
            offs = torch.as_tensor(np.asarray(phase_offsets),
                                   dtype=torch.int32, device=dev_t)
            pers = torch.as_tensor(np.asarray(phase_periods),
                                   dtype=torch.int32, device=dev_t)

    cs, ss, dev = carry.ctl_states, carry.sim_states, carry.devices
    lane_st, phases = carry.lane_state, carry.tile_phase
    logs, cyc_logs = [], []
    for ci in range(n_cycles):
        k0 = (cycle0 + ci) * k_mpc
        for dk in range(k_mpc):
            k = k0 + dk
            t = ci * k_mpc + dk
            pre = pre_tick(cs, dev, k, None if v_ref_schedule is None
                           else v_ref_schedule[t])
            if dk == 0:
                # the solve tick: ONE batched MPC for the whole fleet
                xr_l = pre.xref.to(torch.float32).permute(1, 2, 0)
                fs_l = pre.fsteps.to(torch.float32).permute(1, 2, 0)
                x_f_l, lane_st, sol = ml.solve_mpc_batch_phase(
                    cfg, xr_l, fs_l, ps, phases, state=lane_st, shift=True,
                    n_iters=n_iters, tile=tile, rescue_cap=rescue_cap,
                    stop_at_eps=stop_at_eps)
                x_f_b = x_f_l.permute(2, 0, 1).to(dtype)
                rescued = (sol.rescued if sol.rescued is not None else
                           torch.zeros((), dtype=torch.int64, device=dev_t))
                cyc_logs.append(FleetCycleLog(
                    converged=sol.converged, iters=sol.iters, phase=phases,
                    rescued=rescued))
            else:
                x_f_b = cs.x_f_mpc
            cs, res = post_tick(cs, pre, x_f_b, k)
            ss, dev = sim_tick(ss, res, None if f_ext_schedule is None
                               else f_ext_schedule[t])
            if with_logs:
                logs.append(FleetLog(base_pos=ss.q[:, 0:3],
                                     base_quat=ss.q[:, 3:7],
                                     f_mpc=x_f_b[:, 12:, 0],
                                     tau_ff=res.tau_ff, error=cs.error))
        if phase_offsets is None:
            phases = (phases - 1) % P
        else:
            phases = offs + (phases - offs - 1) % pers

    stack = lambda items: tree_map(lambda *xs: torch.stack(xs), *items)
    carry2 = FleetCarry(ctl_states=cs, sim_states=ss, devices=dev,
                        lane_state=lane_st, tile_phase=phases,
                        cycle=carry.cycle + n_cycles)
    return carry2, stack(logs) if with_logs else None, stack(cyc_logs)


# ----------------------------------------------------------------------
# Heterogeneous fleet: gaits x velocity profiles x terrains
# ----------------------------------------------------------------------

class HeteroMeta(NamedTuple):
    """Static description of a heterogeneous fleet (make_hetero_fleet):
    gaits per kernel tile (a tile shares one phase), predefined velocity
    profiles and terrains (flat, bumpy, stairs) per robot."""
    gait_names: tuple          # gait per tile-gait index
    tile_gait: np.ndarray      # (n_tiles,) index into gait_names
    velID: np.ndarray          # (B,) predefined-profile id per robot
    tid: np.ndarray            # (B,) terrain id (0 flat/1 bumpy/2 stairs)
    phase_offsets: np.ndarray  # (n_tiles,) union-set offset per tile
    phase_periods: np.ndarray  # (n_tiles,) cyclic period per tile


def make_hetero_fleet(cfg: Config, batch: int, tile: int = 128,
                      gaits=("trot", "walk", "bounding"),
                      velIDs=(0, 1, 2, 3, 4, 5, 6),
                      terrain_ids=(0, 1, 2), seed: int = 0,
                      dtype=torch.float32, perturb_q: float = 0.01,
                      perturb_v: float = 0.02, calibration=None,
                      device="cuda"):
    """Build a heterogeneous fleet: returns (ctl, carry, ps, terrain,
    meta).

    Gaits are assigned per kernel tile round-robin; the union phase set
    concatenates each gait's cyclic classes and a tile's phase rotates
    inside its gait's range. Velocity profiles and terrains are assigned
    per robot round-robin, so every tile mixes them. Each robot is
    settled onto its own terrain, and its perturbations are drawn from a
    torch.Generator seeded with `seed`. calibration: optional
    {gait: captured fsteps (C, N_gait, 12)} in numpy, which re-centers
    that gait's metric footholds (mpc_lane.calibrate_phase_fsteps). Run
    it with fleet_rollout(..., terrain=terrain,
    phase_offsets=meta.phase_offsets, phase_periods=meta.phase_periods,
    perfect_estimator=False, v_ref_schedule=hetero_v_ref_schedule(...)).
    """
    from qrw_tpu_torch.core import gait as gait_mod
    from qrw_tpu_torch.models.solo12 import make_solo12
    from qrw_tpu_torch.sim.terrain import (FleetTerrain, height_at,
                                           make_bumpy, make_stairs)
    device = _check_device(device)
    if batch % tile:
        raise ValueError("batch must be a multiple of the tile")
    n_tiles = batch // tile
    N = cfg.n_steps

    # union phase set with per-gait offsets
    sets = []
    for g in gaits:
        s = ml.gait_phase_fsteps(cfg, g)
        if calibration and g in calibration:
            s = ml.calibrate_phase_fsteps(cfg, s, calibration[g])
        sets.append(s)
    offs, lens = [], []
    off = 0
    seen = set()
    for s in sets:
        for fs in s:
            key = (fs[:N, 0::3] != 0).tobytes()
            if key in seen:
                raise ValueError("gait phase classes overlap; the per-tile "
                                 "offsets would be ambiguous")
            seen.add(key)
        offs.append(off)
        lens.append(len(s))
        off += len(s)
    ps = ml.build_phase_data(cfg, np.concatenate(sets, axis=0),
                             device=device)

    # per-tile gait, per-robot velID and terrain
    tile_gait = np.arange(n_tiles) % len(gaits)
    scen_gait = np.repeat(tile_gait, tile)
    velID = np.asarray([velIDs[b % len(velIDs)] for b in range(batch)])
    tid = np.asarray([terrain_ids[(b // len(velIDs)) % len(terrain_ids)]
                      for b in range(batch)])
    phase_offsets = np.asarray([offs[g] for g in tile_gait], np.int32)
    phase_periods = np.asarray([lens[g] for g in tile_gait], np.int32)
    terrain = FleetTerrain(
        tid=torch.as_tensor(tid, dtype=torch.int32, device=device),
        terrains=(make_bumpy(dtype=dtype, device=device),
                  make_stairs(dtype=dtype, device=device)))

    # controller states: per-gait init, gathered per robot
    ctl = make_controller(cfg)
    cs_per_gait = [init_state(ctl, dtype, gait=g, device=device)
                   for g in gaits]
    gidx = torch.as_tensor(scen_gait, device=device)
    cs_b = tree_map(lambda *xs: torch.stack(xs)[gidx], *cs_per_gait)

    # sim states: each robot settled onto its own terrain
    ss0 = init_sim_state(cfg, dtype=dtype, device=device)
    ss_b = tree_map(lambda a: a.expand((batch,) + tuple(a.shape)).clone(),
                    ss0)
    sh = torch.as_tensor(make_solo12().shoulders[0:2].T, dtype=dtype,
                         device=device)
    z_off = np.zeros(batch, np.float32)
    for i, t in enumerate(terrain.terrains):
        z_off[tid == i + 1] = float(torch.max(height_at(t, sh)))
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    dq = torch.randn((batch, 12), generator=gen, dtype=dtype)
    dv = torch.randn((batch, 3), generator=gen, dtype=dtype)
    q = ss_b.q.clone()
    v = ss_b.v.clone()
    q[:, 2] += torch.as_tensor(z_off, dtype=dtype, device=device)
    q[:, 7:] += perturb_q * dq.to(device)
    v[:, 0:3] += perturb_v * dv.to(device)
    ss_b = ss_b._replace(q=q, v=v)
    dev_b = _device_from_sim(ss_b)

    # initial phase per tile: the controller rolls the gait at k = 0
    # before the planner reads it, so the tick-0 support is the ROLLED
    # gait's window
    sups = ps.supports.cpu().numpy()
    tile_phase = np.zeros(n_tiles, np.int32)
    for t in range(n_tiles):
        g = tile_gait[t]
        rolled = gait_mod.roll_gait(gait_mod.make_gait(cfg, gaits[g]))
        sup = (rolled.current[:N] != 0).numpy().reshape(-1)
        hit = np.where((sups[offs[g]:offs[g] + lens[g]] == sup)
                       .all(axis=1))[0]
        if hit.size == 0:
            raise ValueError(f"tile {t}: initial {gaits[g]} support not "
                             f"in the phase set")
        tile_phase[t] = offs[g] + int(hit[0])

    carry = FleetCarry(
        ctl_states=cs_b, sim_states=ss_b, devices=dev_b,
        lane_state=ml.init_lane_state(cfg, batch, device=device),
        tile_phase=torch.as_tensor(tile_phase, device=device),
        cycle=torch.zeros((), dtype=torch.int32, device=device))
    meta = HeteroMeta(gait_names=tuple(gaits), tile_gait=tile_gait,
                      velID=velID, tid=tid, phase_offsets=phase_offsets,
                      phase_periods=phase_periods)
    return ctl, carry, ps, terrain, meta


def hetero_v_ref_schedule(cfg: Config, velID: np.ndarray, n_ticks: int,
                          dtype=torch.float32, device="cuda"
                          ) -> torch.Tensor:
    """(n_ticks, B, 6) velocity commands: each robot follows its own
    predefined profile."""
    from qrw_tpu_torch.core.joystick import v_ref_profile
    uniq = sorted(set(int(v) for v in velID))
    stack = torch.stack([
        torch.stack([v_ref_profile(k, vid, dtype) for k in range(n_ticks)])
        for vid in uniq])                                   # (U, T, 6)
    lut = {vid: i for i, vid in enumerate(uniq)}
    sel = torch.as_tensor([lut[int(v)] for v in velID])
    return stack[sel].permute(1, 0, 2).contiguous().to(device)


def hetero_shakedown_capture(cfg: Config, gait: str, v_cruise: float = 0.4,
                             n_ticks: int = 1200, device="cuda"
                             ) -> np.ndarray:
    """(C, N_gait, 12) footstep matrices captured from one single-robot
    shakedown run of `gait` ramping to v_cruise (sim/rollout on
    `device`): the calibration input of make_hetero_fleet for an
    off-nominal gait."""
    from qrw_tpu_torch.sim.rollout import make_rollout, rollout
    ctl, carry = make_rollout(cfg, gait=gait, device=device)
    t = np.arange(n_ticks)
    sched = np.zeros((n_ticks, 6), np.float32)
    sched[:, 0] = np.clip((t - 200) / 600.0, 0.0, 1.0) * v_cruise
    _, logs = rollout(ctl, carry, n_ticks, v_ref_schedule=sched)
    return logs.mpc_fsteps[::cfg.k_mpc].cpu().numpy()
