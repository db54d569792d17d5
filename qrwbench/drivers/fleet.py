"""The closed-loop fleet: B simulated Solo-12s, one batched MPC a cycle.

Traffic keys: batch, tile, gaits (one per tile, round robin), velIDs
and terrain_ids (per robot, round robin, in an order drawn from the
seed), n_iters, stop_at_eps, rescue_min and rescue_div (the rescue
stage's capacity max(rescue_min, B // rescue_div)), schedule_cycles
(the cycles of velocity commands made in set-up; doubled in the window
if a run outlasts them), sample_lanes, sample_rescued and sample_robots
(the check's sample) and limits. The estimator is the real one.

Each cycle calls `sim.fleet.fleet_rollout` for one MPC cycle (k_mpc
ticks), resuming from the carry, with the slice of the per-robot
velocity schedule for the cycle's absolute ticks.

The check takes the last cycle of the window and recomputes a sample
drawn from the seed with the plain references in float64 from the
inputs of each call, as the port handed them on (`reference.mpc_qp`,
`reference.robot`): the cycle's MPC solve (the phase solve and the
rescue), and for each sampled robot, at one of the cycle's ticks (the
robots spread over all of them), the WBC's inputs, the WBC and the
physics step. The pre-MPC pipeline (`compute_pre`: estimator, gait,
footsteps, references) and the post step (`compute_post`) are not
recomputed. Wrappers keep the calls' arguments and results for the
whole run (references only: no copy, no synchronization).
"""

from __future__ import annotations

import numpy as np
import torch

from qrwbench import harness, trace
from qrwbench.common import (Hook, Wrappers, controller_config, max_gap,
                             tf32_products, warm_rescue)

FLEET = "qrw_tpu_torch.sim.fleet"
MPC_LANE = "qrw_tpu_torch.core.mpc_lane"


def _wbc_inputs_record(args, kwargs, out):
    """What the check needs of a `wbc_inputs(ctl, state, pre, x_f)` call:
    references to its inputs and its result."""
    _, cs, pre, x_f = args
    ft = pre.ft_state
    return dict(prev_p=cs.feet_p_cmd, prev_v=cs.feet_v_cmd, qdes=cs.qdes,
                vdes=cs.vdes, v_ref=pre.v_ref, pos=ft.position,
                vel=ft.velocity, acc=ft.acceleration, oRh=pre.oRh,
                oTh=pre.oTh, contacts=pre.gait.current[..., 0, :],
                f_cmd=x_f[..., 12:24, 0], out=out)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from qrw_tpu_torch.sim import fleet as fl
        self.fl = fl
        self.traffic = traffic
        self.ctrl = config["controller"]
        self.device = torch.device(device)
        cfg = controller_config(config)
        self.cfg = cfg
        B, tile = int(traffic["batch"]), int(traffic["tile"])
        self.B, self.tile = B, tile
        rng = np.random.default_rng(seed)
        velIDs = tuple(int(v) for v in rng.permutation(traffic["velIDs"]))
        tids = tuple(int(t) for t in rng.permutation(traffic["terrain_ids"]))
        calib = {g: np.asarray(v, np.float32)
                 for g, v in config.get("calibration", {}).items()}
        k = cfg.k_mpc
        self.hooks = Wrappers([
            Hook("mpc", MPC_LANE, "solve_mpc_batch_phase"),
            Hook("rescue", MPC_LANE, "_rescue_failed_lanes"),
            Hook("wbc_inputs", FLEET, "wbc_inputs", _wbc_inputs_record, k),
            Hook("wbc", FLEET, "compute_wbc_lane", keep=k),
            Hook("physics", FLEET, "step_lane", keep=k)])
        self.ctl, self.carry, self.ps, self.terrain, self.meta = \
            fl.make_hetero_fleet(cfg, B, tile=tile,
                                 gaits=tuple(traffic["gaits"]),
                                 velIDs=velIDs, terrain_ids=tids,
                                 seed=seed % (2 ** 63), device=self.device,
                                 calibration=calib or None)
        self.k_mpc = k
        self.sched = fl.hetero_v_ref_schedule(
            cfg, np.arange(7), int(traffic["schedule_cycles"]) * k,
            device=self.device)
        self.sel = torch.as_tensor(self.meta.velID, device=self.device)
        self.rescue = max(int(traffic["rescue_min"]),
                          B // int(traffic["rescue_div"]))
        self.n_cycles = 0

    def _rollout(self):
        k0 = self.n_cycles * self.k_mpc
        if k0 + self.k_mpc > self.sched.shape[0]:
            # a faster fleet than set-up planned for: twice the ticks
            self.sched = self.fl.hetero_v_ref_schedule(
                self.cfg, np.arange(7), 2 * self.sched.shape[0],
                device=self.device)
        v = self.sched[k0:k0 + self.k_mpc][:, self.sel]
        tr = self.traffic
        self.carry, _, cl = self.fl.fleet_rollout(
            self.ctl, self.carry, 1, self.ps, tile=self.tile,
            n_iters=int(tr["n_iters"]), rescue_cap=self.rescue,
            terrain=self.terrain, phase_offsets=self.meta.phase_offsets,
            phase_periods=self.meta.phase_periods, perfect_estimator=False,
            v_ref_schedule=v, with_logs=False,
            stop_at_eps=bool(tr["stop_at_eps"]))
        self.n_cycles += 1
        return cl

    def warm(self):
        self._rollout()
        warm_rescue(self.hooks.latest("mpc"))

    def cycle(self) -> dict:
        self.hooks.clear()      # what the check reads is this cycle's
        cl = self._rollout()
        return {"ticks": self.B * self.k_mpc, "solves": self.B,
                "converged": cl.converged.sum()}

    def spans(self):
        return [
            trace.span("pre_mpc", FLEET, "compute_pre"),
            trace.span("mpc", MPC_LANE, "solve_mpc_batch_phase"),
            trace.span("rescue", MPC_LANE, "_rescue_failed_lanes"),
            trace.span("wbc_inputs", FLEET, "wbc_inputs"),
            trace.span("wbc", FLEET, "compute_wbc_lane"),
            trace.span("post", FLEET, "compute_post"),
            trace.span("physics", FLEET, "step_lane"),
        ]

    def constants(self) -> dict:
        return {"k_mpc": self.k_mpc}

    def outcome(self):
        """(robots, robots latched or not upright at the window's end)."""
        z = self.carry.sim_states.q[:, 2]
        bad = (z <= 0.15) | ~torch.isfinite(z) | \
            (self.carry.ctl_states.error != 0)
        return self.B, int(bad.sum())

    def close(self):
        self.hooks.remove()

    # ------------------------------------------------------------------
    # the check
    def check(self, seed: int, control: bool = False):
        """The numbers compared, each beside its limit. With `control`,
        the plain references computed at TF32 precision (operands rounded
        to TF32's mantissa, float32 arithmetic, TF32 products) stand in
        the port's place."""
        lim = self.traffic["limits"]
        got = self.gaps(seed, control, release=not control)
        return [harness.Check(k, got[k], float(v)) for k, v in lim.items()]

    def sample(self, seed: int) -> dict:
        """The last cycle's inputs and the port's answers, for a sample of
        lanes and robots drawn from the seed: lanes of the cycle's MPC
        solve (every rescued lane among them, up to sample_rescued), and
        robots, each at one of the cycle's ticks, spread over all ten."""
        rng = np.random.default_rng([seed, 1])
        hooks = self.hooks
        tr = self.traffic
        a, _, (x_f, _, sol) = hooks.latest("mpc")
        xrefs, fsteps = a[1], a[2]
        cand = torch.nonzero(sol.converged).flatten().cpu().numpy()
        n = min(int(tr["sample_lanes"]), cand.size)
        lanes = set(int(i) for i in rng.choice(cand, size=n, replace=False))
        if hooks.calls["rescue"]:
            ra, _, rout = hooks.latest("rescue")
            before, after = ra[5].converged, rout[2].converged
            resc = torch.nonzero(after & ~before).flatten().cpu().numpy()
            lanes |= set(int(i) for i in resc[:int(tr["sample_rescued"])])
        lanes = torch.as_tensor(sorted(lanes), device=xrefs.device)
        S = {"xr": xrefs[:, :, lanes].permute(2, 0, 1),
             "fs": fsteps[:, :, lanes].permute(2, 0, 1),
             "plan": x_f[:, :, lanes].permute(2, 0, 1)}

        robots = rng.choice(self.B, size=min(int(tr["sample_robots"]),
                                             self.B), replace=False)
        ticks = list(zip(hooks.calls["wbc_inputs"], hooks.calls["wbc"],
                         hooks.calls["physics"]))
        parts, tids = [], []
        for t, (w_in, wbc, phys) in enumerate(ticks):
            r = np.sort(robots[t::len(ticks)])
            if not r.size:
                continue
            idx = torch.as_tensor(r, device=x_f.device)
            _, _, res = wbc
            pa, pkw, pres = phys
            ss, f_ext, new = pa[2], pkw.get("f_ext"), pres[0]
            parts.append({
                "w_in": {k: (v if k == "out" else v[idx])
                         for k, v in w_in.items()},
                "w_out": w_in["out"]._replace(**{
                    f: getattr(w_in["out"], f)[idx]
                    for f in w_in["out"]._fields}),
                "wbc_in": [x[idx] for x in wbc[0][3:10]],
                "wbc": [res.qdes[idx], res.vdes[idx], res.tau_ff[idx]],
                "sim": [ss.q[idx], ss.v[idx], ss.anchors[idx],
                        ss.active[idx]],
                "cmd": [x[idx] for x in pa[3:8]],
                "f_ext": (f_ext[idx] if f_ext is not None else
                          torch.zeros((r.size, 3), device=ss.q.device)),
                "next": [new.q[idx], new.v[idx], new.anchors[idx],
                         new.active[idx]]})
            tids.append(self.meta.tid[r])

        def cat(key):
            return [torch.cat(xs) for xs in zip(*(p[key] for p in parts))]

        from qrwbench.reference import robot
        S["w_in"] = {k: torch.cat([p["w_in"][k] for p in parts])
                     for k in parts[0]["w_in"] if k != "out"}
        S["w_out"] = [torch.cat(xs) for xs in
                      zip(*(p["w_out"] for p in parts))]
        S["wbc_in"] = cat("wbc_in")
        S["wbc"] = robot.WBCOut(*cat("wbc"))
        S["sim"] = robot.Sim(*cat("sim"))
        S["cmd"] = cat("cmd")
        S["f_ext"] = torch.cat([p["f_ext"] for p in parts])
        S["next"] = robot.Sim(*cat("next"))
        S["tid"] = np.concatenate(tids)
        return S

    def release(self):
        """Free the port's state before the references run."""
        self.hooks.clear()
        self.carry = self.ps = self.ctl = self.terrain = self.sched = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def gaps(self, seed: int, control: bool = False,
             release: bool = False) -> dict:
        from qrwbench.reference import mpc_qp, robot
        from qrwbench.reference.mpc_qp import tf32
        S = self.sample(seed)
        if release:
            self.release()
        out = {}
        xr, fs = S["xr"], S["fs"]
        if control:
            with tf32_products():
                have = mpc_qp.control_plans(self.ctrl, xr, fs)
        else:
            have = S["plan"]
        for k, v in mpc_qp.judge(self.ctrl, xr, fs, have).items():
            out["mpc_" + k] = v

        w = S["w_in"]
        keys = ("prev_p", "prev_v", "vdes", "v_ref", "pos", "vel", "acc",
                "oRh", "oTh")
        want = robot.wbc_inputs(self.ctrl,
                                *[w[k].to(torch.float64) for k in keys])
        if control:
            with tf32_products():
                have = robot.wbc_inputs(self.ctrl, *[tf32(w[k]) for k in keys])
            have = [w["qdes"], have.b_v, w["f_cmd"], w["contacts"],
                    have.feet_p, have.feet_v, have.feet_a]
        else:
            have = S["w_out"]
        want = [w["qdes"], want.b_v, w["f_cmd"], w["contacts"], want.feet_p,
                want.feet_v, want.feet_a]
        out["wbc_inputs_gap"] = max(max_gap(h, x) for h, x in zip(have, want))

        ins = S["wbc_in"]
        want = robot.wbc(self.ctrl, *[t.to(torch.float64) for t in ins])
        if control:
            with tf32_products():
                have = robot.wbc(self.ctrl, *[tf32(t) for t in ins])
        else:
            have = S["wbc"]
        out["wbc_tau_gap_Nm"] = max_gap(have.tau_ff, want.tau_ff)
        out["wbc_target_gap"] = max(max_gap(have.qdes, want.qdes),
                                    max_gap(have.vdes, want.vdes))

        sim, dev = S["sim"], S["sim"].q.device

        def step(dtype, rnd):
            ters = _terrains(dtype, dev)
            s0 = robot.Sim(q=rnd(sim.q).to(dtype), v=rnd(sim.v).to(dtype),
                           anchors=rnd(sim.anchors).to(dtype),
                           active=sim.active)
            return robot.physics_step(
                self.ctrl, s0, *[rnd(t).to(dtype) for t in S["cmd"]],
                rnd(S["f_ext"]).to(dtype), [ters[int(t)] for t in S["tid"]])

        want = step(torch.float64, lambda t: t)
        if control:
            with tf32_products():
                have = step(torch.float32, tf32)
        else:
            have = S["next"]
        out["physics_q_gap"] = max_gap(have.q, want.q)
        out["physics_v_gap"] = max_gap(have.v, want.v)
        return out


_TERRAINS = {}


def _terrains(dtype, device):
    """The reference's own terrains, by terrain id (0: the flat plane)."""
    from qrwbench.reference import terrain as ref_terrain
    key = (dtype, str(device))
    if key not in _TERRAINS:
        _TERRAINS[key] = {
            0: None,
            1: ref_terrain.make_bumpy(dtype=dtype, device=device),
            2: ref_terrain.make_stairs(dtype=dtype, device=device)}
    return _TERRAINS[key]
