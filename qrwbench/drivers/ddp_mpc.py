"""The warm-started DDP MPC batch: the reference's Crocoddyl backend as a
batched service, loop bypassed.

Traffic keys: phases (how many of the trot's phase offsets), per_phase
(problems a phase: B = phases x per_phase), noise (the initial state's
noise a cycle), sample_lanes and limits. The configuration's `ddp`
section gives the solver's settings (core/mpc_ddp.DDPSettings).

Inputs from the seed, the rolled QP batch's own (`phase_mpc.
phase_batch`): every problem stands at h_ref with 0.02 N(0, 1) on its
initial state and a forward speed drawn from U(0, 1) m/s over the
horizon; the footsteps of each block of per_phase problems are its trot
phase. Set-up solves them once from a zero warm start and runs one
warm-up cycle. Each cycle draws 0.002 N(0, 1) about the seed's initial
states, rolls each block's phase p -> p - 1, gathers its footsteps and
calls `core/mpc_ddp.solve_mpc_ddp` with the solution carried from the
last cycle, as the controller does when type_MPC is false, then
synchronizes, as a service returns its plans. A 10-iteration DDP has no
convergence test, so a cycle counts its solves and no converged ones;
a problem whose cost is not finite counts as failed.

The check judges a sample of the last cycle's problems, drawn from the
seed, against a float64 DDP run from the same inputs and the same
carried solution (`reference.ddp_mpc`).
"""

from __future__ import annotations

import numpy as np
import torch

from qrwbench import harness
from qrwbench.common import Hook, Wrappers, controller_config, tf32_products
from qrwbench.drivers.phase_mpc import phase_batch

MPC_DDP = "qrw_tpu_torch.core.mpc_ddp"


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from qrw_tpu_torch.core import mpc_ddp
        self.mpc_ddp = mpc_ddp
        self.ctrl = config["controller"]
        self.traffic = traffic
        dev = torch.device(device)
        self.cfg = cfg = controller_config(config)
        self.settings = mpc_ddp.DDPSettings(
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in config["ddp"].items()})
        N = cfg.n_steps
        phases = list(range(int(traffic["phases"])))
        self.per = int(traffic["per_phase"])
        rng = np.random.default_rng(seed)
        xr, _, phase_fs = phase_batch(N, cfg.N_gait, phases, self.per, rng)
        self.B, self.P = xr.shape[-1], N
        self.x0 = torch.as_tensor(xr, device=dev).permute(2, 0, 1) \
            .contiguous()                                   # (B, 12, N+1)
        self.phase_fs = torch.as_tensor(phase_fs, device=dev)
        self.ph = torch.as_tensor(phases, device=dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed % (2 ** 63))
        self.hooks = Wrappers([Hook("ddp", MPC_DDP, "solve_mpc_ddp")])
        self.state = self.mpc_ddp.solve_mpc_ddp(
            cfg, self.x0, self._fsteps(), None, self.settings).state

    def _fsteps(self):
        """(B, N_gait, 12): each block's phase footsteps."""
        return torch.repeat_interleave(self.phase_fs[self.ph], self.per, 0)

    def _solve(self):
        xr = self.x0.clone()
        xr[:, :, 0] += float(self.traffic["noise"]) * torch.randn(
            (self.B, 12), generator=self.gen, device=xr.device)
        self.ph = (self.ph - 1) % self.P
        res = self.mpc_ddp.solve_mpc_ddp(self.cfg, xr, self._fsteps(),
                                         self.state, self.settings)
        self.state = res.state
        return res

    def warm(self):
        self._solve()

    def cycle(self) -> dict:
        self.hooks.clear()      # what the check reads is this cycle's
        self._solve()
        return {"ticks": 0, "solves": self.B, "converged": 0}

    def spans(self):
        return []               # the port's own spans (qrw.ddp, qrw.ilqr.*)

    def constants(self) -> dict:
        return {}

    def outcome(self):
        """(solves of the last cycle, those whose cost is not finite)."""
        res = self.hooks.latest("ddp")[2]
        return self.B, int((~torch.isfinite(res.cost)).sum())

    def release(self):
        """Free the port's state before the reference runs."""
        self.hooks.clear()
        self.state = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def close(self):
        self.hooks.remove()

    def check(self, seed: int, control: bool = False):
        lim = self.traffic["limits"]
        got = self.gaps(seed, control, release=not control)
        return [harness.Check(k, got[k], float(v)) for k, v in lim.items()]

    def gaps(self, seed: int, control: bool = False,
             release: bool = False) -> dict:
        """The last cycle's sample against the float64 DDP; with
        `control`, the reference computed at TF32 precision in the
        port's place."""
        from qrwbench.reference import ddp_mpc
        rng = np.random.default_rng([seed, 1])
        (_, xref, fsteps, carried, _), _, res = self.hooks.latest("ddp")
        n = min(int(self.traffic["sample_lanes"]), self.B)
        lanes = torch.as_tensor(np.sort(rng.choice(self.B, size=n,
                                                   replace=False)),
                                device=xref.device)
        xr, fs, prev = xref[lanes], fsteps[lanes], carried.us[lanes]
        if control:
            with tf32_products():
                have = ddp_mpc.control(self.ctrl, xr, fs, prev)
            xs, us, cost = have.xs, have.us, have.cost
        else:
            xs, us = res.state.xs[lanes], res.state.us[lanes]
            cost = res.cost[lanes]
        if release:
            self.release()
        return {"ddp_" + k: v for k, v in
                ddp_mpc.judge(self.ctrl, xr, fs, prev, xs, us, cost).items()}
