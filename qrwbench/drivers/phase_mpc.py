"""The rolled-gait MPC batch: the fleet's 50 Hz phase solve, loop bypassed.

Traffic keys: phases (how many of the trot's phase offsets) and
per_phase (problems a phase: B = phases x per_phase), cold_iters, n_iters, noise (the initial state's noise a cycle),
rescue_div (the rescue stage's capacity B // rescue_div), rescue (the
rescue's OSQP settings), stop_at_eps, sample_lanes, sample_rescued and
limits.

Inputs from the seed (bench.py's phase_batch): every problem stands at
h_ref with 0.02 N(0, 1) on its initial state and a forward speed drawn
from U(0, 1) m/s over the horizon; its footsteps are its tile's trot
phase. Set-up solves them cold. Each cycle draws 0.002 N(0, 1) about
the initial states (about the seed's own, so the problems stay
stationary), rolls each tile's phase p -> p - 1, gathers the footsteps
again and calls `core/mpc_lane.solve_mpc_batch_phase` with shift=True
and the rescue stage, then synchronizes, as a service returns its plan.
The tile is the port's own --fleet-mpc tile (`runtime.main.FLEET_MPC_TILE`
on the card, `CPU_TILE` on the CPU), so a change of it is measured on
the same problems.

The check judges a sample of the last cycle's converged plans, drawn
from the seed with every rescued lane of that cycle, against each
problem's optimum (`reference.mpc_qp`).
"""

from __future__ import annotations

import numpy as np
import torch

from qrwbench import harness, trace
from qrwbench.common import (Hook, Wrappers, controller_config,
                             tf32_products, warm_rescue)

MPC_LANE = "qrw_tpu_torch.core.mpc_lane"
H0 = 0.24474949993103629


def trot_phase_fsteps(n_steps: int, n_gait: int) -> np.ndarray:
    """(N, N_gait, 12) nominal trot footsteps, one per gait offset: the
    diagonal pairs alternate every N / 2 steps."""
    half = n_steps // 2
    pair1 = np.array([0.195, 0.147, 0., 0., 0., 0.,
                      0., 0., 0., -0.195, -0.147, 0.])
    pair2 = np.array([0., 0., 0., 0.195, -0.147, 0.,
                      -0.195, 0.147, 0., 0., 0., 0.])
    out = np.zeros((n_steps, n_gait, 12), np.float32)
    for p in range(n_steps):
        for i in range(n_steps):
            out[p, i] = (pair1 if ((i + (half - p)) // half) % 2 == 0
                         else pair2)
    return out


def phase_batch(n_steps, n_gait, phase_ids, per_phase, rng):
    """Lane-major xrefs (12, N+1, B) and fsteps (N_gait, 12, B)."""
    phase_fs = trot_phase_fsteps(n_steps, n_gait)
    B = len(phase_ids) * per_phase
    xrefs = np.zeros((12, n_steps + 1, B), np.float32)
    xrefs[2, :, :] = H0
    xrefs[:, 0, :] += rng.normal(scale=0.02, size=(12, B))
    xrefs[6, 1:, :] = rng.uniform(0.0, 1.0, size=B)
    fsteps = np.zeros((n_gait, 12, B), np.float32)
    for i, p in enumerate(phase_ids):
        fsteps[:, :, i * per_phase:(i + 1) * per_phase] = \
            phase_fs[p][:, :, None]
    return xrefs, fsteps, phase_fs


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from qrw_tpu_torch.core import mpc_lane as ml
        from qrw_tpu_torch.ops import qp
        self.ml = ml
        self.ctrl = config["controller"]
        self.traffic = traffic
        dev = torch.device(device)
        cfg = controller_config(config)
        self.cfg = cfg
        N = cfg.n_steps
        from qrw_tpu_torch.runtime import main as cli
        tile = cli.FLEET_MPC_TILE if dev.type == "cuda" else cli.CPU_TILE
        phases = list(range(int(traffic["phases"])))
        per = int(traffic["per_phase"])
        if per % tile:
            raise ValueError("per_phase must be a whole number of tiles")
        rng = np.random.default_rng(seed)
        xr, fs, phase_fs = phase_batch(N, cfg.N_gait, phases, per, rng)
        self.B, self.tile, self.P = xr.shape[-1], tile, N
        self.x0 = torch.as_tensor(xr, device=dev)
        self.phase_fs = torch.as_tensor(phase_fs, device=dev)
        self.ph = torch.as_tensor(np.repeat(phases, per // tile),
                                  dtype=torch.int32, device=dev)
        self.gen = torch.Generator(device=dev).manual_seed(
            seed % (2 ** 63))
        self.ps = ml.build_phase_data(cfg, phase_fs, device=dev)
        r = traffic["rescue"]
        self.rescue_settings = qp.QPSettings(
            eps_abs=r["eps_abs"], eps_rel=r["eps_rel"],
            max_iter=r["max_iter"],
            adaptive_rho_interval=r["adaptive_rho_interval"],
            scaling_iters=r["scaling_iters"])
        self.rescue_cap = self.B // int(traffic["rescue_div"])
        self.hooks = Wrappers([Hook("mpc", MPC_LANE, "solve_mpc_batch_phase"),
                               Hook("rescue", MPC_LANE,
                                    "_rescue_failed_lanes")])
        fsteps = torch.as_tensor(fs, device=dev)
        _, self.state, _ = self.ml.solve_mpc_batch_phase(
            cfg, self.x0, fsteps, self.ps, self.ph,
            n_iters=int(traffic["cold_iters"]), tile=tile)

    def _fsteps(self):
        fs_t = self.phase_fs[self.ph.long()]               # (tiles, Ng, 12)
        return torch.repeat_interleave(fs_t, self.tile, dim=0) \
            .permute(1, 2, 0).contiguous()

    def _solve(self):
        tr = self.traffic
        xr = self.x0.clone()
        xr[:, 0, :] += float(tr["noise"]) * torch.randn(
            (12, self.B), generator=self.gen, device=xr.device)
        self.ph = (self.ph - 1) % self.P
        _, self.state, sol = self.ml.solve_mpc_batch_phase(
            self.cfg, xr, self._fsteps(), self.ps, self.ph, state=self.state,
            shift=True, n_iters=int(tr["n_iters"]), tile=self.tile,
            rescue_cap=self.rescue_cap, rescue_settings=self.rescue_settings,
            stop_at_eps=bool(tr["stop_at_eps"]))
        return sol

    def warm(self):
        self._solve()
        warm_rescue(self.hooks.latest("mpc"))

    def cycle(self) -> dict:
        self.hooks.clear()      # what the check reads is this cycle's
        sol = self._solve()
        return {"ticks": 0, "solves": self.B,
                "converged": sol.converged.sum()}

    def spans(self):
        stop = bool(self.traffic["stop_at_eps"])

        def k1(args, kwargs, sol):
            q, _, data = args[0], args[1], args[2]
            return dict(B=q.shape[-1], cap=q.shape[0] // 3,
                        P=data.Kbar_inv.shape[0],
                        tile=kwargs.get("tile", 128),
                        n_iters=kwargs.get("n_iters", 300),
                        stop_at_eps=kwargs.get("stop_at_eps", stop),
                        iters=sol.iters.tolist(),
                        converged=sol.converged.tolist())
        return [trace.span("mpc", MPC_LANE, "solve_mpc_batch_phase"),
                trace.span("k1", "qrw_tpu_torch.ops.qp_phase", "solve", k1),
                trace.span("rescue", MPC_LANE, "_rescue_failed_lanes")]

    def constants(self) -> dict:
        return {}

    def outcome(self):
        """(solves of the last cycle, those that did not converge)."""
        sol = self.hooks.latest("mpc")[2][2]
        return self.B, int((~sol.converged).sum())

    def release(self):
        """Free the port's state before the reference runs."""
        self.hooks.clear()
        self.state = self.ps = None
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
        """The last cycle's sample against its optimum; with `control`,
        the reference computed at TF32 precision in the port's place."""
        from qrwbench.reference import mpc_qp
        rng = np.random.default_rng([seed, 1])
        a, kw, (x_f, _, sol) = self.hooks.latest("mpc")
        xrefs, fsteps = a[1], a[2]
        cand = torch.nonzero(sol.converged).flatten().cpu().numpy()
        n = min(int(self.traffic["sample_lanes"]), cand.size)
        lanes = set(int(i) for i in rng.choice(cand, size=n, replace=False))
        if self.hooks.calls["rescue"]:
            ra, _, rout = self.hooks.latest("rescue")
            before, after = ra[5].converged, rout[2].converged
            resc = torch.nonzero(after & ~before).flatten().cpu().numpy()
            lanes |= set(int(i) for i in
                         resc[:int(self.traffic["sample_rescued"])])
        lanes = torch.as_tensor(sorted(lanes), device=xrefs.device)
        xr = xrefs[:, :, lanes].permute(2, 0, 1)
        fs = fsteps[:, :, lanes].permute(2, 0, 1)
        if control:
            with tf32_products():
                have = mpc_qp.control_plans(self.ctrl, xr, fs)
        else:
            have = x_f[:, :, lanes].permute(2, 0, 1)
        if release:
            self.release()
        return {"mpc_" + k: v
                for k, v in mpc_qp.judge(self.ctrl, xr, fs, have).items()}
