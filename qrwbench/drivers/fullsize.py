"""The full-size batched MPC: the condensed QP (n = 12N, m = 32N) of B
trot problems through `core/mpc.solve_mpc_batch_pallas`.

Traffic keys: batch, settings (the OSQP settings: eps_abs, eps_rel,
max_iter, adaptive_rho_interval), refactor and schedule (each warm
cycle's K^-1 policy and ADMM rounds), shift_m (the initial state's
shift between cycles), sample_lanes and limits.

Inputs from the seed (bench.py's build_batch): every problem stands at
h_ref with 0.02 N(0, 1) on its initial state, a forward speed drawn
from U(0, 1) m/s over the horizon and a rolling trot stance (offset
b mod N). Set-up solves them cold. Each warm cycle moves the initial
base position by shift_m along x, alternately there and back, carries
the solver state and calls the solver with the cell's refactor policy
and schedule, then synchronizes.

The check judges a sample of the last cycle's converged plans, drawn
from the seed, against each problem's optimum (`reference.mpc_qp`).
"""

from __future__ import annotations

import numpy as np
import torch

from qrwbench import harness, trace
from qrwbench.common import Hook, Wrappers, controller_config, tf32_products

MPC = "qrw_tpu_torch.core.mpc"
QPP = "qrw_tpu_torch.ops.qp_pallas"
H0 = 0.24474949993103629


def build_batch(n_steps, n_gait, batch: int, rng):
    """xrefs (B, 12, N+1), fsteps (B, N_gait, 12), float32."""
    pair1 = np.array([0.195, 0.147, 0., 0., 0., 0.,
                      0., 0., 0., -0.195, -0.147, 0.])
    pair2 = np.array([0., 0., 0., 0.195, -0.147, 0.,
                      -0.195, 0.147, 0., 0., 0., 0.])
    half = n_steps // 2
    xrefs = np.zeros((batch, 12, n_steps + 1), np.float32)
    xrefs[:, 2, :] = H0
    xrefs[:, :, 0] += rng.normal(scale=0.02, size=(batch, 12))
    xrefs[:, 6, 1:] = rng.uniform(0.0, 1.0, size=(batch, 1))
    fsteps = np.zeros((batch, n_gait, 12), np.float32)
    for b in range(batch):
        off = b % n_steps
        for i in range(n_steps):
            fsteps[b, i] = (pair1 if ((i + (half - off)) // half) % 2 == 0
                            else pair2)
    return xrefs, fsteps


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from qrw_tpu_torch.core import mpc as mpc_mod
        from qrw_tpu_torch.ops import qp
        self.mpc = mpc_mod
        self.ctrl = config["controller"]
        self.traffic = traffic
        dev = torch.device(device)
        cfg = controller_config(config)
        self.cfg = cfg
        self.N = cfg.n_steps
        rng = np.random.default_rng(seed)
        xr, fs = build_batch(cfg.n_steps, cfg.N_gait, int(traffic["batch"]),
                             rng)
        self.B = xr.shape[0]
        self.x0 = torch.as_tensor(xr, device=dev)
        self.fs = torch.as_tensor(fs, device=dev)
        st = traffic["settings"]
        self.settings = qp.QPSettings(
            eps_abs=st["eps_abs"], eps_rel=st["eps_rel"],
            max_iter=st["max_iter"],
            adaptive_rho_interval=st["adaptive_rho_interval"])
        self.hooks = Wrappers([Hook("fullsize", MPC, "solve_mpc_batch_pallas")])
        _, self.state, _ = self.mpc.solve_mpc_batch_pallas(
            cfg, self.x0, self.fs, settings=self.settings)
        self.n_cycles = 0

    def _solve(self):
        tr = self.traffic
        xr = self.x0
        if self.n_cycles % 2 == 0:
            xr = self.x0.clone()
            xr[:, 0, 0] += float(tr["shift_m"])
        self.n_cycles += 1
        _, self.state, sol = self.mpc.solve_mpc_batch_pallas(
            self.cfg, xr, self.fs, state=self.state, settings=self.settings,
            refactor=tr["refactor"], schedule=list(tr["schedule"]))
        return sol

    def warm(self):
        self._solve()

    def cycle(self) -> dict:
        sol = self._solve()
        return {"ticks": 0, "solves": self.B,
                "converged": sol.converged.sum()}

    def spans(self):
        def k3(args, kwargs, out):
            K = args[0]
            ns = args[2] if len(args) > 2 else kwargs["ns_iters"]
            return dict(B=K.shape[0], n=K.shape[-1], ns_iters=int(ns))

        def k2(args, kwargs, out):
            Kinv, l = args[0], args[4]
            n_iters = args[11] if len(args) > 11 else kwargs["n_iters"]
            return dict(R=Kinv.shape[0], n=Kinv.shape[-1], m=l.shape[-1],
                        n_iters=int(n_iters),
                        k_ref=kwargs.get("K") is not None)
        return [trace.span("fullsize", MPC, "solve_mpc_batch_pallas"),
                trace.span("qp", QPP, "solve"),
                trace.span("k3", QPP, "_ns_refine", k3),
                trace.span("k2", QPP, "_run_kernel", k2)]

    def constants(self) -> dict:
        return {"n_steps": self.N}

    def outcome(self):
        """(solves of the last cycle, those that did not converge)."""
        sol = self.hooks.latest("fullsize")[2][2]
        return self.B, int((~sol.converged).sum())

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
        """The last cycle's sample against its optimum; with `control`,
        the reference computed at TF32 precision in the port's place."""
        from qrwbench.reference import mpc_qp
        rng = np.random.default_rng([seed, 1])
        a, kw, (x_f, _, sol) = self.hooks.latest("fullsize")
        xrefs, fsteps = a[1], a[2]
        cand = torch.nonzero(sol.converged).flatten().cpu().numpy()
        n = min(int(self.traffic["sample_lanes"]), cand.size)
        lanes = torch.as_tensor(np.sort(rng.choice(cand, size=n,
                                                   replace=False)),
                                device=xrefs.device)
        xr, fs = xrefs[lanes], fsteps[lanes]
        if control:
            with tf32_products():
                have = mpc_qp.control_plans(self.ctrl, xr, fs)
        else:
            have = x_f[lanes]
        if release:
            self.release()
        return {"mpc_" + k: v
                for k, v in mpc_qp.judge(self.ctrl, xr, fs, have).items()}
