"""The benchmark's float64 DDP reference (qrwbench/reference/ddp_mpc.py)
against the port's DDP MPC (core/mpc_ddp.solve_mpc_ddp), CPU, B = 8.

The problems are the DDP cell's own population (`qrwbench/drivers/
phase_mpc.phase_batch`: eight trot phases, one problem each, seed 3),
solved in float64 from a zero warm start ("cold") and, after a gait
roll, from the carried solution ("warm"). The reference is written from
MPC_crocoddyl's description and imports nothing of the port, so where
the two compute the same float64 operations their results agree to
rounding; the DDP's accept test can still flip on a last-bit difference
in one problem's iteration, so its costs are held on 7 of 8 problems.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core import mpc_ddp
from qrwbench.drivers.phase_mpc import phase_batch
from qrwbench.reference import ddp_mpc
from tests.torch_threads import single_thread

single_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "qrwbench", "configs",
                       "solo12-trot-ddp.json")) as f:
    CTRL = json.load(f)["controller"]
CFG = Config(type_MPC=False)
B = 8


@pytest.fixture(scope="module")
def solves():
    """{"cold"|"warm": (xref, fsteps, warm start carried in, result)}."""
    N = CFG.n_steps
    xr, _, phase_fs = phase_batch(N, CFG.N_gait, list(range(B)), 1,
                                  np.random.default_rng(3))
    x0 = torch.as_tensor(xr, dtype=torch.float64).permute(2, 0, 1)
    pfs = torch.as_tensor(phase_fs, dtype=torch.float64)
    ph = torch.arange(B)
    out = {}
    fs = pfs[ph]
    prev = mpc_ddp.init_ddp_state(CFG, torch.float64).us.expand(B, N, 12)
    res = mpc_ddp.solve_mpc_ddp(CFG, x0, fs)
    out["cold"] = (x0, fs, prev, res)
    ph = (ph - 1) % N
    x1 = x0.clone()
    x1[:, :, 0] += 0.002 * torch.randn((B, 12), dtype=torch.float64,
                                       generator=torch.Generator()
                                       .manual_seed(5))
    fs = pfs[ph]
    out["warm"] = (x1, fs, res.state.us,
                   mpc_ddp.solve_mpc_ddp(CFG, x1, fs, res.state))
    return out


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_cost_and_rollout_equal_the_port(solves, start):
    """The reference's cost of the port's (xs, us) is the port's cost, and
    the reference's rollout of the port's us is the port's xs: the same
    float64 operations up to the order of a few sums, so to 1e-12 (cost,
    relative; its terms are O(1)) and 1e-12 (states, absolute, O(1))."""
    xr, fs, _, res = solves[start]
    pb = ddp_mpc.problem(CTRL, xr, fs)
    J = ddp_mpc.total_cost(pb, res.state.xs, res.state.us)
    assert torch.allclose(J, res.cost, rtol=1e-12, atol=0)
    xs = ddp_mpc.rollout(pb, res.state.us)
    assert (xs - res.state.xs).abs().max() <= 1e-12


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_reference_ddp_reaches_the_port_cost(solves, start):
    """The float64 DDP from the same warm start ends at the port's cost
    (relative 1e-9: ten iterations of the same steps, rounding apart) on
    at least 7 of the 8 problems, and every problem accepted a step."""
    xr, fs, prev, res = solves[start]
    sol = ddp_mpc.solve(CTRL, xr, fs, prev)
    rel = ((sol.cost - res.cost).abs() / sol.cost.abs())
    assert int((rel <= 1e-9).sum()) >= 7, rel
    assert bool((sol.accepted >= 1).all())
    gaps = ddp_mpc.judge(CTRL, xr, fs, prev, res.state.xs, res.state.us,
                         res.cost)
    assert gaps["rollout_gap"] <= 1e-12 and gaps["cost_gap"] <= 1e-12
    assert gaps["progress_gap_p50"] <= 1e-9


def test_the_reference_loads_nothing_of_the_port():
    code = ("import json, sys\n"
            "import qrwbench.reference.ddp_mpc\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "    if m.split('.')[0] in ('qrw_tpu_torch', 'qrw_tpu', 'jax',\n"
            "                           'jaxlib', 'flax'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
