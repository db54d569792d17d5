"""The port's package boundary: no JAX, no silent fallbacks.

Importing any qrw_tpu_torch module must not import jax (the port runs on
a machine without it). Branches the port does not cover yet (rescue
stage, Kalman estimator, terrain, DDP MPC, other CLI modes) raise
instead of taking another path, and a fleet asked for on CUDA raises on
a host without a card instead of continuing on the CPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from qrw_tpu.config import Config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = Config()


def test_no_module_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import qrw_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    qrw_tpu_torch.__path__, 'qrw_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from qrw_tpu_torch import convert\n"
        "convert._registry()\n"
        "assert len(mods) >= 25, mods\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m.startswith('qrw_tpu.')\n"
        "             and not m.startswith(('qrw_tpu.config',\n"
        "                                   'qrw_tpu.models')))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_make_fleet_cuda_raises_without_card():
    from qrw_tpu_torch.sim import fleet
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the check is for CPU hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.make_fleet(CFG, 128, None, device="cuda")


def test_rescue_stage_raises():
    from qrw_tpu_torch.core import mpc_lane as ml
    from qrw_tpu_torch.sim import fleet
    x = torch.zeros((12, CFG.n_steps + 1, 4))
    f = torch.zeros((CFG.N_gait, 12, 4))
    with pytest.raises(NotImplementedError):
        ml.solve_mpc_batch_phase(CFG, x, f, None, [0, 0], tile=2,
                                 rescue_cap=2)
    with pytest.raises(NotImplementedError):
        fleet.fleet_rollout(fleet.make_controller(CFG), None, 1, None,
                            rescue_cap=2)


@pytest.mark.parametrize("branch", ["kalman", "ddp", "terrain", "wbc"])
def test_unported_branches_raise(branch):
    from qrw_tpu_torch.core import controller as tc
    from qrw_tpu_torch.sim import physics
    ctl = tc.make_controller(CFG)
    with pytest.raises(NotImplementedError):
        if branch == "kalman":
            cfg = CFG.replace(kf_enabled=True)
            cs = tc.init_state(tc.make_controller(cfg))
            from qrw_tpu_torch.sim.fleet import _device_from_sim
            dev = _device_from_sim(physics.init_sim_state(cfg))
            tc.compute_pre(tc.make_controller(cfg), cs, dev, 0)
        elif branch == "ddp":
            tc.init_state(tc.make_controller(CFG.replace(type_MPC=False)))
        elif branch == "terrain":
            physics.init_sim_state(CFG, terrain=object())
        else:
            tc.compute_post(ctl, None, None, 0, None, None, None, None)


def test_cli_unported_modes_exit():
    from qrw_tpu_torch.runtime import main
    assert main.main(["--hetero", "8"]) == 2
    assert main.main([]) == 2
    assert main.main(["--fleet", "8", "--rescue", "2"]) == 2


def test_kernel_dispatch_has_no_fallback():
    """A tensor on a device other than the CPU never reaches the plain
    version: an unsupported device raises, and the CUDA build needs nvcc
    (on a host without it, asking for the library raises)."""
    from qrw_tpu_torch import kernels
    from qrw_tpu_torch.ops import qp_phase
    q = torch.zeros((96, 128), device="meta")
    with pytest.raises(ValueError, match="device"):
        qp_phase.solve(q, q, None, [0])
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            kernels._nvcc()
