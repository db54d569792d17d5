"""The port's package boundary: no JAX, no silent fallbacks.

Importing any qrw_tpu_torch module must import neither jax nor any
module of the JAX package qrw_tpu (the port runs on a machine without
them); its copies of qrw_tpu's configuration and robot model must equal
the originals. Branches the port does not cover yet (CLI modes) and the
envID=1 spheres in the lane-major fleet step (qrw_tpu asserts there
too) raise instead of taking another path, and a fleet or rollout asked
for on CUDA raises on a host without a card instead of continuing on
the CPU."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from qrw_tpu_torch.config import Config
from tests.torch_threads import single_thread

single_thread()

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
        "             if m in ('jax', 'jaxlib', 'qrw_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'qrw_tpu.')))\n"
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


@pytest.mark.parametrize("branch", ["terrain"])
def test_unported_branches_raise(branch):
    # terrain and the stairs course's spheres are ported for the
    # per-robot step; the lane-major fleet step takes no spheres
    from qrw_tpu_torch.ops import rbd_lane
    from qrw_tpu_torch.sim import physics, physics_lane
    from qrw_tpu_torch.sim.terrain import make_terrain
    cfg = CFG.replace(envID=1)
    ss = physics.init_sim_state(cfg, terrain=make_terrain(cfg, device="cpu"))
    assert ss.proj is not None
    ss = physics.SimState(*[None if a is None else a[None]
                            for a in ss[:-1]], proj=ss.proj)
    z = torch.zeros((1, 12))
    with pytest.raises(NotImplementedError):
        physics_lane.step_lane(cfg, rbd_lane.solo12_lane(), ss, z, z, z, z,
                               z)


def test_cli_unported_modes_exit():
    """No mode of the JAX entry point is left unported: the flags that
    exited with 2 and "not yet ported" (--host-loop, --mesh, --clone,
    --gamepad, --realtime, and the fleets with --batch, --bumpy or
    --envID) now run, and, asked for on CUDA on a host without a card,
    raise instead of running on the CPU, as the single-robot mode and
    the evaluation modes do (the fleets through torch's own "Torch not
    compiled with CUDA enabled" assertion)."""
    import contextlib
    import io

    from qrw_tpu_torch.runtime import main
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the check is for CPU hosts")
    for argv in (["--host-loop"], ["--mesh", "--batch", "2"], ["--clone"],
                 ["--gamepad"], ["--realtime"], ["--sweep", "--mesh"],
                 ["--bumpy", "--fleet", "128"],
                 ["--fleet", "128", "--envID", "1"],
                 ["--hetero", "384", "--batch", "2"],
                 ["--ticks", "1"], ["--ticks", "1", "--kf"],
                 ["--fleet-mpc", "64"], ["--sweep", "--ticks", "1"],
                 ["--estimator-demo", "--ticks", "1"]):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            main.main(argv + ["--ticks", "1"])
        assert "not yet ported" not in err.getvalue(), argv


def test_cli_rescue_defaults_to_the_jax_capacity(monkeypatch):
    """--rescue defaults to max(4, B // 32) lanes, as the JAX entry
    point's; an explicit value (0 included) is passed on as given."""
    from qrw_tpu_torch.runtime import main
    assert main.build_argparser().parse_args(["--fleet", "8"]).rescue is None
    seen = []

    class Stop(Exception):
        pass

    def fake_run_fleet(cfg, batch, tile, seed, device, n_cycles, rescue,
                       perfect=False):
        seen.append((batch, rescue))
        raise Stop      # before anything is built or run

    monkeypatch.setattr(main, "run_fleet", fake_run_fleet)
    for argv, want in [(["--fleet", "256"], (256, 8)),
                       (["--fleet", "4096"], (4096, 128)),
                       (["--fleet", "128"], (128, 4)),
                       (["--fleet", "1024", "--rescue", "0"], (1024, 0))]:
        with pytest.raises(Stop):
            main.main(argv)
        assert seen.pop() == want, argv


def test_cli_estimator_config_and_hetero(monkeypatch, tmp_path):
    """--fleet runs the complementary-filter estimator unless --perfect
    is given, as the JAX entry point does; --config reaches load_config;
    --hetero rounds B down to whole 128-robot tiles, at least three (one
    a gait), with the rescue default of max(4, B // 32)."""
    from qrw_tpu_torch.runtime import main
    seen = []

    class Stop(Exception):
        pass

    def fake_run_fleet(cfg, batch, tile, seed, device, n_cycles, rescue,
                       perfect=False):
        seen.append((cfg.velID, cfg.N_SIMULATION, perfect))
        raise Stop

    def fake_run_hetero(cfg, batch, tile, seed, device, n_cycles, rescue):
        seen.append((batch, n_cycles, rescue))
        raise Stop

    monkeypatch.setattr(main, "run_fleet", fake_run_fleet)
    monkeypatch.setattr(main, "run_hetero", fake_run_hetero)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text("robot:\n  velID: 4\n  N_SIMULATION: 50\n")
    cases = [(["--fleet", "128"], (CFG.velID, CFG.N_SIMULATION, False)),
             (["--fleet", "128", "--perfect"],
              (CFG.velID, CFG.N_SIMULATION, True)),
             (["--hetero", "4096", "--ticks", "100"], (4096, 10, 128)),
             (["--hetero", "100"], (384, CFG.N_SIMULATION // 10, 12)),
             (["--hetero", "1000", "--rescue", "3"], (896, 300, 3))]
    from qrw_tpu_torch import config as tcfg
    if tcfg.yaml is not None:
        cases.append((["--fleet", "128", "--config", str(cfg_path)],
                      (4, 50, False)))
    for argv, want in cases:
        with pytest.raises(Stop):
            main.main(argv)
        assert seen.pop() == want, argv


def test_stairs_asset_copy_equals_jax_package():
    """qrw_tpu_torch/sim/bauzil_stairs_hf.npz is a byte-equal copy of
    qrw_tpu/sim/bauzil_stairs_hf.npz."""
    with open(os.path.join(ROOT, "qrw_tpu", "sim",
                           "bauzil_stairs_hf.npz"), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "qrw_tpu_torch", "sim",
                           "bauzil_stairs_hf.npz"), "rb") as f:
        assert f.read() == want


def test_ipc_source_copy_equals_native():
    """qrw_tpu_torch/csrc/qrw_ipc.cpp (runtime/ipc's library source) is
    a byte-equal copy of native/qrw_ipc.cpp."""
    with open(os.path.join(ROOT, "native", "qrw_ipc.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "qrw_tpu_torch", "csrc", "qrw_ipc.cpp"),
              "rb") as f:
        assert f.read() == want


def test_every_jax_module_has_a_counterpart():
    """The module lists of the two packages: every qrw_tpu module has a
    qrw_tpu_torch module at the same path."""
    def modules(pkg):
        root = os.path.join(ROOT, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if f.endswith(".py")}
    assert modules("qrw_tpu") - modules("qrw_tpu_torch") == set()


def test_qp_oracle_copy_equals_tests_oracle():
    """qrw_tpu_torch/eval/qp_oracle.py (parity_320's oracle) is a
    byte-equal copy of tests/qp_oracle.py."""
    with open(os.path.join(ROOT, "tests", "qp_oracle.py"), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "qrw_tpu_torch", "eval",
                           "qp_oracle.py"), "rb") as f:
        assert f.read() == want


def test_kernel_dispatch_has_no_fallback():
    """A tensor on a device other than the CPU never reaches the plain
    version: an unsupported device raises, and the CUDA build needs nvcc
    (on a host without it, asking for the library raises)."""
    from qrw_tpu_torch import kernels
    from qrw_tpu_torch.ops import qp_phase
    from qrw_tpu_torch.ops import qp_pallas
    q = torch.zeros((96, 128), device="meta")
    with pytest.raises(ValueError, match="device"):
        qp_phase.solve(q, q, None, [0])
    P = torch.zeros((2, 96, 96), device="meta")
    with pytest.raises(ValueError, match="device"):
        qp_pallas.solve(P, q[:, :2].T, q[:, :2], q, q)
    with pytest.raises(ValueError, match="device"):
        qp_pallas._ns_refine(P, P, 3)
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            kernels._nvcc()


def test_warm_refactorization_raises():
    """The warm refactorization from kinv_init runs under every policy:
    "ns" (Newton-Schulz, K3's plain version here) and "stale" (the
    guarded seed with K2's refinement variant) agree with "chol" (a
    fresh Cholesky) on a tiny QP and carry the rho of their factor; an
    unknown policy raises."""
    from qrw_tpu_torch.ops import qp_pallas
    P = torch.eye(3).expand(2, 3, 3) * 2.0
    q = torch.ones((2, 3))
    A = torch.eye(3)
    with pytest.raises(ValueError, match="refactor"):
        qp_pallas.solve(P, q, A, q - 2, q + 2, refactor="newton")
    cold = qp_pallas.solve(P, q, A, q - 2, q + 2)
    assert bool(cold.converged.all())
    np.testing.assert_allclose(cold.x.numpy(), -0.5, atol=1e-3)
    warm = {}
    for refactor in ("ns", "stale", "chol"):
        warm[refactor] = qp_pallas.solve(
            P, q * 1.01, A, q - 2, q + 2, x0=cold.x, y0=cold.y,
            rho_init=cold.rho, precond=cold.precond, kinv_init=cold.kinv,
            kinv_rho=cold.kinv_rho, schedule=[50], refactor=refactor)
        assert bool(warm[refactor].converged.all()), refactor
        np.testing.assert_array_equal(warm[refactor].kinv_rho.numpy(),
                                      cold.rho.numpy())
    for refactor in ("ns", "stale"):
        np.testing.assert_allclose(warm[refactor].x.numpy(),
                                   warm["chol"].x.numpy(), atol=1e-6)
        np.testing.assert_allclose(warm[refactor].kinv.numpy(),
                                   warm["chol"].kinv.numpy(), atol=1e-5)
    np.testing.assert_allclose(warm["chol"].x.numpy(), -0.505, atol=1e-3)


def test_config_copy_equals_jax_package():
    """qrw_tpu_torch.config is a copy of qrw_tpu.config: the same
    fields, defaults, derived values, replace() and load_config."""
    from qrw_tpu import config as jcfg
    from qrw_tpu_torch import config as tcfg
    jf = dataclasses.fields(jcfg.Config)
    tf = dataclasses.fields(tcfg.Config)
    assert [(f.name, f.type, f.default) for f in tf] == \
        [(f.name, f.type, f.default) for f in jf]
    j, t = jcfg.Config(), tcfg.Config()
    for prop in ("k_mpc", "n_steps", "q_init"):
        assert getattr(t, prop) == getattr(j, prop), prop
    kw = dict(velID=5, T_mpc=0.24, mu=0.7, N_SIMULATION=40)
    assert dataclasses.asdict(t.replace(**kw)) == \
        dataclasses.asdict(j.replace(**kw))
    assert dataclasses.asdict(tcfg.load_config(None, velID=3)) == \
        dataclasses.asdict(jcfg.load_config(None, velID=3))
    assert (tcfg.yaml is None) == (jcfg.yaml is None)


def test_solo12_copy_equals_jax_package():
    """qrw_tpu_torch.models.solo12 is a copy of qrw_tpu.models.solo12:
    every array of make_solo12() and H_INIT are equal."""
    from qrw_tpu.models import solo12 as jsolo
    from qrw_tpu_torch.models import solo12 as tsolo
    j, t = jsolo.make_solo12(), tsolo.make_solo12()
    assert t._fields == j._fields
    for name, a, b in zip(j._fields, t, j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    assert tsolo.H_INIT == jsolo.H_INIT
    for name in ("TOTAL_MASS", "GI", "COM_OFFSET", "Q_INIT", "NUM_BODIES",
                 "NUM_JOINTS", "NUM_FEET"):
        np.testing.assert_array_equal(getattr(tsolo, name),
                                      getattr(jsolo, name), err_msg=name)
