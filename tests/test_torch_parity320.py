"""The port's eval/parity_320 against qrw_tpu's, function by function.

One closed-loop capture of 32 MPC cycles (the trot at velID 2, float64,
the real estimator) is made by each package at module scope; the port's
(on the CPU) is held to qrw_tpu's, and qrw_tpu's cycles then feed both
packages' solvers, so every comparison below starts from the same QPs.

Tolerances (of each quantity's scale, max(1, max |reference|)):
  * the capture, float64: 1e-9 (xrefs, fsteps, joint angles);
  * solve_oracle: the same float64 interior-point code on QPs built by
    each package: 1e-7 N;
  * solve_xla64_seq (per-problem ADMM at eps 1e-6, float64, warm): 1e-8;
  * the phase solves (float32): the port's solve_plain through the
    tile grouping (tiles of 32 lanes of one phase, filled with copies)
    against qrw_tpu's plain path solve_ref (one problem a "tile"):
    converged flags equal, forces 1e-3 of scale (tests/
    test_torch_fleet.py's bar for the same solver);
  * solve_pallas_seq (float32, relaxed eps 1e-4) on 4 cycles: K2's and
    K3's plain versions against qrw_tpu's Pallas kernels in interpret
    mode: flags equal, forces 1e-3 of scale;
  * torque_error (float64): 1e-10.
Also: a lane returns the same alone and in a padded tile (stop_at_eps
off); parity_320.main's JSON keys are qrw_tpu's. (K1 at cap 64, the
`--switch static` phase set, is in tests/test_torch_cap64.py.)
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import mpc_lane as jml
from qrw_tpu.eval import parity_320 as jpar
from qrw_tpu_torch.core import mpc_lane as tml
from qrw_tpu_torch.eval import parity_320 as tpar
from tests.torch_threads import single_thread

single_thread()

CFG = Config(velID=2)
C = 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tol(w, rel):
    return rel * max(1.0, float(np.abs(w).max()))


@pytest.fixture(scope="module")
def cap():
    """(qrw_tpu's capture, the port's capture), each (xrefs, fsteps,
    q_mes)."""
    return (jpar.capture(CFG, C),
            tpar.capture(CFG, C, device="cpu"))


@pytest.fixture(scope="module")
def phase_fs(cap):
    """Each package's calibrated trot phase set from qrw_tpu's capture."""
    (xr, fs, _), _ = cap
    j = jml.calibrate_phase_fsteps(CFG, jpar.build_phase_set(CFG, "trot"),
                                   fs)
    t = tml.calibrate_phase_fsteps(CFG, tpar.build_phase_set(CFG, "trot"),
                                   fs)
    return j, t


@pytest.mark.parametrize("i,name", [(0, "xrefs"), (1, "fsteps"),
                                    (2, "q_mes")])
def test_capture_parity(cap, i, name):
    (j, t) = cap
    w, g = j[i], t[i]
    assert g.shape == w.shape and g.dtype == np.float64, name
    np.testing.assert_allclose(g, w, rtol=0, atol=_tol(w, 1e-9),
                               err_msg=name)


def test_phase_sets_equal(cap, phase_fs):
    """build_phase_set and its calibration on the capture agree, and
    every captured cycle of the trot matches one class."""
    j, t = phase_fs
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        tpar.build_phase_set(CFG, "trot", "static"),
        jpar.build_phase_set(CFG, "trot", "static"))


def test_solve_oracle_parity(cap):
    (xr, fs, _), _ = cap
    w = jpar.solve_oracle(CFG, xr[:8], fs[:8])
    g = tpar.solve_oracle(CFG, xr[:8], fs[:8])
    np.testing.assert_allclose(g, w, rtol=0, atol=_tol(w, 1e-7))


def test_solve_xla64_seq_parity(cap):
    (xr, fs, _), _ = cap
    w = jpar.solve_xla64_seq(CFG, xr, fs)
    g = tpar.solve_xla64_seq(CFG, xr, fs, device="cpu")
    np.testing.assert_allclose(g, w, rtol=0, atol=_tol(w, 1e-8))


@pytest.mark.parametrize("kind", ["cold", "warm_streams"])
def test_phase_solve_parity(cap, phase_fs, kind):
    """The port's phase solves (solve_plain through the tile grouping)
    against qrw_tpu's (solve_ref, one problem a tile), on every cycle;
    the warm streams carry each stream's state through two rounds."""
    (xr, fs, _), _ = cap
    jfs, tfs = phase_fs
    fn = {"cold": "solve_phase_cold",
          "warm_streams": "solve_phase_warm_streams"}[kind]
    wf, wc, wm = getattr(jpar, fn)(CFG, xr, fs, jfs)
    gf, gc, gm = getattr(tpar, fn)(CFG, xr, fs, tfs, device="cpu")
    np.testing.assert_array_equal(gm, wm)
    assert wm.all(), "every trot cycle matches a class"
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gf, wf, rtol=0, atol=_tol(wf, 1e-3))


def test_solve_pallas_seq_parity(cap):
    """The relaxed chain on 4 cycles: cold, then 3 warm "ns" calls."""
    (xr, fs, _), _ = cap
    wf, wc = jpar.solve_pallas_seq(CFG, xr[:4], fs[:4], interpret=True)
    gf, gc = tpar.solve_pallas_seq(CFG, xr[:4], fs[:4], device="cpu")
    np.testing.assert_array_equal(gc, wc)
    assert wc.all()
    np.testing.assert_allclose(gf, wf, rtol=0, atol=_tol(wf, 1e-3))


def test_torque_error_parity(cap):
    (_, _, q), _ = cap
    df = np.random.default_rng(0).normal(size=(C, 12))
    w = jpar.torque_error(CFG, q, df)
    g = tpar.torque_error(CFG, q, df)
    np.testing.assert_allclose(g, w, rtol=0, atol=_tol(w, 1e-10))


def test_group_by_phase():
    """Each phase's problems fill whole tiles, the last one padded with
    copies of the same phase's problems; `first` returns every problem
    once."""
    phases = np.array([3, 1, 3, 3, 0, 1, 3])
    g = tpar.group_by_phase(phases, 2)
    assert g.src.size == 2 * g.phases_of.size
    np.testing.assert_array_equal(g.phases_of, [0, 1, 3, 3])
    np.testing.assert_array_equal(
        phases[g.src], np.repeat(g.phases_of, 2))
    np.testing.assert_array_equal(g.src[g.first], np.arange(phases.size))
    np.testing.assert_array_equal(g.src, [4, 4, 1, 5, 0, 2, 3, 6])


def test_lane_alone_equals_lane_in_padded_tile(cap, phase_fs):
    """With stop_at_eps off a lane's result does not depend on its
    tile-mates: one cycle solved alone (a tile of its own copies) and
    among 31 other problems of its phase return the same forces, duals
    and flag, bit for bit."""
    (xr, fs, _), _ = cap
    ps = tml.build_phase_data(CFG, phase_fs[1], device="cpu")
    phases = tpar.match_phases(CFG, ps, fs)
    i = 20
    same = np.where(phases == phases[i])[0]
    alone, ca = tpar.solve_phase_grouped(CFG, ps, xr[[i]], fs[[i]],
                                         phases[[i]], device="cpu")
    # 32 lanes of phase p: the cycles of that phase, perturbed copies
    idx = np.resize(same, 32)
    xr2 = xr[idx].copy()
    xr2[1:, :, 0] += np.random.default_rng(1).normal(
        scale=0.01, size=(31, 12))
    k = int(np.where(idx == i)[0][0])
    xr2[k] = xr[i]
    many, cm = tpar.solve_phase_grouped(CFG, ps, xr2, fs[idx], phases[idx],
                                        device="cpu")
    assert torch.equal(many.f[..., k], alone.f[..., 0])
    assert torch.equal(many.y[..., k], alone.y[..., 0])
    assert bool(cm[k]) == bool(ca[0])


def _jax_json_keys():
    """The keys of the JSON dict qrw_tpu's parity_320.main prints."""
    src = open(os.path.join(ROOT, "qrw_tpu", "eval",
                            "parity_320.py")).read()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "out"
                and isinstance(node.value, ast.Dict)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no out = {...} in qrw_tpu's parity_320")


def test_main_json_keys(capsys):
    """parity_320.main(["--cpu", ...]) prints one JSON dict with
    qrw_tpu's keys, the nested statistics included, and the trot's
    every cycle matched and converged."""
    import json
    out = tpar.main(["--cpu", "--cycles", "16"])
    assert list(out) == _jax_json_keys()
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    for k in ("relaxed", "f64_eps1e-6"):
        assert set(out[k]) == {"force_err_max_first_step_N",
                               "force_err_mean_first_step_N",
                               "force_err_max_horizon_N",
                               "force_err_rms_horizon_N"}
    assert out["phase_match_rate"] == 1.0
    assert out["relaxed_conv_rate"] == 1.0
    assert out["torque_err_max_Nm_relaxed"] < out["torque_budget_Nm"]
