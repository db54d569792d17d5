"""The port's evaluation tools against qrw_tpu's: the estimator study
(eval/estimator_eval), the npz logs and figures (utils/logger), the
offline CLI (eval/analyze), the velocity-envelope sweep
(eval/speed_sweep) and the CLI's --fleet-mpc, --sweep, --estimator-demo,
--kf, --save and --plot.

Inputs: the same closed loop in both packages (qrw_tpu's initial carry,
converted), or the same numpy seeds.

Tolerances:
  * the estimator demo (run_demo, --kf, standing still, float64, 60
    ticks) and score(): every metric to 1e-8 (the float64 closed loops
    agree to 1e-9 of scale, tests/test_torch_rollout.py); score and the
    offline studies (fk_per_foot_velocity, windowed_drift,
    velocity_error_fft) on one dict of logs: 1e-10;
  * npz logs written by one package load in the other with the same keys
    and bit-equal arrays;
  * run_sweep on a 2 x 2 grid over 60 ticks, float32: success equal,
    vx_err 1e-3 m/s (base velocities agree to 1e-3 of scale in float32,
    tests/test_torch_rollout.py), h_err 1e-5 m (positions to 1e-5);
  * --fleet-mpc at the CPU tile of 4 (B = 64, 2 warm cycles): the batch
    solved equal and the warm conv within one lane (1/64) of qrw_tpu's
    (its Pallas kernel in interpret mode against the port's plain
    version, float32 both; a lane whose residual sits at the tolerance
    may pass one check apart).
"""

import io
import os
from contextlib import redirect_stdout
from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qrw_tpu.config import Config  # noqa: E402
from qrw_tpu.eval import estimator_eval as jee  # noqa: E402
from qrw_tpu.eval import speed_sweep as jsw  # noqa: E402
from qrw_tpu.sim import rollout as jro  # noqa: E402
from qrw_tpu.utils import logger as jlog  # noqa: E402
from qrw_tpu_torch import convert  # noqa: E402
from qrw_tpu_torch.eval import analyze as tan  # noqa: E402
from qrw_tpu_torch.eval import estimator_eval as tee  # noqa: E402
from qrw_tpu_torch.eval import speed_sweep as tsw  # noqa: E402
from qrw_tpu_torch.runtime import main as tmain  # noqa: E402
from qrw_tpu_torch.sim import rollout as tro  # noqa: E402
from qrw_tpu_torch.utils import logger as tlog  # noqa: E402
from tests.torch_threads import single_thread  # noqa: E402

single_thread()

CFG = Config()
CFG_KF = CFG.replace(kf_enabled=True)
T = 60


@pytest.fixture(scope="module")
def demo():
    """The estimator demo's loop (--kf, zero command, float64, T ticks)
    in both packages from qrw_tpu's carry: (port logs, qrw_tpu logs)."""
    jctl, jc = jro.make_rollout(CFG_KF, dtype=jnp.float64)
    _, jlogs = jax.jit(lambda c: jro.rollout(
        jctl, c, T, v_ref_schedule=jnp.zeros((T, 6), jnp.float64)))(jc)
    tctl, _ = tro.make_rollout(CFG_KF, device="cpu")
    _, tlogs = tro.rollout(tctl, convert.to_torch(jax.tree.map(np.asarray,
                                                               jc)),
                           T, v_ref_schedule=torch.zeros((T, 6),
                                                         dtype=torch.float64))
    return tlogs, jax.tree.map(np.asarray, jlogs)


def test_score_parity(demo):
    """score() of each package's own loop, and of one dict of logs."""
    tlogs, jlogs = demo
    w = jee.score(jlogs, CFG)
    g = tee.score(tlogs, CFG)
    assert list(g) == list(w)
    for k in w:
        assert g[k] == pytest.approx(w[k], abs=1e-8), k
    g2 = tee.score(jlog.log_to_dict(jlogs), CFG)
    for k in w:
        assert g2[k] == pytest.approx(w[k], abs=1e-10), k


def test_run_demo_parity():
    """run_demo(kf=True) in float64 (both defaults) on the CPU."""
    w = jee.run_demo(CFG, n_ticks=T, kf=True)
    g = tee.run_demo(CFG, n_ticks=T, kf=True, device="cpu")
    assert list(g) == list(w)
    for k in w:
        assert g[k] == pytest.approx(w[k], abs=1e-8), k


@pytest.mark.parametrize("fn", ["fk_per_foot_velocity", "windowed_drift",
                                "velocity_error_fft"])
def test_offline_studies_parity(demo, fn):
    _, jlogs = demo
    d = jlog.log_to_dict(jlogs, CFG)
    w = getattr(jee, fn)(d, CFG)
    g = getattr(tee, fn)(d, CFG)
    for a, b in zip(g if isinstance(g, tuple) else (g,),
                    w if isinstance(w, tuple) else (w,)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_npz_round_trip_across_packages(demo, tmp_path):
    """A file saved by qrw_tpu loads in the port, and one saved by the
    port loads in qrw_tpu, with the same keys and arrays."""
    tlogs, jlogs = demo
    jp = jlog.save_npz(jlogs, str(tmp_path / "jax.npz"), CFG)
    tp = tlog.save_npz(tlogs, str(tmp_path / "port.npz"), CFG)
    from_j = tlog.load_npz(jp)
    from_t = jlog.load_npz(tp)
    assert sorted(from_j) == sorted(from_t) == sorted(
        list(tro.RolloutLog._fields) + ["_dt_wbc", "_dt_mpc"])
    for k, v in jlog.load_npz(jp).items():
        np.testing.assert_array_equal(from_j[k], v, err_msg=k)
    for k, v in tlog.log_to_dict(tlogs, CFG).items():
        np.testing.assert_array_equal(from_t[k], v, err_msg=k)
        assert from_t[k].dtype == from_j[k].dtype, k


def test_plot_all_13_figures(demo, tmp_path):
    import matplotlib.pyplot as plt
    tlogs, _ = demo
    figs = tlog.plot_all(tlog.log_to_dict(tlogs, CFG), dt=CFG.dt_wbc,
                         show=False, save_prefix=str(tmp_path / "run"))
    assert len(figs) == 13
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"run_fig{i}.png" for i in range(13))
    for f in figs:
        plt.close(f)


def test_analyze_saved_file(demo, tmp_path, capsys):
    """eval/analyze on a file qrw_tpu wrote: the estimator metrics and
    figures, the per-foot odometry and tracking figures; --slider and
    --forces (utils/viz, on the CPU with --cpu) exit 0."""
    import matplotlib.pyplot as plt
    _, jlogs = demo
    path = jlog.save_npz(jlogs, str(tmp_path / "run.npz"), CFG)
    pre = str(tmp_path / "an")
    assert tan.main([path, "--estimator", "--plot", pre, "--fk-feet",
                     "--tracking", path]) == 0
    out = capsys.readouterr().out
    assert "estimator metrics:" in out and f"{T} ticks" in out
    for suffix in ("_estimator.png", "_estimator_bis.png", "_fk_feet.png",
                   "_tracking.png"):
        assert os.path.exists(pre + suffix), suffix
    assert tan.main([path, "--plot", pre]) == 0
    assert os.path.exists(pre + "_fig12.png")
    for flag in (["--slider"], ["--forces", "3", "--plot", pre]):
        assert tan.main([path, "--cpu"] + flag) == 0, flag
    assert os.path.exists(pre + "_forces.png")
    plt.close("all")


def test_run_sweep_parity():
    grid = dict(vx_grid=np.array([0.0, 0.3]), wyaw_grid=np.array([0.0, 0.5]),
                n_ticks=T, ramp_ticks=20)
    w = jsw.run_sweep(CFG, **grid)
    g = tsw.run_sweep(CFG, device="cpu", **grid)
    np.testing.assert_array_equal(g.vx, w.vx)
    np.testing.assert_array_equal(g.wyaw, w.wyaw)
    np.testing.assert_array_equal(g.success, w.success)
    assert g.success.all()
    np.testing.assert_allclose(g.vx_err, w.vx_err, rtol=0, atol=1e-3)
    np.testing.assert_allclose(g.h_err, w.h_err, rtol=0, atol=1e-5)
    import matplotlib.pyplot as plt
    plt.close(tsw.plot_envelope(g, show=False))


def test_fleet_mpc_parity():
    """--fleet-mpc 64 at the CPU tile of 4: qrw_tpu's entry function
    (its Pallas kernel in interpret mode) against the port's."""
    from qrw_tpu.runtime import main as jmain
    buf = io.StringIO()
    with redirect_stdout(buf):
        jmain._run_fleet_mpc(SimpleNamespace(fleet_mpc=64, seed=0,
                                             fleet_cycles=2), CFG)
    line = buf.getvalue()
    w_B = int(line.split("service: ")[1].split(" ")[0])
    w_conv = float(line.split("conv ")[1].split(" ")[0])
    r = tmain.run_fleet_mpc(CFG, 64, 0, "cpu", n_cycles=2)
    assert r["tile"] == tmain.CPU_TILE == 4
    assert r["B"] == w_B == 64
    assert abs(r["conv"] - w_conv) <= 1.0 / 64 + 1e-9
    assert r["cold_conv"] >= 0.9 and r["solves_s"] > 0


def test_cli_kf_save_plot(tmp_path, capsys):
    """The single-robot mode with --kf writes a log the JAX package
    loads and the 13 figures; its estimator is the Kalman filter."""
    import matplotlib.pyplot as plt
    path = str(tmp_path / "kf.npz")
    pre = str(tmp_path / "kf")
    assert tmain.main(["--cpu", "--ticks", "20", "--kf", "--save", path,
                       "--plot", pre]) == 0
    d = jlog.load_npz(path)
    assert d["base_pos"].shape == (20, 3)
    assert np.isfinite(d["q_est"]).all()
    # the complementary filters' parts stay at their initial values
    np.testing.assert_array_equal(d["est_hp_vel"], 0.0)
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".png")]) == 13
    plt.close("all")


@pytest.mark.parametrize("argv,want", [
    (["--sweep", "--ticks", "10"], "sweep: 45/45 cells succeeded"),
    (["--estimator-demo", "--kf", "--ticks", "10"], "estimator metrics:"),
    (["--fleet-mpc", "64", "--fleet-cycles", "1"],
     "fleet MPC service: 64 scenarios/cycle (tile 4, on cpu)")])
def test_cli_eval_modes(argv, want, capsys):
    assert tmain.main(["--cpu"] + argv) == 0
    assert want in capsys.readouterr().out


def test_cli_sweep_plot(tmp_path):
    import matplotlib.pyplot as plt
    pre = str(tmp_path / "sw")
    assert tmain.main(["--cpu", "--sweep", "--ticks", "4", "--plot",
                       pre]) == 0
    assert os.path.exists(pre + "_envelope.png")
    plt.close("all")
