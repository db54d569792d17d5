"""The port's utilities against qrw_tpu's: checkpoint / resume, the
profiling harness, the run visualizations and analyze's --slider and
--forces, and the per-process mesh.

Tolerances:
  * checkpoint: a resume in the port is bit-equal to the run without
    the checkpoint; a checkpoint written by qrw_tpu resumes to qrw_tpu's
    resumed carry at the rollout parity bar of
    tests/test_torch_rollout.py, 1e-9 of each leaf's scale (float64);
  * viz.mpc_predictions: qrw_tpu's, float64, at the MPC bar of
    tests/test_torch_controller.py, 1e-8 of scale;
  * the mesh: two gloo processes on the CPU run the rollout, the sweep
    and the metrics sharded, against the unsharded run in float64. The
    per-robot program is the same, but not bit for bit: torch's CPU
    kernels round some batched operations differently at B = 2 and
    B = 4 (one tick: 4.4e-16 on q; 20 ticks: up to 3.4e-13 on v, 2.6e-13
    on tau_ff, 1.7e-14 on the sweep's vx error). Floating leaves are held
    to 1e-11 of their scale, flags and counts equal.
One pair of gloo processes is spawned (tests/torch_children.mesh_rank),
and the world-size-1 mesh (no torchrun) is made and destroyed in this
process."""

import matplotlib

matplotlib.use("Agg")

import multiprocessing as mp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.sim import rollout as jro
from qrw_tpu.utils import checkpoint as jck
from qrw_tpu.utils import viz as jviz
from qrw_tpu_torch import convert
from qrw_tpu_torch.parallel import mesh as tmesh
from qrw_tpu_torch.sim import rollout as tro
from qrw_tpu_torch.utils import checkpoint as tck
from qrw_tpu_torch.utils import logger as tlog
from qrw_tpu_torch.utils import viz as tviz
from tests import torch_children
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
F64 = torch.float64
HALF = 20           # ticks before and after the checkpoint


def _scale_tol(w, rel):
    return rel * max(1.0, float(np.abs(w).max()))


# ----------------------------------------------------------------------
# Checkpoint
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_mid():
    """The port's float64 rollout cut at tick HALF: (ctl, initial carry,
    carry at HALF)."""
    ctl, carry = tro.make_rollout(CFG, dtype=F64, device="cpu")
    mid, _ = tro.rollout(ctl, carry, HALF)
    return ctl, carry, mid


def test_checkpoint_resume_bit_exact(port_mid, tmp_path):
    """20 ticks, a checkpoint round trip, 20 more ticks: bit-equal to the
    same 40 ticks without the round trip. As in qrw_tpu's test
    (tests/test_aux.py:11-33), "uninterrupted" is the two 20-tick calls
    from the carry in memory: each rollout call synthesizes its first
    measurement from the carry (base_lin_acc 0) in both packages, so one
    40-tick call differs from two 20-tick calls (by 1.9e-4 here)."""
    ctl, _, mid = port_mid
    full, _ = tro.rollout(ctl, mid, HALF, k0=HALF)
    path = tck.save_state(str(tmp_path / "ck.npz"), mid)
    loaded = tck.load_state(path, mid)
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_numpy(mid)),
                    jax.tree_util.tree_leaves(convert.to_numpy(loaded))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    resumed, _ = tro.rollout(ctl, loaded, HALF, k0=HALF)
    got = jax.tree_util.tree_leaves(convert.to_numpy(resumed))
    want = jax.tree_util.tree_leaves(convert.to_numpy(full))
    assert len(got) == len(want) == 54
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_written_by_the_jax_package(port_mid, tmp_path):
    """qrw_tpu's save_state of a float64 RolloutCarry (the port's tick-20
    carry in qrw_tpu's classes: both packages' carries have the same 54
    leaf paths, so no conversion of structure is needed) loads into the
    port's carry bit for bit, as float32 it takes the template's dtype,
    and resumes to qrw_tpu's resumed carry."""
    ctl, _, mid = port_mid
    jctl, jc0 = jro.make_rollout(CFG, dtype=jnp.float64)
    jmid = jax.tree.map(jnp.asarray, convert.to_numpy(mid, like=jc0))
    path = jck.save_state(str(tmp_path / "jax.npz"), jmid)

    loaded = tck.load_state(path, mid)
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_numpy(mid)),
                    jax.tree_util.tree_leaves(convert.to_numpy(loaded))):
        np.testing.assert_array_equal(a, b)
    f32 = tck.load_state(path, convert.tree_map(
        lambda a: a.float() if a.is_floating_point() else a, mid))
    assert f32.sim_state.q.dtype == torch.float32
    assert f32.ctl_state.error_code.dtype == torch.int32

    v = np.zeros((HALF, 6))
    run = jax.jit(lambda c, k0, vs: jro.rollout(jctl, c, HALF, k0=k0,
                                                v_ref_schedule=vs))
    jend, _ = run(jck.load_state(path, jc0), HALF, jnp.asarray(v))
    tend, _ = tro.rollout(ctl, loaded, HALF, k0=HALF, v_ref_schedule=v)
    got = convert.to_numpy(tend, like=jend)
    for (p, w), g in zip(jax.tree_util.tree_leaves_with_path(jend),
                         jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=_scale_tol(w, 1e-9),
                                   err_msg=jax.tree_util.keystr(p))


# ----------------------------------------------------------------------
# Profiling
# ----------------------------------------------------------------------

def test_stage_timings():
    from qrw_tpu_torch.utils.profiling import stage_timings
    t = stage_timings(reps=2, device="cpu")
    assert set(t) == {"t_filter", "t_gait", "t_mpc", "t_wbc", "t_sim",
                      "t_loop"}
    assert all(v > 0 for v in t.values()), t


def test_trace_writes_a_file(tmp_path):
    """One small CPU fleet cycle traced: the written trace holds the
    port's layer spans as CPU ranges."""
    import json
    from qrw_tpu_torch.config import Config as TConfig
    from qrw_tpu_torch.core import mpc_lane as tml
    from qrw_tpu_torch.sim import fleet as tfl
    from qrw_tpu_torch.utils.profiling import reset, trace
    cfg = TConfig()
    ps = tml.build_phase_data(cfg, tml.trot_phase_fsteps(cfg), device="cpu")
    ctl, carry = tfl.make_fleet(cfg, 2, ps, tile=1, device="cpu")
    with trace(str(tmp_path)) as d:
        tfl.fleet_rollout(ctl, carry, 1, ps, tile=1, with_logs=False)
    reset()
    assert d == str(tmp_path)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"span:qrw.pre", "span:qrw.mpc.phase", "span:qrw.mpc.k1",
            "span:qrw.wbc", "span:qrw.wbc.qp", "span:qrw.post",
            "span:qrw.physics", "span:qrw.sync.wbc_qp_done"} <= names


# ----------------------------------------------------------------------
# Visualization and analyze --slider / --forces
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_logs(tmp_path_factory):
    """A 40-tick float64 rollout of the port (4 MPC cycles), as the dict
    load_npz gives, and its npz."""
    ctl, carry = tro.make_rollout(CFG, dtype=F64, device="cpu")
    _, logs = tro.rollout(ctl, carry, 40)
    path = tlog.save_npz(logs, str(tmp_path_factory.mktemp("viz")
                                   / "run.npz"), CFG)
    return tlog.load_npz(path), path


def test_mpc_predictions_parity(run_logs):
    d, _ = run_logs
    jt, jx = jviz.mpc_predictions(d, CFG)
    tt, tx = tviz.mpc_predictions(d, CFG, device="cpu")
    np.testing.assert_array_equal(tt, jt)
    assert tx.shape == (4, 24, CFG.n_steps)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=_scale_tol(jx, 1e-8))


def test_foot_positions_parity(run_logs):
    d, _ = run_logs
    np.testing.assert_allclose(tviz.foot_positions(d, device="cpu"),
                               jviz.foot_positions(d), rtol=0, atol=1e-12)


def test_figures_build(run_logs, tmp_path):
    import matplotlib.pyplot as plt
    d, _ = run_logs
    png = str(tmp_path / "forces.png")
    fig = tviz.force_monitor(d, tick=20, show=False, save_path=png,
                             device="cpu")
    assert os.path.getsize(png) > 0
    plt.close(fig)
    fig, slider = tviz.slider_replay(d, CFG, show=False, device="cpu")
    slider.set_val(3)
    plt.close(fig)
    html = str(tmp_path / "anim.html")
    ani = tviz.animate_rollout(d, CFG, stride=10, show=False,
                               save_path=html, device="cpu")
    assert os.path.getsize(html) > 0
    plt.close(ani._fig)


@pytest.mark.parametrize("flags", [["--forces"], ["--forces", "20"],
                                   ["--slider"]])
def test_analyze_slider_and_forces(run_logs, tmp_path, monkeypatch, flags):
    from qrw_tpu_torch.eval.analyze import main
    _, path = run_logs
    monkeypatch.chdir(tmp_path)
    assert main([path, *flags, "--cpu"]) == 0
    if flags[0] == "--forces":
        assert os.path.exists(tmp_path / "qrw_analysis_forces.png")


# ----------------------------------------------------------------------
# The mesh
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_pair(tmp_path_factory):
    """mesh_workload on two gloo processes (rank 0's saved result) and
    unsharded here, while they run."""
    out = str(tmp_path_factory.mktemp("mesh") / "rank0.npz")
    ctx = mp.get_context("spawn")
    port = tmesh._free_port()
    procs = [ctx.Process(target=torch_children.mesh_rank,
                         args=(r, 2, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        want = torch_children.mesh_workload(None)
    finally:
        for p in procs:
            p.join(timeout=600)
    for p in procs:
        assert not p.is_alive() and p.exitcode == 0, p.exitcode
    with np.load(out) as f:
        got = {k: f[k] for k in f.files}
    return got, want


MESH_TOL = 1e-11


def _mesh_close(got, want, key):
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_scale_tol(want, MESH_TOL),
                                   err_msg=key)


@pytest.mark.parametrize("key", ["q", "v", "tau_ff", "base_pos", "error"])
def test_sharded_rollout_equals_unsharded(mesh_pair, key):
    got, want = mesh_pair
    assert got[key].shape == want[key].shape
    assert got[key].shape[0] == torch_children.MESH_B
    _mesh_close(got[key], want[key], key)


def test_sharded_sweep_equals_unsharded(mesh_pair):
    got, want = mesh_pair
    for key in ("success", "vx_err", "h_err"):
        assert got[key].shape == (2, 2)
        _mesh_close(got[key], want[key], key)
    assert got["success"][0, 0]                 # the standing cell


def test_scenario_metrics_all_reduce(mesh_pair):
    got, want = mesh_pair
    e, i = want["errors"], want["iters"]
    np.testing.assert_array_equal(got["errors"], e)
    assert float(got["max_iters"]) == float(want["max_iters"]) == i.max()
    for key, plain in (("error_rate", e.astype(np.float32).mean()),
                       ("mean_iters", i.astype(np.float32).mean())):
        assert abs(float(got[key]) - plain) <= 1e-6 * max(1.0, plain), key
        assert abs(float(want[key]) - plain) <= 1e-6 * max(1.0, plain), key


def test_mesh_world_size_one_without_torchrun(capsys):
    """No torchrun environment: a group of world size 1 in this process.
    The batched MPC solver and the CLI's --batch --mesh through it equal
    their unsharded runs; the group is destroyed at the end."""
    import torch.distributed as dist

    from qrw_tpu_torch.runtime import main
    assert not dist.is_initialized()
    rng = np.random.default_rng(2)
    xref = np.zeros((2, 12, CFG.n_steps + 1))
    xref[:, 2] = 0.2447
    xref[:, :, 0] += rng.normal(scale=0.01, size=(2, 12))
    feet = np.array([0.195, 0.147, 0.0, 0.195, -0.147, 0.0,
                     -0.195, 0.147, 0.0, -0.195, -0.147, 0.0])
    fsteps = np.zeros((2, CFG.N_gait, 12))
    fsteps[:, :CFG.n_steps] = feet
    args = [torch.as_tensor(xref), torch.as_tensor(fsteps)]
    mesh = tmesh.make_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.world_size) == (0, 1)
        with pytest.raises(ValueError):
            tmesh.make_mesh(n_devices=2, device="cpu")
        got = tmesh.batched_mpc_solver(CFG, mesh)(*args)
        want = tmesh.batched_mpc_solver(CFG)(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        cli = main.build_argparser().parse_args(
            ["--cpu", "--batch", "2", "--ticks", "6"])
        cfg = CFG.replace(N_SIMULATION=6)
        _, lm, _ = main.run_single(cfg, cli, "cpu", F64, mesh)
        _, lp, _ = main.run_single(cfg, cli, "cpu", F64)
        for f, a, b in zip(lp._fields, lm, lp):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    finally:
        mesh.close()
    assert not dist.is_initialized()
    capsys.readouterr()
    assert main.main(["--cpu", "--batch", "2", "--mesh", "--ticks",
                      "4"]) == 0
    out = capsys.readouterr().out
    assert "batch=2" in out and "errors 0/2" in out
    assert not dist.is_initialized()


def test_shard_batch_slices_and_checks():
    two = tmesh.Mesh(rank=1, world_size=2, device=torch.device("cpu"),
                     axis="dp", owner=False)
    x = torch.arange(8.0).reshape(4, 2)
    tree = (x, None, {"a": 1}["a"])
    got = tmesh.shard_batch(tree, two)
    np.testing.assert_array_equal(got[0].numpy(), x[2:].numpy())
    assert got[1] is None and got[2] == 1
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_batch(torch.zeros(3, 2), two)
