"""The slice as a whole: the single-robot closed loop against qrw_tpu.

JAX builds the rollout's initial carry (sim/rollout.make_rollout),
broadcast to B = 2 robots whose joint angles are perturbed by
np.random.default_rng(0).normal(scale=0.01), as qrw_tpu's CLI does for
`--batch`; the carry goes to the port through qrw_tpu_torch.convert,
so both packages start from the same robots. qrw_tpu runs
jax.vmap(rollout) for 21 ticks (the MPC solves at k = 0, 10 and 20),
the port its rollout on the CPU along the batch axis: with the
complementary-filter estimator in float32 (the CLI's defaults) and with
the perfect estimator in float64, one JAX compile each.

Tolerances:
  * float32 (the CLI's precision): the fleet tests' bars. Base
    positions and quaternions 1e-5, every other leaf (forces, torques,
    joint states, estimator, foot references) 1e-3 of its scale, flags
    and codes equal. Measured over 30 ticks: 3e-7 on positions, 1.3e-4
    of scale at most (torques), 7e-5 on forces. An MPC solve may stop
    one check (25 iterations) earlier in one package than in the other
    where a residual sits at its tolerance, so the far horizon of the
    plan (x_f_mpc) moved by up to 8.3e-4 of its scale: it is held in
    float64 below.
  * float64: every one of the 33 log leaves and the final carry to 1e-9
    of their scale (measured: 4e-13 on torques, 2e-13 on plans). The
    same equations in another op order; any change of formula shows.

Also here: sim/faults against qrw_tpu's, the CLI's single-robot mode
on the CPU, and hetero_shakedown_capture at a short length against
qrw_tpu's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.sim import faults as jfaults
from qrw_tpu.sim import fleet as jfl
from qrw_tpu.sim import rollout as jro
from qrw_tpu_torch import convert
from qrw_tpu_torch.sim import faults as tfaults
from qrw_tpu_torch.sim import fleet as tfl
from qrw_tpu_torch.sim import rollout as tro
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
B = 2
N_TICKS = 21


def _run(dtype, perfect):
    jdt = {"f32": jnp.float32, "f64": jnp.float64}[dtype]
    jctl, jc = jro.make_rollout(CFG, dtype=jdt)
    jc = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jc)
    dq = jnp.asarray(np.random.default_rng(0).normal(scale=0.01,
                                                     size=(B, 12)), jdt)
    jc = jc._replace(sim_state=jc.sim_state._replace(
        q=jc.sim_state.q.at[:, 7:].add(dq)))
    jout = jax.jit(jax.vmap(lambda c: jro.rollout(
        jctl, c, N_TICKS, perfect_estimator=perfect)))(jc)
    jout = jax.tree.map(np.asarray, jout)
    tctl, _ = tro.make_rollout(CFG, device="cpu")
    tout = tro.rollout(tctl, convert.to_torch(jax.tree.map(np.asarray, jc)),
                       N_TICKS, perfect_estimator=perfect)
    return tout, jout


@pytest.fixture(scope="module")
def runs32():
    return _run("f32", perfect=False)


@pytest.fixture(scope="module")
def runs64():
    return _run("f64", perfect=True)


def _scale_tol(w, rel):
    return rel * max(1.0, float(np.abs(w).max()))


# float32 bars, as fractions of each leaf's scale (chip_smoke.py holds
# the card against the CPU to the same table)
TOL32 = {"base_pos": 1e-5, "base_quat": 1e-5}
F32_FIELDS = [f for f in tro.RolloutLog._fields if f != "x_f_mpc"]


@pytest.mark.parametrize("field", F32_FIELDS)
def test_rollout_log_parity(runs32, field):
    (_, tlog), (_, jlog) = runs32
    w = getattr(jlog, field)
    g = getattr(tlog, field).numpy()
    assert g.shape == w.shape == (B, N_TICKS) + w.shape[2:]
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
        if field == "error":
            assert not w.any(), "no robot may latch its security stop"
    else:
        np.testing.assert_allclose(
            g, w, rtol=0, atol=_scale_tol(w, TOL32.get(field, 1e-3)))


@pytest.mark.parametrize("field", list(tro.RolloutLog._fields))
def test_rollout_log_parity_f64(runs64, field):
    (_, tlog), (_, jlog) = runs64
    w = getattr(jlog, field)
    g = getattr(tlog, field).numpy()
    assert g.shape == w.shape == (B, N_TICKS) + w.shape[2:]
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=_scale_tol(w, 1e-9))


def test_rollout_final_carry_parity_f64(runs64):
    (tcarry, _), (jcarry, _) = runs64
    got = convert.to_numpy(tcarry, like=jcarry)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jcarry)]
    flat_g = jax.tree_util.tree_leaves(got)
    flat_w = jax.tree_util.tree_leaves(jcarry)
    assert len(flat_g) == len(flat_w) == len(paths)
    for path, g, w in zip(paths, flat_g, flat_w):
        assert g.shape == w.shape, path
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=_scale_tol(w, 1e-9),
                                       err_msg=path)


def test_rollout_walks(runs32):
    """The robots stay up and follow the profile's start: three MPC
    solves, every log finite."""
    (_, tlog), _ = runs32
    assert all(bool(torch.isfinite(x.float()).all()) for x in tlog)
    h = tlog.base_pos[:, :, 2]
    assert bool((h > 0.2).all()) and bool((h < 0.3).all())
    # the MPC plan changes exactly on the solve ticks
    changed = (tlog.x_f_mpc[:, 1:] != tlog.x_f_mpc[:, :-1]).flatten(2).any(-1)
    ticks = sorted(set(torch.nonzero(changed)[:, 1].add(1).tolist()))
    assert ticks == [10, 20], ticks


def test_async_mpc_parity():
    """cfg.mpc_async: each solve's plan is consumed one period late,
    rolled one step, its terminal forces rebuilt on a gait-phase change
    (the stale roll). One robot, float64, perfect estimator, 21 ticks,
    against qrw_tpu's rollout: every log leaf to 1e-9 of its scale."""
    cfg = CFG.replace(mpc_async=True)
    jctl, jc = jro.make_rollout(cfg, dtype=jnp.float64)
    want = jax.tree.map(np.asarray, jax.jit(lambda c: jro.rollout(
        jctl, c, N_TICKS, perfect_estimator=True))(jc)[1])
    tctl, _ = tro.make_rollout(cfg, device="cpu")
    _, got = tro.rollout(tctl, convert.to_torch(jax.tree.map(np.asarray, jc)),
                         N_TICKS, perfect_estimator=True)
    for field in tro.RolloutLog._fields:
        w, g = getattr(want, field), getattr(got, field).numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=_scale_tol(w, 1e-9),
                                   err_msg=field)
    # tick 10 consumes tick 0's plan rolled one step, not its own solve
    xf = got.x_f_mpc.numpy()
    np.testing.assert_array_equal(xf[10, :12], xf[9, :12])
    np.testing.assert_array_equal(xf[10, 12:, :-1], xf[9, 12:, 1:])


def test_without_logs():
    ctl, carry = tro.make_rollout(CFG, device="cpu")
    out, logs = tro.rollout(ctl, carry, 2, with_logs=False)
    assert logs is None and out.sim_state.q.shape == (19,)


@pytest.mark.parametrize("velID", [2, 4])
def test_faults_parity(velID):
    cfg = CFG.replace(velID=velID)
    np.testing.assert_array_equal(tfaults.default_perturbations(cfg, 6000),
                                  jfaults.default_perturbations(cfg, 6000))
    hits = [(100, [0.0, 2.0, 0.0]), (400, [-1.0, 0.0, 0.5])]
    np.testing.assert_array_equal(
        tfaults.projectile_impulses(600, hits, duration=20),
        jfaults.projectile_impulses(600, hits, duration=20))
    np.testing.assert_array_equal(tfaults.bell_profile(50, 10, 20),
                                  jfaults.bell_profile(50, 10, 20))


def test_cli_single_robot_mode(capsys):
    """The CLI's default mode on the CPU: --batch robots perturbed from
    np.random.default_rng(seed), qrw_tpu's summary lines, exit 0."""
    from qrw_tpu_torch.runtime import main
    assert main.main(["--cpu", "--ticks", "20", "--batch", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("backend=cpu devices=1 ticks=20 velID=2 gait=trot "
                      "batch=2")
    assert out[1].startswith("rollout done: ")
    assert out[2].startswith("final height mean=0.2")
    assert out[2].endswith("errors 0/2 (codes [])")


def test_hetero_shakedown_capture_parity():
    """The capture that calibrates bounding (21 ticks here, 1200 in the
    CLI) against qrw_tpu's, float32: footholds to 1e-5 m, swing entries
    (exact zeros) equal."""
    want = jfl.hetero_shakedown_capture(CFG, "bounding", n_ticks=21)
    got = tfl.hetero_shakedown_capture(CFG, "bounding", n_ticks=21,
                                       device="cpu")
    assert got.shape == want.shape == (3, CFG.N_gait, 12)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
