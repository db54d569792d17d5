"""The Kalman estimator of the port (core/kalman, core/estimator.run_filter
under cfg.kf_enabled, the single-robot loop with --kf) against qrw_tpu.

Inputs are drawn from numpy seeds and go through both packages.

Tolerances:
  * kf6_step / kf18_step / kf18_noise and run_filter in float64, batched
    (the port along a leading axis, qrw_tpu under jax.vmap): 1e-10 of
    each output's scale. The same equations in another op order; the
    filter's 18 x 18 covariance and 16 x 16 innovation inverse keep
    round-off near 1e-15 of scale over 30 steps.
  * The closed loop with the Kalman filter (B = 2 robots, 21 ticks,
    sim/rollout against jax.vmap(rollout), one carry built by qrw_tpu
    and converted): float64 every one of the 33 log leaves to 1e-9 of
    its scale; float32 (the CLI's precision) at tests/
    test_torch_rollout.py's bars: base positions and quaternions 1e-5,
    every other leaf but the plan's far horizon (x_f_mpc, float64 only)
    1e-3 of its scale, flags and codes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import estimator as jest
from qrw_tpu.core import kalman as jkf
from qrw_tpu.models.solo12 import make_solo12 as jsolo
from qrw_tpu.ops import rbd as jrbd
from qrw_tpu.sim import rollout as jro
from qrw_tpu_torch import convert
from qrw_tpu_torch.core import estimator as tes
from qrw_tpu_torch.core import kalman as tkf
from qrw_tpu_torch.models.solo12 import make_solo12 as tsolo
from qrw_tpu_torch.ops import rbd as trbd
from qrw_tpu_torch.sim import rollout as tro
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
CFG_KF = CFG.replace(kf_enabled=True)
TOL64 = 1e-10
B = 3


def _close(g, w, rel, name=""):
    g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
    w = np.asarray(w)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=rel * max(1.0, float(np.abs(w).max())),
                               err_msg=name)


def _rot(rng, n):
    """n random rotations (n, 3, 3) from small roll / pitch / yaw."""
    from scipy.spatial.transform import Rotation
    return Rotation.from_euler("xyz", rng.normal(scale=0.2, size=(n, 3))
                               ).as_matrix()


def test_kf_init_equal():
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.float64, jnp.float64)):
        t6, j6 = tkf.kf6_init(dtype), jkf.kf6_init(jdt)
        t18, j18 = tkf.kf18_init(0.22, dtype), jkf.kf18_init(0.22, jdt)
        for g, w in zip(tuple(t6) + tuple(t18), tuple(j6) + tuple(j18)):
            assert g.dtype == dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kf6_matrices_and_const_equal():
    for g, w in zip(tkf.kf6_matrices(0.002), jkf.kf6_matrices(0.002)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tkf._kf18_const(0.002), jkf._kf18_const(0.002)):
        np.testing.assert_array_equal(g, w)


def test_kf6_step_parity():
    """30 predict / correct steps of B = 3 filters, float64."""
    rng = np.random.default_rng(0)
    ts = tkf.kf6_init(torch.float64)
    ts = tkf.KF6State(*(a.expand((B,) + a.shape).clone() for a in ts))
    js = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                      jkf.kf6_init(jnp.float64))
    step = jax.jit(jax.vmap(lambda s, a, m: jkf.kf6_step(0.002, s, a, m)))
    for _ in range(30):
        acc = rng.normal(size=(B, 3))
        meas = rng.normal(scale=0.1, size=(B, 6))
        js = step(js, jnp.asarray(acc), jnp.asarray(meas))
        ts = tkf.kf6_step(0.002, ts, torch.as_tensor(acc),
                          torch.as_tensor(meas))
    _close(ts.X, js.X, TOL64, "X")
    _close(ts.P, js.P, TOL64, "P")


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_kf18_noise_parity(dtype):
    tdt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    jdt = {"f32": jnp.float32, "f64": jnp.float64}[dtype]
    fs = np.array([[1, 0, 0, 1], [0, 0, 0, 0], [1, 1, 1, 1]], np.float64)
    R, Q = tkf.kf18_noise(0.002, torch.as_tensor(fs, dtype=tdt), tdt)
    jR, jQ = jax.vmap(lambda f: jkf.kf18_noise(0.002, f, jdt))(
        jnp.asarray(fs, jdt))
    assert R.dtype == Q.dtype == tdt
    rel = 1e-6 if dtype == "f32" else TOL64
    _close(R, jR, rel, "R")
    _close(Q, jQ, rel, "Q")


def test_kf18_step_parity():
    """30 steps of B = 3 filters on random rotations, accelerations,
    foot positions, contact patterns and gyro rates, float64: the state,
    the covariance and both outputs."""
    rng = np.random.default_rng(3)
    h0 = 0.22
    ts = tkf.kf18_init(h0, torch.float64)
    ts = tkf.KF18State(*(a.expand((B,) + a.shape).clone() for a in ts))
    js = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                      jkf.kf18_init(h0, jnp.float64))
    step = jax.jit(jax.vmap(lambda s, R, a, fp, f, w: jkf.kf18_step(
        CFG, s, R, a, fp, f, w)))
    for _ in range(30):
        oRb = _rot(rng, B)
        acc = rng.normal(size=(B, 3))
        fp = rng.normal(scale=0.1, size=(B, 4, 3)) + np.array([0, 0, -h0])
        fs = (rng.random((B, 4)) > 0.4).astype(np.float64)
        w = rng.normal(scale=0.2, size=(B, 3))
        js, jpos, jvel = step(js, *map(jnp.asarray, (oRb, acc, fp, fs, w)))
        ts, tpos, tvel = tkf.kf18_step(CFG, ts, *map(torch.as_tensor,
                                                     (oRb, acc, fp, fs, w)))
    for name, g, w in (("X", ts.X, js.X), ("P", ts.P, js.P),
                       ("pos", tpos, jpos), ("vel", tvel, jvel)):
        _close(g, w, TOL64, name)


def test_run_filter_kf_parity():
    """15 estimator ticks under kf_enabled, B = 3 robots on random joint
    states, IMU readings and gait rows, float64, each package carrying
    its own state: q_filt, v_filt, v_secu, rpy and every state leaf."""
    rng = np.random.default_rng(5)
    jmodel = jrbd.to_jax(jsolo())
    tmodel = trbd.to_torch(tsolo())
    h0 = 0.22
    js0 = jest.init_estimator_state(CFG_KF, h0, jnp.float64)
    js = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), js0)
    ts = convert.to_torch(jax.tree.map(np.asarray, js))
    step = jax.jit(jax.vmap(
        lambda s, g, d, goals, k: jest.run_filter(CFG_KF, jmodel, s, k, g, d,
                                                  goals),
        in_axes=(0, 0, 0, 0, None)), static_argnums=4)
    qj0 = np.tile(np.asarray(CFG.q_init), (B, 1))
    for k in range(15):
        gait = (rng.random((B, CFG.N_gait, 4)) > 0.3).astype(np.float64)
        if k % 3:
            gait[:, 1:] = gait[:, :1]       # long stances too
        quat = rng.normal(scale=0.05, size=(B, 4))
        quat[:, 3] = 1.0
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)
        dev = dict(base_lin_acc=rng.normal(size=(B, 3)),
                   base_ang_vel=rng.normal(scale=0.3, size=(B, 3)),
                   base_quat=quat,
                   q_mes=qj0 + rng.normal(scale=0.05, size=(B, 12)),
                   v_mes=rng.normal(scale=0.5, size=(B, 12)),
                   dummy_pos=rng.normal(scale=0.01, size=(B, 3)),
                   b_base_vel=rng.normal(scale=0.1, size=(B, 3)))
        goals = rng.normal(scale=0.2, size=(B, 3, 4))
        jout = step(js, jnp.asarray(gait), jest.DeviceData(
            **{k_: jnp.asarray(v) for k_, v in dev.items()}),
            jnp.asarray(goals), k)
        tout = tes.run_filter(CFG_KF, tmodel, ts, k, torch.as_tensor(gait),
                                tes.DeviceData(**{
                                    k_: torch.as_tensor(v)
                                    for k_, v in dev.items()}),
                                torch.as_tensor(goals))
        js, ts = jout.state, tout.state
    for name in ("q_filt", "v_filt", "v_secu", "rpy"):
        _close(getattr(tout, name), getattr(jout, name), TOL64, name)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(js)]
    got = jax.tree_util.tree_leaves(convert.to_numpy(ts, like=js))
    for path, g, w in zip(paths, got, jax.tree_util.tree_leaves(js)):
        _close(g, w, TOL64, path)
    # the Kalman state moved; the complementary filters' did not
    assert not np.allclose(np.asarray(js.kf.P), np.asarray(js0.kf.P))
    np.testing.assert_array_equal(ts.hp_vel.numpy(), 0.0)


# ----------------------------------------------------------------------
# the closed loop with the Kalman filter
# ----------------------------------------------------------------------

R_B = 2
N_TICKS = 21


def _run(dtype):
    jdt = {"f32": jnp.float32, "f64": jnp.float64}[dtype]
    jctl, jc = jro.make_rollout(CFG_KF, dtype=jdt)
    jc = jax.tree.map(lambda a: jnp.broadcast_to(a, (R_B,) + a.shape), jc)
    dq = jnp.asarray(np.random.default_rng(0).normal(scale=0.01,
                                                     size=(R_B, 12)), jdt)
    jc = jc._replace(sim_state=jc.sim_state._replace(
        q=jc.sim_state.q.at[:, 7:].add(dq)))
    jout = jax.jit(jax.vmap(lambda c: jro.rollout(jctl, c, N_TICKS)))(jc)
    jout = jax.tree.map(np.asarray, jout)
    tctl, _ = tro.make_rollout(CFG_KF, device="cpu")
    tout = tro.rollout(tctl, convert.to_torch(jax.tree.map(np.asarray, jc)),
                       N_TICKS)
    return tout, jout


@pytest.fixture(scope="module")
def runs32():
    return _run("f32")


@pytest.fixture(scope="module")
def runs64():
    return _run("f64")


TOL32 = {"base_pos": 1e-5, "base_quat": 1e-5}
F32_FIELDS = [f for f in tro.RolloutLog._fields if f != "x_f_mpc"]


def _check_leaf(g, w, rel):
    assert g.shape == w.shape == (R_B, N_TICKS) + w.shape[2:]
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("field", F32_FIELDS)
def test_kf_rollout_log_parity(runs32, field):
    (_, tlog), (_, jlog) = runs32
    _check_leaf(getattr(tlog, field).numpy(), getattr(jlog, field),
                TOL32.get(field, 1e-3))


@pytest.mark.parametrize("field", list(tro.RolloutLog._fields))
def test_kf_rollout_log_parity_f64(runs64, field):
    (_, tlog), (_, jlog) = runs64
    _check_leaf(getattr(tlog, field).numpy(), getattr(jlog, field), 1e-9)


def test_kf_rollout_final_carry_parity_f64(runs64):
    """Every leaf of the final carry, the Kalman state included, to 1e-9
    of its scale; the filter drove the loop (its state moved, the
    complementary filters' did not) and no robot latched."""
    (tcarry, tlog), (jcarry, _) = runs64
    got = convert.to_numpy(tcarry, like=jcarry)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jcarry)]
    for path, g, w in zip(paths, jax.tree_util.tree_leaves(got),
                          jax.tree_util.tree_leaves(jcarry)):
        assert g.shape == w.shape, path
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            _close(g, w, 1e-9, path)
    est = tcarry.ctl_state.estimator
    assert not np.allclose(est.kf.P.numpy(), np.eye(18))
    np.testing.assert_array_equal(est.hp_vel.numpy(), 0.0)
    assert not bool(tlog.error.any())
    assert bool(torch.isfinite(tlog.base_pos).all())
