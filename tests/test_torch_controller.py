"""Parity of the port's controller pipeline with qrw_tpu, in float64.

The planners and the estimator are held against their JAX counterparts
directly (joystick profiles, gait roll and phase durations, reference
states), then one robot runs 20 ticks (two MPC cycles) of
compute_pre -> wbc_inputs -> compute_wbc_lane -> compute_post in both
packages from the same initial state, on the same seeded device
measurements and the same MPC plan. Every intermediate of every tick is
compared.

Tolerance: float64, same update equations. The only difference is the
order of operations (and the WBC box QP solving its KKT system with a
batched Cholesky instead of the unrolled one); 1e-8 absolute leaves
orders of magnitude over the round-off of 20 closed-loop ticks while
still catching any change of formula.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import controller as jc
from qrw_tpu.core import gait as jgait
from qrw_tpu.core import joystick as jjoy
from qrw_tpu.core import state_planner as jsp
from qrw_tpu.core import wbc as jwbc
from qrw_tpu.core import wbc_lane as jwl
from qrw_tpu.core.estimator import DeviceData as JDevice
from qrw_tpu.ops import rbd_lane as jrl
from qrw_tpu_torch import convert
from qrw_tpu_torch.core import controller as tc
from qrw_tpu_torch.core import gait as tgait
from qrw_tpu_torch.core import joystick as tjoy
from qrw_tpu_torch.core import state_planner as tsp
from qrw_tpu_torch.core import wbc as twbc
from qrw_tpu_torch.core import wbc_lane as twl
from qrw_tpu_torch.core.estimator import DeviceData as TDevice
from qrw_tpu_torch.ops import rbd_lane as trl
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
TOL = 1e-8
N_TICKS = 20
F64 = torch.float64


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _cmp_tree(got, want, tol=TOL, path=""):
    if want is None:
        assert got is None, path
        return
    if isinstance(want, tuple):
        names = getattr(want, "_fields", range(len(want)))
        for i, name in enumerate(names):
            _cmp_tree(got[i], want[i], tol, f"{path}.{name}")
        return
    w = np.asarray(want)
    g = _np(got)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=path)


@pytest.mark.parametrize("vel_id", range(7))
def test_joystick_profile_parity(vel_id):
    ks_j, v_j = jjoy.profile_tables(vel_id)
    ks_t, v_t = tjoy.profile_tables(vel_id)
    np.testing.assert_array_equal(ks_t, ks_j)
    np.testing.assert_array_equal(v_t, v_j)
    ticks = [0, 1, 250, 499, 500, 777, 4321, int(ks_j[-1]) - 1,
             int(ks_j[-1]), int(ks_j[-1]) + 10]
    want = jax.jit(jax.vmap(lambda k: jjoy.v_ref_profile(k, vel_id)))(
        jnp.asarray(ticks))
    got = np.stack([_np(tjoy.v_ref_profile(k, vel_id)) for k in ticks])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["trot", "walk", "bounding", "static"])
def test_gait_roll_and_phase_durations(kind):
    """13 rolls (with a gait switch to pacing at the 6th) of the contact
    matrices; swing and stance phase durations after each roll."""
    js = jax.tree.map(lambda a: np.asarray(a, np.float64)
                      if np.asarray(a).dtype != bool else np.asarray(a),
                      jgait.make_gait(CFG, kind))
    ts = tgait.make_gait(CFG, kind, F64)
    jpat = jgait.gait_patterns(CFG)
    tpat = tgait.gait_patterns(CFG)
    np.testing.assert_array_equal(tpat, np.asarray(jpat))
    for k in range(0, 130, 10):
        code = 1 if k == 50 else 0
        js = jgait.update_gait(js, k, CFG.k_mpc, code, jpat)
        ts = tgait.update_gait(ts, k, CFG.k_mpc, code, tpat)
        _cmp_tree(ts, js, path=f"gait k={k}")
        for value in (0.0, 1.0):
            _cmp_tree(tgait.phase_durations(ts, value, CFG.dt_mpc),
                      jgait.phase_durations(js, value, CFG.dt_mpc),
                      path=f"phase k={k} v={value}")


def test_reference_states_parity():
    rng = np.random.default_rng(5)
    q7 = rng.normal(size=(6, 7))
    q7[:, 3:7] /= np.linalg.norm(q7[:, 3:7], axis=1, keepdims=True)
    hv = rng.normal(size=(6, 6))
    vr = rng.normal(size=(6, 6))
    vr[0, 5] = 0.0                          # the straight-line branch
    kw = dict(dt_mpc=CFG.dt_mpc, n_steps=CFG.n_steps, h_ref=CFG.h_ref)
    want = jax.vmap(lambda a, b, c: jsp.compute_reference_states(
        a, b, c, **kw))(jnp.asarray(q7), jnp.asarray(hv), jnp.asarray(vr))
    got = tsp.compute_reference_states(torch.as_tensor(q7),
                                       torch.as_tensor(hv),
                                       torch.as_tensor(vr), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_base_inertia_diag_parity():
    np.testing.assert_allclose(twbc.base_inertia_diag(),
                               jwbc.base_inertia_diag(), rtol=1e-12)
    np.testing.assert_array_equal(twbc.friction_generators(CFG.mu),
                                  jwbc.friction_generators(CFG.mu))


def _devices(n_ticks, seed=11):
    """Seeded device measurements near the standing pose."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_ticks):
        rpy = rng.normal(scale=0.03, size=3)
        cr, sr = np.cos(rpy / 2), np.sin(rpy / 2)
        quat = np.array([sr[0] * cr[1] * cr[2] - cr[0] * sr[1] * sr[2],
                         cr[0] * sr[1] * cr[2] + sr[0] * cr[1] * sr[2],
                         cr[0] * cr[1] * sr[2] - sr[0] * sr[1] * cr[2],
                         cr[0] * cr[1] * cr[2] + sr[0] * sr[1] * sr[2]])
        out.append(dict(
            base_lin_acc=rng.normal(scale=0.3, size=3),
            base_ang_vel=rng.normal(scale=0.1, size=3), base_quat=quat,
            q_mes=np.asarray(CFG.q_init) + rng.normal(scale=0.02, size=12),
            v_mes=rng.normal(scale=0.2, size=12),
            dummy_pos=np.array([0.0, 0.0, CFG.h_ref + 0.015])
            + rng.normal(scale=0.005, size=3),
            b_base_vel=rng.normal(scale=0.05, size=3)))
    return out


def _plan():
    """A fixed MPC plan (24, N): trot stance forces carrying the robot."""
    x_f = np.zeros((24, CFG.n_steps))
    x_f[2, :] = CFG.h_ref
    for f in range(4):
        x_f[12 + 3 * f + 2, :] = 6.0 + 0.5 * f
        x_f[12 + 3 * f, :] = 0.3 - 0.2 * f
    return x_f


@pytest.fixture(scope="module")
def chain():
    """Both packages run 20 ticks; returns the per-tick records."""
    jctl = jc.make_controller(CFG)
    jlane = jrl.solo12_lane()
    tctl = tc.make_controller(CFG)
    tlane = trl.solo12_lane()
    devs = _devices(N_TICKS)
    x_f = _plan()

    def jtick(cs, dev, k, x_f):
        pre = jc.compute_pre(jctl, cs, dev, k)
        inp = jc.wbc_inputs(jctl, cs, pre, x_f)
        b1 = lambda a: a[None]
        w = jwl.compute_wbc_lane(
            CFG, jlane, jax.tree.map(b1, cs.wbc), b1(inp.qj), b1(inp.b_v),
            b1(inp.f_cmd), b1(inp.contacts), b1(inp.feet_p_cmd),
            b1(inp.feet_v_cmd), b1(inp.feet_a_cmd))
        w = jax.tree.map(lambda a: a[0], w)
        cs2, res = jc.compute_post(jctl, cs, pre, k, x_f, x_f, cs.mpc,
                                   cs.planner_target, wbc_res=w)
        return pre, inp, w, cs2, res

    jtick = jax.jit(jtick)
    jcs = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                       if jnp.asarray(a).dtype == jnp.float32 else a,
                       jc.init_state(jctl, jnp.float64))
    tcs = tc.init_state(tctl, F64)
    _cmp_tree(tcs, jcs, path="init_state")
    recs = []
    for k in range(N_TICKS):
        d = devs[k]
        jout = jtick(jcs, JDevice(**{n: jnp.asarray(v)
                                     for n, v in d.items()}),
                     k, jnp.asarray(x_f))
        jout = jax.tree.map(np.asarray, jout)
        tdev = TDevice(**{n: torch.as_tensor(v) for n, v in d.items()})
        pre = tc.compute_pre(tctl, tcs, tdev, k)
        inp = tc.wbc_inputs(tctl, tcs, pre, torch.as_tensor(x_f))
        b1 = lambda a: a[None]
        w = twl.compute_wbc_lane(
            CFG, tlane, convert.tree_map(b1, tcs.wbc), b1(inp.qj),
            b1(inp.b_v), b1(inp.f_cmd), b1(inp.contacts),
            b1(inp.feet_p_cmd), b1(inp.feet_v_cmd), b1(inp.feet_a_cmd))
        w = convert.tree_map(lambda a: a[0], w)
        tcs2, res = tc.compute_post(tctl, tcs, pre, k, torch.as_tensor(x_f),
                                    torch.as_tensor(x_f), tcs.mpc,
                                    tcs.planner_target, wbc_res=w)
        recs.append(((pre, inp, w, tcs2, res), jout))
        # both packages continue from the JAX state, so a mismatch shows
        # at the tick where it arises
        jcs = jax.tree.map(jnp.asarray, jout[3])
        tcs = convert.to_torch(jout[3], dtype=F64)
    return recs


@pytest.mark.parametrize("part", [
    "estimator", "gait", "footstep", "foot_trajectory", "reference_states",
    "fsteps", "wbc_inputs", "wbc", "post_state", "result"])
def test_controller_chain_parity(chain, part):
    for k, ((pre, inp, w, cs2, res), (jpre, jinp, jw, jcs2, jres)) in \
            enumerate(chain):
        got, want = {
            "estimator": (pre.est, jpre.est),
            "gait": (pre.gait, jpre.gait),
            "footstep": (pre.fs_state, jpre.fs_state),
            "foot_trajectory": (pre.ft_state, jpre.ft_state),
            "reference_states": ((pre.xref, pre.q, pre.v, pre.h_v,
                                  pre.oRh, pre.oTh),
                                 (jpre.xref, jpre.q, jpre.v, jpre.h_v,
                                  jpre.oRh, jpre.oTh)),
            "fsteps": (pre.fsteps, jpre.fsteps),
            "wbc_inputs": (inp, jinp),
            "wbc": (w, jw),
            "post_state": (cs2, jcs2),
            "result": (res, jres)}[part]
        _cmp_tree(got, want, path=f"tick {k} {part}")
