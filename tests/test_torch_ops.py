"""Parity of the port's ops (rotations, rbd, rbd_lane) with qrw_tpu.

Random free-flyer states made with numpy go through both packages in
float64. The algorithms are the same, so the only differences are the
order of floating-point operations: 1e-10 absolute leaves four orders
of magnitude over what f64 round-off accumulates through the three-level
leg recursion (tests/test_rbd_lane.py holds the JAX side at 1e-8 to
1e-10 against the 18x18 form)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.models.solo12 import make_solo12
from qrw_tpu.ops import rbd as jrbd
from qrw_tpu.ops import rbd_lane as jrl
from qrw_tpu.ops import rotations as jrot
from qrw_tpu_torch.ops import rbd as trbd
from qrw_tpu_torch.ops import rbd_lane as trl
from qrw_tpu_torch.ops import rotations as trot
from tests.torch_threads import single_thread

single_thread()

B = 5
TOL = 1e-10


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(q=q, base_pos=rng.normal(size=(B, 3)),
                qj=rng.uniform(-1.5, 1.5, size=(B, 12)),
                v=rng.normal(size=(B, 18)), a=rng.normal(size=(B, 18)),
                rpy=rng.uniform(-1.0, 1.0, size=(B, 3)),
                omega=rng.normal(size=(B, 3)))


@pytest.fixture(scope="module")
def lanes():
    jm = jrbd.to_jax(make_solo12())
    return jrl.to_lane(jm), trl.to_lane(trbd.to_torch(make_solo12()))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("fn", ["quat_to_rot", "quat_to_rpy", "rpy_to_quat",
                                "rpy_to_rot", "rot_z", "skew", "quat_mul",
                                "quat_integrate"])
def test_rotations_parity(states, fn):
    args = {"quat_to_rot": (states["q"],), "quat_to_rpy": (states["q"],),
            "rpy_to_quat": (states["rpy"],), "rpy_to_rot": (states["rpy"],),
            "rot_z": (states["rpy"][:, 2],), "skew": (states["omega"],),
            "quat_mul": (states["q"], states["q"][::-1].copy()),
            "quat_integrate": (states["q"], states["omega"], 0.002)}[fn]
    want = getattr(jrot, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args])
    got = getattr(trot, fn)(*[_t(a) if isinstance(a, np.ndarray) else a
                              for a in args])
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)


def test_rbd_frame_kinematics_parity(states):
    jm = jrbd.to_jax(make_solo12())
    tm = trbd.to_torch(make_solo12())
    s = states
    want = jax.vmap(lambda bp, bq, j, bv, vj: jrbd.frame_kinematics(
        jm, bp, bq, j, bv, vj))(jnp.asarray(s["base_pos"]),
                                jnp.asarray(s["q"]), jnp.asarray(s["qj"]),
                                jnp.asarray(s["v"][:, 0:6]),
                                jnp.asarray(s["v"][:, 6:]))
    got = trbd.frame_kinematics(tm, _t(s["base_pos"]), _t(s["q"]),
                                _t(s["qj"]), _t(s["v"][:, 0:6]),
                                _t(s["v"][:, 6:]))
    for f in want._fields:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=TOL,
                                   err_msg=f)


def _lane_qj(qj, mod):
    x = qj.reshape(-1, 4, 3)
    return (torch.as_tensor(x).permute(1, 2, 0) if mod is trl
            else jnp.transpose(jnp.asarray(x), (1, 2, 0)))


def _vec(x, mod):
    return [(_t(x[:, i]) if mod is trl else jnp.asarray(x[:, i]))
            for i in range(x.shape[1])]


def _cmp(a, b):
    """Compare nested lists / tensors / numbers from the two packages."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _cmp(x, y)
        return
    np.testing.assert_allclose(
        np.broadcast_to(_np(a), np.broadcast_shapes(np.shape(_np(a)),
                                                     np.shape(np.asarray(b)))),
        np.broadcast_to(np.asarray(b), np.broadcast_shapes(
            np.shape(_np(a)), np.shape(np.asarray(b)))), atol=TOL)


def _lane_call(name, mod, lane, s):
    R0 = mod.quat_to_mat(_vec(s["q"], mod))
    qj = _lane_qj(s["qj"], mod)
    vj = _lane_qj(s["v"][:, 6:], mod)
    bv = (_vec(s["v"][:, 0:3], mod), _vec(s["v"][:, 3:6], mod))
    bp = _vec(s["base_pos"], mod)
    if name == "frame_kinematics":
        k = mod.frame_kinematics(lane, bp, R0, qj, bv, vj)
        return [k.pos, k.vel, k.drift, k.omega]
    if name == "frame_kinematics_fixed":
        k = mod.frame_kinematics(lane, mod.ZV3, mod.EYE3, qj, None, vj)
        return [k.pos, k.vel, k.drift]
    if name == "foot_jacobians":
        k = mod.frame_kinematics(lane, bp, R0, qj, None, vj)
        return list(mod.foot_jacobians(lane, k, R0, bp))
    a = (_vec(s["a"][:, 0:3], mod), _vec(s["a"][:, 3:6], mod),
         _lane_qj(s["a"][:, 6:], mod))
    if name == "rnea":
        return list(mod.rnea(lane, R0, qj, bv + (vj,), a))
    if name == "nonlinear_effects":
        return list(mod.nonlinear_effects(lane, R0, qj, bv + (vj,)))
    blocks = mod.crba(lane, qj)
    if name == "crba":
        return list(blocks)
    rhs = s["a"]
    return list(mod.forward_dynamics(blocks, _vec(rhs[:, 0:6], mod),
                                     _lane_qj(rhs[:, 6:], mod)))


@pytest.mark.parametrize("name", ["frame_kinematics",
                                  "frame_kinematics_fixed",
                                  "foot_jacobians", "rnea",
                                  "nonlinear_effects", "crba",
                                  "forward_dynamics"])
def test_rbd_lane_parity(states, lanes, name):
    jl, tl = lanes
    want = _lane_call(name, jrl, jl, states)
    got = _lane_call(name, trl, tl, states)
    _cmp(got, want)
