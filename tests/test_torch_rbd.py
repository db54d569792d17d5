"""Parity of the port's batch-major rigid-body dynamics (ops/rbd) with
qrw_tpu's, in float64.

Three seeded configurations (base position and unit quaternion, joint
angles, generalized velocities and accelerations) go through the port
along a leading batch axis and through qrw_tpu's per-robot functions
under jax.vmap: fk_world, frame_kinematics, foot_jacobians (with and
without the shared kinematic sweep), rnea, nonlinear_effects and crba;
one more case takes a single robot without a batch axis. Same
algorithm, different op order: tolerance 1e-12 of the result's scale
(measured: 1e-18 to 4e-15)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.models.solo12 import make_solo12
from qrw_tpu.ops import rbd as jr
from qrw_tpu_torch.models import solo12 as tsolo
from qrw_tpu_torch.ops import rbd as tr
from tests.torch_threads import single_thread

single_thread()

B = 3
REL = 1e-12
JM = jr.to_jax(make_solo12())
TM = tr.to_torch(tsolo.make_solo12())


def _inputs(seed):
    rng = np.random.default_rng(seed)
    bp = rng.normal(size=(B, 3))
    qt = rng.normal(size=(B, 4))
    qt /= np.linalg.norm(qt, axis=1, keepdims=True)
    return dict(bp=bp, qt=qt, qj=rng.normal(scale=0.5, size=(B, 12)),
                v=rng.normal(size=(B, 18)), a=rng.normal(size=(B, 18)))


CASES = {
    "fk_world": (lambda m, d: jr.fk_world(m, d["bp"], d["qt"], d["qj"]),
                 lambda m, d: tr.fk_world(m, d["bp"], d["qt"], d["qj"])),
    "frame_kinematics": (
        lambda m, d: tuple(jr.frame_kinematics(m, d["bp"], d["qt"], d["qj"],
                                               d["v"][..., :6],
                                               d["v"][..., 6:])),
        lambda m, d: tuple(tr.frame_kinematics(m, d["bp"], d["qt"], d["qj"],
                                               d["v"][..., :6],
                                               d["v"][..., 6:]))),
    "foot_jacobians": (
        lambda m, d: jr.foot_jacobians(m, d["bp"], d["qt"], d["qj"]),
        lambda m, d: tr.foot_jacobians(m, d["bp"], d["qt"], d["qj"])),
    "foot_jacobians_shared_fk": (
        lambda m, d: jr.foot_jacobians(
            m, d["bp"], d["qt"], d["qj"],
            fk=jr.fk_world(m, d["bp"], d["qt"], d["qj"])),
        lambda m, d: tr.foot_jacobians(
            m, d["bp"], d["qt"], d["qj"],
            fk=tr.fk_world(m, d["bp"], d["qt"], d["qj"]))),
    "rnea": (lambda m, d: jr.rnea(m, d["qt"], d["qj"], d["v"], d["a"]),
             lambda m, d: tr.rnea(m, d["qt"], d["qj"], d["v"], d["a"])),
    "nonlinear_effects": (
        lambda m, d: jr.nonlinear_effects(m, d["qt"], d["qj"], d["v"]),
        lambda m, d: tr.nonlinear_effects(m, d["qt"], d["qj"], d["v"])),
    "crba": (lambda m, d: jr.crba(m, d["qj"]),
             lambda m, d: tr.crba(m, d["qj"])),
}


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


def _check(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_against_vmap(name):
    jfn, tfn = CASES[name]
    d = _inputs(1)
    want = jax.vmap(lambda dd: jfn(JM, dd))(
        {k: jnp.asarray(v) for k, v in d.items()})
    got = tfn(TM, {k: torch.as_tensor(v) for k, v in d.items()})
    _check(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_single_robot(name):
    jfn, tfn = CASES[name]
    d = {k: v[0] for k, v in _inputs(2).items()}
    want = jfn(JM, {k: jnp.asarray(v) for k, v in d.items()})
    got = tfn(TM, {k: torch.as_tensor(v) for k, v in d.items()})
    _check(got, want)


def test_crba_is_the_mass_matrix():
    """M a = rnea(q, v, a) - rnea(q, v, 0): CRBA and RNEA agree."""
    d = {k: torch.as_tensor(v) for k, v in _inputs(3).items()}
    M = tr.crba(TM, d["qj"])
    lhs = (M @ d["a"][..., None])[..., 0]
    rhs = (tr.rnea(TM, d["qt"], d["qj"], d["v"], d["a"])
           - tr.nonlinear_effects(TM, d["qt"], d["qj"], d["v"]))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-12)
