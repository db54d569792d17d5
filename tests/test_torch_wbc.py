"""Parity of the port's per-robot whole-body controller
(core/wbc.compute_wbc) with qrw_tpu's, in float64.

Four robots with seeded joint configurations, base twists, joint
rates, MPC forces, contact patterns (all four feet down, two, one, none)
and foot references go through the port along a leading batch axis and
through qrw_tpu's compute_wbc under jax.vmap, twice: the second call
warm-starts the box QP from the first call's state (as every tick
does). Each WBCResult leaf is held to 1e-9 of its scale (measured:
1e-14 on torques; the box QP stops at its 1e-5 tolerance, at the same
iteration on every robot in both packages) and the QP's iteration
counts must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import wbc as jw
from qrw_tpu.models.solo12 import make_solo12
from qrw_tpu.ops import rbd as jr
from qrw_tpu_torch import convert
from qrw_tpu_torch.core import wbc as tw
from qrw_tpu_torch.models import solo12 as tsolo
from qrw_tpu_torch.ops import rbd as tr
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
B = 4
REL = 1e-9


def _inputs(rng):
    qj = np.asarray(CFG.q_init) + rng.normal(scale=0.1, size=(B, 12))
    b_v = rng.normal(scale=0.3, size=(B, 18))
    f_cmd = np.tile([0.0, 0.0, CFG.mass * CFG.gravity / 4], 4) \
        + rng.normal(scale=1.0, size=(B, 12))
    contacts = np.array([[1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 0, 0],
                         [0, 0, 0, 0]], float)
    sh = make_solo12().shoulders
    pg = sh[None] + np.array([0, 0, -0.22])[None, :, None] \
        + rng.normal(scale=0.02, size=(B, 3, 4))
    vg = rng.normal(scale=0.2, size=(B, 3, 4))
    ag = rng.normal(scale=1.0, size=(B, 3, 4))
    return [qj, b_v, f_cmd, contacts, pg, vg, ag]


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(5)
    jm = jr.to_jax(make_solo12())
    tm = tr.to_torch(tsolo.make_solo12())
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                       jw.init_wbc_state(jnp.float64))
    jfn = jax.jit(jax.vmap(lambda st, *a: jw.compute_wbc(CFG, jm, st, *a)))
    tst = convert.to_torch(jax.tree.map(np.asarray, jst))
    out = []
    for _ in range(2):
        inp = _inputs(rng)
        want = jax.tree.map(np.asarray, jfn(jst, *[jnp.asarray(a)
                                                   for a in inp]))
        got = tw.compute_wbc(CFG, tm, tst, *[torch.as_tensor(a)
                                             for a in inp])
        out.append((got, want))
        jst = jax.tree.map(jnp.asarray, want.state)
        tst = convert.to_torch(want.state)
    return out


FIELDS = ["qdes", "vdes", "tau_ff", "f_with_delta", "ddq_cmd", "feet_pos",
          "feet_vel", "state.k_since_contact", "state.qp_x", "state.qp_y"]


@pytest.mark.parametrize("call", [0, 1])
@pytest.mark.parametrize("field", FIELDS)
def test_compute_wbc_parity(runs, call, field):
    got, want = runs[call]
    g, w = got, want
    for part in field.split("."):
        g, w = getattr(g, part), getattr(w, part)
    assert g.shape == w.shape
    np.testing.assert_allclose(g.numpy(), w, rtol=0,
                               atol=REL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("call", [0, 1])
def test_box_qp_iterations(runs, call):
    got, want = runs[call]
    np.testing.assert_array_equal(got.qp_iters.numpy(), want.qp_iters)
    assert (want.qp_iters < CFG.wbc_max_iter).all()
    if call == 1:       # the warm start helps
        assert (want.qp_iters <= runs[0][1].qp_iters).any()


def test_base_inertia_diag_equals_jax():
    np.testing.assert_allclose(tw.base_inertia_diag(),
                               jw.base_inertia_diag(), rtol=1e-12)
