"""Parity of the port's phase solver stack with qrw_tpu.

ops/qp_phase (structural cone products, torque slabs, matrix-free H x,
the plain solver against the Pallas kernel run in interpret mode) and
core/mpc_lane (phase data, the batched warm solve). Inputs are made
with numpy from a seed and handed to both packages. The trot phase
structure is built once per module in each package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import mpc_lane as jml
from qrw_tpu.ops import qp_phase as jqp
from qrw_tpu_torch import convert
from qrw_tpu_torch.core import mpc_lane as tml
from qrw_tpu_torch.ops import qp_phase as tqp

torch.set_num_threads(1)

CFG = Config()
N = CFG.n_steps
CAP = 2 * N


@pytest.fixture(scope="module")
def jps():
    return jml.build_phase_data(CFG, jml.trot_phase_fsteps(CFG))


@pytest.fixture(scope="module")
def tps():
    return tml.build_phase_data(CFG, tml.trot_phase_fsteps(CFG),
                                device="cpu")


def _batch(phases, per_phase, seed=0, vmax=0.6):
    """The phase-sorted trot batch of tests/test_mpc_lane.py."""
    rng = np.random.default_rng(seed)
    phase_fs = jml.trot_phase_fsteps(CFG)
    B = len(phases) * per_phase
    xrefs = np.zeros((12, N + 1, B), np.float32)
    xrefs[2, :, :] = CFG.h_ref
    xrefs[:, 0, :] += rng.normal(scale=0.02, size=(12, B)).astype(np.float32)
    xrefs[6, 1:, :] = rng.uniform(0, vmax, B).astype(np.float32)
    fsteps = np.zeros((CFG.N_gait, 12, B), np.float32)
    for i, p in enumerate(phases):
        fsteps[:, :, i * per_phase:(i + 1) * per_phase] = \
            phase_fs[p][:, :, None]
    return xrefs, fsteps


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("fn", ["a_apply", "at_apply", "tor_slabs",
                                "time_coupling"])
def test_structural_ops_parity(fn):
    """Pure index/sign arithmetic: float64 agrees to round-off."""
    rng = np.random.default_rng(1)
    if fn == "a_apply":
        x = rng.normal(size=(3 * CAP, 5))
        want = jqp.a_apply(jnp.asarray(x), CAP, CFG.mu)
        got = tqp.a_apply(torch.as_tensor(x), CAP, CFG.mu)
    elif fn == "at_apply":
        y = rng.normal(size=(5 * CAP, 5))
        want = jqp.at_apply(jnp.asarray(y), CAP, CFG.mu)
        got = tqp.at_apply(torch.as_tensor(y), CAP, CFG.mu)
    elif fn == "tor_slabs":
        b = rng.normal(size=(6, 3 * CAP, 5))
        want = jqp.tor_slabs(jnp.asarray(b))
        got = tqp.tor_slabs(torch.as_tensor(b))
    else:
        want = np.stack(jqp.time_coupling(N))
        got = torch.as_tensor(np.stack(tqp.time_coupling(N)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_build_phase_data_parity(jps, tps):
    """Slot maps and supports are exact. The metric inverse comes from
    float32 builds of the nominal H in each package (different op order,
    ~1e-7 relative) pushed through a float64 inverse whose condition
    number is ~1e3-1e4; measured 7e-7 of its largest entry, held to
    1e-5. The Gram matrices are integer-valued sums, exact in float32."""
    np.testing.assert_array_equal(_np(tps.onehot2), jps.onehot2)
    np.testing.assert_array_equal(_np(tps.supports), jps.supports)
    np.testing.assert_array_equal(_np(tps.data.onehot),
                                  np.asarray(jps.data.onehot))
    assert tps.cap == jps.cap
    assert abs(tps.c_scale - jps.c_scale) <= 1e-6 * abs(jps.c_scale)
    K = np.asarray(jps.data.Kbar_inv)
    np.testing.assert_allclose(_np(tps.data.Kbar_inv), K, rtol=0,
                               atol=1e-5 * np.abs(K).max())
    for f in ("G1", "G2", "l", "u", "A"):
        np.testing.assert_array_equal(_np(getattr(tps.data, f)),
                                      np.asarray(getattr(jps.data, f)))
    for f in ("wtop", "wbot"):
        np.testing.assert_allclose(_np(getattr(tps.data, f)),
                                   np.asarray(getattr(jps.data, f)),
                                   rtol=1e-6)
    for f in ("w_force", "dt", "rho", "sigma", "alpha", "mu", "dt_m"):
        assert abs(getattr(tps.data, f) - getattr(jps.data, f)) <= \
            1e-6 * abs(getattr(jps.data, f)), f


@pytest.mark.parametrize("case", ["cone_matrix", "build_qp_reduced",
                                  "gait_phase_fsteps-trot",
                                  "gait_phase_fsteps-walk",
                                  "gait_phase_fsteps-bounding",
                                  "gait_phase_fsteps-static"])
def test_mpc_builders_parity(case):
    """The host-side builders behind build_phase_data. The cone matrix
    and the nominal phase footsteps are exact; the reduced QP is built
    in float64 in both packages from one seeded reference and a
    perturbed trot footstep set: same formula, different op order,
    held to 1e-10 of each array's largest entry."""
    from qrw_tpu.core import mpc as jmpc
    from qrw_tpu_torch.core import mpc as tmpc
    if case == "cone_matrix":
        np.testing.assert_array_equal(tmpc.cone_matrix(N, CFG.mu),
                                      jmpc.cone_matrix(N, CFG.mu))
    elif case == "build_qp_reduced":
        rng = np.random.default_rng(4)
        xref = np.zeros((12, N + 1))
        xref[2] = CFG.h_ref
        xref += rng.normal(scale=0.05, size=xref.shape)
        fs = jml.trot_phase_fsteps(CFG)[3].astype(np.float64)
        fs = np.where(fs != 0, fs + rng.normal(scale=0.01, size=fs.shape),
                      0.0)
        want = jmpc.build_qp_reduced(CFG, jnp.asarray(xref),
                                     jnp.asarray(fs), CAP)
        got = tmpc.build_qp_reduced(CFG, torch.as_tensor(xref),
                                    torch.as_tensor(fs), CAP)
        for name, g, w in zip(["H_r", "q_r", "Bl", "h", "idx", "valid"],
                              got, want):
            w = np.asarray(w)
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(_np(g), w, err_msg=name)
            else:
                np.testing.assert_allclose(
                    _np(g), w, rtol=0, atol=1e-10 * np.abs(w).max(),
                    err_msg=name)
    else:
        kind = case.split("-")[1]
        np.testing.assert_array_equal(tml.gait_phase_fsteps(CFG, kind),
                                      jml.gait_phase_fsteps(CFG, kind))


def _problem(tps, phases, per_phase, seed=0):
    """q (n, B) and BlS (6, n, B) of a phase-sorted batch, float32
    numpy, built by the port's assembly (held against the JAX pipeline
    end to end by test_solve_mpc_batch_phase_parity)."""
    xrefs, fsteps = _batch(phases, per_phase, seed=seed)
    tile = per_phase
    phases_of = np.asarray(phases)
    _, _, _, BlS, q_r, _ = tml.phase_problem(
        CFG, torch.as_tensor(xrefs), torch.as_tensor(fsteps), tps,
        phases_of, tile)
    return _np(q_r), _np(BlS), phases_of, tile


def test_hx_matfree_parity(jps, tps):
    """float32 on both sides (the JAX product accumulates in f32 at
    HIGHEST precision): a few ulps of the largest entry."""
    q, BlS, phases_of, tile = _problem(tps, [0, 5], 2)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3 * CAP, 2)).astype(np.float32)
    p = 5
    want = jqp.hx_matfree(jnp.asarray(x), jqp.tor_slabs(jnp.asarray(
        BlS[..., 2:4])), jps.data.G1[p], jps.data.G2[p], jps.data)
    got = tqp.hx_matfree(torch.as_tensor(x), tqp.tor_slabs(
        torch.as_tensor(BlS[..., 2:4])), tps.data.G1[p], tps.data.G2[p],
        tps.data)
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("stop_at_eps", [False, True])
def test_solve_plain_matches_pallas(jps, tps, warm, stop_at_eps):
    """Two phases x two problems, tile 2, against the Pallas kernel in
    interpret mode. converged / iters are equal. Both sides run the same
    float32 update equations with a different summation order in the
    dense products. The iteration is contractive, so that rounding
    difference does not grow: measured at most 2e-6 of each array's
    largest entry after 300 iterations; held to 1e-4 (forces of order
    10 N: 1e-3 N, ten times below the 1e-4-relative termination
    tolerance)."""
    q, BlS, phases_of, tile = _problem(tps, [0, 5], 2, seed=3)
    kw = dict(n_iters=300, tile=tile, stop_at_eps=stop_at_eps)
    x0 = y0 = None
    if warm:
        cold = jqp.solve(jnp.asarray(q), jnp.asarray(BlS), jps.data,
                         phases_of, interpret=True, **kw)
        x0 = np.asarray(cold.x) * 0.9
        y0 = np.asarray(cold.y) * 0.9
    want = jqp.solve(jnp.asarray(q), jnp.asarray(BlS), jps.data, phases_of,
                     x0=None if x0 is None else jnp.asarray(x0),
                     y0=None if y0 is None else jnp.asarray(y0),
                     interpret=True, **kw)
    got = tqp.solve_plain(torch.as_tensor(q), torch.as_tensor(BlS),
                          tps.data, phases_of,
                          x0=None if x0 is None else torch.as_tensor(x0),
                          y0=None if y0 is None else torch.as_tensor(y0),
                          **kw)
    np.testing.assert_array_equal(_np(got.converged),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(_np(got.iters), np.asarray(want.iters))
    for f in ("x", "y", "z"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(_np(getattr(got, f)), w, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=f)
    # the dispatcher takes the plain version for CPU tensors
    again = tqp.solve(torch.as_tensor(q), torch.as_tensor(BlS), tps.data,
                      phases_of,
                      x0=None if x0 is None else torch.as_tensor(x0),
                      y0=None if y0 is None else torch.as_tensor(y0), **kw)
    np.testing.assert_array_equal(_np(again.x), _np(got.x))


def test_solve_mpc_batch_phase_parity(jps, tps):
    """Warm, shifted solve of the full lane pipeline (assembly, warm
    extraction, solve, support guard, fallback, state recovery), with
    the cold state of the JAX package carried across. Same float32
    tolerance reasoning as above; the predicted states inherit it."""
    xrefs, fsteps = _batch([0, 5], 2, vmax=0.5)
    phases_of = np.array([0, 5])
    _, st, _ = jml.solve_mpc_batch_phase(
        CFG, jnp.asarray(xrefs), jnp.asarray(fsteps), jps, phases_of,
        n_iters=300, tile=2, interpret=True)
    phases2 = (phases_of - 1) % N
    phase_fs = jml.trot_phase_fsteps(CFG)
    fsteps2 = np.stack([phase_fs[phases2[b // 2]] for b in range(4)], -1)
    xrefs2 = xrefs.copy()
    xrefs2[:, 0, :] += 0.002
    x_f, st2, sol = jml.solve_mpc_batch_phase(
        CFG, jnp.asarray(xrefs2), jnp.asarray(fsteps2), jps, phases2,
        state=st, shift=True, n_iters=300, tile=2, interpret=True)
    st_t = convert.to_torch(jax.tree.map(np.asarray, st))
    tx_f, tst2, tsol = tml.solve_mpc_batch_phase(
        CFG, torch.as_tensor(xrefs2), torch.as_tensor(fsteps2), tps,
        phases2, state=st_t, shift=True, n_iters=300, tile=2)
    np.testing.assert_array_equal(_np(tsol.converged),
                                  np.asarray(sol.converged))
    np.testing.assert_array_equal(_np(tsol.iters), np.asarray(sol.iters))
    for name, a, b in [("x_f", tx_f, x_f), ("f", tst2.f, st2.f),
                       ("y", tst2.y, st2.y), ("rrho", tst2.rrho, st2.rrho),
                       ("sol.x", tsol.x, sol.x), ("sol.y", tsol.y, sol.y),
                       ("sol.z", tsol.z, sol.z)]:
        w = np.asarray(b)
        np.testing.assert_allclose(_np(a), w, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
