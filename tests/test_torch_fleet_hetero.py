"""The heterogeneous fleet against qrw_tpu: gaits {trot, walk, bounding}
per tile over a union phase set at cap 48, velocity profiles and
terrains per robot, the complementary-filter estimator in the loop.

make_hetero_fleet is held against qrw_tpu's at B = 6, tile 1 (the
settings of tests/test_fleet_hetero.py); the phase-set helpers on seeded
synthetic captures; the velocity schedule exactly. The slice as a whole:
JAX builds the fleet, its carry and terrain go to the port through
qrw_tpu_torch.convert, and both packages run one full cycle and one
crippled cycle (a 1-iteration phase solve, so every lane fails it) with
rescue_cap = 2: the rescue re-solves two lanes at n = 144, m = 240 (K2's
reduced cone at cap 48; its plain version here, the Pallas kernel in
interpret mode there) and the other four ship their stale plan. The
phase solves are K1 at cap 48 (its plain version here; JAX's plain path,
use_ref). stop_at_eps is off on both sides (tests/test_torch_fleet.py
says why).

Tolerances, as tests/test_torch_fleet_rescue.py sets them: float32 on
both sides, same equations, different op order and each package's own
Cholesky of the rescue's K. Measured: full cycle 7e-9 m on base
positions, 8.5e-5 N on the consumed plan forces (of 13 N), 1.1e-5 N m on
torques, 1.0e-5 of scale on the carry; crippled cycle 4.5e-8 m,
7.6e-4 N (of 17 N), 5.2e-5 N m, 4.3e-5 of scale, the rescue's rho
1.0-1.15x. Positions and quaternions are held to 1e-5, forces, torques
and the carry to 1e-3 of their scale, the WBC dual `.wbc.qp_y` to 3e-3
(float32 rounding carried through the rescue, as measured there) and
the rescue's adapted rho within a factor 2; every integer and boolean is
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import mpc_lane as jml
from qrw_tpu.sim import fleet as jfl
from qrw_tpu_torch import convert
from qrw_tpu_torch.core import mpc_lane as tml
from qrw_tpu_torch.sim import fleet as tfl
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
N = CFG.n_steps
B = 6
KW = dict(gaits=("trot", "walk", "bounding"), velIDs=(0, 2),
          terrain_ids=(0, 1), seed=3)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def built():
    jout = jfl.make_hetero_fleet(CFG, B, tile=1, **KW)
    tout = tfl.make_hetero_fleet(CFG, B, tile=1, device="cpu", **KW)
    return jout, tout


def test_hetero_meta_equal(built):
    (*_, jmeta), (*_, tmeta) = built
    assert tmeta._fields == jmeta._fields
    assert tmeta.gait_names == jmeta.gait_names
    for f in jmeta._fields[1:]:
        np.testing.assert_array_equal(getattr(tmeta, f), getattr(jmeta, f),
                                      err_msg=f)


def test_union_phase_structure_equal(built):
    """The union set of the three gaits has cap 48 (walk's 3-stance
    rows): n = 144, m = 240. Supports and slot maps are exact; the metric
    inverses agree as tests/test_torch_qp_phase.py holds them (1e-5 of
    the largest entry)."""
    (_, _, jps, *_), (_, _, tps, *_) = built
    assert tps.cap == jps.cap == 48
    assert tuple(tps.data.Kbar_inv.shape) == (48, 144, 144)
    assert tuple(tps.data.A.shape) == (240, 144)
    np.testing.assert_array_equal(_np(tps.supports), jps.supports)
    np.testing.assert_array_equal(_np(tps.onehot2), jps.onehot2)
    K = np.asarray(jps.data.Kbar_inv)
    np.testing.assert_allclose(_np(tps.data.Kbar_inv), K, rtol=0,
                               atol=1e-5 * np.abs(K).max())
    for f in ("G1", "G2", "l", "u", "A"):
        np.testing.assert_array_equal(_np(getattr(tps.data, f)),
                                      np.asarray(getattr(jps.data, f)))


def test_initial_carry_equal(built):
    """Each tile starts at the phase of its rolled gait; each robot's
    base is raised onto its terrain; the controller states (per gait)
    are equal. The perturbations come from each package's own generator
    (ROADMAP queue 3) and are left out."""
    (_, jc, _, jter, _), (_, tc, _, tter, _) = built
    np.testing.assert_array_equal(_np(tc.tile_phase),
                                  np.asarray(jc.tile_phase))
    np.testing.assert_array_equal(_np(tc.sim_states.q[:, :7]),
                                  np.asarray(jc.sim_states.q[:, :7]))
    assert (np.asarray(jc.sim_states.q[:, 2])[np.asarray(jter.tid) == 1]
            != np.asarray(jc.sim_states.q[0, 2])).all()
    got = convert.to_numpy(tc.ctl_states, like=jc.ctl_states)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jc.ctl_states)):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(_np(tter.tid), np.asarray(jter.tid))
    for t, j in zip(tter.terrains, jter.terrains):
        np.testing.assert_array_equal(_np(t.heights), np.asarray(j.heights))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hetero_v_ref_schedule_equal(dtype):
    velID = np.array([0, 2, 5, 6, 2, 1])
    want = jfl.hetero_v_ref_schedule(CFG, velID, 400, getattr(jnp, dtype))
    got = tfl.hetero_v_ref_schedule(CFG, velID, 400, getattr(torch, dtype),
                                    device="cpu")
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-6 if dtype == "float32" else 1e-12)


def _captures(seed, n):
    """Seeded synthetic captures: bounding windows at random offsets with
    footholds scattered around the nominal ones, and pacing windows no
    bounding class matches."""
    rng = np.random.default_rng(seed)
    bd = jml.gait_phase_fsteps(CFG, "bounding")
    pc = jml.gait_phase_fsteps(CFG, "pacing")
    pick = np.concatenate([bd[rng.integers(0, len(bd), n)],
                           pc[rng.integers(0, len(pc), 3)]])
    noise = rng.normal(scale=0.03, size=pick.shape).astype(np.float32)
    return np.where(pick != 0, pick + noise, 0.0).astype(np.float32)


@pytest.mark.parametrize("case", ["calibrate", "union", "transition"])
def test_phase_set_helpers_equal(case):
    if case == "calibrate":
        for seed in (0, 1):
            cap = _captures(seed, 11)
            base = jml.gait_phase_fsteps(CFG, "bounding")
            np.testing.assert_array_equal(
                tml.calibrate_phase_fsteps(CFG, base, cap),
                jml.calibrate_phase_fsteps(CFG, base, cap))
    elif case == "union":
        sets = [jml.gait_phase_fsteps(CFG, g)
                for g in ("trot", "walk", "pacing", "trot")]
        sets.append(jml.transition_phase_fsteps(CFG, "trot", "walk"))
        want = jml.union_phase_fsteps(CFG, sets)
        np.testing.assert_array_equal(tml.union_phase_fsteps(CFG, sets),
                                      want)
        ps = tml.build_phase_data(CFG, want, device="cpu")
        assert ps.cap == 48
    else:
        for a, b in [("trot", "walk"), ("walk", "bounding"),
                     ("pacing", "trot")]:
            np.testing.assert_array_equal(
                tml.transition_phase_fsteps(CFG, a, b),
                jml.transition_phase_fsteps(CFG, a, b))


@pytest.fixture(scope="module")
def runs(built):
    (jctl, jcarry, jps, jter, meta), (tctl, _, tps, _, _) = built
    C = 2
    sched = np.array(jfl.hetero_v_ref_schedule(CFG, meta.velID,
                                               C * CFG.k_mpc))
    kw = dict(tile=1, rescue_cap=2, perfect_estimator=False,
              stop_at_eps=False, phase_offsets=meta.phase_offsets,
              phase_periods=meta.phase_periods)
    T = CFG.k_mpc

    def jrun(c, s, n_iters):
        return jfl.fleet_rollout(jctl, c, 1, jps, n_iters=n_iters,
                                 terrain=jter, use_ref=True, interpret=True,
                                 v_ref_schedule=s, **kw)
    j1 = jax.jit(lambda c, s: jrun(c, s, 300))(jcarry, sched[:T])
    j2 = jax.jit(lambda c, s: jrun(c, s, 1))(j1[0], sched[T:])
    tter = convert.to_torch(jax.tree.map(np.asarray, jter))
    tcarry = convert.to_torch(jax.tree.map(np.asarray, jcarry))
    trun = lambda c, s, n_iters: tfl.fleet_rollout(
        tctl, c, 1, tps, n_iters=n_iters, terrain=tter,
        v_ref_schedule=torch.as_tensor(s), **kw)
    t1 = trun(tcarry, sched[:T], 300)
    t2 = trun(t1[0], sched[T:], 1)
    to_np = lambda o: jax.tree.map(np.asarray, o)
    return [(t1, to_np(j1)), (t2, to_np(j2))]


def _scale_tol(w, rel):
    return rel * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("cycle", [0, 1])
@pytest.mark.parametrize("field,rel", [("base_pos", 1e-5),
                                       ("base_quat", 1e-5),
                                       ("f_mpc", 1e-3), ("tau_ff", 1e-3),
                                       ("error", 0)])
def test_hetero_fleet_log_parity(runs, cycle, field, rel):
    (_, tlog, _), (_, jlog, _) = runs[cycle]
    w = getattr(jlog, field)
    g = _np(getattr(tlog, field))
    assert g.shape == w.shape == (CFG.k_mpc, B) + w.shape[2:]
    if rel == 0:
        np.testing.assert_array_equal(g, w)
        assert not w.any(), "no robot may latch its security stop"
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=_scale_tol(w, rel))


@pytest.mark.parametrize("cycle", [0, 1])
def test_hetero_fleet_cycle_log_parity(runs, cycle):
    """The full cycle converges every lane; in the crippled one every
    lane fails the phase solve and the rescue brings back two."""
    (_, _, tcyc), (_, _, jcyc) = runs[cycle]
    np.testing.assert_array_equal(_np(tcyc.converged), jcyc.converged)
    np.testing.assert_array_equal(_np(tcyc.iters), jcyc.iters)
    np.testing.assert_array_equal(_np(tcyc.phase), jcyc.phase)
    if cycle == 0:
        assert jcyc.converged.all()
        np.testing.assert_array_equal(_np(tcyc.rescued), [0])
    else:
        assert jcyc.converged.sum() == 2
        np.testing.assert_array_equal(_np(tcyc.rescued), [2])


@pytest.mark.parametrize("cycle", [0, 1])
def test_hetero_fleet_carry_parity(runs, cycle):
    (tcarry, _, _), (jcarry, _, _) = runs[cycle]
    got = convert.to_numpy(tcarry, like=jcarry)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jcarry)]
    flat_g = jax.tree_util.tree_leaves(got)
    flat_w = jax.tree_util.tree_leaves(jcarry)
    assert len(flat_g) == len(flat_w)
    for path, g, w in zip(paths, flat_g, flat_w):
        assert g.shape == w.shape, path
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=path)
        elif path.endswith(".rrho"):
            ratio = g / w
            assert (ratio > 0.5).all() and (ratio < 2.0).all(), ratio
        elif path.endswith(".wbc.qp_y"):
            np.testing.assert_allclose(g, w, rtol=0, atol=3e-3,
                                       err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=_scale_tol(w, 1e-3),
                                       err_msg=path)
