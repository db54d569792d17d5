"""The slice as a whole with its rescue stage: the closed-loop trot fleet
against qrw_tpu through cycles in which every lane needs the rescue.

JAX builds the fleet (B = 4, tile 1, seed 0) and its carry goes to the
port through qrw_tpu_torch.convert. Each package then runs two crippled
cycles (a 1-iteration phase solve, so every lane fails it) with
rescue_cap = B, under per-robot velocity commands (v_ref_schedule) and
world-frame pushes on the base (f_ext_schedule): the first from the
fleet's zero warm carry (cold-restart lanes), the second from the
rescued carry (lanes with a live stale plan, warm-started, early exit).
JAX runs its plain phase path (use_ref) and its Pallas rescue kernel in
interpret mode; the port runs on CPU tensors (the plain versions).
stop_at_eps is off on both sides (tests/test_torch_fleet.py says why).

Tolerances: float32 on both sides, same equations, different op order
and each package's own Cholesky of the rescue's K (condition ~1e7).
Measured: 7e-8 m on base positions, 9e-4 N on the consumed plan forces
(of 23 N), 7e-5 N m on torques. Positions and quaternions are held to
1e-5, forces, torques and the carry to 1e-3 of their scale. The rescue's
adapted rho (the carry's rrho) is set by primal residuals at the float32
round-off floor (tests/test_torch_qp_pallas.py) and is held within a
factor 2; every other integer or boolean is equal.

One leaf has its own tolerance: the WBC box-QP's dual `.wbc.qp_y` after
the second rescued cycle (scale 0.81) is held to 5e-3, 2.5x qrw_tpu's
own float32 spread on it. The numbers come from
tests/torch_rescue_rounding.py (CPU, one thread, x64 on as in these
tests):
  * `spread 32`: 32 runs, each from the fleet's carry with the
    simulator's q and v moved by about one float32 ulp (run 0 unmoved),
    the same carry for both packages. Over the 496 pairs of runs qrw_tpu's
    qp_y differs from itself by up to 2.0e-3 and the port's by up to
    2.3e-3; the plan forces by 1.1e-3 N and 1.2e-3 N (of 23 N). The two
    packages are equally sensitive: the rescue's K (condition ~1e7) turns
    a 1e-6 difference of the state into a 1e-3 N one of the plan forces,
    and the WBC's warm-started ADMM dual follows them. Port against
    qrw_tpu from the same carry: qp_y 1.0e-3 apart in run 0 (this
    test's case), 9.7e-4 in the median run, 2.6e-3 at most and 4.1e-5
    at least, so no systematic difference above 4.1e-5 hides in the
    gap. With x64 off, qrw_tpu's own float32 run moves so that run 0's
    gap is 1.8e-3.
  * `f64`: from the same float64 carry (every stage but the MPC, which
    is float32 in both packages by design, in float64) the packages'
    qp_y differ by 2.0e-4; each package's float32 against its float64
    run moves qp_y by 1.2e-4 (qrw_tpu) and 9.3e-4 (the port), two single
    draws of the spread above.
The gap is float32 rounding carried through the rescue, not a formula
difference, and it lies over the 1e-3 bar every other leaf keeps (of
its scale) in 16 of the 32 runs.
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
B = 4
T = CFG.k_mpc           # one cycle per call


def _schedules():
    rng = np.random.default_rng(5)
    v_ref = np.zeros((T, B, 6), np.float32)
    v_ref[:, :, 0] = rng.uniform(0.0, 0.3, B)
    v_ref[:, :, 5] = rng.uniform(-0.2, 0.2, B)
    f_ext = rng.normal(scale=3.0, size=(T, B, 3)).astype(np.float32)
    return v_ref, f_ext


@pytest.fixture(scope="module")
def setup():
    v_ref, f_ext = _schedules()
    jps = jml.build_phase_data(CFG, jml.trot_phase_fsteps(CFG))
    jctl, jcarry = jfl.make_fleet(CFG, B, jps, tile=1, seed=0)
    tps = tml.build_phase_data(CFG, tml.trot_phase_fsteps(CFG),
                               device="cpu")
    tcarry = convert.to_torch(jax.tree.map(np.asarray, jcarry))
    return jctl, jcarry, jps, tfl.make_controller(CFG), tcarry, tps, \
        v_ref, f_ext


def _port_cycle(tctl, carry, tps, **kw):
    return tfl.fleet_rollout(tctl, carry, 1, tps, tile=1, n_iters=1,
                             rescue_cap=B, stop_at_eps=False, **kw)


@pytest.fixture(scope="module")
def runs(setup):
    jctl, jcarry, jps, tctl, tcarry, tps, v_ref, f_ext = setup
    crippled = jax.jit(lambda c: jfl.fleet_rollout(
        jctl, c, 1, jps, tile=1, n_iters=1, rescue_cap=B, use_ref=True,
        interpret=True, stop_at_eps=False,
        v_ref_schedule=jnp.asarray(v_ref),
        f_ext_schedule=jnp.asarray(f_ext)))
    j1 = crippled(jcarry)
    j2 = crippled(j1[0])
    vt, ft = torch.as_tensor(v_ref), torch.as_tensor(f_ext)
    t1 = _port_cycle(tctl, tcarry, tps, v_ref_schedule=vt,
                     f_ext_schedule=ft)
    t2 = _port_cycle(tctl, t1[0], tps, v_ref_schedule=vt,
                     f_ext_schedule=ft)
    to_np = lambda o: jax.tree.map(np.asarray, o)
    return [(t1, to_np(j1)), (t2, to_np(j2))]


def _scale_tol(w, rel):
    return rel * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("cycle", [0, 1])
@pytest.mark.parametrize("field,rel", [("base_pos", 1e-5),
                                       ("base_quat", 1e-5),
                                       ("f_mpc", 1e-3), ("tau_ff", 1e-3),
                                       ("error", 0)])
def test_rescue_fleet_log_parity(runs, cycle, field, rel):
    (_, tlog, _), (_, jlog, _) = runs[cycle]
    w = getattr(jlog, field)
    g = getattr(tlog, field).numpy()
    assert g.shape == w.shape == (T, B) + w.shape[2:]
    if rel == 0:
        np.testing.assert_array_equal(g, w)
        assert not w.any(), "no robot may latch its security stop"
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=_scale_tol(w, rel))


@pytest.mark.parametrize("cycle", [0, 1])
def test_rescue_fleet_cycle_log_parity(runs, cycle):
    """Every lane fails the 1-iteration phase solve and every one comes
    back converged from the rescue, in both packages."""
    (_, _, tcyc), (_, _, jcyc) = runs[cycle]
    np.testing.assert_array_equal(tcyc.converged.numpy(), jcyc.converged)
    np.testing.assert_array_equal(tcyc.iters.numpy(), jcyc.iters)
    np.testing.assert_array_equal(tcyc.phase.numpy(), jcyc.phase)
    assert jcyc.converged.all()
    np.testing.assert_array_equal(tcyc.rescued.numpy(), [B])


@pytest.mark.parametrize("cycle", [0, 1])
def test_rescue_fleet_carry_parity(runs, cycle):
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
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-3,
                                       err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=_scale_tol(w, 1e-3),
                                       err_msg=path)


def test_shared_v_ref_schedule_and_no_logs(setup, runs):
    """A shared (T, 6) command schedule is the per-robot one broadcast,
    and with_logs=False returns no tick log and the same carry."""
    _, _, _, tctl, tcarry, tps, v_ref, f_ext = setup
    shared = np.repeat(v_ref[:, :1, :], B, axis=1)
    ft = torch.as_tensor(f_ext)
    a = _port_cycle(tctl, tcarry, tps,
                    v_ref_schedule=torch.as_tensor(shared[:, 0]),
                    f_ext_schedule=ft)
    b = _port_cycle(tctl, tcarry, tps,
                    v_ref_schedule=torch.as_tensor(shared),
                    f_ext_schedule=ft, with_logs=False)
    assert b[1] is None
    np.testing.assert_array_equal(a[0].sim_states.q.numpy(),
                                  b[0].sim_states.q.numpy())
    np.testing.assert_array_equal(a[2].converged.numpy(),
                                  b[2].converged.numpy())
    # the commands reach the controller: a different schedule moves it
    (t1, _, _), _ = runs[0]
    assert not np.array_equal(a[0].sim_states.q.numpy(),
                              t1.sim_states.q.numpy())
