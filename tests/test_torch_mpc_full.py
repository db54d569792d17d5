"""Parity of the port's full-size batched MPC path with qrw_tpu:
core/mpc's build_qp_compact, shift_warm_state and solve_mpc_batch_pallas
(cold, warm, warm after a gait roll, and the batch-1 rolled-stance chain
of tests/test_qp_pallas.py), the MPCBatchState conversion, and the entry
point qrw_tpu_torch.eval.kernel_profile with its copy of
bench.build_batch.

The JAX side runs its Pallas kernels in interpret mode; the port's side
runs on CPU tensors, i.e. the kernels' plain versions. Inputs come from
bench.build_batch (numpy, seeded) and are handed to both packages.

Tolerances (measured on the CPU in brackets):
* build_qp_compact in float64: every output within 1e-12 of its scale
  [2.8e-16: the same sums in another order].
* shift_warm_state: exact (rolls and a concatenation).
* solve_mpc_batch_pallas, cold: flags and iteration counts equal; x_f
  within 2e-4 of its scale (forces up to 25 N) [7.1e-5]: the cold solve
  adapts rho twice from primal residuals at the float32 round-off floor,
  so the two packages' rho differ by up to 1.41x (ROADMAP queue 3).
  Warm, from the JAX package's cold carry (the same inputs on both
  sides): flags and iteration counts equal, x_f within 1e-4 of its scale
  [2.2e-5 warm "stale", 4.4e-5 after a shift, "chol"], the carried
  K^-1 within 2e-4 of its scale [3.7e-5].
* the rolled-stance chain: each package on its own carry must stay
  finite and converge in at least 5 of the 6 cycles, as the JAX
  package's own test holds it [both converge in all 6].
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from qrw_tpu.config import Config
from qrw_tpu.core import mpc as jmpc
from qrw_tpu.ops import qp as jqp
from qrw_tpu_torch import convert
from qrw_tpu_torch.core import mpc as tmpc
from qrw_tpu_torch.eval import kernel_profile
from qrw_tpu_torch.ops import qp as tqp
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
N = CFG.n_steps
JST = jqp.QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=450,
                     adaptive_rho_interval=200)
TST = tqp.QPSettings(*JST)
B = 3


def _np(t):
    return t.detach().cpu().numpy()


def _batch(batch=B, seed=0):
    return bench.build_batch(CFG, batch, np.random.default_rng(seed))


def _close(got, want, rel, name=""):
    w = np.asarray(want)
    np.testing.assert_allclose(_np(got), w, rtol=0,
                               atol=rel * np.abs(w).max(), err_msg=name)


def test_build_batch_copy_equals_bench():
    """The entry point's numpy copy of bench.build_batch makes the same
    scenarios from the same seed."""
    for batch, seed in [(5, 0), (37, 4)]:
        want = bench.build_batch(CFG, batch, np.random.default_rng(seed))
        got = kernel_profile.build_batch(CFG, batch,
                                         np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("batched", [False, True])
def test_build_qp_compact_parity(batched):
    """H, qlin, l, u, Bl, h of one problem and of a batch, float64."""
    xr, fs = (a.astype(np.float64) for a in _batch())
    if batched:
        want = jax.vmap(lambda x, f: jmpc.build_qp_compact(CFG, x, f))(
            jnp.asarray(xr), jnp.asarray(fs))
        got = tmpc.build_qp_compact(CFG, torch.as_tensor(xr),
                                    torch.as_tensor(fs))
    else:
        want = jmpc.build_qp_compact(CFG, jnp.asarray(xr[1]),
                                     jnp.asarray(fs[1]))
        got = tmpc.build_qp_compact(CFG, torch.as_tensor(xr[1]),
                                    torch.as_tensor(fs[1]))
    for name, g, w in zip(["H", "qlin", "l", "u", "Bl", "h"], got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert g.dtype == torch.float64, name
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(_np(g)), fin, name)
        np.testing.assert_array_equal(_np(g)[~fin], w[~fin], name)
        np.testing.assert_allclose(_np(g)[fin], w[fin], rtol=0,
                                   atol=1e-12 * np.abs(w[fin]).max(),
                                   err_msg=name)


def _random_state(seed=5, batch=2):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    n, m = 12 * N, 32 * N
    return jmpc.MPCBatchState(
        f=f32(batch, n), y=f32(batch, m), rho=f32(batch, 1),
        D=f32(batch, n), E=f32(batch, m), c=f32(batch, 1),
        kinv=f32(batch, n, n), kinv_rho=f32(batch, 1))


def test_shift_warm_state_parity():
    """The gait-roll shift of the carry: f by 12, cone duals by 20,
    identity-row duals by 12, K^-1 by 12 on both axes; the rest kept."""
    st = _random_state()
    want = jmpc.shift_warm_state(jax.tree_util.tree_map(jnp.asarray, st), N)
    got = tmpc.shift_warm_state(convert.to_torch(st), N)
    assert type(got) is tmpc.MPCBatchState
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)


def test_convert_mpc_batch_state_both_ways():
    """A JAX carry, K^-1 included, converts to the port's MPCBatchState
    and back unchanged."""
    st = _random_state(seed=6)
    t = convert.to_torch(st)
    assert type(t) is tmpc.MPCBatchState
    assert t.kinv.shape == (2, 12 * N, 12 * N)
    back = convert.to_numpy(t, like=st)
    assert type(back) is jmpc.MPCBatchState
    for name, a, b in zip(st._fields, back, st):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def cold():
    """Both packages' cold full-size solves of B scenarios."""
    xr, fs = _batch()
    want = jmpc.solve_mpc_batch_pallas(CFG, jnp.asarray(xr),
                                       jnp.asarray(fs), settings=JST,
                                       tile=B, interpret=True)
    got = tmpc.solve_mpc_batch_pallas(CFG, torch.as_tensor(xr),
                                      torch.as_tensor(fs), settings=TST)
    return got, want


def test_solve_mpc_batch_pallas_cold_parity(cold):
    (xf_t, st_t, sol_t), (xf_j, st_j, sol_j) = cold
    assert xf_t.shape == (B, 24, N)
    np.testing.assert_array_equal(_np(sol_t.converged),
                                  np.asarray(sol_j.converged))
    np.testing.assert_array_equal(_np(sol_t.iters), np.asarray(sol_j.iters))
    assert np.asarray(sol_j.converged).all()
    _close(xf_t, xf_j, 2e-4, "x_f")
    assert type(st_t) is tmpc.MPCBatchState
    for name in ("D", "E", "c"):
        np.testing.assert_allclose(_np(getattr(st_t, name)),
                                   np.asarray(getattr(st_j, name)),
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("shift", [False, True])
def test_solve_mpc_batch_pallas_warm_parity(cold, shift):
    """A warm call from the JAX package's cold carry on the next cycle's
    scenarios (1 mm state shift): the default policy "stale" (K2 with
    refinement against K, K3's guard), or after a gait roll (fsteps one
    row on, carry shifted) the default "chol"."""
    _, st_j, _ = cold[1]
    xr, fs = _batch()
    xr[:, :, 0] += 0.001
    if shift:
        fs = np.ascontiguousarray(np.roll(fs, -1, axis=1))
    want = jmpc.solve_mpc_batch_pallas(CFG, jnp.asarray(xr),
                                       jnp.asarray(fs), state=st_j,
                                       settings=JST, tile=B, shift=shift,
                                       interpret=True)
    got = tmpc.solve_mpc_batch_pallas(CFG, torch.as_tensor(xr),
                                      torch.as_tensor(fs),
                                      state=convert.to_torch(st_j),
                                      settings=TST, shift=shift)
    (xf_t, st_t, sol_t), (xf_j, st2_j, sol_j) = got, want
    np.testing.assert_array_equal(_np(sol_t.converged),
                                  np.asarray(sol_j.converged))
    np.testing.assert_array_equal(_np(sol_t.iters), np.asarray(sol_j.iters))
    assert np.asarray(sol_j.converged).all()
    np.testing.assert_array_equal(np.asarray(sol_j.iters), 100)
    _close(xf_t, xf_j, 1e-4, "x_f")
    _close(st_t.kinv, st2_j.kinv, 2e-4, "kinv")
    np.testing.assert_array_equal(_np(st_t.kinv_rho),
                                  np.asarray(st2_j.kinv_rho))


def _chain(solve, to_in, C=6):
    """The batch-1 chain of tests/test_qp_pallas.py: C cycles whose
    stance pattern rolls one MPC step each, warm from the previous
    carry (schedule [100], default policy)."""
    xr, fs = bench.build_batch(CFG, C, np.random.default_rng(3))
    st, convs = None, []
    for i in range(C):
        kw = {} if st is None else dict(state=st, schedule=[100])
        x_f, st, sol = solve(to_in(xr[i:i + 1]), to_in(fs[i:i + 1]), **kw)
        assert np.isfinite(np.asarray(x_f)).all(), f"x_f not finite @{i}"
        assert np.isfinite(np.asarray(st.kinv)).all(), f"kinv not finite @{i}"
        convs.append(bool(np.asarray(sol.converged)[0]))
    return convs


def test_warm_chain_batch1_rolled_stance_stays_finite():
    """Both packages keep every cycle of the rolled-stance chain finite
    and converge in at least C - 1 of C cycles (the cold one included)."""
    C = 6
    want = _chain(lambda x, f, **kw: jmpc.solve_mpc_batch_pallas(
        CFG, x, f, settings=JST, tile=8, interpret=True, **kw),
        jnp.asarray, C)
    got = _chain(lambda x, f, **kw: tmpc.solve_mpc_batch_pallas(
        CFG, x, f, settings=TST, **kw), torch.as_tensor, C)
    for convs in (want, got):
        assert convs[0]
        assert sum(convs) >= C - 1, convs


def test_kernel_profile_cpu_prints_the_jax_tools_keys(capsys):
    """The entry point on the CPU (plain versions) prints one JSON dict
    with the keys of qrw_tpu/eval/kernel_profile.py (:89-110) for each
    --tiles label, plus the cold solve's conv; every time is positive
    and every conv a fraction."""
    res = kernel_profile.main(["--cpu", "--batch", "4", "--reps", "1",
                               "--tiles", "4"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == res
    runs = [f"tile4_{p}_{i}it" for p, i in (("ns", 50), ("ns", 1),
                                            ("chol", 50), ("stale", 50))]
    jax_keys = set(runs) | {"tile4_compile_s", "tile4_per_admm_iter_us",
                            "tile4_fixed_overhead_ms"}
    assert set(res) == jax_keys | {"tile4_cold_conv"}
    for k in runs:
        assert set(res[k]) == {"s_per_cycle", "solves_per_s", "conv"}
        assert res[k]["s_per_cycle"] > 0 and 0.0 <= res[k]["conv"] <= 1.0
    assert res["tile4_cold_conv"] == 1.0
    assert res["tile4_ns_50it"]["conv"] == 1.0
    assert kernel_profile.build_argparser().parse_args([]).cpu is False


def test_kernel_profile_needs_a_card_unless_asked_for_the_cpu():
    """Without --cpu the entry point runs on cuda; on a host without a
    card it raises instead of continuing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the check is for CPU hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_profile.main(["--batch", "4", "--reps", "1", "--tiles", "4"])

