"""K1 at cap 64: the phase sets with 4-stance rows (eval/parity_320's
`--switch static`: the union of trot, static and the trot -> static
transition windows, 201 classes, n = 192, m = 320) against qrw_tpu.

Tolerances: the phase data equal (Kbar^-1, inverted in float64 on the
host and stored in float32, to 1e-6 of its scale); the plain solve
through parity_320's tile grouping against qrw_tpu's plain path
solve_ref (one problem a "tile"), float32 both: converged flags equal,
forces 1e-3 of scale (tests/test_torch_fleet.py's bar for this solver).
The kernel's launch geometry at cap 64: tile 32 only.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from qrw_tpu.config import Config
from qrw_tpu.core import mpc_lane as jml
from qrw_tpu.eval import parity_320 as jpar
from qrw_tpu_torch.core import mpc_lane as tml
from qrw_tpu_torch.eval import parity_320 as tpar
from qrw_tpu_torch.ops import qp_phase as tqph
from tests.torch_threads import single_thread

single_thread()

CFG = Config(velID=2)


def _tol(w, rel):
    return rel * max(1.0, float(np.abs(w).max()))


@pytest.fixture(scope="module")
def cap64():
    """The trot -> static union set: qrw_tpu's and the port's phase
    data (cap 64, n = 192, m = 320)."""
    fs = jpar.build_phase_set(CFG, "trot", "static")
    return fs, (jml.build_phase_data(CFG, fs),
                tml.build_phase_data(CFG, fs, device="cpu"))


def test_build_phase_data_cap64(cap64):
    """201 classes at cap 64: every array of the phase data equal to
    qrw_tpu's (Kbar^-1 to float32 round-off of its float64 inverse)."""
    fs, (jps, tps) = cap64
    assert fs.shape[0] == 201 and jps.cap == tps.cap == 64
    assert tps.data.Kbar_inv.shape == (201, 192, 192)
    np.testing.assert_array_equal(tps.supports.numpy(),
                                  np.asarray(jps.supports))
    np.testing.assert_array_equal(tps.onehot2.numpy(),
                                  np.asarray(jps.onehot2))
    assert tps.c_scale == pytest.approx(jps.c_scale, rel=1e-6)
    for f in ("A", "onehot", "L", "P2", "l", "u", "G1", "G2", "wtop",
              "wbot"):
        w = np.asarray(getattr(jps.data, f))
        np.testing.assert_allclose(getattr(tps.data, f).numpy(), w,
                                   rtol=1e-6, atol=0, err_msg=f)
    w = np.asarray(jps.data.Kbar_inv)
    np.testing.assert_allclose(tps.data.Kbar_inv.numpy(), w, rtol=0,
                               atol=_tol(w, 1e-6))


def test_solve_plain_cap64(cap64):
    """16 problems of 8 classes of the union set (static, trot and
    mixed windows), cold at 300 iterations: the port's solve_plain
    through the tile grouping against qrw_tpu's solve_ref, flags and
    forces (1e-3 of scale)."""
    fs_set, (jps, tps) = cap64
    rng = np.random.default_rng(2)
    cls = np.array([0, 5, 16, 17, 40, 90, 150, 200])
    phases = np.repeat(cls, 2)
    n = phases.size
    N = CFG.n_steps
    xr = np.zeros((n, 12, N + 1))
    xr[:, 2] = CFG.h_ref
    xr[:, :, 0] += rng.normal(scale=0.01, size=(n, 12))
    xr[:, 6, 1:] = rng.uniform(0.0, 0.5, size=(n, 1))
    fs = fs_set[phases].astype(np.float64)
    jx, jst, jsol = jml.solve_mpc_batch_phase(
        CFG, jnp.asarray(np.moveaxis(xr, 0, -1), jnp.float32),
        jnp.asarray(np.moveaxis(fs, 0, -1), jnp.float32), jps, phases,
        n_iters=300, tile=1, use_ref=True)
    st, cv = tpar.solve_phase_grouped(CFG, tps, xr, fs, phases,
                                      device="cpu")
    stance = (fs[:, :N, 0::3] != 0).sum(axis=(1, 2))
    assert stance.max() == 64
    np.testing.assert_array_equal(cv.numpy(), np.asarray(jsol.converged))
    assert cv.float().mean() >= 0.9
    w = np.asarray(jst.f)
    np.testing.assert_allclose(st.f.numpy(), w, rtol=0, atol=_tol(w, 1e-3))


def test_k1_launch_geometry_cap64():
    """At cap 64 a block holds the phase's 192 x 193 Kbar^-1 beside its
    problems: 4 problems (256 threads a block) fit the 227 KiB a block
    can have, at tile 32 over a cluster of 8 and at tile 64 over a
    cluster of 16; a block of 8 does not: tile 128 raises with the byte
    count, as do the larger tiles."""
    geo = tqph.launch_geometry(64, 32, 1024)
    assert geo.smem_bytes == 224896 <= tqph.MAX_SMEM_BYTES
    assert (geo.problems_per_block, geo.threads, geo.grid) == (4, 256, 256)
    with pytest.raises(ValueError, match="267264 B of shared memory"):
        tqph.launch_geometry(64, 128, 1024)
    for tile in (256, 512):
        with pytest.raises(ValueError, match="B of shared memory"):
            tqph.launch_geometry(64, tile, 1024)
