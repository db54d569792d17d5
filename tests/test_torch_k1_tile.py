"""K1 at the JAX package's own accelerator tile, and --fleet-mpc's layout.

The JAX package runs the phase solver at tile 512 on its accelerator
(bench.py's phase mode, `tile = args.tile or 512`; its --fleet-mpc,
qrw_tpu/runtime/main.py:208). The port's kernel spreads a tile over a
thread-block cluster: 8 blocks where a block of tile / 8 problems fits
in shared memory, else 16 (ops/qp_phase.launch_geometry). These tests
hold the geometry table, the plain solver at tile 512 against qrw_tpu's
reference, what the tile changes under stop_at_eps, and --fleet-mpc's
batch layout against the JAX entry point's formula.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from qrw_tpu.config import Config as JConfig
from qrw_tpu.core import mpc_lane as jml
from qrw_tpu.ops import qp_phase as jqp
from qrw_tpu_torch import kernels
from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core import mpc_lane as tml
from qrw_tpu_torch.ops import qp_phase as tqp
from qrw_tpu_torch.runtime import main as tmain
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
JCFG = JConfig()
N = CFG.n_steps
TILE = 512


# (cap, tile) -> (cluster, problems a block, shared bytes a block). Every
# shape the kernel took over a cluster of 8 keeps it, with its bytes.
ACCEPTED = {
    (32, 32): (8, 4, 67456), (32, 64): (8, 8, 88704),
    (32, 128): (8, 16, 130432), (32, 256): (8, 32, 213888),
    (48, 32): (8, 4, 134912), (48, 64): (8, 8, 166720),
    (48, 128): (8, 16, 229184), (64, 32): (8, 4, 224896),
    # the tiles that only a cluster of 16 holds
    (32, 512): (16, 32, 213888), (48, 256): (16, 16, 229184),
    (64, 64): (16, 4, 224896),
}
# (cap, tile) -> shared bytes of the block a cluster of 16 would need
REFUSED = {(32, 1024): 380800, (48, 512): 354112, (64, 128): 267264,
           (64, 256): 350464}


@pytest.mark.parametrize("cap,tile", sorted(ACCEPTED))
def test_launch_geometry_accepts(cap, tile):
    B = 4096
    cl, pb, smem = ACCEPTED[cap, tile]
    geo = tqp.launch_geometry(cap, tile, B)
    assert (geo.cluster, geo.problems_per_block, geo.smem_bytes) == (
        cl, pb, smem)
    assert geo.problems_per_block * geo.cluster == tile
    assert geo.grid == (B // tile) * cl
    assert geo.threads == cap * min(pb, 8) and geo.threads % 32 == 0
    assert smem <= tqp.MAX_SMEM_BYTES


@pytest.mark.parametrize("cap,tile", sorted(REFUSED))
def test_launch_geometry_refuses(cap, tile):
    with pytest.raises(ValueError,
                       match=f"needs {REFUSED[cap, tile]} B of shared"):
        tqp.launch_geometry(cap, tile, 4096)


def test_compiled_instances_match_the_geometry():
    """csrc/qp_phase.cu compiles one instance per (cap, problems a block,
    cluster) that launch_geometry gives, and no other: its one dispatch
    table, which the launch, the occupancy query and the geometry all
    go through, names that set."""
    with open([s for s in kernels.sources()
               if s.endswith("qp_phase.cu")][0]) as f:
        src = f.read()
    want = {(cap, pb, cl) for (cap, _), (cl, pb, _) in ACCEPTED.items()}
    found = re.findall(r"f\(I<(\d+)>\(\), I<(\d+)>\(\), I<(\d+)>\(\)\)", src)
    assert len(found) == len(want)
    assert {tuple(map(int, m)) for m in found} == want
    geo = {(cap, t): tqp.launch_geometry(cap, t, 4096)
           for cap in tqp.KERNEL_CAP for t in (32, 64, 128, 256, 512)
           if (cap, t) in ACCEPTED}
    assert {(c, g.problems_per_block, g.cluster)
            for (c, _), g in geo.items()} == want


def _bench_batch(tps, phases_of, tile, shift=0.0):
    """bench.py::phase_batch at seed 0 (phase 0, 512 problems: one tile
    of bench.py's run_phase_mode), assembled by the port: q (n, B) and
    BlS (6, n, B) as float32 numpy."""
    xr, fs, _ = bench.phase_batch(JCFG, [0], TILE, np.random.default_rng(0))
    xr = xr.copy()
    xr[:, 0, :] += shift
    _, _, _, BlS, q, _ = tml.phase_problem(
        CFG, torch.as_tensor(xr), torch.as_tensor(fs), tps,
        np.asarray(phases_of), tile)
    return q.numpy(), BlS.numpy()


@pytest.fixture(scope="module")
def jps():
    return jml.build_phase_data(JCFG, jml.trot_phase_fsteps(JCFG))


@pytest.fixture(scope="module")
def tps():
    return tml.build_phase_data(CFG, tml.trot_phase_fsteps(CFG),
                                device="cpu")


@pytest.fixture(scope="module")
def tile512(jps, tps):
    """Cold, then warm on a 1 mm shift, at tile 512, stop_at_eps on: the
    port's solve_plain and qrw_tpu's solve_ref (whose whole-batch exit
    is the per-tile exit at one tile). Returns {warm: (got, want, q,
    BlS, x0, y0)}."""
    kw = dict(n_iters=300, stop_at_eps=True)
    out = {}
    x0 = y0 = None
    for warm in (False, True):
        q, BlS = _bench_batch(tps, [0], TILE, 0.001 if warm else 0.0)
        got = tqp.solve_plain(
            torch.as_tensor(q), torch.as_tensor(BlS), tps.data, [0],
            x0=None if x0 is None else torch.as_tensor(x0),
            y0=None if y0 is None else torch.as_tensor(y0), tile=TILE, **kw)
        want = jqp.solve_ref(
            jnp.asarray(q), jnp.asarray(BlS), jps.data,
            np.zeros(TILE, np.int32),
            x0=None if x0 is None else jnp.asarray(x0),
            y0=None if y0 is None else jnp.asarray(y0), **kw)
        out[warm] = (got, want, q, BlS, x0, y0)
        x0, y0 = np.array(want.x), np.array(want.y)
    return out


@pytest.mark.parametrize("warm", [False, True])
def test_solve_plain_tile512_matches_solve_ref(tile512, warm):
    """One tile of 512: flags and iteration counts equal, x and y within
    1e-4 of each array's largest entry (test_torch_qp_phase.py's bar:
    the same float32 update equations, another summation order)."""
    got, want, *_ = tile512[warm]
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    for f in ("x", "y"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=f)
    assert np.asarray(want.converged).mean() >= 0.95


def test_four_tiles_of_128_leave_other_iterates(jps, tps, tile512):
    """The warm solve split into four tiles of 128: under stop_at_eps a
    tile of 128 whose problems all pass exits at that check, while the
    tile of 512 runs on for the few that do not. Each lane's `iters`
    (its first passing check) is the same in both splits, by
    construction; what the split changes is how many iterations a tile
    runs, and so the iterates it leaves. Both packages show it (qrw_tpu
    through solve_ref per tile of 128, whose whole-batch exit is then
    the per-tile exit)."""
    got512, want512, q, BlS, x0, y0 = tile512[True]
    T = 128
    kw = dict(n_iters=300, stop_at_eps=True)
    got = tqp.solve_plain(torch.as_tensor(q), torch.as_tensor(BlS),
                          tps.data, [0] * (TILE // T), x0=torch.as_tensor(x0),
                          y0=torch.as_tensor(y0), tile=T, **kw)
    parts = [jqp.solve_ref(jnp.asarray(q[:, s]), jnp.asarray(BlS[..., s]),
                           jps.data, np.zeros(T, np.int32),
                           x0=jnp.asarray(x0[:, s]), y0=jnp.asarray(y0[:, s]),
                           **kw)
             for s in (slice(i, i + T) for i in range(0, TILE, T))]
    want_x = np.concatenate([np.asarray(p.x) for p in parts], axis=1)
    want_it = np.concatenate([np.asarray(p.iters) for p in parts])
    want_cv = np.concatenate([np.asarray(p.converged) for p in parts])
    np.testing.assert_array_equal(got.iters.numpy(), want_it)
    np.testing.assert_array_equal(got.converged.numpy(), want_cv)
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want_x).max()))
    # the same first passing checks as the one tile of 512 ...
    np.testing.assert_array_equal(want_it, np.asarray(want512.iters))
    # ... but a tile of 128 that converged whole stopped early, where the
    # tile of 512 did not, and its lanes' iterates moved on there
    exited = want_cv.reshape(-1, T).all(axis=1)
    assert exited.any() and not np.asarray(want512.converged).all()
    for x_split, x_one in ((want_x, np.asarray(want512.x)),
                           (got.x.numpy(), got512.x.numpy())):
        dx = np.abs(x_split - x_one).max(axis=0)
        moved = dx > 1e-4 * max(1.0, np.abs(x_one).max())
        assert moved.reshape(-1, T)[exited].all()
        assert not moved.reshape(-1, T)[~exited].any()


def _jax_layout(B, P, tile):
    """qrw_tpu/runtime/main.py:208-221 (_run_fleet_mpc), restated."""
    per = max(tile, (B // (P * tile)) * tile)
    phase_ids = list(range(P)) if B >= P * tile else [0, P // 2]
    B = per * len(phase_ids)
    phases_of = np.repeat(phase_ids, per // tile)
    return B, per, phase_ids, phases_of


@pytest.mark.parametrize("batch", [1000, 1024, 4096, 8192, 16384])
def test_fleet_mpc_layout_is_the_jax_entry_points(batch):
    tile = tmain.FLEET_MPC_TILE
    assert tile == 512
    got = tmain.fleet_mpc_layout(batch, N, tile)
    want = _jax_layout(batch, N, tile)
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    if batch == 4096:
        assert got[:3] == (1024, 512, [0, 8])
    if batch == 8192:
        assert got[:3] == (8192, 512, list(range(16)))


def test_fleet_mpc_on_the_cpu_keeps_tile_4():
    r = tmain.run_fleet_mpc(CFG, 40, 0, "cpu", n_cycles=1)
    assert r["tile"] == tmain.CPU_TILE == 4
    assert (r["B"], r["phases"]) == (8, [0, 8])
    assert r["cold_conv"] >= 0.75 and r["solves_s"] > 0
