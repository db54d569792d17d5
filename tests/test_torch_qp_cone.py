"""What the CPU can check of K2's cone variant and K1's cluster launch.

K2 (qrw_tpu_torch/csrc/qp_admm.cu) applies A by its cone structure when
the caller passes one: the wrapper hands the kernel a description (the
kind, the block count, mu) instead of A, and checks once per `solve`
that A is that cone matrix. Here: the description reconstructs the JAX
package's matrices exactly, a plain emulation of the structured
products (each output's nonzero terms from 0 in increasing index order,
as the kernel's FMAs take them) equals the dense products, and a
perturbed A is refused; the cone variant's new shape, the reduced cone
at n = 144 (cap 48), takes one round of the plain version against the
Pallas kernel in interpret mode. K1 (csrc/qp_phase.cu) spreads a tile
over a cluster of thread blocks; its launch-geometry helper refuses the
tiles the kernel does not take (at cap 48: tile 256, whose block would
not fit the shared memory), which the plain solver still accepts.

Tolerances. Float64 with integer data and a dyadic mu: every product and
partial sum is exact, so the structured and dense products are equal
bit for bit whatever their order. Float32 at the configuration's mu:
within 1e-6 of the largest entry, against the float64 product (each
output is a sum of at most five float32 products).
"""

import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import mpc as jmpc
from qrw_tpu.ops import qp as jqp
from qrw_tpu_torch.core import mpc_lane as tml
from qrw_tpu_torch.ops import qp as tqp
from qrw_tpu_torch.ops import qp_pallas as tqpp
from qrw_tpu_torch.ops import qp_phase as tqph
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
N = CFG.n_steps

# the two cone structures of the system's callers: the full-size path's
# ConeStructure(N, mu) and the rescue's ReducedConeStructure(2N, mu),
# each beside the JAX package's dense matrix of it
CONES = {
    "full": (lambda mu: tqp.ConeStructure(N, mu),
             lambda mu: jmpc.cone_matrix(N, mu)),
    "reduced": (lambda mu: tqp.ReducedConeStructure(2 * N, mu),
                lambda mu: jqp.ReducedConeStructure(2 * N, mu).matrix()),
}


def cone_apply_plain(desc, v):
    """A v by the structure, v (..., n) -> (..., m): each row's nonzero
    terms summed from 0 in increasing column order, as the kernel's FMAs
    take them."""
    v3 = v.reshape(v.shape[:-1] + (desc.n_blocks, 3))
    x0, x1, x2 = v3[..., 0], v3[..., 1], v3[..., 2]
    cm = -torch.as_tensor(desc.mu, dtype=v.dtype)
    z = torch.zeros_like(x0)
    rows = torch.stack([(z + x0) + cm * x2, (z - x0) + cm * x2,
                        (z + x1) + cm * x2, (z - x1) + cm * x2, z - x2],
                       dim=-1).reshape(v.shape[:-1] + (5 * desc.n_blocks,))
    if desc.kind == tqpp.CONE_FULL:
        rows = torch.cat([rows, torch.zeros_like(v) + v], dim=-1)
    return rows


def cone_apply_t_plain(desc, w):
    """A' w by the structure, w (..., m) -> (..., n): each column's
    friction rows from 0 in increasing row order, then its identity
    row."""
    mf = 5 * desc.n_blocks
    w5 = w[..., :mf].reshape(w.shape[:-1] + (desc.n_blocks, 5))
    cm = -torch.as_tensor(desc.mu, dtype=w.dtype)
    z = torch.zeros_like(w5[..., 0])
    gz = z + cm * w5[..., 0]
    for t in (1, 2, 3):
        gz = gz + cm * w5[..., t]
    cols = torch.stack([(z + w5[..., 0]) - w5[..., 1],
                        (z + w5[..., 2]) - w5[..., 3], gz - w5[..., 4]],
                       dim=-1).reshape(w.shape[:-1] + (desc.n,))
    if desc.kind == tqpp.CONE_FULL:
        cols = cols + w[..., mf:]
    return cols


@pytest.mark.parametrize("kind", sorted(CONES))
def test_cone_description_reconstructs_A(kind):
    """The description the wrapper hands the kernel stands for exactly
    the JAX package's cone matrix, in float64 and in float32."""
    make, jax_matrix = CONES[kind]
    cone = make(CFG.mu)
    desc = tqpp.cone_description(cone)
    A = jax_matrix(CFG.mu)
    assert (desc.n, desc.m) == (cone.n, cone.m) == A.shape[::-1]
    assert desc.kind == (tqpp.CONE_FULL if kind == "full"
                         else tqpp.CONE_REDUCED)
    assert desc.n_blocks == cone.n // 3
    np.testing.assert_array_equal(tqpp.cone_matrix_of(desc), A)
    A32 = torch.as_tensor(A, dtype=torch.float32)
    assert tqpp.check_cone(A32, cone) == desc


@pytest.mark.parametrize("kind", sorted(CONES))
def test_structured_products_float64_exact(kind):
    """A v and A' w by the structure equal the dense products bit for
    bit on data whose every product and partial sum is exact."""
    make, jax_matrix = CONES[kind]
    mu = 0.625                                   # dyadic
    desc = tqpp.cone_description(make(mu))
    A = torch.as_tensor(jax_matrix(mu), dtype=torch.float64)
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.integers(-1000, 1000, (7, desc.n)), dtype=A.dtype)
    w = torch.as_tensor(rng.integers(-1000, 1000, (7, desc.m)), dtype=A.dtype)
    assert torch.equal(cone_apply_plain(desc, v), v @ A.T)
    assert torch.equal(cone_apply_t_plain(desc, w), w @ A)


@pytest.mark.parametrize("kind", sorted(CONES))
def test_structured_products_float32(kind):
    """At the configuration's mu, in float32: within 1e-6 of the scale of
    the float64 dense products."""
    make, jax_matrix = CONES[kind]
    desc = tqpp.cone_description(make(CFG.mu))
    A = jax_matrix(CFG.mu)
    rng = np.random.default_rng(1)
    v = rng.normal(scale=20.0, size=(7, desc.n)).astype(np.float32)
    w = rng.normal(scale=20.0, size=(7, desc.m)).astype(np.float32)
    for got, want in ((cone_apply_plain(desc, torch.as_tensor(v)),
                       v.astype(np.float64) @ A.T),
                      (cone_apply_t_plain(desc, torch.as_tensor(w)),
                       w.astype(np.float64) @ A)):
        assert got.dtype == torch.float32
        err = np.abs(got.numpy().astype(np.float64) - want).max()
        assert err <= 1e-6 * np.abs(want).max(), err


def _perturbed(kind, how):
    make, jax_matrix = CONES[kind]
    A = torch.as_tensor(jax_matrix(CFG.mu), dtype=torch.float32)
    if how == "one ulp":
        A[7, 2] = torch.nextafter(A[7, 2], torch.tensor(1.0))
    elif how == "other mu":
        A = torch.as_tensor(jax_matrix(CFG.mu + 0.1), dtype=torch.float32)
    elif how == "zeroed entry":
        A[0, 0] = 0.0
    elif how == "rows dropped":
        A = A[:-5].contiguous()
    return make(CFG.mu), A


@pytest.mark.parametrize("how", ["one ulp", "other mu", "zeroed entry",
                                 "rows dropped"])
@pytest.mark.parametrize("kind", sorted(CONES))
def test_check_cone_raises_on_a_perturbed_A(kind, how):
    """The check that A is the cone matrix raises ValueError on any
    difference, and `solve` runs it before anything else."""
    cone, A = _perturbed(kind, how)
    with pytest.raises(ValueError, match="cone matrix"):
        tqpp.check_cone(A, cone)
    B, n = 2, A.shape[1]
    P = torch.eye(n).expand(B, n, n).contiguous()
    lu = torch.zeros((B, A.shape[0]))
    with pytest.raises(ValueError, match="cone matrix"):
        tqpp.solve(P, torch.zeros((B, n)), A, lu, lu, cone=cone)


def test_cone_kernel_refuses_an_uncompiled_shape():
    """The cone variant is compiled for n = 96 and n = 192: another cone
    raises before anything is launched (no dense fallback)."""
    cone = tqp.ReducedConeStructure(8, CFG.mu)
    desc = tqpp.cone_description(cone)
    B, n, m = 2, desc.n, desc.m
    A = torch.as_tensor(tqpp.cone_matrix_of(desc), dtype=torch.float32)
    v, w = torch.zeros((B, n)), torch.zeros((B, m))
    M = torch.zeros((B, n, n))
    with pytest.raises(ValueError, match="no kernel for n=24"):
        tqpp._launch(M, M, A, v, w, w, w, v, v, w, 1.6, 50, cone=desc)


def test_cone_dispatch_has_no_fallback():
    """With a cone, a tensor off the CPU still never reaches the plain
    version."""
    cone = tqp.ReducedConeStructure(2 * N, CFG.mu)
    B, n, m = 2, cone.n, cone.m
    v = torch.zeros((B, n), device="meta")
    w = torch.zeros((B, m), device="meta")
    M = torch.zeros((B, n, n), device="meta")
    A = torch.zeros((m, n), device="meta")
    with pytest.raises(ValueError, match="device"):
        tqpp._run_kernel(M, M, A, v, w, w, w, v, v, w, 1.6, 50, cone=cone)


@pytest.mark.parametrize("cap,tile,B", [(32, 16, 1024), (32, 48, 960),
                                        (32, 96, 960), (32, 2048, 4096),
                                        (32, 1024, 1024), (24, 128, 1024),
                                        (32, 128, 1000), (32, 128, 64),
                                        (48, 512, 4096), (64, 128, 1024),
                                        (48, 16, 1024)])
def test_k1_launch_geometry_refuses(cap, tile, B):
    """Tiles that K1's cluster launch cannot take raise ValueError."""
    with pytest.raises(ValueError, match="qp_phase kernel"):
        tqph.launch_geometry(cap, tile, B)


@pytest.mark.parametrize("tile", [32, 64, 128, 256])
def test_k1_launch_geometry(tile):
    """A tile is a cluster of 8 blocks, tile / 8 problems a block; at the
    fleet's B = 1024 and tile 128 the grid has 64 blocks, so the launch
    reaches 64 SMs, not the 8 of one block a tile."""
    B = 1024
    geo = tqph.launch_geometry(32, tile, B)
    assert geo.cluster == tqph.CLUSTERS[0] == 8
    assert geo.problems_per_block * geo.cluster == tile
    assert geo.grid == (B // tile) * geo.cluster
    assert geo.threads % 32 == 0 and geo.threads <= 1024
    assert geo.smem_bytes <= 227 * 1024
    if tile == 128:
        assert geo.grid == 64


@pytest.mark.parametrize("tile,smem", [(32, 134912), (64, 166720),
                                       (128, 229184)])
def test_k1_launch_geometry_cap48(tile, smem):
    """At cap 48 (n = 144, m = 240) a block holds the phase's 144 x 145
    Kbar^-1 beside its problems: tiles 32-128 fit the 227 KiB a block can
    have over a cluster of 8 (tile 128 with ~3 kB to spare); tile 256
    takes a cluster of 16 blocks of 16 problems, and tile 512's block of
    32 does not fit and raises with the reason. B = 4096 at tile 128 is
    32 tiles, 256 blocks."""
    B = 4096
    geo = tqph.launch_geometry(48, tile, B)
    assert geo.smem_bytes == smem <= tqph.MAX_SMEM_BYTES == 227 * 1024
    assert geo.problems_per_block * geo.cluster == tile
    assert geo.threads == 48 * min(geo.problems_per_block, 8)
    assert geo.threads % 32 == 0
    assert geo.grid == (B // tile) * 8
    with pytest.raises(ValueError, match="354112 B of shared memory"):
        tqph.launch_geometry(48, 512, B)


def test_cone_kernel_n144_is_the_reduced_cone_only():
    """n = 144 is compiled for the reduced cone (the rescue of a cap-48
    fleet); a full cone of that n raises before anything is launched."""
    assert 144 in tqpp.CONE_KERNEL_SHAPES[tqpp.CONE_REDUCED]
    cone = tqp.ConeStructure(12, CFG.mu)
    desc = tqpp.cone_description(cone)
    assert desc.n == 144
    B, n, m = 2, desc.n, desc.m
    A = torch.as_tensor(tqpp.cone_matrix_of(desc), dtype=torch.float32)
    v, w = torch.zeros((B, n)), torch.zeros((B, m))
    M = torch.zeros((B, n, n))
    with pytest.raises(ValueError, match="no kernel for n=144"):
        tqpp._launch(M, M, A, v, w, w, w, v, v, w, 1.6, 50, cone=desc)


@pytest.mark.parametrize("k_ref", [False, True])
def test_kernel_round_parity_n144(k_ref):
    """K2 at the rescue shape of a cap-48 fleet (reduced cone, n = 144,
    m = 240): one 50-iteration round of the plain version against the
    Pallas kernel (qrw_tpu's _run_kernel, interpret mode) on the same
    float32 inputs, K^-1 included, and with K_ref its two refinements a
    step. Problems from two walk phases and one trot phase, built by
    qrw_tpu's build_qp_reduced at cap 48. Tolerances as
    tests/test_torch_qp_pallas.py holds the n = 96 round: pri to 4 ulps
    of the ~25 N scale, the rest to 1e-4 of their scale plus 1e-6."""
    import jax
    import jax.numpy as jnp
    from qrw_tpu.core import mpc_lane as jml
    from qrw_tpu.ops import qp_pallas as jqpp
    cap, Bq = 48, 3
    rng = np.random.default_rng(11)
    walk = jml.gait_phase_fsteps(CFG, "walk")
    trot = jml.gait_phase_fsteps(CFG, "trot")
    fs = np.stack([walk[0], walk[5], trot[2]]).astype(np.float32)
    xr = np.zeros((Bq, 12, N + 1), np.float32)
    xr[:, 2] = CFG.h_ref
    xr[:, :, 0] += rng.normal(scale=0.02, size=(Bq, 12))
    xr[:, 6, 1:] = rng.uniform(0.0, 0.4, size=(Bq, 1))
    H, q, *_ = jax.vmap(lambda x, f: jmpc.build_qp_reduced(
        CFG, x, f, cap))(jnp.asarray(xr), jnp.asarray(fs))
    H, q = np.array(H, np.float32), np.array(q, np.float32)
    cone = jqp.ReducedConeStructure(cap, CFG.mu)
    A = cone.matrix().astype(np.float32)
    assert A.shape == (240, 144)
    l = np.tile(np.array([-np.inf] * 4 + [-CFG.fz_max], np.float32),
                (Bq, cap))
    u = np.zeros_like(l)
    rho = np.full((Bq, 5 * cap), 0.1, np.float32)
    sig = np.full((Bq, 3 * cap), 1e-6, np.float32)
    K = jqpp._build_K(jnp.asarray(H), jnp.asarray(A), jnp.asarray(rho),
                      jnp.asarray(sig), cone)
    Kinv = np.array(jqpp._chol_inv(K), np.float32)
    K = np.array(K, np.float32) if k_ref else None
    x0 = rng.normal(scale=5.0, size=(Bq, 3 * cap)).astype(np.float32)
    y0 = rng.normal(scale=1e-3, size=(Bq, 5 * cap)).astype(np.float32)
    args = (Kinv, H, A, q, l, u, rho, sig, x0, y0)
    want = jqpp._run_kernel(*map(jnp.asarray, args), 1.6, 50, Bq, True,
                            K=None if K is None else jnp.asarray(K))
    got = tqpp._run_kernel(*map(torch.as_tensor, args), 1.6, 50,
                           K=None if K is None else torch.as_tensor(K),
                           cone=tqp.ReducedConeStructure(cap, CFG.mu))
    ulp4 = 4 * np.spacing(np.float32(32.0))
    for name, g, w in zip(["x", "y", "z", "pri", "dua", "n1", "n2"], got,
                          want):
        w = np.asarray(w)
        tol = (ulp4 if name == "pri"
               else 1e-4 * np.abs(w).max() + 1e-6)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("tile", [16, 48])
def test_solve_plain_takes_tiles_the_kernel_refuses(tile):
    """solve_plain runs any tile that divides the batch: without the
    early exit its result does not depend on the tile."""
    ps = tml.build_phase_data(CFG, tml.trot_phase_fsteps(CFG), device="cpu")
    B = 96
    rng = np.random.default_rng(3)
    xrefs = np.zeros((12, N + 1, B), np.float32)
    xrefs[2, :, :] = CFG.h_ref
    xrefs[:, 0, :] += rng.normal(scale=0.02, size=(12, B)).astype(np.float32)
    xrefs[6, 1:, :] = rng.uniform(0, 0.6, B).astype(np.float32)
    fsteps = np.repeat(tml.trot_phase_fsteps(CFG)[0][:, :, None], B, axis=2)
    phases = lambda t: torch.zeros(B // t, dtype=torch.int32)
    _, _, _, BlS, q, _ = tml.phase_problem(CFG, torch.as_tensor(xrefs),
                                           torch.as_tensor(fsteps), ps,
                                           phases(tile), tile)
    with pytest.raises(ValueError):
        tqph.launch_geometry(ps.cap, tile, B)
    kw = dict(n_iters=50, stop_at_eps=False)
    got = tqph.solve_plain(q, BlS, ps.data, phases(tile), tile=tile, **kw)
    want = tqph.solve_plain(q, BlS, ps.data, phases(B), tile=B, **kw)
    for f in ("x", "y", "z", "iters", "converged"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
