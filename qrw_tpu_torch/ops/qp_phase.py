"""Phase-grouped, lane-major, matrix-free MPC QP solver (kernel K1).

Port of qrw_tpu/ops/qp_phase.py. The math is the JAX package's:

* one proximal-ADMM step per iteration with ONE shared metric per phase
  class, x+ = x - Kbar_p^-1 (H_b x + q + A'(rho (A x - z) + y)),
  clipped to the safeguard box;
* H_b x applied matrix-free (torque slabs of the per-slot input blocks
  and the two phase Gram matrices G1, G2);
* the friction-pyramid products A x, A'y applied structurally;
* every `check_every` iterations the OSQP unscaled termination test per
  problem, recorded in `it_conv`; with `stop_at_eps`, a tile of
  problems exits once all of them pass.

Layout at the API is the JAX package's lane-major one: q (n, B),
BlS (6, n, B), x0 (n, B), y0 (m, B); the batch is phase-sorted so that
each `tile` of consecutive problems shares one phase (`phases_of`,
(B // tile,)).

`solve` is the dispatcher: CUDA tensors go to the hand-written kernel in
qrw_tpu_torch/csrc/qp_phase.cu, CPU tensors to `solve_plain`, the plain
PyTorch version with the same per-tile exit semantics. A CUDA tensor
never falls back to the plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from qrw_tpu_torch import kernels
from qrw_tpu_torch.utils.profiling import host_read, spanned

X_CLIP = 100.0          # primal safeguard box [N]
Y_CLIP = 1.0e4          # dual safeguard box


class PhaseQPData(NamedTuple):
    """Static per-solve data shared across the batch (host-built)."""
    A: torch.Tensor         # (m, n) reduced cone matrix
    Kbar_inv: torch.Tensor  # (P, n, n) shared metric inverses per phase
    onehot: torch.Tensor    # (P, N, cap) slot -> step one-hot
    L: torch.Tensor         # (N, N) lower-triangular ones
    P2: torch.Tensor        # (N, N) P2[k, j] = max(k - j, 0)
    l: torch.Tensor         # (m,) cone lower bounds (-inf on 4 of 5 rows)
    u: torch.Tensor         # (m,) cone upper bounds
    wtop: torch.Tensor      # (6,) position-block state weights * c_scale
    wbot: torch.Tensor      # (6,) velocity-block state weights * c_scale
    w_force: float
    dt: float
    rho: float
    sigma: float
    alpha: float
    c_scale: float = 1.0
    G1: torch.Tensor = None  # (P, cap, cap) oh' P2'P2 oh
    G2: torch.Tensor = None  # (P, cap, cap) oh' L'L oh
    mu: float = 0.9
    dt_m: float = 0.0        # dt / mass: constant force rows of Bl


class PhaseQPResult(NamedTuple):
    x: torch.Tensor          # (n, B)
    y: torch.Tensor          # (m, B)
    z: torch.Tensor          # (m, B)
    pri_res: torch.Tensor    # (B,)
    dua_res: torch.Tensor    # (B,)
    converged: torch.Tensor  # (B,) bool
    iters: torch.Tensor      # (B,) int32
    # () failed lanes that core/mpc_lane's rescue stage re-solved (None
    # when the stage is off)
    rescued: Optional[torch.Tensor] = None


def a_apply(x, cap, mu):
    """A x, structural: A = I_cap (x) C with C the 5x3 pyramid block.
    x (3cap, ...) -> (5cap, ...)."""
    x3 = x.reshape((cap, 3) + tuple(x.shape[1:]))
    fx, fy, fz = x3[:, 0], x3[:, 1], x3[:, 2]
    mfz = mu * fz
    return torch.stack([fx - mfz, -fx - mfz, fy - mfz, -fy - mfz, -fz],
                       dim=1).reshape((5 * cap,) + tuple(x.shape[1:]))


def at_apply(y, cap, mu):
    """A' y, structural. y (5cap, ...) -> (3cap, ...)."""
    y5 = y.reshape((cap, 5) + tuple(y.shape[1:]))
    gx = y5[:, 0] - y5[:, 1]
    gy = y5[:, 2] - y5[:, 3]
    gz = -mu * (y5[:, 0] + y5[:, 1] + y5[:, 2] + y5[:, 3]) - y5[:, 4]
    return torch.stack([gx, gy, gz], dim=1).reshape(
        (3 * cap,) + tuple(y.shape[1:]))


def time_coupling(n_steps: int):
    """(L, P2) prefix-sum constants of the SRB response (numpy f32)."""
    k = np.arange(n_steps)
    L = (k[:, None] >= k[None, :]).astype(np.float32)
    P2 = np.maximum(k[:, None] - k[None, :], 0).astype(np.float32)
    return L, P2


def tor_slabs(BlS):
    """(3, cap, 3, ...) slot-major slabs of the TORQUE rows of BlS
    (6, 3cap, ...): slab[i][s, a] = Bl_s[3 + a, 3 s + i]."""
    rest = tuple(BlS.shape[2:])
    cap = BlS.shape[1] // 3
    nr = len(rest)
    t = BlS[3:6].reshape((3, cap, 3) + rest)
    return t.permute((2, 1, 0) + tuple(range(3, 3 + nr))).contiguous()


def _gram(G, v):
    """G @ v over the slot axis. G (cap, cap) shared, or (nt, cap, cap)
    per tile with v (cap, k, nt, tile)."""
    if G.dim() == 2:
        return torch.einsum("sc,c...->s...", G, v)
    return torch.einsum("tsc,cktb->sktb", G, v)


def hx_matfree(x, BlS_tor, G1, G2, d: PhaseQPData):
    """H_b x, matrix-free. x (3cap, *T); BlS_tor (3, cap, 3, *T);
    G1/G2 (cap, cap) shared, or (nt, cap, cap) per tile when
    T = (nt, tile). H_b = Gr' W Gr + w_force I."""
    cap = G1.shape[-1]
    T = tuple(x.shape[1:])
    x3 = x.reshape((cap, 3) + T)
    b0, b1, b2 = BlS_tor[0], BlS_tor[1], BlS_tor[2]     # (cap, 3, *T)
    ps_f = d.dt_m * x3
    ps_t = (b0 * x3[:, 0:1] + b1 * x3[:, 1:2] + b2 * x3[:, 2:3])
    psf = torch.cat([ps_f, ps_t], dim=1)                 # (cap, 6, *T)
    ext = (None,) * len(T)
    vS = (_gram(G1, psf) * (d.dt * d.dt) * d.wtop[(None, slice(None)) + ext]
          + _gram(G2, psf) * d.wbot[(None, slice(None)) + ext])
    vF = d.dt_m * vS[:, 0:3]
    vT = vS[:, 3:6]
    out = torch.stack([vF[:, 0] + (b0 * vT).sum(dim=1),
                       vF[:, 1] + (b1 * vT).sum(dim=1),
                       vF[:, 2] + (b2 * vT).sum(dim=1)], dim=1)
    return out.reshape((3 * cap,) + T) + d.w_force * x


def _kinv_step(Kinv, g):
    if Kinv.dim() == 2:
        return torch.einsum("ij,j...->i...", Kinv, g)
    return torch.einsum("tij,jtb->itb", Kinv, g)


def admm_iter(x, z, y, Ax, q, BlS_tor, G1, G2, Kinv, d: PhaseQPData):
    """One prox-ADMM iteration, lane-major, carrying A x."""
    cap = G1.shape[-1]
    ext = (None,) * (x.dim() - 1)
    lo, hi = d.l[(slice(None),) + ext], d.u[(slice(None),) + ext]
    w = d.rho * (Ax - z) + y
    Atw = at_apply(w, cap, d.mu)
    g = hx_matfree(x, BlS_tor, G1, G2, d) + q + Atw
    xt = x - _kinv_step(Kinv, g)
    if d.alpha == 1.0:
        xn = torch.clamp(xt, -X_CLIP, X_CLIP)
        Axn = a_apply(xn, cap, d.mu)
        zr = Axn
    else:
        xn = torch.clamp(d.alpha * xt + (1.0 - d.alpha) * x, -X_CLIP, X_CLIP)
        zt = a_apply(xt, cap, d.mu)
        zr = d.alpha * zt + (1.0 - d.alpha) * z
        Axn = a_apply(xn, cap, d.mu)
    zn = torch.minimum(torch.maximum(zr + y / d.rho, lo), hi)
    yn = torch.clamp(y + d.rho * (zr - zn), -Y_CLIP, Y_CLIP)
    return xn, zn, yn, Axn


def residuals(x, z, y, Ax, q, BlS_tor, G1, G2, d: PhaseQPData):
    """Unscaled residual norms and scales, reduced over axis 0."""
    cap = G1.shape[-1]
    Aty = at_apply(y, cap, d.mu)
    Hx = hx_matfree(x, BlS_tor, G1, G2, d)
    pri = torch.amax(torch.abs(Ax - z), dim=0)
    dua = torch.amax(torch.abs(Hx + q + Aty), dim=0)
    n1 = torch.maximum(torch.amax(torch.abs(Ax), dim=0),
                       torch.amax(torch.abs(z), dim=0))
    n2 = torch.maximum(torch.amax(torch.abs(Hx), dim=0),
                       torch.amax(torch.abs(Aty), dim=0))
    return pri, dua, n1, n2


def _phases_tensor(phases_of, n_tiles, device):
    ph = torch.as_tensor(np.asarray(phases_of) if not torch.is_tensor(
        phases_of) else phases_of, device=device).to(torch.int64)
    if ph.shape != (n_tiles,):
        raise ValueError(f"phases_of must have shape ({n_tiles},), got "
                         f"{tuple(ph.shape)}")
    return ph


def _finish(q, data, x, y, z, pri, dua, n1, n2, it_conv, eps_abs, eps_rel):
    """OSQP-equivalent unscaled termination test on the final iterate
    (the dual side divided back by the cost scaling)."""
    ci = 1.0 / data.c_scale
    dua = dua * ci
    n2 = n2 * ci
    nrm_q = torch.amax(torch.abs(q), dim=0) * ci
    eps_p = eps_abs + eps_rel * n1
    eps_d = eps_abs + eps_rel * torch.maximum(n2, nrm_q)
    conv = (pri <= eps_p) & (dua <= eps_d)
    return PhaseQPResult(x=x, y=y, z=z, pri_res=pri, dua_res=dua,
                         converged=conv, iters=it_conv.to(torch.int32))


def solve_plain(q, BlS, data: PhaseQPData, phases_of, x0=None, y0=None,
                n_iters: int = 300, eps_abs: float = 1e-4,
                eps_rel: float = 1e-4, tile: int = 128,
                check_every: int = 25,
                stop_at_eps: bool = False) -> PhaseQPResult:
    """Plain PyTorch version of the kernel, same arguments as `solve`.

    Tiles are computed together; with stop_at_eps a tile that passed
    the termination test at a chunk boundary is frozen (torch.where),
    so iterates and iteration counts follow the kernel tile for tile."""
    n, B = q.shape
    cap = n // 3
    m = 5 * cap
    if B % tile:
        raise ValueError("batch must be a multiple of the tile")
    nt = B // tile
    dev, f32 = q.device, torch.float32
    ph = _phases_tensor(phases_of, nt, dev)
    Kinv = data.Kbar_inv.to(dev, f32)[ph]
    G1 = data.G1.to(dev, f32)[ph]
    G2 = data.G2.to(dev, f32)[ph]
    d = data._replace(l=data.l.to(dev, f32), u=data.u.to(dev, f32),
                      wtop=data.wtop.to(dev, f32),
                      wbot=data.wbot.to(dev, f32))
    shp = lambda a, r: a.to(f32).reshape(r, nt, tile)
    qt = shp(q, n)
    BlS_tor = tor_slabs(BlS.to(f32)).reshape(3, cap, 3, nt, tile)
    x = (torch.zeros(n, nt, tile, dtype=f32, device=dev) if x0 is None
         else shp(x0, n))
    y = (torch.zeros(m, nt, tile, dtype=f32, device=dev) if y0 is None
         else shp(y0, m))
    Ax = a_apply(x, cap, d.mu)
    z = Ax

    ci = 1.0 / d.c_scale
    nrm_q = torch.amax(torch.abs(qt), dim=0) * ci

    def conv_test(x, z, y, Ax):
        pri, dua, n1, n2 = residuals(x, z, y, Ax, qt, BlS_tor, G1, G2, d)
        eps_p = eps_abs + eps_rel * n1
        eps_d = eps_abs + eps_rel * torch.maximum(n2 * ci, nrm_q)
        return (pri <= eps_p) & (dua * ci <= eps_d)

    n_chunks = -(-n_iters // check_every)
    it_conv = torch.full((nt, tile), float(n_iters), dtype=f32, device=dev)
    active = torch.ones(nt, dtype=torch.bool, device=dev)
    for c in range(n_chunks):
        if stop_at_eps and not bool(active.any()):
            break
        hi = min((c + 1) * check_every, n_iters)
        s = (x, z, y, Ax)
        for _ in range(c * check_every, hi):
            s = admm_iter(*s, qt, BlS_tor, G1, G2, Kinv, d)
        cv = conv_test(*s)
        it_new = torch.minimum(
            it_conv, torch.where(cv, float(hi), float(n_iters)))
        if stop_at_eps:
            a = active[None, :, None]
            x, z, y, Ax = (torch.where(a, new, old)
                           for new, old in zip(s, (x, z, y, Ax)))
            it_conv = torch.where(active[:, None], it_new, it_conv)
            active = active & ~cv.all(dim=1)
        else:
            x, z, y, Ax = s
            it_conv = it_new
    pri, dua, n1, n2 = residuals(x, z, y, Ax, qt, BlS_tor, G1, G2, d)
    flat = lambda a: a.reshape(a.shape[0], B) if a.dim() == 3 \
        else a.reshape(B)
    return _finish(flat(qt), data, flat(x), flat(y), flat(z), flat(pri),
                   flat(dua), flat(n1), flat(n2), flat(it_conv), eps_abs,
                   eps_rel)


# ----------------------------------------------------------------------
# The CUDA kernel (qrw_tpu_torch/csrc/qp_phase.cu), launches counted
# under (cap, tile)
# ----------------------------------------------------------------------

# The kernel spreads a tile over a cluster of thread blocks, each holding
# tile // cluster problems; it is compiled for these block sizes and for
# three caps of stance slots (csrc/qp_phase.cu): 32 (trot, pacing,
# bounding), 48 (walk's 3-stance rows, and any phase set holding walk)
# and 64 (4-stance rows: the static gait and the mixed windows of a
# switch to it). The cluster is the portable 8 blocks where a block of
# tile // 8 problems fits in shared memory, else the H100's non-portable
# 16: cap 32 at tile 512 (the JAX package's tile on its accelerator),
# cap 48 at tile 256, cap 64 at tile 64 (launch_geometry). Larger tiles
# are refused: cap 32 at 1024, cap 48 at 512, cap 64 at 128 and above.
CLUSTERS = (8, 16)
KERNEL_CAP = (32, 48, 64)
BLOCK_PROBLEMS = (4, 8, 16, 32)
# A block's dynamic shared memory can be at most 227 KiB on the H100
# (cudaDevAttrMaxSharedMemoryPerBlockOptin). This is the one place the
# limit is kept: csrc/qp_phase.cu compiles no block that exceeds it, and
# on a card that offers less the kernel's shared-memory attribute is
# refused and the launch raises.
MAX_SMEM_BYTES = 232448


class LaunchGeometry(NamedTuple):
    problems_per_block: int
    cluster: int             # blocks a tile
    threads: int             # threads a block
    grid: int                # blocks in all
    smem_bytes: int          # dynamic shared memory a block


def _block(cap: int, pb: int):
    """(threads, shared-memory bytes) of a block of pb problems at cap:
    one thread per (slot, problem) up to 8 problems, cap * 8 threads
    above; the phase's Kbar^-1, G1, G2, l, u beside the problems'
    iterates and scratch (csrc/qp_phase.cu::smem_floats)."""
    threads = cap * min(pb, 8)
    n, m = 3 * cap, 5 * cap
    floats = (n * (n + 1) + 2 * cap * (cap + 1) + 2 * m
              + pb * (n + 3 * m + n + 9 * cap + 6 * cap + n)
              + (threads // 32) * 6 * pb + 6 * pb + 2 * pb)
    return threads, 4 * floats


def launch_geometry(cap: int, tile: int, B: int) -> LaunchGeometry:
    """K1's launch geometry for B problems of `cap` stance slots in tiles
    of `tile`: a cluster of 8 blocks a tile where a block of tile // 8
    problems is compiled and fits in MAX_SMEM_BYTES, else a cluster of
    16 (tile // 16 problems a block) where that one does. Raises
    ValueError on a shape the kernel does not take (solve_plain takes
    any): a cap other than 32, 48 or 64, a batch that is not whole
    tiles, or a tile that neither cluster holds, with the shared memory
    its block would need at a cluster of 16 (cap 32 at tile 1024, cap 48
    at tile 512, cap 64 at tile 128 and above)."""
    if cap not in KERNEL_CAP:
        raise ValueError(f"qp_phase kernel: cap {cap}, the kernel is "
                         f"compiled for caps {KERNEL_CAP}")
    if B < tile or B % tile:
        raise ValueError(f"qp_phase kernel: batch {B} is not a positive "
                         f"multiple of the tile {tile}")
    for cl in CLUSTERS:
        pb = tile // cl
        if tile % cl == 0 and pb in BLOCK_PROBLEMS:
            threads, smem = _block(cap, pb)
            if smem <= MAX_SMEM_BYTES:
                return LaunchGeometry(pb, cl, threads, (B // tile) * cl,
                                      smem)
    cl = CLUSTERS[-1]
    if tile % cl == 0 and tile // cl >= BLOCK_PROBLEMS[0]:
        smem = _block(cap, tile // cl)[1]
        if smem > MAX_SMEM_BYTES:
            raise ValueError(
                f"qp_phase kernel: cap {cap} at tile {tile} needs {smem} B "
                f"of shared memory a block ({tile // cl} problems a block "
                f"over a cluster of {cl}), more than the {MAX_SMEM_BYTES} "
                f"B a block can have")
    raise ValueError(f"qp_phase kernel: tile {tile} is not one of "
                     f"{sorted({c * p for c in CLUSTERS for p in BLOCK_PROBLEMS})}")


_CLUSTERS_CHECKED = set()   # (cap, tile, B) whose cluster fits the card


def max_active_clusters(tile: int, B: int, cap: int = 32) -> int:
    """Clusters of a B-problem launch that the card can hold at once
    (cudaOccupancyMaxActiveClusters at the launch's own cluster size,
    16 blocks where launch_geometry says so)."""
    return kernels.query("qrw_qp_phase_max_active_clusters", cap, tile, B)


def _launch(q, BlS_tor, data, ph, x0, y0, n_iters, eps_abs, eps_rel,
            tile, check_every, stop_at_eps):
    """Launch the kernel on the current stream: a cluster of 8 or 16
    blocks per tile (`launch_geometry`). Returns (x, y, z, res (5, B))
    with res rows pri, dua, n1, n2, it_conv."""
    n, B = q.shape
    cap = n // 3
    m = 5 * cap
    P = data.Kbar_inv.shape[0]
    dev, f32 = q.device, torch.float32
    for name, t, shape in (
            ("q", q, (n, B)), ("BlS_tor", BlS_tor, (3, cap, 3, B)),
            ("x0", x0, (n, B)), ("y0", y0, (m, B)),
            ("Kbar_inv", data.Kbar_inv, (P, n, n)),
            ("G1", data.G1, (P, cap, cap)), ("G2", data.G2, (P, cap, cap)),
            ("l", data.l, (m,)), ("u", data.u, (m,))):
        kernels.check(name, t, shape, f32, dev)
    kernels.check("phases_of", ph, (B // tile,), torch.int32, dev)
    if check_every < 1:
        raise ValueError(f"check_every {check_every} < 1")
    geo = launch_geometry(cap, tile, B)
    built = kernels.query("qrw_qp_phase_geometry", cap, tile, n_out=4)
    if built != (geo.problems_per_block, geo.cluster, geo.threads,
                 geo.smem_bytes):
        raise RuntimeError(f"qp_phase kernel: the compiled launch geometry "
                           f"{built} is not {geo}")
    if (cap, tile, B) not in _CLUSTERS_CHECKED:
        n_cl = max_active_clusters(tile, B, cap)
        if n_cl < 1:
            raise RuntimeError(f"qp_phase kernel: the card cannot hold one "
                               f"cluster of {geo.cluster} blocks of "
                               f"{geo.smem_bytes} B (cap {cap}, tile "
                               f"{tile}): cudaOccupancyMaxActiveClusters "
                               f"gave {n_cl}")
        _CLUSTERS_CHECKED.add((cap, tile, B))
    x = torch.empty((n, B), dtype=f32, device=dev)
    y = torch.empty((m, B), dtype=f32, device=dev)
    z = torch.empty((m, B), dtype=f32, device=dev)
    res = torch.empty((5, B), dtype=f32, device=dev)
    with host_read("k1_weights"):
        w12 = torch.cat([data.wtop.reshape(6), data.wbot.reshape(6)]).to(
            "cpu", torch.float32).numpy()
    kernels.launch(
        "qrw_qp_phase_solve",
        q.data_ptr(), BlS_tor.data_ptr(), x0.data_ptr(), y0.data_ptr(),
        data.Kbar_inv.data_ptr(), data.G1.data_ptr(), data.G2.data_ptr(),
        ph.data_ptr(), data.l.data_ptr(), data.u.data_ptr(),
        x.data_ptr(), y.data_ptr(), z.data_ptr(), res.data_ptr(),
        w12.ctypes.data,
        B, cap, tile, P, int(n_iters), int(check_every), int(stop_at_eps),
        float(data.rho), float(data.alpha), float(data.mu),
        float(data.dt * data.dt), float(data.dt_m), float(data.w_force),
        float(1.0 / data.c_scale), float(eps_abs), float(eps_rel),
        torch.cuda.current_stream(dev).cuda_stream, key=(cap, tile))
    return x, y, z, res


@spanned("mpc.k1")
def solve(q, BlS, data: PhaseQPData, phases_of, x0=None, y0=None,
          n_iters: int = 300, eps_abs: float = 1e-4, eps_rel: float = 1e-4,
          tile: int = 128, check_every: int = 25,
          stop_at_eps: bool = False) -> PhaseQPResult:
    """Solve a phase-sorted batch: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. q (n, B); BlS (6, n, B); phases_of
    (B // tile,) phase of each tile (numpy or a tensor); x0/y0 warm
    starts in the same layout."""
    if not torch.is_tensor(q):
        raise TypeError("q must be a tensor")
    if q.device.type == "cpu":
        return solve_plain(q, BlS, data, phases_of, x0=x0, y0=y0,
                           n_iters=n_iters, eps_abs=eps_abs,
                           eps_rel=eps_rel, tile=tile,
                           check_every=check_every, stop_at_eps=stop_at_eps)
    if q.device.type != "cuda":
        raise ValueError(f"qp_phase.solve: unsupported device {q.device}")
    n, B = q.shape
    m = 5 * (n // 3)
    if B % tile:
        raise ValueError("batch must be a multiple of the tile")
    ph = _phases_tensor(phases_of, B // tile, q.device).to(torch.int32)
    x0 = (torch.zeros((n, B), dtype=torch.float32, device=q.device)
          if x0 is None else x0)
    y0 = (torch.zeros((m, B), dtype=torch.float32, device=q.device)
          if y0 is None else y0)
    BlS_tor = tor_slabs(BlS)
    x, y, z, res = _launch(q, BlS_tor, data, ph.contiguous(), x0, y0,
                           n_iters, eps_abs, eps_rel, tile, check_every,
                           stop_at_eps)
    return _finish(q, data, x, y, z, res[0], res[1], res[2], res[3], res[4],
                   eps_abs, eps_rel)
