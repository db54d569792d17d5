"""Batched OSQP-semantics QP solve around kernels K2 and K3.

Port of qrw_tpu/ops/qp_pallas.py (`solve`, `_build_K`, `_chol_inv`,
`_ns_refine`, `_factor`, `_run_kernel`). The math is the JAX package's:

* the constraint matrix A (m, n) is SHARED across the batch, so the
  preconditioned ADMM runs in the ORIGINAL variables: Ruiz scaling
  (D, E, c) enters only as the diagonal sigma' = (sigma / c) D^-2 and
  rho' = (1 / c) E^2 rho_class;
* per round, K = P + diag(sigma') + A' diag(rho') A is assembled and
  K^-1 obtained by `_factor`: a fresh batched Cholesky and two
  triangular solves (one launch of csrc/qp_kinv.cu; plain JAX in the
  JAX package), or, on the first round of a warm call, a guarded
  Newton-Schulz refinement of the carried inverse (kernel K3) with a
  fixed-capacity Cholesky fallback for the worst seeds;
* the ADMM kernel K2 runs exactly `n_iters` steps and one residual pass;
  under refactor="stale" it applies two iterative-refinement steps
  against K itself to every x-update;
* between rounds (not after the last one) OSQP's residual-based rho
  adaptation; converged flags are sticky and iterations are counted only
  for problems still open, while the kernel keeps iterating every
  problem, converged or not;
* `early_exit` skips the remaining rounds once every problem passes.

`_run_kernel`, `_ns_refine` and `_chol_inv` are the dispatchers: CUDA
tensors go to the hand-written kernels in qrw_tpu_torch/csrc/qp_admm.cu,
(K3, by n, `ns_variant`) qrw_tpu_torch/csrc/qp_ns_refine_tc.cu or
qp_ns_refine.cu, and (K^-1) qrw_tpu_torch/csrc/qp_kinv.cu, CPU tensors
to `_run_kernel_plain`, `_ns_refine_plain` and `_chol_inv_plain`, the
same equations in plain PyTorch. A CUDA tensor never falls back to a
plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qrw_tpu_torch import kernels
from qrw_tpu_torch.ops import lin, qp
from qrw_tpu_torch.utils.profiling import (active, count, host_read, span,
                                           spanned)


class PallasQPResult(NamedTuple):
    x: torch.Tensor          # (B, n)
    y: torch.Tensor          # (B, m)
    z: torch.Tensor          # (B, m)
    iters: torch.Tensor      # (B,) int32
    pri_res: torch.Tensor    # (B,)
    dua_res: torch.Tensor    # (B,)
    converged: torch.Tensor  # (B,) bool
    rho: torch.Tensor        # (B, 1) adapted rho, the warm-start carry
    precond: tuple           # (D, E, c) Ruiz preconditioner
    kinv: torch.Tensor       # (B, n, n) last K^-1
    kinv_rho: torch.Tensor   # (B, 1) rho the last K^-1 was factored at


def _block_index(nb: int):
    """Row / column indices of the nb 3x3 diagonal blocks of K."""
    rows = (3 * np.repeat(np.arange(nb), 9)
            + np.tile(np.repeat(np.arange(3), 3), nb))
    cols = (3 * np.repeat(np.arange(nb), 9) + np.tile(np.arange(3), 3 * nb))
    return torch.as_tensor(rows), torch.as_tensor(cols)


def _build_K(P, A, rho_vec, sig_vec, cone=None):
    """K = P + diag(sig) + A' diag(rho) A. With a cone structure the
    A'RA term collapses to 3x3 blocks per (step, foot) (plus the
    identity-row diagonal of the full cone); otherwise a dense product
    over the shared A."""
    B, n = P.shape[0], P.shape[-1]
    ii = torch.arange(n, device=P.device)
    if cone is None:
        K = P + torch.einsum("ma,bm,mc->bac", A, rho_vec, A)
        K[:, ii, ii] += sig_vec
        return K
    K = P.clone()
    if isinstance(cone, qp.ReducedConeStructure):
        nb = cone.n_blocks
        rc = rho_vec.reshape(B, nb, 5)
        diag = sig_vec
    else:
        mc = 20 * cone.n_steps
        nb = 4 * cone.n_steps
        rc = rho_vec[:, :mc].reshape(B, nb, 5)
        diag = sig_vec + rho_vec[:, mc:]
    rows, cols = _block_index(nb)
    with host_read("qp_cone_blocks"):
        C5 = torch.as_tensor(cone.cone_rows(), dtype=P.dtype,
                             device=P.device)
        rows, cols = rows.to(P.device), cols.to(P.device)
    blocks = torch.einsum("ca,bkc,cd->bkad", C5, rc, C5)       # (B,nb,3,3)
    K[:, rows, cols] += blocks.reshape(B, -1)
    K[:, ii, ii] += diag
    return K


def _chol_inv_plain(K):
    """Plain PyTorch version of the K^-1 kernel: the factor of
    (K + K') / 2 (jnp.linalg.cholesky symmetrizes its input) through
    `cholesky_ex` (no status read), then the two triangular solves
    against the identity (ops/lin). Returns (K^-1, nonpd (B,) bool): a
    problem whose factor failed, or whose pivots are not all finite, gets
    NaN in its whole K^-1, as jnp.linalg.cholesky gives."""
    L, info = torch.linalg.cholesky_ex((K + K.transpose(-1, -2)) / 2)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    X = lin.solve_upper_t(L, lin.solve_lower(L, eye.expand(K.shape)))
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    bad = (info != 0) | ~torch.isfinite(diag).all(dim=-1)
    return torch.where(bad[:, None, None], float("nan"), X), bad


def _chol_inv(K):
    """K^-1 of a batch of SPD matrices K (B, n, n): Cholesky, then two
    triangular solves against the identity. The kernel for CUDA tensors,
    the plain version for CPU tensors, ValueError elsewhere; neither
    reads anything back. A problem that is not positive definite gets NaN
    in its whole K^-1; the others are untouched. Counts the problems
    ("qp.kinv_lanes", a host number) and those set to NaN
    ("qp.kinv_nonpd", summed on the device) while a profiler runs."""
    if K.device.type == "cpu":
        X, bad = _chol_inv_plain(K)
    elif K.device.type == "cuda":
        X, bad = _kinv_launch(K.contiguous())
    else:
        raise ValueError(f"qp_pallas: unsupported device {K.device}")
    if active():
        count("qp.kinv_lanes", K.shape[0])
        count("qp.kinv_nonpd", bad.sum())
    return X


def _ns_refine_plain(K, X0, ns_iters: int):
    """Plain PyTorch version of K3: `ns_iters` Newton-Schulz steps
    X <- 2X - X (K X) from X0, then resid = max|K X - I| per problem
    (NaN propagates, as jnp.max does). K, X0 (B, n, n). Returns (X,
    resid (B,)), X not yet re-centred."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    X = X0
    for _ in range(int(ns_iters)):
        KX = torch.matmul(K, X)
        X = 2.0 * X - torch.matmul(X, KX)
    KX = torch.matmul(K, X)
    return X, torch.amax(torch.abs(KX - eye), dim=(1, 2))


@spanned("qp.k3")
def _ns_refine(K, X0, ns_iters: int):
    """(X_refined, resid): kernel K3 for CUDA tensors, its plain version
    for CPU tensors, ValueError elsewhere. X comes re-centred as
    0.5 (X + X'), as the JAX package does outside its kernel."""
    if K.device.type == "cpu":
        X, resid = _ns_refine_plain(K, X0, ns_iters)
        return 0.5 * (X + X.transpose(1, 2)), resid
    if K.device.type == "cuda":
        return _ns_launch(K.contiguous(), X0.contiguous(), ns_iters)
    raise ValueError(f"qp_pallas: unsupported device {K.device}")


def _factor(K, kinv_init=None, ns_iters: int = 3, seed_scale=None):
    """K^-1 of the assembled KKT matrices K (B, n, n). Cold: `_chol_inv`.
    Warm (kinv_init given): the seed, scaled by seed_scale
    (B, 1) = rho_old / rho_new, is refined by `ns_iters` Newton-Schulz
    steps (K3); a problem whose residual max|K X - I| is not finite or
    above 1e-2 is bad. The `cap` = min(B, max(8, B // 32)) largest
    residuals are refactored by Cholesky (always computed, as in the JAX
    package, with no host read) and the bad ones among them take it;
    bad problems beyond the capacity keep their refined seed. The top-k
    is a stable sort on -resid, so ties (inf, the usual case when seeds
    diverge) keep the lower index first, as jax.lax.top_k does."""
    if kinv_init is None:
        return _chol_inv(K)
    B = K.shape[0]
    X = kinv_init
    if seed_scale is not None:
        X = X * seed_scale[:, :, None]
    X, resid = _ns_refine(K, X, ns_iters)
    resid = torch.where(torch.isfinite(resid), resid,
                        torch.full_like(resid, float("inf")))
    bad = resid > 1e-2
    cap = int(min(B, max(8, B // 32)))
    idx = torch.argsort(-resid, stable=True)[:cap]
    Xr = _chol_inv(K[idx])
    X[idx] = torch.where(bad[idx][:, None, None], Xr, X[idx])
    return X


def _amax_abs(v):
    """Infinity norm of each row; NaN propagates (as jnp.max does)."""
    return torch.amax(torch.abs(v), dim=1)


def _run_kernel_plain(Kinv, P, A, q, l, u, rho_vec, sig_vec, xw, yw,
                      alpha: float, n_iters: int, K=None):
    """Plain PyTorch version of the kernel: exactly `n_iters` ADMM steps
    from (xw, yw), then the residual norms. All (B, .) float32. With K
    (B, n, n), the KKT matrix itself, every x-update takes two
    iterative-refinement steps r = b - K xt; xt += K^-1 r. Returns
    (x, y, z, pri, dua, n1, n2)."""
    rho_inv = 1.0 / rho_vec
    Amul = lambda v: torch.einsum("bn,mn->bm", v, A)
    Atmul = lambda w: torch.einsum("bm,mn->bn", w, A)
    x, y = xw, yw
    z = Amul(x)
    for _ in range(int(n_iters)):
        b = sig_vec * x - q + Atmul(rho_vec * z - y)
        xt = torch.einsum("bij,bi->bj", Kinv, b)      # K^-1 symmetric
        if K is not None:
            # r is a small difference of large terms, and its rounding
            # sets the refinement's noise floor: an elementwise product
            # and a reduction, as the JAX kernel writes it. On an H100 a
            # batched product (einsum) rounded it 2.7x worse and the
            # "stale" policy converged 0.89 of the problems, not 0.996.
            for _ in range(2):
                r = b - (K * xt[:, :, None]).sum(dim=1)
                xt = xt + torch.einsum("bij,bi->bj", Kinv, r)
        zt = Amul(xt)
        xn = alpha * xt + (1.0 - alpha) * x
        zr = alpha * zt + (1.0 - alpha) * z
        zn = torch.minimum(torch.maximum(zr + y * rho_inv, l), u)
        y = y + rho_vec * (zr - zn)
        x, z = xn, zn
    Ax = Amul(x)
    Px = torch.einsum("bij,bi->bj", P, x)             # P symmetric
    Aty = Atmul(y)
    pri = _amax_abs(Ax - z)
    dua = _amax_abs(Px + q + Aty)
    n1 = torch.maximum(_amax_abs(Ax), _amax_abs(z))
    n2 = torch.maximum(_amax_abs(Px), _amax_abs(Aty))
    return x, y, z, pri, dua, n1, n2


# ----------------------------------------------------------------------
# The cone structure as the kernel takes it
# ----------------------------------------------------------------------

CONE_FULL = 1       # ConeStructure: A = [I_nb (x) C; I_n], nb = 4N
CONE_REDUCED = 2    # ReducedConeStructure: A = I_nb (x) C


class ConeDesc(NamedTuple):
    """What K2's cone variant gets instead of A: the kind, the number of
    5 x 3 friction blocks (n / 3) and mu."""
    kind: int
    n_blocks: int
    mu: float

    @property
    def n(self) -> int:
        return 3 * self.n_blocks

    @property
    def m(self) -> int:
        return 5 * self.n_blocks + (self.n if self.kind == CONE_FULL else 0)


def cone_description(cone) -> ConeDesc:
    """The kernel's description of a ConeStructure or
    ReducedConeStructure."""
    if isinstance(cone, qp.ReducedConeStructure):
        return ConeDesc(CONE_REDUCED, int(cone.n_blocks), float(cone.mu))
    if isinstance(cone, qp.ConeStructure):
        return ConeDesc(CONE_FULL, 4 * int(cone.n_steps), float(cone.mu))
    raise TypeError(f"not a cone structure: {type(cone).__name__}")


def cone_matrix_of(desc: ConeDesc) -> np.ndarray:
    """The dense A (m, n), float64, that the description stands for."""
    F = qp.ReducedConeStructure(desc.n_blocks, desc.mu).matrix()
    if desc.kind == CONE_FULL:
        return np.vstack([F, np.eye(desc.n)])
    return F


@spanned("qp.cone_check")
def check_cone(A, cone) -> ConeDesc:
    """Raise ValueError unless A (m, n) is exactly the cone matrix of
    `cone` in A's dtype; return the kernel's description of it."""
    desc = cone_description(cone)
    want = cone_matrix_of(desc)
    with host_read("qp_cone_check"):
        want = torch.as_tensor(want, dtype=A.dtype, device=A.device)
        same = (tuple(A.shape) == tuple(want.shape)
                and torch.equal(A, want))
    if not same:
        raise ValueError(f"A {tuple(A.shape)} is not the cone matrix of "
                         f"{cone}")
    return desc


# ----------------------------------------------------------------------
# The CUDA kernels: K2 (qrw_tpu_torch/csrc/qp_admm.cu), K3 and K^-1, each
# launch counted under its n
# ----------------------------------------------------------------------

# n of the cone variant's compiled kernels by cone kind
# (csrc/qp_admm.cu): both kinds at 96 and 192, the reduced cone also at
# 144 (the rescue of a cap-48 fleet)
CONE_KERNEL_SHAPES = {CONE_FULL: (96, 192), CONE_REDUCED: (96, 144, 192)}


def _launch(Kinv, P, A, q, l, u, rho_vec, sig_vec, xw, yw, alpha: float,
            n_iters: int, K=None, cone=None):
    """Launch K2 on the current stream, one block per problem. With a
    `cone` description (ConeDesc) the cone variant runs: A is not read,
    K^-1 stays in registers (4n threads a block) and K (K_ref) in shared
    memory. Without it the dense variant runs; where A does not fit a
    block's shared memory beside K^-1 (n = 192, m = 512) it reads A and a
    contiguous A' from device memory. Returns (x, y, z, pri, dua, n1,
    n2)."""
    B, n = q.shape
    m = A.shape[0]
    dev = q.device
    checks = [("Kinv", Kinv, (B, n, n)), ("P", P, (B, n, n)),
              ("A", A, (m, n)), ("q", q, (B, n)), ("l", l, (B, m)),
              ("u", u, (B, m)), ("rho_vec", rho_vec, (B, m)),
              ("sig_vec", sig_vec, (B, n)), ("x0", xw, (B, n)),
              ("y0", yw, (B, m))]
    if K is not None:
        checks.append(("K", K, (B, n, n)))
    for name, t, shape in checks:
        kernels.check(name, t, shape, torch.float32, dev)
    if B < 1 or B > 2 ** 31 - 1:
        raise ValueError(f"batch {B} out of range")
    if K is not None and K.data_ptr() % 16:
        raise ValueError("K: not 16-byte aligned (the kernel reads float4)")
    if cone is not None and ((cone.n, cone.m) != (n, m)
                             or n not in CONE_KERNEL_SHAPES[cone.kind]):
        raise ValueError(f"qp_admm cone kernel: no kernel for n={n}, m={m} "
                         f"and cone {cone}; compiled for n in "
                         f"{CONE_KERNEL_SHAPES} (cone kind: n)")
    lib = kernels.library()
    have = lib.qrw_qp_admm_max_smem_bytes()
    if cone is not None:
        need = lib.qrw_qp_admm_cone_smem_bytes(cone.kind, n, m,
                                               int(K is not None))
    else:
        need = lib.qrw_qp_admm_smem_bytes(n, m)
    if need > have:
        raise ValueError(f"qp_admm kernel needs {need} B of shared memory "
                         f"per block at n={n}, m={m}; the card offers "
                         f"{have}")
    f32 = torch.float32
    x = torch.empty((B, n), dtype=f32, device=dev)
    y = torch.empty((B, m), dtype=f32, device=dev)
    z = torch.empty((B, m), dtype=f32, device=dev)
    res = torch.empty((4, B), dtype=f32, device=dev)
    vecs = (P.data_ptr(), q.data_ptr(), l.data_ptr(), u.data_ptr(),
            rho_vec.data_ptr(), sig_vec.data_ptr(), xw.data_ptr(),
            yw.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
            res.data_ptr())
    Kp = None if K is None else K.data_ptr()
    tail = (B, n, m, int(n_iters), float(alpha),
            torch.cuda.current_stream(dev).cuda_stream)
    if cone is not None:
        kernels.launch("qrw_qp_admm_cone_solve", cone.kind, float(cone.mu),
                       Kinv.data_ptr(), Kp, *vecs, *tail, key=n)
    else:
        At = A if lib.qrw_qp_admm_stages_A(n, m) else A.t().contiguous()
        kernels.launch("qrw_qp_admm_solve", Kinv.data_ptr(), Kp,
                       P.data_ptr(), A.data_ptr(), At.data_ptr(), *vecs[1:],
                       *tail, key=n)
    return x, y, z, res[0], res[1], res[2], res[3]


# n of K3's resident variant (csrc/qp_ns_refine_tc.cu); every other n
# takes the general variant (csrc/qp_ns_refine.cu)
NS_RESIDENT_N = 192


def ns_variant(n: int) -> str:
    """K3's variant for n x n problems: "resident" (3xTF32 tensor-core
    products, each problem's K, X and K X held in the shared memory of a
    cluster of two blocks; compiled for n = 192, the full-size MPC's n)
    or "general" (any n, one block per problem, products streamed in
    tiles through shared memory, a scratch in device memory)."""
    return "resident" if int(n) == NS_RESIDENT_N else "general"


def ns_max_active_clusters() -> int:
    """Clusters of the resident variant the card holds at once (one
    problem each); raises if the kernel cannot be resident at all."""
    n_cl = kernels.query("qrw_ns_refine_tc_max_active_clusters")
    if n_cl < 1:
        raise RuntimeError(f"ns_refine resident kernel: no cluster fits the "
                           f"card ({n_cl} clusters)")
    return n_cl


def _ns_launch(K, X0, ns_iters: int, variant: str = None):
    """Launch K3 on the current stream: the variant `ns_variant(n)`
    picks, or the one named. "resident": a cluster of two blocks per
    problem, the re-centring folded into its store. "general": one
    block per problem with a (B, 2, n, n) scratch, re-centred here.
    Returns (X re-centred as 0.5 (X + X'), resid)."""
    B, n = K.shape[0], K.shape[-1]
    variant = ns_variant(n) if variant is None else variant
    if variant not in ("resident", "general"):
        raise ValueError(f"unknown ns_refine variant {variant!r}")
    if variant == "resident" and n != NS_RESIDENT_N:
        raise ValueError(f"ns_refine resident kernel: compiled for "
                         f"n = {NS_RESIDENT_N}, not n = {n}")
    dev = K.device
    kernels.check("K", K, (B, n, n), torch.float32, dev)
    kernels.check("X0", X0, (B, n, n), torch.float32, dev)
    if B < 1 or B > 2 ** 30:
        raise ValueError(f"batch {B} out of range")
    if ns_iters < 0:
        raise ValueError(f"ns_iters {ns_iters} < 0")
    f32 = torch.float32
    X = torch.empty((B, n, n), dtype=f32, device=dev)
    resid = torch.empty((B,), dtype=f32, device=dev)
    tail = (resid.data_ptr(), B, n, int(ns_iters),
            torch.cuda.current_stream(dev).cuda_stream)
    if variant == "resident":
        if K.data_ptr() % 16 or X0.data_ptr() % 16:
            raise ValueError("K, X0: not 16-byte aligned (the kernel "
                             "copies 16 bytes at a time)")
        kernels.launch("qrw_ns_refine_tc", K.data_ptr(), X0.data_ptr(),
                       X.data_ptr(), *tail, key=n)
        return X, resid
    scratch = torch.empty((B, 2, n, n), dtype=f32, device=dev)
    kernels.launch("qrw_ns_refine", K.data_ptr(), X0.data_ptr(),
                   X.data_ptr(), scratch.data_ptr(), *tail, key=n)
    return 0.5 * (X + X.transpose(1, 2)), resid


# The largest n of the K^-1 kernel (csrc/qp_kinv.cu): a 6 x 6 tile of
# each matrix a thread, at most 32 x 32 threads a block
KINV_MAX_N = 192


def _kinv_launch(K):
    """Launch the K^-1 kernel on the current stream, one block per
    problem. Returns (K^-1 (B, n, n), nonpd (B,) int32: 1 where the whole
    K^-1 is NaN)."""
    B, n = K.shape[0], K.shape[-1]
    kernels.check("K", K, (B, n, n), torch.float32, K.device)
    if n > KINV_MAX_N:
        raise ValueError(f"kinv kernel: n = {n} > {KINV_MAX_N}, the largest "
                         f"n whose factor fits a block's shared memory and "
                         f"whose 6 x 6 tiles fit its 1,024 threads")
    if B < 1 or B > 2 ** 31 - 1 or n < 1:
        raise ValueError(f"kinv kernel: batch {B} of n = {n} out of range")
    X = torch.empty_like(K)
    nonpd = torch.empty((B,), dtype=torch.int32, device=K.device)
    kernels.launch("qrw_kinv", K.data_ptr(), X.data_ptr(), nonpd.data_ptr(),
                   B, n, torch.cuda.current_stream(K.device).cuda_stream,
                   key=n)
    return X, nonpd


def kinv_blocks_per_sm(n: int) -> int:
    """Blocks of the K^-1 kernel at n an SM holds at once."""
    return kernels.query("qrw_kinv_blocks_per_sm", int(n))


@spanned("qp.k2")
def _run_kernel(Kinv, P, A, q, l, u, rho_vec, sig_vec, xw, yw,
                alpha: float, n_iters: int, tile: int = 16, K=None,
                cone=None):
    """One round of `n_iters` ADMM steps: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. With K, the refinement
    variant. With `cone` (a ConeStructure or ReducedConeStructure, A its
    matrix, as `solve` checks) the kernel's cone variant applies A by its
    structure; without it the dense variant reads A. `tile` is the JAX
    package's problems per grid step; both variants take one block per
    problem and ignore it."""
    del tile
    if q.device.type == "cpu":
        return _run_kernel_plain(Kinv, P, A, q, l, u, rho_vec, sig_vec, xw,
                                 yw, alpha, n_iters, K=K)
    if q.device.type != "cuda":
        raise ValueError(f"qp_pallas: unsupported device {q.device}")
    c = lambda t: None if t is None else t.contiguous()
    desc = None if cone is None else cone_description(cone)
    return _launch(c(Kinv), c(P), c(A), c(q), c(l), c(u), c(rho_vec),
                   c(sig_vec), c(xw), c(yw), alpha, n_iters, K=c(K),
                   cone=desc)


def precondition(P, q, A, l, u, s: qp.QPSettings, precond=None):
    """The diagonal scaling of the original-variable ADMM: returns
    ((D, E, c), sigma' (B, n), rho -> rho' (B, m)). `precond` = (D, E,
    c) reuses a preconditioner; otherwise `s.scaling_iters` Ruiz passes
    (none: identity)."""
    if precond is not None:
        D, E, c = precond
    elif s.scaling_iters > 0:
        D, E, c = qp.ruiz_equilibrate(P, q, A, s.scaling_iters)
    else:
        D = torch.ones_like(q)
        E = torch.ones_like(l)
        c = torch.ones((q.shape[0], 1), dtype=q.dtype, device=q.device)
    sig_vec = (s.sigma / c) / (D * D)
    El, Eu, EE_over_c = E * l, E * u, E * E / c

    def rho_to_vec(rho):
        return qp.rho_vec_for_bounds(El, Eu, rho) * EE_over_c
    return (D, E, c), sig_vec, rho_to_vec


@spanned("qp.solve")
def solve(P, q, A, l, u, settings: qp.QPSettings = qp.QPSettings(),
          x0=None, y0=None, tile: int = 16, schedule=None,
          cone=None, precond=None, rho_init=None, kinv_init=None,
          kinv_rho=None, refactor: str = "ns",
          early_exit: bool = False) -> PallasQPResult:
    """Batched QP solve with OSQP semantics, one K2 launch a round.

    P (B, n, n); q (B, n); A (m, n) SHARED across the batch; l/u (B, m).
    `schedule` is the per-round iteration budget (default: 50, then
    adaptive_rho_interval per round up to max_iter);
    `precond` = (D, E, c) reuses a Ruiz preconditioner instead of
    equilibrating; `rho_init` (B, 1) carries an adapted rho; x0/y0 warm
    starts (non-finite entries reset to zero). With `early_exit`, rounds
    after the first are skipped once every problem has converged (one
    host read a round). `cone` (a ConeStructure or ReducedConeStructure)
    says that A is its cone matrix, which is checked once (ValueError
    if not): K is then assembled block by block and K2 applies A by its
    structure; with cone=None K2 reads A as a general matrix. The device
    of q decides where it runs: the kernels on CUDA, their plain
    versions on the CPU, ValueError elsewhere.

    `refactor` says how round 0 of a warm call (kinv_init given, the
    previous K^-1, factored at kinv_rho) obtains K^-1:
      "ns"    the seed, scaled by kinv_rho / rho, refined by Newton-Schulz
              (K3) with the guarded Cholesky fallback of `_factor`;
      "chol"  a fresh Cholesky, ignoring the seed;
      "stale" the scaled seed through `_factor` with zero Newton-Schulz
              steps (the residual guard and the fallback only), then K2
              with two refinement steps against K per x-update.
    Later rounds, and every round of a cold call, factor fresh. The
    returned kinv_rho is the rho at which the last K^-1 was taken.
    """
    if not torch.is_tensor(q):
        raise TypeError("q must be a tensor")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qp_pallas.solve: unsupported device {q.device}")
    if refactor not in ("ns", "chol", "stale"):
        raise ValueError(f"unknown refactor policy {refactor!r}")
    dev, f32 = q.device, torch.float32
    P, q, A, l, u = (t.to(dev, f32) for t in (P, q, A, l, u))
    if A.dim() != 2:
        raise ValueError("qp_pallas.solve needs a shared constraint "
                         "matrix A (m, n)")
    B, n = q.shape
    if cone is not None:
        check_cone(A, cone)     # the kernel applies this structure, not A
    s = settings
    with span("qp.precondition"):
        if schedule is None:
            # a short first round before the first rho adaptation, then
            # adaptive_rho_interval per round up to max_iter
            interval = min(s.adaptive_rho_interval, s.max_iter)
            schedule = [min(50, interval)]
            while sum(schedule) < s.max_iter:
                schedule.append(min(interval, s.max_iter - sum(schedule)))

        (D, E, c), sig_vec, rho_to_vec = precondition(P, q, A, l, u, s,
                                                       precond)
        finite0 = lambda v: torch.where(torch.isfinite(v), v,
                                        torch.zeros_like(v)).to(f32)
        x = torch.zeros_like(q) if x0 is None else finite0(x0.to(dev))
        y = torch.zeros_like(l) if y0 is None else finite0(y0.to(dev))
        rho = (torch.full((B, 1), s.rho, dtype=f32, device=dev)
               if rho_init is None else rho_init.to(dev, f32))
        nrm_q = torch.amax(torch.abs(q), dim=1)
        iters = torch.zeros((B,), dtype=torch.int32, device=dev)
        conv = torch.zeros((B,), dtype=torch.bool, device=dev)

    z = pri = dua = Kinv = kinv_at = None
    for r, n_iters in enumerate(schedule):
        if early_exit and r > 0:
            with host_read("qp_early_exit"):
                done = bool(conv.all())
            if done:
                break   # converged flags are sticky: every later round skips
        with span("qp.factor"):
            rho_vec = rho_to_vec(rho)
            K = _build_K(P, A, rho_vec, sig_vec, cone)
            seeded = r == 0 and kinv_init is not None and refactor != "chol"
            stale = seeded and refactor == "stale"
            if seeded:
                scale = (None if kinv_rho is None
                         else kinv_rho.to(dev, f32) / rho)
                Kinv = _factor(K, kinv_init.to(dev, f32),
                               ns_iters=0 if stale else 3, seed_scale=scale)
            else:
                Kinv = _chol_inv(K)
        x, y, z, pri, dua, n1, n2 = _run_kernel(
            Kinv, P, A, q, l, u, rho_vec, sig_vec, x, y, s.alpha, n_iters,
            tile=tile, K=K if stale else None, cone=cone)
        with span("qp.rho"):
            eps_p = s.eps_abs + s.eps_rel * n1
            eps_d = s.eps_abs + s.eps_rel * torch.maximum(n2, nrm_q)
            iters = iters + torch.where(conv, 0, int(n_iters)).to(
                torch.int32)
            conv = conv | ((pri <= eps_p) & (dua <= eps_d))
            kinv_at = rho
            if r + 1 < len(schedule):
                # osqp compute_rho_estimate from the kernel's norms; not
                # applied after the final round
                denom_p = torch.clamp(n1, min=1e-30)
                denom_d = torch.clamp(torch.maximum(n2, nrm_q), min=1e-30)
                ratio = (pri / denom_p) / torch.clamp(dua / denom_d,
                                                      min=1e-30)
                scale = torch.sqrt(ratio)[:, None]
                want = ((scale > s.adaptive_rho_tolerance)
                        | (scale < 1.0 / s.adaptive_rho_tolerance))
                want = want & ~conv[:, None]
                rho = torch.where(want, torch.clamp(rho * scale, qp.RHO_MIN,
                                                    qp.RHO_MAX), rho)
    return PallasQPResult(x=x, y=y, z=z, iters=iters, pri_res=pri,
                          dua_res=dua, converged=conv, rho=rho,
                          precond=(D, E, c), kinv=Kinv, kinv_rho=kinv_at)
