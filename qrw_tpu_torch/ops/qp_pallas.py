"""Batched OSQP-semantics QP solve around kernel K2 (the rescue solver).

Port of qrw_tpu/ops/qp_pallas.py (`solve`, `_build_K`, `_chol_inv`,
`_run_kernel`). The math is the JAX package's:

* the constraint matrix A (m, n) is SHARED across the batch, so the
  preconditioned ADMM runs in the ORIGINAL variables: Ruiz scaling
  (D, E, c) enters only as the diagonal sigma' = (sigma / c) D^-2 and
  rho' = (1 / c) E^2 rho_class;
* per round, K = P + diag(sigma') + A' diag(rho') A is factored fresh
  (batched Cholesky, plain PyTorch as it was plain JAX) and K^-1 goes to
  the kernel, which runs exactly `n_iters` ADMM steps and one residual
  pass;
* between rounds (not after the last one) OSQP's residual-based rho
  adaptation; converged flags are sticky and iterations are counted only
  for problems still open, while the kernel keeps iterating every
  problem, converged or not;
* `early_exit` skips the remaining rounds once every problem passes.

`_run_kernel` is the dispatcher: CUDA tensors go to the hand-written
kernel in qrw_tpu_torch/csrc/qp_admm.cu, CPU tensors to
`_run_kernel_plain`, the same equations in plain PyTorch. A CUDA tensor
never falls back to the plain version. The warm-refactor branches of the
full-size path (`kinv_init` with refactor "ns", Newton-Schulz refinement
in kernel K3, or "stale", the kernel's refinement variant) are not
ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from qrw_tpu_torch.ops import qp

# Counts launches of the CUDA kernel (one per ADMM round on CUDA
# tensors). chip_smoke.py resets it before a run of the main path and
# reads it after.
KERNEL_LAUNCHES = 0


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
    C5 = torch.as_tensor(cone.cone_rows(), dtype=P.dtype, device=P.device)
    blocks = torch.einsum("ca,bkc,cd->bkad", C5, rc, C5)       # (B,nb,3,3)
    rows, cols = _block_index(nb)
    rows, cols = rows.to(P.device), cols.to(P.device)
    K[:, rows, cols] += blocks.reshape(B, -1)
    K[:, ii, ii] += diag
    return K


def _chol_inv(K):
    """K^-1 of a batch of SPD matrices: Cholesky, then a solve against
    the identity."""
    C = torch.linalg.cholesky(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return torch.cholesky_solve(eye.expand(K.shape), C)


def _amax_abs(v):
    """Infinity norm of each row; NaN propagates (as jnp.max does)."""
    return torch.amax(torch.abs(v), dim=1)


def _run_kernel_plain(Kinv, P, A, q, l, u, rho_vec, sig_vec, xw, yw,
                      alpha: float, n_iters: int):
    """Plain PyTorch version of the kernel: exactly `n_iters` ADMM steps
    from (xw, yw), then the residual norms. All (B, .) float32. Returns
    (x, y, z, pri, dua, n1, n2)."""
    rho_inv = 1.0 / rho_vec
    Amul = lambda v: torch.einsum("bn,mn->bm", v, A)
    Atmul = lambda w: torch.einsum("bm,mn->bn", w, A)
    x, y = xw, yw
    z = Amul(x)
    for _ in range(int(n_iters)):
        b = sig_vec * x - q + Atmul(rho_vec * z - y)
        xt = torch.einsum("bij,bi->bj", Kinv, b)      # K^-1 symmetric
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
# The CUDA kernel (qrw_tpu_torch/csrc/qp_admm.cu)
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _cfunc():
    from qrw_tpu_torch import kernels
    lib = kernels.library()
    fn = lib.qrw_qp_admm_solve
    if fn.argtypes is None:
        fn.argtypes = [_P] * 14 + [_I] * 4 + [_F] + [_P]
        fn.restype = _I
        lib.qrw_qp_admm_smem_bytes.argtypes = [_I, _I]
        lib.qrw_qp_admm_smem_bytes.restype = _I
        lib.qrw_qp_admm_max_smem_bytes.argtypes = []
        lib.qrw_qp_admm_max_smem_bytes.restype = _I
    return lib


def _check(name, t, shape, device):
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(Kinv, P, A, q, l, u, rho_vec, sig_vec, xw, yw, alpha: float,
            n_iters: int):
    """Launch the kernel on the current stream: one block per problem.
    Returns (x, y, z, pri, dua, n1, n2)."""
    global KERNEL_LAUNCHES
    B, n = q.shape
    m = A.shape[0]
    dev = q.device
    for name, t, shape in [("Kinv", Kinv, (B, n, n)), ("P", P, (B, n, n)),
                           ("A", A, (m, n)), ("q", q, (B, n)),
                           ("l", l, (B, m)), ("u", u, (B, m)),
                           ("rho_vec", rho_vec, (B, m)),
                           ("sig_vec", sig_vec, (B, n)), ("x0", xw, (B, n)),
                           ("y0", yw, (B, m))]:
        _check(name, t, shape, dev)
    if B < 1 or B > 2 ** 31 - 1:
        raise ValueError(f"batch {B} out of range")
    lib = _cfunc()
    need = lib.qrw_qp_admm_smem_bytes(n, m)
    have = lib.qrw_qp_admm_max_smem_bytes()
    if need > have:
        raise ValueError(f"qp_admm kernel needs {need} B of shared memory "
                         f"per block at n={n}, m={m}; the card offers "
                         f"{have}")
    f32 = torch.float32
    x = torch.empty((B, n), dtype=f32, device=dev)
    y = torch.empty((B, m), dtype=f32, device=dev)
    z = torch.empty((B, m), dtype=f32, device=dev)
    res = torch.empty((4, B), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.qrw_qp_admm_solve(
        Kinv.data_ptr(), P.data_ptr(), A.data_ptr(), q.data_ptr(),
        l.data_ptr(), u.data_ptr(), rho_vec.data_ptr(), sig_vec.data_ptr(),
        xw.data_ptr(), yw.data_ptr(), x.data_ptr(), y.data_ptr(),
        z.data_ptr(), res.data_ptr(), B, n, m, int(n_iters), float(alpha),
        stream)
    if err != 0:
        raise RuntimeError(f"qp_admm kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return x, y, z, res[0], res[1], res[2], res[3]


def _run_kernel(Kinv, P, A, q, l, u, rho_vec, sig_vec, xw, yw,
                alpha: float, n_iters: int, tile: int = 16):
    """One round of `n_iters` ADMM steps: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. `tile` is the JAX
    package's problems per grid step; the kernel takes one block per
    problem and ignores it."""
    del tile
    if q.device.type == "cpu":
        return _run_kernel_plain(Kinv, P, A, q, l, u, rho_vec, sig_vec, xw,
                                 yw, alpha, n_iters)
    if q.device.type != "cuda":
        raise ValueError(f"qp_pallas: unsupported device {q.device}")
    c = lambda t: t.contiguous()
    return _launch(c(Kinv), c(P), c(A), c(q), c(l), c(u), c(rho_vec),
                   c(sig_vec), c(xw), c(yw), alpha, n_iters)


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


def solve(P, q, A, l, u, settings: qp.QPSettings = qp.QPSettings(),
          x0=None, y0=None, tile: int = 16, schedule=None,
          cone=None, precond=None, rho_init=None, kinv_init=None,
          refactor: str = "ns", early_exit: bool = False) -> PallasQPResult:
    """Batched QP solve with OSQP semantics, one kernel launch a round.

    P (B, n, n); q (B, n); A (m, n) SHARED across the batch; l/u (B, m).
    `schedule` is the per-round iteration budget (default: 50, then
    adaptive_rho_interval per round up to max_iter);
    `precond` = (D, E, c) reuses a Ruiz preconditioner instead of
    equilibrating; `rho_init` (B, 1) carries an adapted rho; x0/y0 warm
    starts (non-finite entries reset to zero). With `early_exit`, rounds
    after the first are skipped once every problem has converged (one
    host read a round). The device of q decides where it runs: the
    kernel on CUDA, its plain version on the CPU, ValueError elsewhere.
    A seed inverse `kinv_init` is ignored under refactor="chol" (a fresh
    Cholesky every round, as always) and raises NotImplementedError
    under "ns" and "stale", the full-size path's policies.
    """
    if not torch.is_tensor(q):
        raise TypeError("q must be a tensor")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qp_pallas.solve: unsupported device {q.device}")
    if refactor not in ("ns", "chol", "stale"):
        raise ValueError(f"unknown refactor policy {refactor!r}")
    if kinv_init is not None and refactor != "chol":
        raise NotImplementedError(
            f"refactor={refactor!r} from kinv_init (the Newton-Schulz "
            "kernel K3, or the stale inverse with in-kernel refinement) "
            "belongs to the full-size path, which is not ported yet")
    del kinv_init                   # "chol" refactors fresh every round
    dev, f32 = q.device, torch.float32
    P, q, A, l, u = (t.to(dev, f32) for t in (P, q, A, l, u))
    if A.dim() != 2:
        raise ValueError("qp_pallas.solve needs a shared constraint "
                         "matrix A (m, n)")
    B, n = q.shape
    s = settings
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
        if early_exit and r > 0 and bool(conv.all()):
            break       # converged flags are sticky: every later round skips
        rho_vec = rho_to_vec(rho)
        Kinv = _chol_inv(_build_K(P, A, rho_vec, sig_vec, cone))
        x, y, z, pri, dua, n1, n2 = _run_kernel(
            Kinv, P, A, q, l, u, rho_vec, sig_vec, x, y, s.alpha, n_iters,
            tile=tile)
        eps_p = s.eps_abs + s.eps_rel * n1
        eps_d = s.eps_abs + s.eps_rel * torch.maximum(n2, nrm_q)
        iters = iters + torch.where(conv, 0, int(n_iters)).to(torch.int32)
        conv = conv | ((pri <= eps_p) & (dua <= eps_d))
        kinv_at = rho
        if r + 1 < len(schedule):
            # osqp compute_rho_estimate from the kernel's norms; not
            # applied after the final round
            denom_p = torch.clamp(n1, min=1e-30)
            denom_d = torch.clamp(torch.maximum(n2, nrm_q), min=1e-30)
            ratio = (pri / denom_p) / torch.clamp(dua / denom_d, min=1e-30)
            scale = torch.sqrt(ratio)[:, None]
            want = ((scale > s.adaptive_rho_tolerance)
                    | (scale < 1.0 / s.adaptive_rho_tolerance))
            want = want & ~conv[:, None]
            rho = torch.where(want, torch.clamp(rho * scale, qp.RHO_MIN,
                                                qp.RHO_MAX), rho)
    return PallasQPResult(x=x, y=y, z=z, iters=iters, pri_res=pri,
                          dua_res=dua, converged=conv, rho=rho,
                          precond=(D, E, c), kinv=Kinv, kinv_rho=kinv_at)
