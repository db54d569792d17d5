"""Batched iLQR (the Crocoddyl SolverDDP equivalent).

Port of qrw_tpu/ops/ilqr.py. The reference's DDP backends call
`crocoddyl.SolverDDP.solve(x_init, u_init, max_iter)` over a list of
per-node action models; here the solver is one function over fixed
shapes with B problems along a leading axis (qrw_tpu `jax.vmap`s its
per-problem solve): exact per-node derivatives through `torch.func`
(or a caller's `derivs`), the backward Riccati sweep as a reversed
loop over the N nodes, the line search over the crocoddyl alpha
schedule (2^-k) as one more batch axis, and a Levenberg regularization
adapted per problem, as crocoddyl's increase/decreaseRegularization.
Each problem keeps its own accept/reject decision. The solve runs a
fixed `max_iters` and reads nothing back to the host: its constants
(the step sizes, the identity) are made once per (schedule, dtype,
device) and kept on the device.

Under a profiler the solve opens the span `qrw.ilqr`, in it
`qrw.ilqr.rollout` and, each iteration, `qrw.ilqr.derivs` (the
derivatives), `qrw.ilqr.backward` (the Riccati sweep),
`qrw.ilqr.linesearch` and `qrw.ilqr.accept`; it counts `ilqr.problems`
(problems x iterations) and `ilqr.accepted` (the iterations a problem
accepted, summed on the card).

A problem is given as functions of one node of one problem, written so
that they broadcast over leading axes (they also run under
`torch.func.vmap`):
    step(x, u, *node_args) -> x_next   (action model calc: dynamics)
    cost(x, u, *node_args) -> scalar   (running cost)
    cost_T(x, *term_args)  -> scalar   (terminal cost)
where node_args are tensors (B, N, ...) read at the node (the JAX
package's closures over the node index k), term_args tensors (B, ...),
an optional project_u(u, k) applied to every candidate control of
the line search at node k (contact gating: swing-foot forces stay
exactly zero), and an optional `derivs` that computes the derivatives
in place of `torch.func`:
    derivs(X, U, flat_node_args, xT, term_args)
        -> (fx, fu, lx, lu, lxx, lux, luu, Vx, Vxx)
on the B N node rows X, U (B N, n | m) with the node args flattened the
same way, and the terminal states xT (B, n); the node rows' outputs
come flat ((B N, n, n) ...), Vx (B, n) and Vxx (B, n, n) are the
terminal cost's gradient and Hessian. It must give what `torch.func`
gives on step, cost and cost_T (core/mpc_ddp passes the SRB model's
hand-written kernel on CUDA tensors).

An optional `linesearch` does the initial rollout and each iteration's
line search and accept in place of `plain_linesearch` (core/mpc_ddp
passes the SRB model's kernel on CUDA tensors):
    linesearch(x0, xs, us, kffs, Ks, cost, reg, trace, it)
        -> (xs, us, cost, reg, accepted)
with the iterate xs (B, N+1, n), us (B, N, m), its cost (B,), the
regularization reg (B,) and the backward pass's lists of N feed-forward
terms kffs (B, m) and gains Ks (B, m, n): every step size's closed-loop
rollout u_k = project_u(us_k + alpha kff_k + K_k (x_k - xs_k), k), the
best (a NaN cost counts as +inf, the first of equal costs wins) accepted
where its cost is below `cost`; it returns the new iterate (the old one
where rejected), cost and regularization, the accepted flags (B,) bool,
and writes the new cost into column `it` of trace (B, max_iters). With
kffs and Ks None it is the initial rollout of us from x0: (xs, us as
given, its cost, reg as given, None); xs, cost, trace and it are not
read.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch
from torch.func import jacfwd, jacrev, vmap

from qrw_tpu_torch.utils.profiling import active, count, span, spanned


class ILQRSettings(NamedTuple):
    max_iters: int = 10
    # crocoddyl SolverDDP line-search schedule (alphas 2^-k)
    alphas: tuple = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625,
                     0.0078125, 0.00390625)
    reg_init: float = 1e-9
    reg_min: float = 1e-9
    reg_max: float = 1e4
    reg_inc: float = 10.0
    reg_dec: float = 0.1


class ILQRResult(NamedTuple):
    xs: torch.Tensor          # (B, N+1, n) optimized state trajectory
    us: torch.Tensor          # (B, N, m) optimized controls
    cost: torch.Tensor        # (B,) final total cost
    cost_trace: torch.Tensor  # (B, max_iters) accepted cost per iteration


_CONST_CACHE: dict = {}


def _constants(alphas: tuple, m: int, dtype, device):
    """(the m x m identity, the step sizes) on the device, made once: a
    tensor made from host data is a copy that blocks the host."""
    key = (alphas, m, dtype, str(device))
    if key not in _CONST_CACHE:
        _CONST_CACHE[key] = (
            torch.eye(m, dtype=dtype, device=device),
            torch.tensor(alphas, dtype=dtype, device=device))
    return _CONST_CACHE[key]


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _second_order(fn):
    """(x, u, *a) -> ((lxx, lxu), (lux, luu)), (lx, lu) of a scalar
    function: forward over reverse, as jax.hessian."""
    def grads(x, u, *a):
        g = jacrev(fn, argnums=(0, 1))(x, u, *a)
        return g, g
    return jacfwd(grads, argnums=(0, 1), has_aux=True)


def _terminal_second_order(fn):
    def grad(x, *a):
        g = jacrev(fn)(x, *a)
        return g, g
    return jacfwd(grad, has_aux=True)


def plain_linesearch(step: Callable, cost: Callable, cost_T: Callable,
                     node_args: Sequence[torch.Tensor] = (),
                     term_args: Sequence[torch.Tensor] = (),
                     settings: ILQRSettings = ILQRSettings(),
                     project_u: Optional[Callable] = None) -> Callable:
    """The solver's own `linesearch` (the contract in the module
    docstring) on the problem of `solve`'s arguments: every step size at
    once as one more batch axis (A, B, ...), node by node."""
    if project_u is None:
        def project_u(u, k):
            return u

    def at(k, lead=()):
        return [a[:, k].expand(lead + a[:, k].shape) for a in node_args]

    def total_cost(xs, us, lead=()):
        """Running costs of every node in one call, plus the terminal
        cost: xs (*lead, B, N+1, n), us (*lead, B, N, m) -> (*lead, B)."""
        a = [t.expand(lead + t.shape) for t in node_args]
        return (cost(xs[..., :-1, :], us, *a).sum(-1)
                + cost_T(xs[..., -1, :],
                         *[t.expand(lead + t.shape) for t in term_args]))

    def linesearch(x0, xs, us, kffs, Ks, cost_now, reg, trace, it):
        B, N, _ = us.shape
        if kffs is None:
            x, xs = x0, [x0]
            for k in range(N):
                x = step(x, us[:, k], *at(k))
                xs.append(x)
            xs = torch.stack(xs, 1)
            return xs, us, total_cost(xs, us), reg, None
        n = x0.shape[-1]
        _, alphas = _constants(tuple(settings.alphas), us.shape[-1],
                               x0.dtype, x0.device)
        A = alphas.shape[0]
        rows = torch.arange(B, device=x0.device)
        # every alpha at once, (A, B, ...)
        x = x0.expand(A, B, n)
        xs_c, us_c = [x], []
        for k in range(N):
            u = project_u(us[:, k] + alphas[:, None, None] * kffs[k]
                          + _mv(Ks[k], x - xs[:, k]), k)
            x = step(x, u, *at(k, (A,)))
            xs_c.append(x)
            us_c.append(u)
        xs_c, us_c = torch.stack(xs_c, 2), torch.stack(us_c, 2)
        costs = total_cost(xs_c, us_c, (A,))
        costs = torch.where(torch.isnan(costs), torch.inf, costs)
        best = torch.argmin(costs, dim=0)                   # (B,)
        best_cost = costs[best, rows]
        improved = best_cost < cost_now
        xs = torch.where(improved[:, None, None], xs_c[best, rows], xs)
        us = torch.where(improved[:, None, None], us_c[best, rows], us)
        cost_now = torch.where(improved, best_cost, cost_now)
        reg = torch.where(improved,
                          torch.clamp(reg * settings.reg_dec,
                                      min=settings.reg_min),
                          torch.clamp(reg * settings.reg_inc,
                                      max=settings.reg_max))
        trace[:, it] = cost_now
        return xs, us, cost_now, reg, improved

    return linesearch


@spanned("ilqr")
def solve(step: Callable, cost: Callable, cost_T: Callable,
          x0: torch.Tensor, us0: torch.Tensor,
          node_args: Sequence[torch.Tensor] = (),
          term_args: Sequence[torch.Tensor] = (),
          settings: ILQRSettings = ILQRSettings(),
          project_u: Optional[Callable] = None,
          derivs: Optional[Callable] = None,
          linesearch: Optional[Callable] = None) -> ILQRResult:
    """Run iLQR from the warm start us0. x0: (B, n), us0: (B, N, m)."""
    B, N, m = us0.shape
    n = x0.shape[-1]
    dtype, dev = x0.dtype, x0.device
    if linesearch is None:
        linesearch = plain_linesearch(step, cost, cost_T, node_args,
                                      term_args, settings, project_u)
    fxu_fn = vmap(jacfwd(step, argnums=(0, 1)))
    l_fn = vmap(_second_order(cost))
    lT_fn = vmap(_terminal_second_order(cost_T))
    flat = [a.reshape((B * N,) + a.shape[2:]) for a in node_args]
    eye, _ = _constants(tuple(settings.alphas), m, dtype, dev)

    count("ilqr.problems", B * settings.max_iters)
    reg = torch.full((B,), settings.reg_init, dtype=dtype, device=dev)
    trace = x0.new_empty((B, settings.max_iters))
    with span("ilqr.rollout"):
        xs, us, cost_now, _, _ = linesearch(x0, None, us0, None, None, None,
                                            reg, trace, 0)
    for it in range(settings.max_iters):
        with span("ilqr.derivs"):
            X = xs[:, :-1].reshape(B * N, n)
            U = us.reshape(B * N, m)
            if derivs is None:
                fx, fu = fxu_fn(X, U, *flat)
                ((lxx, _), (lux, luu)), (lx, lu) = l_fn(X, U, *flat)
                Vxx, Vx = lT_fn(xs[:, -1], *term_args)
            else:
                fx, fu, lx, lu, lxx, lux, luu, Vx, Vxx = derivs(
                    X, U, flat, xs[:, -1], term_args)
            fx, fu = fx.reshape(B, N, n, n), fu.reshape(B, N, n, m)
            lx, lu = lx.reshape(B, N, n), lu.reshape(B, N, m)
            lxx = lxx.reshape(B, N, n, n)
            luu, lux = luu.reshape(B, N, m, m), lux.reshape(B, N, m, n)
        with span("ilqr.backward"):
            kffs, Ks = _backward(fx, fu, lx, lu, lxx, lux, luu, Vx, Vxx,
                                 reg[:, None, None] * eye)
        with span("ilqr.linesearch"):
            xs, us, cost_now, reg, improved = linesearch(
                x0, xs, us, kffs, Ks, cost_now, reg, trace, it)
        with span("ilqr.accept"):
            if active():
                count("ilqr.accepted", improved.sum())
    return ILQRResult(xs=xs, us=us, cost=cost_now, cost_trace=trace)


def _backward(fx, fu, lx, lu, lxx, lux, luu, Vx, Vxx, reg_I):
    """The Riccati sweep from the terminal value (Vx, Vxx) back over the
    N nodes: the feed-forward terms and feedback gains of every node."""
    N = fx.shape[1]
    kffs, Ks = [None] * N, [None] * N
    for k in reversed(range(N)):
        fxT = fx[:, k].transpose(-1, -2)
        fuT = fu[:, k].transpose(-1, -2)
        Qx = lx[:, k] + _mv(fxT, Vx)
        Qu = lu[:, k] + _mv(fuT, Vx)
        Qxx = lxx[:, k] + fxT @ Vxx @ fx[:, k]
        Quu = luu[:, k] + fuT @ Vxx @ fu[:, k] + reg_I
        Qux = lux[:, k] + fuT @ Vxx @ fx[:, k]
        # LU solve without a status check: Quu can transiently lose
        # PD-ness at early iterates (active-set switches in the
        # penalty Hessians); a singular Quu gives non-finite gains,
        # and the line search then rejects every alpha of it
        sol = torch.linalg.solve_ex(
            Quu, torch.cat([Qu[..., None], Qux], -1),
            check_errors=False).result
        kff, K = -sol[..., 0], -sol[..., 1:]
        KT = K.transpose(-1, -2)
        QuxT = Qux.transpose(-1, -2)
        Vx = Qx + _mv(KT @ Quu, kff) + _mv(KT, Qu) + _mv(QuxT, kff)
        Vxx = Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        kffs[k], Ks[k] = kff, K
    return kffs, Ks
