"""The DDP line-search kernel (qrw_tpu_torch/csrc/ddp_linesearch.cu) on
the card.

Marked `card`: each test skips where no CUDA device is present, since a
CUDA kernel has no CPU interpret mode (tests/test_torch_ddp.py holds
`ilqr.solve` with its plain line search, `ilqr.plain_linesearch`,
against qrw_tpu on the CPU). This file imports no JAX; on the card
machine run it with `python3 -m pytest --noconftest -m card
tests/test_torch_ddp_linesearch_card.py`.

* One iteration's line search and accept, the kernel against the plain
  version on the same iterate (xs, us, its cost after two iterations of
  `solve_mpc_ddp`'s problem on build_batch's trot problems), the same
  feed-forward terms and gains (the backward pass of that iterate), at
  B = 37 (the last block of 32 problems part-filled) and B = 1,024, for
  every model toggle; every third problem's current cost is set to 0, so
  that it rejects. States, controls and costs to a share of their
  scale, max(1, max |plain|): float64 1e-12 (the same arithmetic in
  another order of roundings), float32 4e-6. Where two step sizes' plain
  costs, or the best one and the current cost, lie within that share of
  the cost's scale, either choice is right and the problem's trajectory
  is not compared (its cost still is); elsewhere the kernel's accept
  and chosen step must be the plain version's.
* A problem whose gains are not finite (a singular Quu) is rejected:
  with NaN gains all its step sizes' costs are NaN, with infinite
  feed-forward terms every step size but none is non-finite; both keep
  their iterate and cost and raise the regularization tenfold.
* The whole float32 solve at B = 1,024, derivatives and line search from
  the kernels, against the float64 plain solve: its relative cost gaps
  at the median, 90th and 99th percentile at most twice those of the
  float32 plain solve plus 1e-7, the bar of
  tests/test_torch_ddp_derivs_card.py.
* Launches: one a solve for the initial rollout and one an iteration.
"""

import numpy as np
import pytest
import torch

from qrw_tpu_torch import kernels
from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core import mpc_ddp
from qrw_tpu_torch.eval.kernel_profile import build_batch
from qrw_tpu_torch.ops import ilqr

CFG = Config()
TOGGLES = [dict(nonlinear=a, implicit_integration=b, relative_forces=c)
           for a in (False, True) for b in (False, True)
           for c in (False, True)]
LS = "qrw_ddp_linesearch"


def toggle_name(t):
    return "-".join(k for k, v in t.items() if v) or "linear"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the DDP line-search kernel has no "
                    "CPU interpret mode)")
    return "cuda"


def problem(B, toggles, dtype, device, seed=3):
    """(settings, solve_mpc_ddp's iLQR arguments) for B trot problems of
    build_batch."""
    xr_np, fs_np = build_batch(CFG, B, np.random.default_rng(seed))
    xr = torch.as_tensor(xr_np, device=device, dtype=dtype)
    fs = torch.as_tensor(fs_np, device=device, dtype=dtype)
    settings = mpc_ddp.DDPSettings(**toggles)
    return settings, mpc_ddp._setup(CFG, xr, fs, None, settings, None, None)


def iteration(settings, args, kernel):
    """The plain and the kernel's line search of one iteration from the
    iterate two plain iterations reach: ((xs, us, cost, reg, accepted)
    of each, the inputs, each step size's plain cost (A, B))."""
    plain = ilqr.plain_linesearch(
        args["step"], args["cost"], args["cost_T"], args["node_args"],
        args["term_args"], settings.to_ilqr(), args["project_u"])
    it = ilqr.solve(**dict(args, linesearch=None),
                    settings=settings.to_ilqr()._replace(max_iters=2))
    xs, us, cost = it.xs, it.us, it.cost
    B, N = us.shape[:2]
    X = xs[:, :-1].reshape(B * N, 12)
    flat = [a.reshape((B * N,) + a.shape[2:]) for a in args["node_args"]]
    d = args["derivs"](X, us.reshape(B * N, 12), flat, xs[:, -1],
                       args["term_args"])
    d = [t.reshape((B, N) + t.shape[1:]) for t in d[:7]] + list(d[7:])
    reg = torch.full_like(cost, 1e-6)
    kffs, Ks = ilqr._backward(*d, reg[:, None, None]
                              * torch.eye(12, dtype=xs.dtype,
                                          device=xs.device))
    # every third problem's current cost 0: no step size beats it
    third = torch.arange(B, device=xs.device) % 3 == 0
    cost = torch.where(third, 0.0, cost)
    inputs = (args["x0"], xs, us, kffs, Ks, cost, reg)
    out = []
    for fn in (plain, kernel):
        trace = torch.full((B, 3), -1.0, dtype=xs.dtype, device=xs.device)
        out.append(fn(*inputs, trace, 1) + (trace,))
    inf = torch.full_like(cost, torch.inf)
    each = torch.stack([
        ilqr.plain_linesearch(
            args["step"], args["cost"], args["cost_T"], args["node_args"],
            args["term_args"], settings.to_ilqr()._replace(alphas=(a,)),
            args["project_u"])(args["x0"], xs, us, kffs, Ks, inf, reg,
                               torch.empty_like(cost)[:, None], 0)[2]
        for a in settings.alphas])
    return out, inputs, each


@pytest.mark.card
@pytest.mark.parametrize("B", [37, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("toggles", TOGGLES, ids=toggle_name)
def test_linesearch_kernel_against_plain(card, toggles, dtype, B):
    settings, args = problem(B, toggles, dtype, card)
    itemsize = torch.finfo(dtype).bits // 8
    launches = kernels.launches(LS)[itemsize]
    (want, got), inputs, each = iteration(settings, args,
                                          args["linesearch"])
    assert kernels.launches(LS)[itemsize] == launches + 1
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 4e-6
    xs_w, us_w, cost_w, reg_w, acc_w, trace_w = want
    xs_g, us_g, cost_g, reg_g, acc_g, trace_g = got
    cost_scale = max(1.0, float(cost_w.abs().max()))
    # the problems whose choice rounding may decide
    top2 = each.sort(0).values[:2]
    close = ((top2[1] - top2[0]).abs() <= tol * cost_scale) | (
        (top2[0] - inputs[5]).abs() <= tol * cost_scale)
    assert float(close.double().mean()) < 0.05, int(close.sum())
    sure = ~close
    assert torch.equal(acc_g[sure], acc_w[sure])
    assert torch.equal(reg_g[sure], reg_w[sure])
    assert bool(acc_w.any()) and not bool(acc_w[::3].any())
    for name, g, w in (("xs", xs_g, xs_w), ("us", us_g, us_w)):
        scale = max(1.0, float(w.abs().max()))
        err = float((g[sure] - w[sure]).abs().max())
        assert err <= tol * scale, (name, err, scale)
    for name, g, w in (("cost", cost_g, cost_w),
                       ("trace", trace_g[:, 1], trace_w[:, 1])):
        err = float((g - w).abs().max())
        assert err <= tol * cost_scale, (name, err, cost_scale)
    # the other columns of the trace are not written
    assert torch.equal(trace_g[:, 0::2], trace_w[:, 0::2])


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_nonfinite_gains_are_rejected(card, dtype):
    settings, args = problem(37, {}, dtype, card)
    plain = ilqr.plain_linesearch(
        args["step"], args["cost"], args["cost_T"], args["node_args"],
        args["term_args"], settings.to_ilqr(), args["project_u"])
    it = ilqr.solve(**dict(args, linesearch=None),
                    settings=settings.to_ilqr()._replace(max_iters=1))
    xs, us, cost = it.xs, it.us, it.cost
    B, N = us.shape[:2]
    X = xs[:, :-1].reshape(B * N, 12)
    flat = [a.reshape((B * N,) + a.shape[2:]) for a in args["node_args"]]
    d = args["derivs"](X, us.reshape(B * N, 12), flat, xs[:, -1],
                       args["term_args"])
    d = [t.reshape((B, N) + t.shape[1:]) for t in d[:7]] + list(d[7:])
    reg = torch.full_like(cost, 1e-3)
    kffs, Ks = ilqr._backward(*d, reg[:, None, None]
                              * torch.eye(12, dtype=xs.dtype,
                                          device=xs.device))
    kffs = [k.clone() for k in kffs]
    Ks = [K.clone() for K in Ks]
    Ks[5][3] = torch.nan                  # problem 3: every cost NaN
    kffs[0][7, 2] = torch.inf             # problem 7: every cost not finite
    outs = []
    for fn in (plain, args["linesearch"]):
        trace = torch.zeros((B, 1), dtype=dtype, device=card)
        outs.append(fn(args["x0"], xs, us, kffs, Ks, cost, reg, trace, 0)
                    + (trace,))
    torch.cuda.synchronize()
    for out in outs:
        xs_n, us_n, cost_n, reg_n, acc, trace = out
        for b in (3, 7):
            assert not bool(acc[b])
            assert torch.equal(xs_n[b], xs[b]) and torch.equal(us_n[b], us[b])
            assert float(cost_n[b]) == float(cost[b]) == float(trace[b, 0])
            assert float(reg_n[b]) == float(reg[b] * 10)
        assert bool(acc.any())


def _solve(dtype, device, plain=False):
    """A cold and a warm solve of solve_mpc_ddp's problem at B = 1,024;
    the warm one's ILQRResult, through the kernels or (plain) through
    torch.func and the plain line search."""
    xr_np, fs_np = build_batch(CFG, 1024, np.random.default_rng(11))
    xr = torch.as_tensor(xr_np, device=device, dtype=dtype)
    fs = torch.as_tensor(fs_np, device=device, dtype=dtype)
    settings = mpc_ddp.DDPSettings()
    state = None
    for _ in range(2):
        args = mpc_ddp._setup(CFG, xr, fs, state, settings, None, None)
        if plain:
            args.update(derivs=None, linesearch=None)
        res = ilqr.solve(**args, settings=settings.to_ilqr())
        state = mpc_ddp.DDPState(xs=res.xs, us=res.us)
    return res


@pytest.mark.card
def test_solve_float32_against_float64(card):
    launches = kernels.launches(LS)[4]
    got = _solve(torch.float32, card)
    settings = mpc_ddp.DDPSettings()
    assert kernels.launches(LS)[4] == launches + 2 * (1 + settings.max_iters)
    want = _solve(torch.float32, card, plain=True)
    ref = _solve(torch.float64, card, plain=True)
    torch.cuda.synchronize()
    assert kernels.launches(LS)[4] == launches + 2 * (1 + settings.max_iters)
    q = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=card)
    gaps = [torch.quantile(((r.cost.double() - ref.cost) / ref.cost).abs(), q)
            for r in (got, want)]
    assert bool(torch.isfinite(got.cost).all())
    assert bool((gaps[0] <= 2 * gaps[1] + 1e-7).all()), (gaps[0].tolist(),
                                                         gaps[1].tolist())


@pytest.mark.card
def test_solve_float64_against_plain(card):
    """The float64 solve through both kernels against the plain one, at the
    CPU tests' bars where a one-ulp accept may flip: xs and us to 1e-7 of
    scale, the cost to 1e-9 relative."""
    got = _solve(torch.float64, card)
    want = _solve(torch.float64, card, plain=True)
    torch.cuda.synchronize()
    for leaf in ("xs", "us"):
        w, g = getattr(want, leaf), getattr(got, leaf)
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= 1e-7 * scale, (leaf, err, scale)
    rel = float(((got.cost - want.cost).abs() / want.cost.abs()).max())
    assert rel <= 1e-9, rel
