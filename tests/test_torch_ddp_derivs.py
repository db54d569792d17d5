"""The DDP derivatives written out (core/mpc_ddp._srb_derivs_plain, the
plain version of csrc/ddp_derivs.cu) against torch.func on the same
problem, float64 on the CPU.

torch.func (forward over reverse, as qrw_tpu's jax.hessian) is what
ops/ilqr.solve computes on the CPU, and what tests/test_torch_ddp.py
holds against qrw_tpu; the written-out version is what the card runs.
Each case builds core/mpc_ddp._setup's problem for B = 3 problems and
compares the nine outputs of `derivs` (fx, fu, lx, lu, lxx, lux, luu on
the B N node rows, Vx, Vxx on the B terminal states) to 1e-12 of each
output's scale, max(1, max |torch.func's|): the two differ only in the
order of float64 roundings (measured: 1.9e-16 at most).

Cases: every combination of the three model toggles (nonlinear,
implicit_integration, relative_forces) on each kind of rows of
tests/torch_ddp_rows.py ("random", "cold": the cone's ties, "dt_first").
"""

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core import mpc_ddp
from qrw_tpu_torch.ops import ilqr
from tests.torch_ddp_rows import (KINDS, NAMES, TOGGLES, inputs,
                                  toggle_name)
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
N = CFG.n_steps
B = 3


def _derivs(kind, toggles):
    """(torch.func's nine outputs, the plain version's) on one case."""
    settings = mpc_ddp.DDPSettings(**toggles)
    xref, fsteps, X, U, xT, dt_first = (
        None if a is None else torch.as_tensor(a)
        for a in inputs(kind, B=B))
    args = mpc_ddp._setup(CFG, xref, fsteps, None, settings, dt_first, None)
    assert args["derivs"] is None                 # the CPU keeps torch.func
    flat = [a.reshape((B * N,) + a.shape[2:]) for a in args["node_args"]]
    fx, fu = vmap(jacfwd(args["step"], argnums=(0, 1)))(X, U, *flat)
    ((lxx, _), (lux, luu)), (lx, lu) = vmap(
        ilqr._second_order(args["cost"]))(X, U, *flat)
    Vxx, Vx = vmap(ilqr._terminal_second_order(args["cost_T"]))(
        xT, *args["term_args"])
    want = (fx, fu, lx, lu, lxx, lux, luu, Vx, Vxx)
    c = mpc_ddp.make_consts(CFG, torch.float64, "cpu")
    got = mpc_ddp._srb_derivs_plain(CFG, settings, c, X, U, flat, xT,
                                    args["term_args"])
    return want, got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("toggles", TOGGLES, ids=toggle_name)
def test_srb_derivs_plain_against_torch_func(toggles, kind):
    want, got = _derivs(kind, toggles)
    for name, w, g in zip(NAMES, want, got):
        assert g.shape == w.shape and g.dtype == torch.float64, name
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-12 * scale, err_msg=name)


def test_srb_derivs_cases_reach_every_branch():
    """The cases exercise what they say: shoulder penalties active and
    inactive, cone ties at u = 0 and at the other rows, forces outside
    the cone."""
    _, fsteps, X, U, _, _ = inputs("random", B=B)
    x = torch.as_tensor(X)
    feet = torch.as_tensor(fsteps[:, :N].reshape(B * N, 4, 3))
    cs, sn = torch.cos(x[:, 5:6]), torch.sin(x[:, 5:6])
    sx, sy = torch.as_tensor(mpc_ddp.SHOULDERS_XY)
    ex = x[:, 0:1] + cs * sx - sn * sy - feet[..., 0]
    ey = x[:, 1:2] + sn * sx + cs * sy - feet[..., 1]
    d = torch.sqrt(ex ** 2 + ey ** 2 + x[:, 2:3] ** 2)
    active = d > mpc_ddp.SHOULDER_HLIM
    assert 0.1 < float(active.double().mean()) < 0.9
    fz = U.reshape(-1, 4, 3)[..., 2]
    assert (fz < mpc_ddp.MIN_FZ).any() and (fz > CFG.fz_max).any()
    want, _ = _derivs("cold", TOGGLES[0])
    luu = want[6]
    # the first stance foot's cone rows all at their tie: 1/4 of the
    # friction weight on each (d2/dfx2: two rows), plus the force weight
    g0 = (torch.as_tensor(fsteps[:, :N, 0::3]) != 0).reshape(B * N, 4)
    r, i = [int(v) for v in torch.nonzero(g0)[0]]
    assert float(luu[r, 3 * i, 3 * i]) == pytest.approx(
        0.5 + mpc_ddp.FORCE_WEIGHT ** 2)


@pytest.mark.parametrize("variant", ["linear", "nonlinear",
                                     "implicit_relative"])
def test_ilqr_solve_with_plain_derivs(variant):
    """ops/ilqr.solve given the written-out derivatives as `derivs`
    against its torch.func path on the same problems, 4 iterations
    (before the steps reach rounding): xs, us, cost and cost_trace to
    1e-9 of scale."""
    toggles = {"linear": {}, "nonlinear": dict(nonlinear=True),
               "implicit_relative": dict(implicit_integration=True,
                                         relative_forces=True)}[variant]
    settings = mpc_ddp.DDPSettings(max_iters=4, **toggles)
    xref, fsteps, _, _, _, _ = (torch.as_tensor(a) if a is not None else a
                                for a in inputs("random", seed=3, B=B))
    args = mpc_ddp._setup(CFG, xref, fsteps, None, settings, None, None)
    want = ilqr.solve(**args, settings=settings.to_ilqr())
    c = mpc_ddp.make_consts(CFG, torch.float64, "cpu")
    args["derivs"] = lambda *a: mpc_ddp._srb_derivs_plain(
        CFG, settings, c, *a)
    got = ilqr.solve(**args, settings=settings.to_ilqr())
    for leaf in ("xs", "us", "cost", "cost_trace"):
        w, g = getattr(want, leaf), getattr(got, leaf)
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-9 * scale, err_msg=leaf)
    assert float(got.cost_trace[0, -1]) < float(got.cost_trace[0, 0])


def test_derivs_params_layout():
    """The kernel's host parameters: N_PARAMS doubles in the order of
    csrc/ddp_derivs.cu's `Params`; the toggles' bit mask."""
    p = np.asarray(mpc_ddp.derivs_params(CFG))
    assert p.shape == (mpc_ddp.N_PARAMS,) == (41,)
    assert p[0] == CFG.mass and p[3:12].tolist() == list(CFG.gI)
    np.testing.assert_array_equal(p[12:24], mpc_ddp.STATE_WEIGHTS)
    assert p[-1] == CFG.mass * CFG.gravity
    assert [mpc_ddp.derivs_flags(mpc_ddp.DDPSettings(**t)) for t in
            TOGGLES] == [0, 4, 2, 6, 1, 5, 3, 7]
