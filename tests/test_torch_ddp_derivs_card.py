"""The DDP derivatives kernel (qrw_tpu_torch/csrc/ddp_derivs.cu) on the
card.

Marked `card`: each test skips where no CUDA device is present, since a
CUDA kernel has no CPU interpret mode (tests/test_torch_ddp_derivs.py
holds the kernel's plain version, `core/mpc_ddp._srb_derivs_plain`,
against torch.func on the CPU). This file imports no JAX; on the card
machine run it with `python3 -m pytest --noconftest -m card
tests/test_torch_ddp_derivs_card.py`.

* The kernel against the plain version on the same inputs, every model
  toggle and the three kinds of rows of tests/torch_ddp_rows.py, at
  B = 37 problems (R = 592 node rows: the last group of 32 rows a warp
  stages is part-filled, as is the terminal rows' one), each output to
  a share of its scale, max(1, max |plain|). float64: 1e-12 (the same
  arithmetic in another order of roundings). float32: 4e-6, on the rows
  farther than 1e-5 m from the shoulder penalty's kink
  (`mpc_ddp.shoulder_kink_margin`; a row within float32 rounding of it
  may take either side): at the DDP cell's shape both float32 versions
  lie within 5.8e-7 of scale of the float64 plain version (chip_smoke
  D0, NVIDIA H100 80GB HBM3, 700.00 W). The cone's residuals are formed
  alike in both, so their ties and active sets agree bit for bit.
* One warm solve of `solve_mpc_ddp`'s problem at B = 1,024 (its
  `ilqr.solve` call with the kernel as `derivs`, one launch an
  iteration) against the same solve through torch.func. float64: xs and
  us to 1e-7 of their scale, the cost to 1e-9 relative (the CPU tests'
  bars where a one-ulp accept decision may flip; the plain version
  against torch.func on the CPU measured 8.7e-9 and 7.7e-14 here).
  float32 cannot be held to a fixed bar at this batch: two float32
  roundings of the same derivatives let the line search take another
  step on a few problems (on the CPU, the plain version against
  torch.func, both float32: 7 of 1,024 costs apart by more than 1e-5,
  the farthest by 1.7e-2; each solve's farthest cost from the float64
  solve's 2.87e-2). So each float32 solve is held against the float64
  solve of the same problems: the kernel's relative cost gap, at its
  median, 90th and 99th percentile over the problems, at most twice
  torch.func's plus 1e-7.
"""

import os
import sys

import numpy as np
import pytest
import torch

from qrw_tpu_torch import kernels
from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core import mpc_ddp
from qrw_tpu_torch.eval.kernel_profile import build_batch
from qrw_tpu_torch.ops import ilqr

# the rows' module by its own name: on the card machine another package
# may own the name `tests`
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ddp_rows import (KINDS, NAMES, TOGGLES, inputs,  # noqa: E402
                            toggle_name)

CFG = Config()
N = CFG.n_steps
B_ROWS = 37


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the DDP derivatives kernel has no "
                    "CPU interpret mode)")
    return "cuda"


def _case(kind, toggles, dtype, device):
    """(the kernel's nine outputs, the plain version's, the node rows'
    and the terminal rows' distance from the shoulder kink)."""
    settings = mpc_ddp.DDPSettings(**toggles)
    xref, fsteps, X, U, xT, dt_first = (
        None if a is None else torch.as_tensor(a).to(device, dtype)
        for a in inputs(kind, seed=5, B=B_ROWS))
    args = mpc_ddp._setup(CFG, xref, fsteps, None, settings, dt_first, None)
    flat = [a.reshape((B_ROWS * N,) + a.shape[2:])
            for a in args["node_args"]]
    launches = kernels.launches("qrw_ddp_derivs")[X.element_size()]
    got = args["derivs"](X, U, flat, xT, args["term_args"])
    assert kernels.launches("qrw_ddp_derivs")[X.element_size()] == \
        launches + 1
    plain = mpc_ddp._srb_derivs_plain(
        CFG, settings, mpc_ddp.make_consts(CFG, dtype, device), X, U, flat,
        xT, args["term_args"])
    xrefT, feetT, gaitT = args["term_args"]
    margin = (mpc_ddp.shoulder_kink_margin(X, flat[0], flat[1]),
              mpc_ddp.shoulder_kink_margin(xT, feetT, gaitT))
    return got, plain, margin


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("toggles", TOGGLES, ids=toggle_name)
def test_derivs_kernel_against_plain(card, toggles, kind, dtype):
    got, plain, (m_node, m_term) = _case(kind, toggles, dtype, card)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 4e-6
    for name, g, p in zip(NAMES, got, plain):
        assert g.shape == p.shape and g.dtype == dtype, name
        scale = max(1.0, float(p.abs().max()))
        err = (g.double() - p.double()).abs().flatten(1).amax(1)
        if dtype == torch.float32:
            err = err[(m_term if name.startswith("V") else m_node) > 1e-5]
        assert float(err.max()) <= tol * scale, (name, float(err.max()),
                                                 scale)


def _warm_solves(dtype, device, state64=None):
    """(kernel, torch.func) solves of the warm problem at B = 1,024 in
    `dtype`, from a float64 torch.func cold solve's solution."""
    xr_np, fs_np = build_batch(CFG, 1024, np.random.default_rng(11))
    xr = torch.as_tensor(xr_np, device=device, dtype=dtype)
    fs = torch.as_tensor(fs_np, device=device, dtype=dtype)
    settings = mpc_ddp.DDPSettings()
    state = mpc_ddp.DDPState(*(t.to(dtype) for t in state64))
    args = mpc_ddp._setup(CFG, xr, fs, state, settings, None, None)
    assert args["derivs"] is not None
    launches = kernels.launches("qrw_ddp_derivs")[xr.element_size()]
    got = ilqr.solve(**args, settings=settings.to_ilqr())
    assert kernels.launches("qrw_ddp_derivs")[xr.element_size()] == \
        launches + settings.max_iters
    args["derivs"] = None
    want = ilqr.solve(**args, settings=settings.to_ilqr())
    torch.cuda.synchronize()
    return got, want


@pytest.fixture(scope="module")
def cold64():
    """A float64 torch.func cold solve's solution at B = 1,024 (the warm
    solves' carried state)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xr_np, fs_np = build_batch(CFG, 1024, np.random.default_rng(11))
    xr = torch.as_tensor(xr_np, device="cuda", dtype=torch.float64)
    fs = torch.as_tensor(fs_np, device="cuda", dtype=torch.float64)
    settings = mpc_ddp.DDPSettings()
    args = mpc_ddp._setup(CFG, xr, fs, None, settings, None, None)
    args["derivs"] = None
    res = ilqr.solve(**args, settings=settings.to_ilqr())
    return mpc_ddp.DDPState(xs=res.xs, us=res.us)


@pytest.mark.card
def test_solve_kernel_against_torch_func_float64(card, cold64):
    got, want = _warm_solves(torch.float64, card, cold64)
    for leaf in ("xs", "us"):
        w, g = getattr(want, leaf), getattr(got, leaf)
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= 1e-7 * scale, (leaf, err, scale)
    rel = float(((got.cost - want.cost).abs() / want.cost.abs()).max())
    assert rel <= 1e-9, rel


@pytest.mark.card
def test_solve_kernel_float32_against_float64(card, cold64):
    got, want = _warm_solves(torch.float32, card, cold64)
    _, ref = _warm_solves(torch.float64, card, cold64)
    q = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=card)
    gaps = [torch.quantile(((r.cost.double() - ref.cost) / ref.cost).abs(), q)
            for r in (got, want)]
    assert bool(torch.isfinite(got.cost).all())
    assert bool((gaps[0] <= 2 * gaps[1] + 1e-7).all()), (gaps[0].tolist(),
                                                         gaps[1].tolist())
