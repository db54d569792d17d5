"""The K^-1 kernel (qrw_tpu_torch/csrc/qp_kinv.cu) on the card.

Marked `card`: each test skips where no CUDA device is present, since a
CUDA kernel has no CPU interpret mode (the CPU tests hold the plain
version, `qp_pallas._chol_inv_plain`, against qrw_tpu in
tests/test_torch_qp_pallas.py). This file imports no JAX; on the card
machine run it with `python3 -m pytest --noconftest -m card
tests/test_torch_kinv_card.py`.

Each batch is held against the float64 Cholesky and solve of the same
symmetrized matrices. Tolerance: the kernel's error relative to the
largest entry of the float64 inverse may be at most 4 times the error of
the library's float32 Cholesky and solve (torch.linalg.cholesky +
cholesky_solve) on the same inputs, plus 1e-6. Both are float32
factorizations of the same matrices; their errors scale with the
condition number (~1e2-1e3 here) times float32's epsilon, in another
order of operations, so the factor 4 leaves room for the order and
nothing for a wrong entry.
"""

import pytest
import torch

from qrw_tpu_torch import kernels
from qrw_tpu_torch.ops import qp_pallas as qpp

# n: the rolled rescue's, the fleet rescue's, the full size's, and one
# that leaves the last row and column of 6 x 6 thread tiles part-filled.
# B: the kernel runs one problem a block, so no block is part-filled; an
# odd B leaves the card's last wave of blocks part-filled.
SHAPES = [(96, 37), (144, 21), (192, 13), (100, 9)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the K^-1 kernel has no CPU "
                    "interpret mode)")
    return "cuda"


def _spd(B, n, seed, device):
    g = torch.Generator().manual_seed(seed)
    M = torch.randn(B, n, n, generator=g, dtype=torch.float64)
    K = M @ M.transpose(1, 2) / n + 0.05 * torch.eye(n, dtype=torch.float64)
    # not bitwise symmetric, as the solver's assembly can give it
    K = K + torch.triu(1e-6 * torch.randn(B, n, n, generator=g,
                                          dtype=torch.float64), 1)
    return K.to(device, torch.float32).contiguous()


def _err(X, X64):
    scale = X64.abs().amax(dim=(1, 2))
    return (X.double() - X64).abs().amax(dim=(1, 2)) / scale


@pytest.mark.card
@pytest.mark.parametrize("n,B", SHAPES)
def test_kinv_kernel_against_float64(card, n, B):
    K = _spd(B, n, n, card)
    j = B // 2
    Kb = K.clone()
    Kb[j, n // 3, n // 3] = -1.0            # problem j: a negative pivot
    launches = kernels.launches("qrw_kinv")[n]
    X, nonpd = qpp._kinv_launch(K)
    Xb, nonpd_b = qpp._kinv_launch(Kb)
    torch.cuda.synchronize()
    assert kernels.launches("qrw_kinv")[n] == launches + 2

    S = (K.double() + K.double().transpose(1, 2)) / 2
    eye = torch.eye(n, device=card).expand(B, n, n)
    X64 = torch.cholesky_solve(eye.double(), torch.linalg.cholesky(S))
    lib = torch.cholesky_solve(eye, torch.linalg.cholesky(
        (K + K.transpose(1, 2)) / 2))
    e_k, e_lib = _err(X, X64), _err(lib, X64)
    assert not nonpd.any()
    assert bool((e_k <= 4 * e_lib + 1e-6).all()), (e_k.max(), e_lib.max())

    others = torch.arange(B, device=card) != j
    assert nonpd_b.tolist() == [int(i == j) for i in range(B)]
    assert bool(torch.isnan(Xb[j]).all())
    assert torch.equal(Xb[others], X[others])


@pytest.mark.card
def test_kinv_kernel_refuses_what_it_cannot_hold(card):
    with pytest.raises(ValueError, match="192"):
        qpp._kinv_launch(torch.eye(193, device=card).expand(2, 193, 193)
                         .contiguous())
    with pytest.raises(TypeError, match="float32"):
        qpp._kinv_launch(torch.eye(6, device=card, dtype=torch.float64)
                         .expand(2, 6, 6).contiguous())
