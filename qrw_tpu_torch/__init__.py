"""qrw_tpu_torch: the PyTorch + CUDA port of qrw_tpu.

The JAX package `qrw_tpu` stays the reference; every module here mirrors
its counterpart there (qrw_tpu_torch/ops/qp_phase.py <-> qrw_tpu/ops/
qp_phase.py, ...) and is held against it by tests/test_torch_*.py.

Precision: the JAX package runs every contraction at
Precision.HIGHEST (qrw_tpu/ops/qp_phase.py, qrw_tpu/ops/qp.py) because
the ADMM solvers need true f32 accumulation. TF32 would keep about three
decimal digits, so the port turns it off for matmuls and cuDNN alike.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
