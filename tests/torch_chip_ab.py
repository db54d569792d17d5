"""Not a test: chip_smoke.py's trot fleet (phase 5) and S2 (--batch 256,
300 ticks) from one checkout of the repo, to compare two commits on
the same card.

    python tests/torch_chip_ab.py CHECKOUT [--build-only]

CHECKOUT is a directory holding a checkout (`git archive`) whose
chip_smoke.py and qrw_tpu_torch are used; --build-only builds its
kernels and exits. Build both checkouts first (in parallel), then run
them alternately in separate processes, parent, change, change, parent,
and compare the printed `fleet B=1024` and `S2` lines. Needs the card.
"""

import os
import sys

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs  # noqa: E402
from qrw_tpu_torch import kernels  # noqa: E402
from qrw_tpu_torch.config import Config  # noqa: E402

kernels.library()
if "--build-only" not in sys.argv[2:]:
    print(f"== {root}", flush=True)
    cfg = Config()
    cs.run_main_path(cfg, "cuda")
    cs.run_batch_path(cfg, "cuda")
