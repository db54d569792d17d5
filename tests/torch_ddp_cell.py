"""Not a test: bench.py's DDP cell (run_ddp_bench) in both packages on the
CPU, cycle by cycle.

    python tests/torch_ddp_cell.py [batch] [cycles]

B trot problems of build_batch(cfg, B, default_rng(11)) (default
B = 1024), one warm-started batched DDP solve a cycle (default 11: the
warm-up cycle and the 10 warm cycles of chip_smoke.py's D1), float32:
qrw_tpu's jax.vmap(solve_mpc_ddp) and the port's solve_mpc_ddp. Prints,
per cycle, the mean, min and max of each package's total fz at the
first node, the number chip_smoke.py's D1 holds the card to."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import bench
from qrw_tpu.config import Config
from qrw_tpu.core import mpc_ddp as jddp
from qrw_tpu_torch.config import Config as TConfig
from qrw_tpu_torch.core import mpc_ddp as tddp
from qrw_tpu_torch.eval.kernel_profile import build_batch


def total_fz(x_f, B):
    fz = np.asarray(x_f)[:, 12:, 0].reshape(B, 4, 3)[:, :, 2].sum(1)
    return f"{fz.mean():.4f} [{fz.min():.4f}, {fz.max():.4f}]"


def main(B: int = 1024, cycles: int = 11):
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    cfg, tcfg = Config(), TConfig()
    xr_np, fs_np = build_batch(tcfg, B, np.random.default_rng(11))
    jxr, jfs = bench.build_batch(cfg, B, np.random.default_rng(11))
    assert np.array_equal(np.asarray(jxr), xr_np)
    assert np.array_equal(np.asarray(jfs), fs_np)
    solve = jax.jit(jax.vmap(lambda x, f, s: jddp.solve_mpc_ddp(cfg, x, f,
                                                                s)))
    jst = jax.vmap(lambda _: jddp.init_ddp_state(cfg))(jnp.arange(B))
    tst = None
    xr, fs = torch.as_tensor(xr_np), torch.as_tensor(fs_np)
    for c in range(cycles):
        jr = solve(jnp.asarray(xr_np), jnp.asarray(fs_np), jst)
        tr = tddp.solve_mpc_ddp(tcfg, xr, fs, tst)
        jst, tst = jr.state, tr.state
        print(f"cycle {c}: total fz of the first node, qrw_tpu "
              f"{total_fz(jr.x_f_applied, B)} N, port "
              f"{total_fz(tr.x_f_applied, B)} N (mg "
              f"{cfg.mass * cfg.gravity:.4f})", flush=True)


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])
