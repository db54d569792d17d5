"""Not a test: how many torch operations one tick of the single-robot loop
dispatches, by stage, on the CPU.

    python tests/torch_op_count.py [ticks]
    python tests/torch_op_count.py ddp [batch]

Runs the port's rollout (default Config: trot, velID 2, one robot) for
one warm-up tick, then counts, through a TorchDispatchMode, every
operation the next `ticks` ticks (default 10: one MPC solve) dispatch,
views included, and prints the mean per tick for each stage (pre-MPC
pipeline, MPC solve, WBC, physics, the rest). On the card each
non-view operation is one kernel launch, so these counts bound the
eager loop's host time per tick from below.

`ddp` counts one DDP MPC solve (core/mpc_ddp.solve_mpc_ddp, 10 iLQR
iterations, `batch` trot problems, default 1; the count does not depend
on the batch) by stage: the per-node derivatives (the torch.func
Jacobians and Hessians), the rollouts (the line search's 9 alphas and
the initial rollout), and the backward Riccati sweep with the rest of
the iteration; all operations, the non-view ones and, among those, the
`prims` ones: torch.func's forward-over-reverse derivatives run the
jvp of elementwise ops through Python reference decompositions
(torch._refs), which dispatch prims."""

import collections
import sys

import torch

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core import controller, mpc, wbc
from qrw_tpu_torch.sim import rollout
from qrw_tpu_torch.utils.op_count import count_ops


def main(ticks: int = 10):
    torch.set_num_threads(1)
    stack = []

    def label(mod, name, tag):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            stack.append(tag)
            try:
                return fn(*a, **k)
            finally:
                stack.pop()
        setattr(mod, name, wrapped)

    label(controller, "compute_pre", "pre-MPC")
    label(mpc, "solve_mpc", "MPC")
    label(wbc, "compute_wbc", "WBC")
    label(rollout, "step", "physics")
    ctl, carry = rollout.make_rollout(Config(), device="cpu")
    carry, _ = rollout.rollout(ctl, carry, 1)
    by_kind = count_ops(
        lambda: rollout.rollout(ctl, carry, ticks, k0=1, with_logs=False),
        tag=lambda: stack[-1] if stack else "rest")
    counts = collections.Counter()
    for (stage, _), n in by_kind.items():
        counts[stage] += n
    total = sum(counts.values())
    print(f"torch ops per tick over {ticks} ticks: {total / ticks:.0f}; "
          + ", ".join(f"{k} {v / ticks:.0f}" for k, v in
                      counts.most_common()))


def ddp_ops(batch: int = 1):
    """{stage: (all ops, non-view ops, prims ops)} of one DDP solve of
    `batch` trot problems (float32, on the CPU)."""
    import numpy as np
    from torch.func import vmap
    from qrw_tpu_torch.core import mpc_ddp
    from qrw_tpu_torch.core.mpc_lane import trot_phase_fsteps
    from qrw_tpu_torch.ops import ilqr

    cfg = Config()
    fs = torch.as_tensor(np.asarray(trot_phase_fsteps(cfg))[
        np.arange(batch) % 16], dtype=torch.float32)
    xref = torch.zeros((batch, 12, cfg.n_steps + 1))
    xref[:, 2] = cfg.h_ref
    stack = []

    def labelled(fn, tag):
        def wrapped(*a, **k):
            stack.append(stack[-1] if stack else tag)
            try:
                return fn(*a, **k)
            finally:
                stack.pop()
        return wrapped

    orig = (ilqr.vmap, mpc_ddp._dynamics, mpc_ddp._stage_cost)
    ilqr.vmap = lambda fn: labelled(vmap(fn), "derivatives")
    mpc_ddp._dynamics = labelled(orig[1], "rollouts (line search)")
    mpc_ddp._stage_cost = labelled(orig[2], "rollouts (line search)")
    try:
        mpc_ddp.solve_mpc_ddp(cfg, xref, fs)
        counts = count_ops(
            lambda: mpc_ddp.solve_mpc_ddp(cfg, xref, fs),
            tag=lambda: stack[-1] if stack else "backward sweep and the rest")
    finally:
        ilqr.vmap, mpc_ddp._dynamics, mpc_ddp._stage_cost = orig
    out = {}
    for (tag, kind), n in counts.items():
        a, nv, pr = out.get(tag, (0, 0, 0))
        out[tag] = (a + n, nv + (kind != "view") * n,
                    pr + (kind == "prims") * n)
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1:2] == ["ddp"]:
        stages = ddp_ops(*[int(a) for a in sys.argv[2:]])
        total = [sum(v[i] for v in stages.values()) for i in (0, 1, 2)]
        print(f"torch ops per DDP solve (10 iterations): {total[0]}, "
              f"{total[1]} not views, {total[2]} of them prims; by stage "
              "(all, not views, prims): " + ", ".join(
                  f"{k} {a} ({nv}, {pr})" for k, (a, nv, pr) in sorted(
                      stages.items(), key=lambda kv: -kv[1][0])))
    else:
        main(*[int(a) for a in sys.argv[1:]])
