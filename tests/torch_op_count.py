"""Not a test: how many torch operations one tick of the single-robot loop
dispatches, by stage, on the CPU.

    python tests/torch_op_count.py [ticks]

Runs the port's rollout (default Config: trot, velID 2, one robot) for
one warm-up tick, then counts, through a TorchDispatchMode, every
operation the next `ticks` ticks (default 10: one MPC solve) dispatch,
views included, and prints the mean per tick for each stage (pre-MPC
pipeline, MPC solve, WBC, physics, the rest). On the card each
non-view operation is one kernel launch, so these counts bound the
eager loop's host time per tick from below."""

import collections
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core import controller, mpc, wbc
from qrw_tpu_torch.sim import rollout


def main(ticks: int = 10):
    torch.set_num_threads(1)
    stack, counts = [], collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[stack[-1] if stack else "rest"] += 1
            return func(*args, **(kwargs or {}))

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
    with Count():
        rollout.rollout(ctl, carry, ticks, k0=1, with_logs=False)
    total = sum(counts.values())
    print(f"torch ops per tick over {ticks} ticks: {total / ticks:.0f}; "
          + ", ".join(f"{k} {v / ticks:.0f}" for k, v in
                      counts.most_common()))


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])
