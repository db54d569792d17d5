"""K1's share of its roofline in the rolled-gait batch, in percent: the
least time the card could take for the phase solves' work (operations at
the float32 peak or bytes at the memory rate, from the shapes and the
iterations each tile ran) over the device time of the kernels launched
inside `ops/qp_phase.solve`."""

from qrwbench import work


def read(tr):
    recs = tr.records.get("k1", [])
    if not recs:
        return None
    bound = sum(work.bound_s(*work.k1_work(
        r["B"], r["cap"], r["P"], r["tile"], r["iters"], r["converged"],
        r["n_iters"], r["stop_at_eps"])) for r in recs)
    return work.roofline_pct(bound, tr.kernel_s("k1"))
