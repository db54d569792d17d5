"""Milliseconds a tick in the lane WBC's box QP (core/wbc_lane.
wbc_qp_solve): the port's own span `qrw.wbc.qp`, on the profiler's clock
with no synchronization of its own, so it holds the QP's issue time and
its rounds' blocking reads of the termination flags."""


def read(tr):
    if "qrw.wbc.qp" not in tr.spans:
        return None
    ticks = tr.cycles * tr.constants["k_mpc"]
    return 1e3 * tr.span_s("qrw.wbc.qp") / ticks
