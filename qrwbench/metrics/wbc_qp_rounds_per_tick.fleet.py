"""Check rounds a tick of the lane WBC's box QP (core/wbc_lane.
wbc_qp_solve, each round one factorization, check_every iterations and
one host read): the port's counter `wbc.qp_rounds` over the traced
ticks."""


def read(tr):
    try:
        from qrw_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    n = counters().get("wbc.qp_rounds")
    if n is None:
        return None
    return n / (tr.cycles * tr.constants["k_mpc"])
