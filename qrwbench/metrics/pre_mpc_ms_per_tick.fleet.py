"""Milliseconds a tick in the pre-MPC pipeline (core/controller.
compute_pre as sim/fleet calls it), synchronized at both ends."""


def read(tr):
    if "pre_mpc" not in tr.spans:
        return None
    return 1e3 * tr.span_s("pre_mpc") / (tr.cycles * tr.constants["k_mpc"])
