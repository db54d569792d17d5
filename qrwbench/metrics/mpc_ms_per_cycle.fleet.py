"""Milliseconds a cycle in the MPC phase solve (core/mpc_lane.
solve_mpc_batch_phase) less its rescue stage."""


def read(tr):
    if "mpc" not in tr.spans:
        return None
    return 1e3 * (tr.span_s("mpc") - tr.span_s("rescue")) / tr.cycles
