"""Milliseconds a cycle in the MPC's assembly and glue: core/mpc_lane.
solve_mpc_batch_phase outside ops/qp_phase.solve and the rescue stage."""


def read(tr):
    if "mpc" not in tr.spans:
        return None
    return 1e3 * (tr.span_s("mpc") - tr.span_s("k1")
                  - tr.span_s("rescue")) / tr.cycles
