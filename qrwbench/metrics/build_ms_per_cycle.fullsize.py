"""Milliseconds a cycle in the full-size path's assembly: core/mpc.
solve_mpc_batch_pallas outside ops/qp_pallas.solve (build_qp_compact,
the carry, recover_dx)."""


def read(tr):
    if "fullsize" not in tr.spans:
        return None
    return 1e3 * (tr.span_s("fullsize") - tr.span_s("qp")) / tr.cycles
