"""Milliseconds a cycle in the MPC rescue stage (mpc_lane.
_rescue_failed_lanes; kernel K2 at n = 144 in the heterogeneous fleet),
including the host read that decides whether it runs."""


def read(tr):
    if "rescue" not in tr.spans:
        return None
    return 1e3 * tr.span_s("rescue") / tr.cycles
