"""Milliseconds a cycle in the rescue stage (mpc_lane._rescue_failed_lanes:
kernel K2 at n = 96 on the lanes the phase solve failed), including the
host read that decides whether it runs."""


def read(tr):
    if "rescue" not in tr.spans:
        return None
    return 1e3 * tr.span_s("rescue") / tr.cycles
