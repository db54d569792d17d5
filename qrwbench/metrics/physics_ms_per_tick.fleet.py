"""Milliseconds a tick in the lane-major physics step (sim/physics_lane.
step_lane)."""


def read(tr):
    if "physics" not in tr.spans:
        return None
    return 1e3 * tr.span_s("physics") / (tr.cycles * tr.constants["k_mpc"])
