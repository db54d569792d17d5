"""Milliseconds a tick in the WBC and the post step (controller.
wbc_inputs, core/wbc_lane.compute_wbc_lane, controller.compute_post)."""

SPANS = ("wbc_inputs", "wbc", "post")


def read(tr):
    if not any(s in tr.spans for s in SPANS):
        return None
    return 1e3 * sum(tr.span_s(s) for s in SPANS) / (
        tr.cycles * tr.constants["k_mpc"])
