"""Milliseconds a cycle in the iLQR's line search (ops/ilqr.solve: the
closed-loop rollouts of all nine step sizes at once and their costs):
the port's own span `qrw.ilqr.linesearch`, summed over the solve's
iterations, on the profiler's clock with no synchronization of its
own."""


def read(tr):
    if "qrw.ilqr.linesearch" not in tr.spans:
        return None
    return 1e3 * tr.span_s("qrw.ilqr.linesearch") / tr.cycles
