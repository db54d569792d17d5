"""Milliseconds a cycle in the iLQR's derivatives (ops/ilqr.solve's
`torch.func` calls: the dynamics' Jacobians and the costs' Hessians on
B x N rows): the port's own span `qrw.ilqr.derivs`, summed over the
solve's iterations, on the profiler's clock with no synchronization of
its own: the host's time to issue the work, and the card's where the
host waits on it."""


def read(tr):
    if "qrw.ilqr.derivs" not in tr.spans:
        return None
    return 1e3 * tr.span_s("qrw.ilqr.derivs") / tr.cycles
