"""Milliseconds a cycle in the iLQR's backward pass (ops/ilqr._backward:
the Riccati sweep over the N nodes, batched 12 x 12 products and
`solve_ex`): the port's own span `qrw.ilqr.backward`, summed over the
solve's iterations, on the profiler's clock with no synchronization of
its own."""


def read(tr):
    if "qrw.ilqr.backward" not in tr.spans:
        return None
    return 1e3 * tr.span_s("qrw.ilqr.backward") / tr.cycles
