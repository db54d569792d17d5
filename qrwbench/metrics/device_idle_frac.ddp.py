"""The device's idle share of the traced cycles: 1 - the union of the
device operations' intervals over the profiled wall."""


def read(tr):
    if not tr.n_kernels or tr.wall_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.wall_s
